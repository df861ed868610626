// Bitonic block sort of (int32 key, int32 value) pairs for Hopper.
//
// Replaces sparkrdma_tpu/ops/sort_kernel.py::_block_sort_body, the
// Pallas bitonic XOR network reached through sort_pairs_blocks.  It
// runs the SAME network, so keys and values match the Pallas kernel
// bit for bit:
//   for stage = 1 .. log2(B):
//     up = (flat & (1 << stage)) == 0, or true at the last stage
//     for j = stage-1 .. 0, d = 1 << j:
//       the pair (lo, lo | d) sorts ascending iff up; with equal keys
//       the pair is swapped when descending (the Pallas tie rule
//       mine_small = k < pk | (k == pk & is_lower)).
// Blocks of B = block_rows * 128 pairs sort independently; `flat` is
// the index within the block.  Only the schedule differs from Pallas:
// every step runs after the steps before it, so the bits are the same.
//
// Bound.  Operations: B/2 * L(L+1)/2 compare-exchanges per block
// (L = log2 B; 136 steps at B = 2^16), each at least one compare and
// four selects on the int32 lanes (64 per SM, 16.7 T/s across 132 SMs
// at 1.98 GHz): 0.34 ms for 2^24 pairs at B = 2^16.  Bytes come second:
// one read and one write of 8 B per pair, 0.08 ms.
//
// Design.  The network is bound by int32 instructions, so every
// compare-exchange runs in registers, and data moves only to change
// which index bits are register bits:
// - A CTA of 256 threads holds a tile of T = 2^13 pairs in 64 KB of
//   shared memory, (key, value) as one 8-byte word; two CTAs share an
//   SM, so one's barriers and copies overlap the other's work.  Each
//   thread holds 32 pairs in registers.  A run of steps at the index
//   bits [lo, lo+4] loads the tile in the layout
//   x = (t_hi << (lo+5)) | (r << lo) | t_lo (thread t, register r), so
//   each step is a compare-exchange of two registers with compile-time
//   indices: one ISETP and four SELs, no branch.  Each of the nine
//   layouts is its own instance, so a register's address is the
//   thread's base XOR a constant.  Stages 1..5 run in one run; every
//   later stage takes ceil(min(stage, 13) / 5) runs, each one
//   shared-memory round trip.
// - Shared memory is swizzled, x ^ ((x >> 5) & 15), so that every
//   layout above, the cluster exchange and the copies from and to HBM
//   are free of bank conflicts (8-byte accesses, served per half warp).
// - Steps at distances >= T run across a thread-block cluster of up to
//   16 CTAs (B = 2^14..2^17 in one cluster; 16 is a non-portable size)
//   through distributed shared memory: CTA q takes local positions
//   [q T/C, (q+1) T/C) of all C tiles, runs the stage's cluster steps
//   on each position's C pairs in registers, and writes each pair back
//   to its owner, between two cluster barriers (all tiles current
//   before the reads; all writes landed before anyone reads again).
// - So a block of up to 2^17 pairs sorts in ONE launch, with one HBM
//   read and one HBM write per pair.  Larger blocks add one global
//   compare-exchange pass per distance above 2^17 and one cluster
//   launch per stage above 17 for the distances below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLogRegs = 5;  // 32 pairs per thread
constexpr int kRegs = 1 << kLogRegs;
constexpr int kLogTile = 13;  // 8192 pairs per CTA
constexpr int kTileThreads = 1 << (kLogTile - kLogRegs);  // 256
constexpr int kMaxLogCluster = 4;  // 16 CTAs: 2^17 pairs
constexpr int kPassThreads = 256;

// Shared memory holds (key, value) as one 8-byte word; a warp's 8-byte
// access is served per half warp, 16 words over the 32 banks.
__device__ __forceinline__ int swz(int x) {
  return x ^ ((x >> kLogRegs) & (kRegs / 2 - 1));
}

// The pair (a, b), a the lower index, ends ascending iff `up`.
__device__ __forceinline__ void cmpex(int& ka, int& va, int& kb, int& vb,
                                      bool up) {
  const bool sw = (ka > kb) == up;
  const int k0 = sw ? kb : ka;
  const int k1 = sw ? ka : kb;
  const int v0 = sw ? vb : va;
  const int v1 = sw ? va : vb;
  ka = k0;
  kb = k1;
  va = v0;
  vb = v1;
}

// Register steps at register bits jb_hi .. 0, one direction per thread.
__device__ __forceinline__ void reg_steps(int (&k)[kRegs], int (&v)[kRegs],
                                          int jb_hi, bool up) {
#pragma unroll
  for (int jb = kLogRegs - 1; jb >= 0; --jb) {
    if (jb <= jb_hi) {
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        if (!(r & (1 << jb))) {
          cmpex(k[r], v[r], k[r | (1 << jb)], v[r | (1 << jb)], up);
        }
      }
    }
  }
}

// Tile index of thread t's register 0 when the register bits are the
// index bits [lo, lo + kLogRegs).
__device__ __forceinline__ int run_base(int t, int lo) {
  return ((t >> lo) << (lo + kLogRegs)) | (t & ((1 << lo) - 1));
}

// One run: load the tile in the layout of index bits [LO, LO + 4], run
// the steps at register bits jb_hi .. 0, store it back.  The swizzle is
// linear over XOR and base and r << LO share no bit, so register r sits
// at swz(base) ^ swz(r << LO): the thread's base XOR a constant.
template <int LO>
__device__ __forceinline__ void run(int2* sp, int (&k)[kRegs],
                                    int (&v)[kRegs], int jb_hi, bool up) {
  const int sb = swz(run_base(threadIdx.x, LO));
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int2 e = sp[sb ^ swz(r << LO)];
    k[r] = e.x;
    v[r] = e.y;
  }
  if (LO > 0 || jb_hi == kLogRegs - 1) {
    reg_steps(k, v, kLogRegs - 1, up);
  } else {
    reg_steps(k, v, jb_hi, up);
  }
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    sp[sb ^ swz(r << LO)] = make_int2(k[r], v[r]);
  }
}

// DSMEM through 32-bit shared::cluster addresses (mapa).
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void ld_cluster(unsigned addr, int& k, int& v) {
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];"
               : "=r"(k), "=r"(v)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void st_cluster(unsigned addr, int k, int v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};" ::"r"(addr),
               "r"(k), "r"(v)
               : "memory");
}

// The steps of `stage` at distances 2^top .. 2^log_tile, across the
// cluster's C tiles.  Thread t of the CTA of rank q takes, for p < 32/C,
// local position x = q T/C + p * threads + t of every tile.
template <int LOG_C>
__device__ __forceinline__ void cluster_steps(int2* sp, int top,
                                              int stage, int log_tile,
                                              int log_block) {
  constexpr int C = 1 << LOG_C;
  constexpr int P = kRegs / C;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int nthr = blockDim.x;
  const int per = (1 << log_tile) >> LOG_C;
  const long long first_cta = (long long)blockIdx.x - q;
  bool up[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    up[c] = stage == log_block ||
            !((((first_cta + c) << log_tile) >> stage) & 1);
  }
  const unsigned sp_addr = (unsigned)__cvta_generic_to_shared(sp);
  cluster.sync();  // every tile holds the previous step's result
  // positions are independent: two at a time keep this phase's
  // registers few
#pragma unroll 2
  for (int p = 0; p < P; ++p) {
    const unsigned x = 8u * swz(q * per + p * nthr + t);
    int k[C];
    int v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ld_cluster(mapa(sp_addr, c) + x, k[c], v[c]);
    }
#pragma unroll
    for (int jc = LOG_C - 1; jc >= 0; --jc) {
      if (jc <= top - log_tile) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!(c & (1 << jc))) {
            cmpex(k[c], v[c], k[c + (1 << jc)], v[c + (1 << jc)], up[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      st_cluster(mapa(sp_addr, c) + x, k[c], v[c]);
    }
  }
  cluster.sync();  // every write landed before the tiles are read again
}

// Stages [stage_first, stage_last] of blocks of 2^log_block pairs on
// tiles of 2^log_tile pairs, in clusters of 2^LOG_C tiles; each stage
// from distance min(2^(stage-1), 2^(log_tile+LOG_C-1)) down to 1.
// stage_first is 1 (the whole network up to the cluster's span) or
// above kLogRegs.  src may equal dst: a cluster reads all of its tiles
// before it writes any.
template <int LOG_C>
__global__ void __launch_bounds__(kTileThreads, 2)
    block_sort_kernel(const int* src_k, const int* src_v, int* dst_k,
                      int* dst_v, int log_tile, int stage_first,
                      int stage_last, int log_block) {
  // tiles are full in a cluster, so there the tile is a constant
  if constexpr (LOG_C > 0) log_tile = kLogTile;
  extern __shared__ int2 sp[];
  const int t = threadIdx.x;
  const int nthr = blockDim.x;
  const long long tile_base = (long long)blockIdx.x << log_tile;
  int k[kRegs];
  int v[kRegs];
  // HBM -> shared: 4-byte coalesced loads, lanes on neighbouring pairs
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    k[i] = src_k[tile_base + i * nthr + t];
    v[i] = src_v[tile_base + i * nthr + t];
  }
#pragma unroll
  for (int i = 0; i < kRegs; ++i) sp[swz(i * nthr + t)] = make_int2(k[i], v[i]);
  __syncthreads();
  int stage = stage_first;
  if (stage_first == 1) {
    // stages 1..5 in the layout x = t * 32 + r: bit s < 5 of x is bit s
    // of r, bit 5 is bit 0 of t (log_block >= 7, so none is the last)
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int2 e = sp[swz((t << kLogRegs) | r)];
      k[r] = e.x;
      v[r] = e.y;
    }
#pragma unroll
    for (int s = 1; s <= kLogRegs; ++s) {
#pragma unroll
      for (int j = s - 1; j >= 0; --j) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          if (!(r & (1 << j))) {
            const bool up = s < kLogRegs ? !((r >> s) & 1) : !(t & 1);
            cmpex(k[r], v[r], k[r | (1 << j)], v[r | (1 << j)], up);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      sp[swz((t << kLogRegs) | r)] = make_int2(k[r], v[r]);
    }
    __syncthreads();
    stage = kLogRegs + 1;
  }
  const int span = log_tile + LOG_C;
  for (; stage <= stage_last; ++stage) {
    const int top = min(stage - 1, span - 1);
    if constexpr (LOG_C > 0) {
      if (top >= log_tile) {
        cluster_steps<LOG_C>(sp, top, stage, log_tile, log_block);
      }
    }
    // runs of the index bits [lo, hi]: stage > lo + 4, so the direction
    // (bit `stage` of the index) is one per thread
    for (int hi = min(top, log_tile - 1); hi >= 0; hi -= kLogRegs) {
      const int lo = max(0, hi - (kLogRegs - 1));
      const int base = run_base(t, lo);
      const bool up =
          stage == log_block || !(((tile_base | base) >> stage) & 1);
      switch (lo) {  // lo <= kLogTile - kLogRegs
#define SR_RUN(LO)                          \
  case LO:                                  \
    run<LO>(sp, k, v, hi - lo, up);         \
    break;
        SR_RUN(0) SR_RUN(1) SR_RUN(2) SR_RUN(3) SR_RUN(4)
        SR_RUN(5) SR_RUN(6) SR_RUN(7) SR_RUN(8)
#undef SR_RUN
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    const int2 e = sp[swz(i * nthr + t)];
    dst_k[tile_base + i * nthr + t] = e.x;
    dst_v[tile_base + i * nthr + t] = e.y;
  }
}

// One step (stage, j) with d = 2^j beyond the cluster's span, over all
// pairs, four neighbouring pairs per thread in 16-byte accesses.
__global__ void global_pass(int* k, int* v, long long n_quads, int stage,
                            int j, int log_block) {
  const long long d = 1LL << j;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_quads; i += step) {
    const long long p = i << 2;
    const long long lo = ((p >> j) << (j + 1)) | (p & (d - 1));
    const long long hi = lo + d;
    int4 ka = *reinterpret_cast<const int4*>(k + lo);
    int4 kb = *reinterpret_cast<const int4*>(k + hi);
    int4 va = *reinterpret_cast<const int4*>(v + lo);
    int4 vb = *reinterpret_cast<const int4*>(v + hi);
    const bool up = stage == log_block || !((lo >> stage) & 1);
    cmpex(ka.x, va.x, kb.x, vb.x, up);
    cmpex(ka.y, va.y, kb.y, vb.y, up);
    cmpex(ka.z, va.z, kb.z, vb.z, up);
    cmpex(ka.w, va.w, kb.w, vb.w, up);
    *reinterpret_cast<int4*>(k + lo) = ka;
    *reinterpret_cast<int4*>(k + hi) = kb;
    *reinterpret_cast<int4*>(v + lo) = va;
    *reinterpret_cast<int4*>(v + hi) = vb;
  }
}

template <int LOG_C>
cudaLaunchConfig_t sort_config(long long n, int log_tile, cudaStream_t st,
                               cudaLaunchAttribute* attr, cudaError_t* err) {
  const size_t smem = sizeof(int2) << log_tile;
  *err = cudaFuncSetAttribute(block_sort_kernel<LOG_C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  if (*err == cudaSuccess && LOG_C > 3) {  // 16 CTAs: above the portable 8
    *err = cudaFuncSetAttribute(
        block_sort_kernel<LOG_C>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n >> log_tile));
  cfg.blockDim = dim3(1u << (log_tile - kLogRegs));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << LOG_C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int LOG_C>
cudaError_t launch_sort(const int* sk, const int* sv, int* dk, int* dv,
                        long long n, int log_tile, int stage_first,
                        int stage_last, int log_block, cudaStream_t st) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  cudaLaunchConfig_t cfg = sort_config<LOG_C>(n, log_tile, st, &attr, &err);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, block_sort_kernel<LOG_C>, sk, sv, dk, dv,
                            log_tile, stage_first, stage_last, log_block);
}

cudaError_t launch_sort_c(int log_c, const int* sk, const int* sv, int* dk,
                          int* dv, long long n, int log_tile, int stage_first,
                          int stage_last, int log_block, cudaStream_t st) {
  switch (log_c) {
    case 0:
      return launch_sort<0>(sk, sv, dk, dv, n, log_tile, stage_first,
                            stage_last, log_block, st);
    case 1:
      return launch_sort<1>(sk, sv, dk, dv, n, log_tile, stage_first,
                            stage_last, log_block, st);
    case 2:
      return launch_sort<2>(sk, sv, dk, dv, n, log_tile, stage_first,
                            stage_last, log_block, st);
    case 3:
      return launch_sort<3>(sk, sv, dk, dv, n, log_tile, stage_first,
                            stage_last, log_block, st);
    default:
      return launch_sort<kMaxLogCluster>(sk, sv, dk, dv, n, log_tile,
                                         stage_first, stage_last, log_block,
                                         st);
  }
}

// Tile and cluster for blocks of 2^log_block pairs.
void plan(int log_block, int* log_tile, int* log_c) {
  *log_tile = log_block < kLogTile ? log_block : kLogTile;
  const int rest = log_block - *log_tile;
  *log_c = rest < kMaxLogCluster ? rest : kMaxLogCluster;
}

template <int LOG_C>
cudaError_t max_clusters(int log_tile, int* out) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  cudaLaunchConfig_t cfg = sort_config<LOG_C>(
      (long long)1 << (log_tile + LOG_C), log_tile, nullptr, &attr, &err);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, block_sort_kernel<LOG_C>, &cfg);
}

}  // namespace

// Sort each block of 2^log_block pairs of (k_in, v_in) ascending into
// (k_out, v_out).  n must be a multiple of the block; 7 <= log_block;
// k_out and v_out 16-byte aligned (blocks above 2^17 pairs pass over
// them in 16-byte accesses).  Returns cudaGetLastError() (0 on
// success); the sort is queued on `stream` and not synchronised.
extern "C" int sr_bitonic_block_sort(const void* k_in, const void* v_in,
                                     void* k_out, void* v_out,
                                     long long n, int log_block,
                                     void* stream) {
  if (n <= 0) return 0;
  if (log_block <= kLogRegs + 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(k_in);
  const int* vi = static_cast<const int*>(v_in);
  int* ko = static_cast<int*>(k_out);
  int* vo = static_cast<int*>(v_out);
  int log_tile, log_c;
  plan(log_block, &log_tile, &log_c);
  const int span = log_tile + log_c;
  const int first_last = log_block < span ? log_block : span;
  cudaError_t err = launch_sort_c(log_c, ki, vi, ko, vo, n, log_tile, 1,
                                  first_last, log_block, st);
  if (err != cudaSuccess) return err;
  const long long n_quads = n / 8;
  const long long want = (n_quads + kPassThreads - 1) / kPassThreads;
  const unsigned pass_blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  for (int stage = span + 1; stage <= log_block; ++stage) {
    for (int j = stage - 1; j >= span; --j) {
      global_pass<<<pass_blocks, kPassThreads, 0, st>>>(ko, vo, n_quads,
                                                        stage, j, log_block);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    err = launch_sort_c(log_c, ko, vo, ko, vo, n, log_tile, stage, stage,
                        log_block, st);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The launch shape for blocks of 2^log_block pairs: out[0] CTAs per
// cluster, out[1] cudaOccupancyMaxActiveClusters for it, out[2] threads
// per CTA, out[3] pairs per CTA.  Returns a cudaError_t.
extern "C" int sr_bitonic_block_sort_shape(int log_block, int* out) {
  if (log_block <= kLogRegs + 1) return cudaErrorInvalidValue;
  int log_tile, log_c;
  plan(log_block, &log_tile, &log_c);
  int clusters = 0;
  cudaError_t err;
  switch (log_c) {
    case 0:
      err = max_clusters<0>(log_tile, &clusters);
      break;
    case 1:
      err = max_clusters<1>(log_tile, &clusters);
      break;
    case 2:
      err = max_clusters<2>(log_tile, &clusters);
      break;
    case 3:
      err = max_clusters<3>(log_tile, &clusters);
      break;
    default:
      err = max_clusters<kMaxLogCluster>(log_tile, &clusters);
  }
  out[0] = 1 << log_c;
  out[1] = clusters;
  out[2] = 1 << (log_tile - kLogRegs);
  out[3] = 1 << log_tile;
  return err;
}
