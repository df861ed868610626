// Blockwise flash-attention partials for Hopper.
//
// Replaces sparkrdma_tpu/ops/attention.py:60 _kernel, the Pallas
// kernel reached through _pallas_block_attention / block_attention.
// For q [s_q, d] against one K/V block [s_k, d] (a batch of N of each)
// it writes float32
//   m[i] = max_j s[i, j],  l[i] = sum_j exp(s[i, j] - m[i]),
//   o[i] = sum_j exp(s[i, j] - m[i]) v[j]            (not normalised)
// in the Pallas kernel's order of arithmetic: s = (q . k^T in f32) *
// scale, then the causal mask (q_offset + row >= k_offset + col, int32,
// masked scores set to the FINITE NEG_INF = -1e30), then per K/V tile
//   m_new = max(m, rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new)
//   l = l * alpha + sum(p)
//   acc = acc * alpha + (p cast to v's dtype) . v    (f32 accumulate)
// A row masked throughout keeps m == NEG_INF and gets
// p = exp(NEG_INF - NEG_INF) = 1, so l = s_k and o = sum v, as in the
// JAX package; the ring's fold relies on it.  Key columns past s_k are
// not masked entries: they contribute nothing (p = 0, V rows zeroed).
// Query rows past s_q are computed on zeros and not written.
//
// Design.  One CUDA block per (batch n, tile of 64 query rows); the
// block loops over every 64-key K/V tile itself, which takes the place
// of the Pallas grid's sequential j axis and its VMEM scratch, so
// nothing crosses blocks.  Every tile is computed, causal or not, as
// the TPU kernel does.
//  - bfloat16: 4 warps, each owning 16 query rows.  The q tile, one K
//    tile and one V tile sit in shared memory (rows padded by 16 B so
//    ldmatrix is free of bank conflicts; 52 KB at d = 128).  Scores and
//    p . v run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//    f32 accumulate); q's fragments stay in registers for the whole
//    loop, the scores never leave registers, and p becomes the A
//    fragment of the p . v product in place.  m, l and the o
//    accumulator are f32 registers.  K and V tiles arrive by cp.async:
//    the next K tile loads while p . v runs, the next V tile while the
//    next scores run.
//  - float32: exact f32 FMAs on the CUDA cores (no TF32), 256 threads,
//    each holding a 4 x 4 block of scores and a 4 x d/16 block of o.
//
// Bound.  At the bench shape (N = 8, S = 8192, d = 128, bf16, causal)
// the work is 4 d N S^2 / 2 = 137 GFLOP of unmasked products against
// 84 MB of inputs and outputs: bound by operations (tensor-core rate),
// 0.139 ms at 989 TFLOP/s; computing every tile doubles the products.
// The design keeps every operand of the two products on chip (shared
// memory and registers) so the tensor cores, not memory, set the pace.
// mma.sync reaches only part of Hopper's rate (wgmma, TMA, warp
// specialisation and skipping masked tiles are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kBf16Threads = 128;
constexpr int kF32Threads = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* m;
  float* l;
  float* o;
  int n_q_tiles;
  int s_q;
  int s_k;
  int q_offset;
  int k_offset;
  int causal;
  float scale;
};

// exp(x - m) with exp(0) exactly 1: a fully masked row must give
// l == s_k exactly, whatever the approximate exponential returns at 0.
__device__ __forceinline__ float exp_diff(float x, float m) {
  const float d = x - m;
  return d == 0.f ? 1.f : __expf(d);
}

// Scaled, masked score of local (row, col); -INFINITY marks a key past
// s_k, which the row max ignores and p turns into 0.
__device__ __forceinline__ float mask_score(float s, int row, int col,
                                            const Args& a) {
  if (col >= a.s_k) return -INFINITY;
  s *= a.scale;
  if (a.causal && a.q_offset + row < a.k_offset + col) return kNegInf;
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b for one 16 x 8 f32 tile; a 16 x 16 bf16, b 16 x 8 bf16.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [row0, row0 + 64) of a [n_rows, D] bf16 matrix into a padded
// shared tile, 16 B per cp.async; rows past n_rows become zeros.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile,
                                               const __nv_bfloat16* g,
                                               int row0, int n_rows) {
  constexpr int kStride = D + 8;
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlockQ * kChunks; c += kBf16Threads) {
    const int r = c / kChunks;
    const int c8 = (c % kChunks) * 8;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src =
        g + (size_t)(valid ? row0 + r : 0) * D + c8;
    cp_async16(tile + r * kStride + c8, src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads)
    attention_bf16(Args a) {
  constexpr int kStride = D + 8;
  constexpr int kKSteps = D / 16;      // k-steps of the score product
  constexpr int kNTiles = kBlockK / 8;  // 8-key score tiles per warp
  constexpr int kDTiles = D / 8;        // 8-column o tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockQ * kStride;
  __nv_bfloat16* sV = sK + kBlockK * kStride;

  const int n = blockIdx.x / a.n_q_tiles;
  const int q0 = (blockIdx.x % a.n_q_tiles) * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within an 8-row group
  const int tig = lane & 3;  // column pair within a fragment
  const int lrow = lane & 7;
  const int lmat = lane >> 3;  // which 8 x 8 matrix lane addresses
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + (size_t)n * a.s_q * D;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + (size_t)n * a.s_k * D;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + (size_t)n * a.s_k * D;

  load_tile_bf16<D>(sQ, q, q0, a.s_q);
  load_tile_bf16<D>(sK, k, 0, a.s_k);
  cp_async_commit();
  load_tile_bf16<D>(sV, v, 0, a.s_k);
  cp_async_commit();

  const int row = q0 + warp * 16 + g;  // rows row and row + 8
  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only

  const int n_k_tiles = (a.s_k + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_k_tiles; ++t) {
    const int kbase = t * kBlockK;
    const bool more = t + 1 < n_k_tiles;
    cp_async_wait<1>();  // q and this K tile
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lmat & 1) * 8 + lrow) *
                                     kStride +
                                 ks * 16 + (lmat >> 1) * 8);
    }
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (np * 16 + (lmat >> 1) * 8 + lrow) * kStride +
                           ks * 16 + (lmat & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with sK
    if (more) load_tile_bf16<D>(sK, k, kbase + kBlockK, a.s_k);
    cp_async_commit();

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + j * 8 + 2 * tig + (e & 1);
        s[j][e] = mask_score(s[j][e], row + (e >> 1) * 8, col, a);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = exp_diff(m_run[h], m_new);
      m_run[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.f : exp_diff(x, m_run[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + rs[h];
#pragma unroll
    for (int t2 = 0; t2 < kDTiles; ++t2) {
      acc[t2][0] *= alpha[0];
      acc[t2][1] *= alpha[0];
      acc[t2][2] *= alpha[1];
      acc[t2][3] *= alpha[1];
    }
    // p, rounded to bf16, as the A fragments of p . v (16 keys each)
    uint32_t pf[kNTiles / 2][4];
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    cp_async_wait<1>();  // this V tile (the next K tile may still fly)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kNTiles / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (kk * 16 + (lmat & 1) * 8 + lrow) *
                                      kStride +
                                  dp * 16 + (lmat >> 1) * 8);
        mma_bf16(acc[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with sV
    if (more) load_tile_bf16<D>(sV, v, kbase + kBlockK, a.s_k);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    const int r = row + h * 8;
    if (r >= a.s_q) continue;
    const size_t out_row = (size_t)n * a.s_q + r;
    if (tig == 0) {
      a.m[out_row] = m_run[h];
      a.l[out_row] = l_run[h];
    }
#pragma unroll
    for (int t2 = 0; t2 < kDTiles; ++t2) {
      float2 val = make_float2(acc[t2][2 * h], acc[t2][2 * h + 1]);
      *reinterpret_cast<float2*>(a.o + out_row * D + t2 * 8 + 2 * tig) =
          val;
    }
  }
}

// float32: exact FMAs on the CUDA cores.  Thread (tr, tc) holds scores
// of rows tr + 16 i and keys tc + 16 j (i, j < 4), and o of rows
// tr + 16 i and columns tc + 16 c (c < D / 16).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    attention_f32(Args a) {
  constexpr int kQS = D + 1;        // padded row of q and k tiles
  constexpr int kPS = kBlockK + 1;  // padded row of the p tile
  constexpr int kDC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBlockQ * kQS;
  float* sV = sK + kBlockK * kQS;
  float* sP = sV + kBlockK * D;
  float* sAlpha = sP + kBlockQ * kPS;

  const int n = blockIdx.x / a.n_q_tiles;
  const int q0 = (blockIdx.x % a.n_q_tiles) * kBlockQ;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int srow = threadIdx.x >> 2;  // row of the softmax step
  const int part = threadIdx.x & 3;   // its quarter of the columns
  const float* q = static_cast<const float*>(a.q) + (size_t)n * a.s_q * D;
  const float* k = static_cast<const float*>(a.k) + (size_t)n * a.s_k * D;
  const float* v = static_cast<const float*>(a.v) + (size_t)n * a.s_k * D;

  for (int c = threadIdx.x; c < kBlockQ * D; c += kF32Threads) {
    const int r = c / D, col = c % D;
    sQ[r * kQS + col] = q0 + r < a.s_q ? q[(size_t)(q0 + r) * D + col] : 0.f;
  }
  float acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;  // this thread's quarter of the columns only

  const int n_k_tiles = (a.s_k + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_k_tiles; ++t) {
    const int kbase = t * kBlockK;
    __syncthreads();  // the previous tile's p . v is done
    for (int c = threadIdx.x; c < kBlockK * D; c += kF32Threads) {
      const int r = c / D, col = c % D;
      const bool valid = kbase + r < a.s_k;
      const size_t off = (size_t)(kbase + r) * D + col;
      sK[r * kQS + col] = valid ? k[off] : 0.f;
      sV[r * D + col] = valid ? v[off] : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr + 16 * i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * kQS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(tr + 16 * i) * kPS + tc + 16 * j] = mask_score(
            s[i][j], q0 + tr + 16 * i, kbase + tc + 16 * j, a);
    __syncthreads();

    float mx = -INFINITY;
    for (int j = part; j < kBlockK; j += 4) mx = fmaxf(mx, sP[srow * kPS + j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = m_run - m_new == 0.f ? 1.f : expf(m_run - m_new);
    m_run = m_new;
    float rs = 0.f;
    for (int j = part; j < kBlockK; j += 4) {
      const float x = sP[srow * kPS + j];
      const float p = x == -INFINITY ? 0.f
                      : x == m_new   ? 1.f
                                     : expf(x - m_new);
      sP[srow * kPS + j] = p;  // v is float32: the cast is the identity
      rs += p;
    }
    l_run = l_run * alpha + rs;
    if (part == 0) sAlpha[srow] = alpha;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sAlpha[tr + 16 * i];
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= al;
    }
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kDC];
#pragma unroll
      for (int c = 0; c < kDC; ++c) vv[c] = sV[j * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tr + 16 * i) * kPS + j];
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (part == 0 && q0 + srow < a.s_q) {
    a.m[(size_t)n * a.s_q + q0 + srow] = m_run;
    a.l[(size_t)n * a.s_q + q0 + srow] = l_run;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r >= a.s_q) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      a.o[((size_t)n * a.s_q + r) * D + tc + 16 * c] = acc[i][c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, unsigned blocks,
                   const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
size_t smem_bf16() {
  return (size_t)(kBlockQ + 2 * kBlockK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
size_t smem_f32() {
  return sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (D + 1) +
                          (size_t)kBlockK * D +
                          (size_t)kBlockQ * (kBlockK + 1) + kBlockQ);
}

}  // namespace

// Partials of q [n, s_q, d] against k, v [n, s_k, d] (contiguous, rows
// 16-byte aligned) into m, l [n, s_q] and o [n, s_q, d] (float32).
// dtype 0 = float32, 1 = bfloat16; d is 64 or 128.  Returns
// cudaGetLastError() (0 on success); queued on `stream`, not
// synchronised.
extern "C" int sr_block_attention(const void* q, const void* k,
                                  const void* v, void* m, void* l, void* o,
                                  int n, int s_q, int s_k, int d,
                                  int q_offset, int k_offset, int causal,
                                  float scale, int dtype, void* stream) {
  if (n <= 0 || s_q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.o = static_cast<float*>(o);
  a.n_q_tiles = (s_q + kBlockQ - 1) / kBlockQ;
  a.s_q = s_q;
  a.s_k = s_k;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.scale = scale;
  const long long blocks_ll = (long long)a.n_q_tiles * n;
  if (blocks_ll > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)blocks_ll;
  if (dtype == 1 && d == 64)
    return launch(attention_bf16<64>, kBf16Threads, smem_bf16<64>(), blocks,
                  a, st);
  if (dtype == 1 && d == 128)
    return launch(attention_bf16<128>, kBf16Threads, smem_bf16<128>(),
                  blocks, a, st);
  if (dtype == 0 && d == 64)
    return launch(attention_f32<64>, kF32Threads, smem_f32<64>(), blocks, a,
                  st);
  if (dtype == 0 && d == 128)
    return launch(attention_f32<128>, kF32Threads, smem_f32<128>(), blocks,
                  a, st);
  return cudaErrorInvalidValue;
}
