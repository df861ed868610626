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
// the index within the block.
//
// Design.  A block of B = 65536..131072 pairs (512 KB..1 MB) does not
// fit in one SM's 227 KB of shared memory, so the network is split by
// distance: every distance d >= T (T = 8192 pairs, 64 KB of keys and
// values in dynamic shared memory) runs as a global-memory pass of
// compare-exchanges, and all remaining distances d < T of a stage run
// in ONE shared-memory launch over tiles of T pairs.  Stages 1..log2(T)
// run together in the first shared-memory launch.
//
// Bound.  Memory traffic: ideally one read and one write of keys and
// values, 16 B per pair.  The split adds, per pair, 16 B for every
// global pass and every shared-memory launch after the first:
// for B = 2^16 and T = 2^13 that is 6 global passes and 3 more tile
// launches, so 10 x 16 B per pair in all.  The compare-exchanges,
// log2(B) (log2(B) + 1) / 2 per pair, are far below the ALU rate.

#include <cuda_runtime.h>

namespace {

constexpr int kLogTile = 13;        // T = 8192 pairs per shared tile
constexpr int kTileThreads = 512;
constexpr int kPassThreads = 256;

// Whether pair (lo, hi) ends ascending at this stage.  `g` is the
// global index of `lo`; below the last stage its bit `stage` equals
// that of the block-local flat index because B is a power of two.
__device__ __forceinline__ bool ascending(long long g, int stage,
                                          int log_block) {
  return stage == log_block || ((g >> stage) & 1) == 0;
}

__device__ __forceinline__ bool need_swap(int k_lo, int k_hi, bool up) {
  return up ? (k_lo > k_hi) : (k_lo <= k_hi);
}

// One step (stage, j) with d = 2^j >= T, over all n/2 pairs.
__global__ void global_pass(int* __restrict__ k, int* __restrict__ v,
                            long long n_pairs, int stage, int j,
                            int log_block) {
  const long long d = 1LL << j;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pairs; p += step) {
    const long long lo = ((p >> j) << (j + 1)) | (p & (d - 1));
    const long long hi = lo | d;
    const int k_lo = k[lo];
    const int k_hi = k[hi];
    if (need_swap(k_lo, k_hi, ascending(lo, stage, log_block))) {
      const int v_lo = v[lo];
      k[lo] = k_hi;
      k[hi] = k_lo;
      v[lo] = v[hi];
      v[hi] = v_lo;
    }
  }
}

// Stages [stage_first, stage_last], each from distance
// min(2^(stage-1), T/2) down to 1, on one tile of T pairs in shared
// memory.  src may equal dst: a block reads its whole tile before it
// writes it.
__global__ void tile_passes(const int* src_k, const int* src_v, int* dst_k,
                            int* dst_v, int stage_first, int stage_last,
                            int log_tile, int log_block) {
  extern __shared__ int smem[];
  const int tile = 1 << log_tile;
  int* sk = smem;
  int* sv = smem + tile;
  const long long base = (long long)blockIdx.x << log_tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = src_k[base + t];
    sv[t] = src_v[base + t];
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int stage = stage_first; stage <= stage_last; ++stage) {
    const int j0 = min(stage - 1, log_tile - 1);
    for (int j = j0; j >= 0; --j) {
      const int d = 1 << j;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int lo = ((p >> j) << (j + 1)) | (p & (d - 1));
        const int hi = lo | d;
        const int k_lo = sk[lo];
        const int k_hi = sk[hi];
        if (need_swap(k_lo, k_hi, ascending(base + lo, stage, log_block))) {
          const int v_lo = sv[lo];
          sk[lo] = k_hi;
          sk[hi] = k_lo;
          sv[lo] = sv[hi];
          sv[hi] = v_lo;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    dst_k[base + t] = sk[t];
    dst_v[base + t] = sv[t];
  }
}

}  // namespace

// Sort each block of 2^log_block pairs of (k_in, v_in) ascending into
// (k_out, v_out).  n must be a multiple of the block; 1 <= log_block.
// Returns cudaGetLastError() (0 on success); the sort is queued on
// `stream` and not synchronised.
extern "C" int sr_bitonic_block_sort(const void* k_in, const void* v_in,
                                     void* k_out, void* v_out,
                                     long long n, int log_block,
                                     void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(k_in);
  const int* vi = static_cast<const int*>(v_in);
  int* ko = static_cast<int*>(k_out);
  int* vo = static_cast<int*>(v_out);
  const int log_tile = log_block < kLogTile ? log_block : kLogTile;
  const size_t smem = (size_t)2 * sizeof(int) << log_tile;
  cudaError_t err = cudaFuncSetAttribute(
      tile_passes, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned n_tiles = (unsigned)(n >> log_tile);
  const int half = 1 << (log_tile - 1);
  const int tile_threads = half < kTileThreads ? half : kTileThreads;
  tile_passes<<<n_tiles, tile_threads, smem, st>>>(
      ki, vi, ko, vo, 1, log_tile, log_tile, log_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n_pairs = n / 2;
  const unsigned pass_blocks =
      (unsigned)((n_pairs + kPassThreads - 1) / kPassThreads);
  for (int stage = log_tile + 1; stage <= log_block; ++stage) {
    for (int j = stage - 1; j >= log_tile; --j) {
      global_pass<<<pass_blocks, kPassThreads, 0, st>>>(
          ko, vo, n_pairs, stage, j, log_block);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    tile_passes<<<n_tiles, tile_threads, smem, st>>>(
        ko, vo, ko, vo, stage, stage, log_tile, log_block);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
