// Stable merge of D sorted runs with their source slots (merge_runs).
//
// Replaces no Pallas kernel: the JAX package merges the received
// [D, cap] block of its TeraSort exchange with lax.sort keyed (key,
// invalid), and the port did the same with two stable radix sorts
// (ops/lexsort.py).  Row s of that block is already ascending over
// its first rvalid[s] slots, and every later slot holds the key
// dtype's max, so a merge of the rows gives the sort's result bit for
// bit with none of its passes:
//   out[0, n_valid): the stable merge of the valid prefixes, equal keys
//     from the lower row first, then from the lower slot;
//   out[n_valid, D cap): the padding slots in (row, slot) order, their
//     keys copied from the block;
// each output carrying src = row * cap + slot, its flat source slot.
//
// Bound.  Bytes: a merge does a few compares per output, so the reads
// and writes set the pace.  Each round reads every real key (and from
// the second round on its src) once and writes every real key and src
// once; the last round also writes the padding tail.  At D = 4, 8 B
// keys, 2^26 real of 87.2M slots: about 3.2 GB over two rounds, 0.96 ms
// at 3.35 TB/s.
//
// Design: ceil(log2 D) rounds (one at D = 1) of a stable two-way merge
// path (Green, McColl and Bader, "GPU Merge Path", 2012).
//  - Round r merges runs of 2^r rows in pairs; the left run holds the
//    lower rows and ties go left, so the merge is stable across rows.
//    A run without a partner (D not a power of two) is copied through.
//    A run lives at its first row's offset (row * cap), so offsets are
//    known on the host and only lengths come from the device: every
//    block reads rvalid (clamped to [0, cap]) and takes its prefix
//    sums in shared memory.  Nothing is read back to the host.
//  - The grid is sized for every slot of a pair's rows; a tile past
//    the pair's merged length exits (in the last round it writes the
//    padding tail instead).
//  - A block owns a tile of 2048 output positions.  Warps 0 and 1 find
//    the co-ranks of the tile's two ends by a 32-way search over the
//    runs in device memory (each step probes 32 points with one
//    ballot, so about 5 dependent loads, not 25).  The block stages
//    both spans in shared memory with coalesced loads, each thread
//    finds its own co-rank in shared memory and merges 8 outputs in
//    registers, and the tile goes back out through shared memory with
//    coalesced stores.
//  - Round 0 reads the block itself, and a slot's src is its flat
//    index, so only the keys are read.  The rounds ping-pong between
//    the output and one scratch pair (key, src) that the wrapper
//    allocates, ordered so that the last round writes the output.
//  - The padding tail's slot p >= n_valid is the (p - n_valid)-th
//    padding slot in (row, slot) order: its row by a binary search of
//    the padding's prefix sums s cap - valid_prefix[s].
//  256 threads; shared memory 12 B (8 B keys) or 8 B (4 B keys) per
//  tile position plus 8 B per row.  ptxas (sm_90a): 32 registers with
//  4 B keys, 40 with 8 B keys, no spills.  At D = 4 and 2^26 real of
//  87.2M int64 slots it took 1.64 ms on an H100 (about 2 TB/s of its
//  own traffic); chip_smoke.py prints these numbers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxRuns = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The number of elements of run a among the first `diag` outputs of
// the stable merge of a and b (ties to a), found by one warp: each
// step probes 32 evenly spaced candidates and keeps the interval
// between the last that still precedes and the first that does not.
template <typename K>
__device__ long long corank_warp(const K* __restrict__ a, long long na,
                                 const K* __restrict__ b, long long nb,
                                 long long diag, int lane) {
  long long lo = diag - nb > 0 ? diag - nb : 0;
  long long hi = diag < na ? diag : na;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + lane * step;
    const bool pred = p < hi && a[p] <= b[diag - 1 - p];
    const int c = __popc(__ballot_sync(kFull, pred));
    if (c == 0) {
      hi = lo;
    } else {
      const long long first_false = lo + c * step;
      lo += (c - 1) * step + 1;
      if (first_false < hi) hi = first_false;
    }
  }
  return lo;
}

// The same co-rank by one thread, in shared memory.
template <typename K>
__device__ __forceinline__ int corank_seq(const K* a, int na, const K* b,
                                          int nb, int diag) {
  int lo = diag - nb > 0 ? diag - nb : 0;
  int hi = diag < na ? diag : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One round.  blockIdx.y is the pair (rows [2 y w, 2 y w + w) and the
// next w rows, w = width), blockIdx.x a tile of its rows' slots.
// src_in is null in round 0: a slot's src is then its flat index.
template <typename K>
__global__ void __launch_bounds__(kThreads)
merge_runs_round(const K* __restrict__ key_in,
                 const int* __restrict__ src_in, K* __restrict__ key_out,
                 int* __restrict__ src_out, const K* __restrict__ rk,
                 const int* __restrict__ rvalid, long long cap,
                 int n_runs, int width, int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_off = reinterpret_cast<long long*>(smem);
  K* s_key = reinterpret_cast<K*>(s_off + n_runs + 1);
  int* s_src = reinterpret_cast<int*>(s_key + kTile);
  __shared__ long long s_co[2];
  const int tid = threadIdx.x;

  for (int s = tid; s < n_runs; s += kThreads) {
    const long long v = rvalid[s];
    s_off[s + 1] = v < 0 ? 0 : (v > cap ? cap : v);
  }
  __syncthreads();
  if (tid == 0) {
    s_off[0] = 0;
    for (int s = 1; s <= n_runs; ++s) s_off[s] += s_off[s - 1];
  }
  __syncthreads();

  const int a_row = 2 * blockIdx.y * width;
  const int b_row = min(a_row + width, n_runs);
  const int end_row = min(a_row + 2 * width, n_runs);
  const long long na = s_off[b_row] - s_off[a_row];
  const long long nb = s_off[end_row] - s_off[b_row];
  const long long merged = na + nb;
  const long long a_base = (long long)a_row * cap;
  const long long b_base = (long long)b_row * cap;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long region = (long long)(end_row - a_row) * cap;
  if (t0 >= region || (!last && t0 >= merged)) return;
  const long long t1 = t0 + kTile < region ? t0 + kTile : region;

  const long long d0 = t0;
  const long long d1 = t1 < merged ? t1 : merged;
  if (d0 < d1) {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    if (warp < 2) {
      const long long c = corank_warp(key_in + a_base, na, key_in + b_base,
                                      nb, warp ? d1 : d0, lane);
      if (lane == 0) s_co[warp] = c;
    }
    __syncthreads();
    const long long a0 = s_co[0];
    const long long b0 = d0 - a0;
    const int n = (int)(d1 - d0);
    const int ta = (int)(s_co[1] - a0);
    const int tb = n - ta;
    for (int k = tid; k < n; k += kThreads) {
      const long long x = k < ta ? a_base + a0 + k : b_base + b0 + (k - ta);
      s_key[k] = key_in[x];
      s_src[k] = src_in ? src_in[x] : (int)x;
    }
    __syncthreads();
    K keys[kItems];
    int srcs[kItems];
    const int diag = tid * kItems;
    if (diag < n) {
      int i = corank_seq(s_key, ta, s_key + ta, tb, diag);
      int j = diag - i;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        if (diag + it < n) {
          const bool take_a =
              j >= tb || (i < ta && s_key[i] <= s_key[ta + j]);
          const int at = take_a ? i : ta + j;
          keys[it] = s_key[at];
          srcs[it] = s_src[at];
          i += take_a;
          j += !take_a;
        }
      }
    }
    __syncthreads();
    if (diag < n) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        if (diag + it < n) {
          s_key[diag + it] = keys[it];
          s_src[diag + it] = srcs[it];
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) {
      key_out[a_base + d0 + k] = s_key[k];
      src_out[a_base + d0 + k] = s_src[k];
    }
  }

  if (last) {
    // the last round has one pair over every row: merged == n_valid
    const long long start = t0 > merged ? t0 : merged;
    for (long long p = start + tid; p < t1; p += kThreads) {
      const long long j = p - merged;
      int lo = 0, hi = n_runs - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((long long)mid * cap - s_off[mid] <= j) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const long long slot = (s_off[lo + 1] - s_off[lo]) +
                             (j - ((long long)lo * cap - s_off[lo]));
      const long long x = (long long)lo * cap + slot;
      key_out[p] = rk[x];
      src_out[p] = (int)x;
    }
  }
}

// ceil(log2 n_runs) rounds, one at n_runs = 1.
int n_rounds(int n_runs) {
  int rounds = 1;
  while ((1 << rounds) < n_runs) ++rounds;
  return rounds;
}

template <typename K>
cudaError_t run(const K* rk, const int* rvalid, K* key_out, int* src_out,
                K* key_tmp, int* src_tmp, int n_runs, long long cap,
                cudaStream_t st) {
  const int rounds = n_rounds(n_runs);
  const size_t smem = (size_t)(n_runs + 1) * sizeof(long long) +
                      (size_t)kTile * (sizeof(K) + sizeof(int));
  const K* key_in = rk;
  const int* src_in = nullptr;
  for (int r = 0; r < rounds; ++r) {
    const int width = 1 << r;
    const bool last = r == rounds - 1;
    // the last round writes the output; before it the rounds alternate
    const bool to_out = ((rounds - 1 - r) & 1) == 0;
    K* ko = to_out ? key_out : key_tmp;
    int* so = to_out ? src_out : src_tmp;
    const int rows = 2 * width < n_runs ? 2 * width : n_runs;
    const long long tiles = ((long long)rows * cap + kTile - 1) / kTile;
    const int pairs = (n_runs + 2 * width - 1) / (2 * width);
    dim3 grid((unsigned)tiles, (unsigned)pairs);
    merge_runs_round<K><<<grid, kThreads, smem, st>>>(
        key_in, src_in, ko, so, rk, rvalid, cap, n_runs, width, last);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    key_in = ko;
    src_in = so;
  }
  return cudaSuccess;
}

}  // namespace

// The rounds sr_merge_runs launches for n_runs rows; scratch is needed
// when there are more than one.
extern "C" int sr_merge_runs_rounds(int n_runs) { return n_rounds(n_runs); }

// Merge the rows of rk [n_runs, cap] (key_bytes 4 or 8) into key_out
// and src_out [n_runs * cap].  key_tmp and src_tmp, of the same sizes,
// are scratch, used when sr_merge_runs_rounds(n_runs) > 1 (null
// otherwise).
extern "C" int sr_merge_runs(const void* rk, const void* rvalid,
                             void* key_out, void* src_out, void* key_tmp,
                             void* src_tmp, int n_runs, long long cap,
                             int key_bytes, void* stream) {
  if (n_runs < 1 || n_runs > kMaxRuns || cap < 1 ||
      (long long)n_runs * cap > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (n_rounds(n_runs) > 1 && (key_tmp == nullptr || src_tmp == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rv = static_cast<const int*>(rvalid);
  int* so = static_cast<int*>(src_out);
  int* st_src = static_cast<int*>(src_tmp);
  if (key_bytes == 8)
    return run<long long>(static_cast<const long long*>(rk), rv,
                          static_cast<long long*>(key_out), so,
                          static_cast<long long*>(key_tmp), st_src, n_runs,
                          cap, st);
  if (key_bytes == 4)
    return run<int>(static_cast<const int*>(rk), rv,
                    static_cast<int*>(key_out), so,
                    static_cast<int*>(key_tmp), st_src, n_runs, cap, st);
  return cudaErrorInvalidValue;
}
