// Flagged (segmented) inclusive scan over a bool flag and 1-3 columns.
//
// Replaces sparkrdma_tpu/ops/scan_kernels.py::_scan_kernel_body (the
// Pallas one-pass scan reached through _scan_padded / scan_flagged /
// cumsum_1d).  It scans the (flag, columns) recurrence
//   combine(prev, cur).flag = prev.flag | cur.flag
//   fill: cur.flag ? cur.x : prev.x
//   add : cur.flag ? cur.x : prev.x + cur.x    (wraps in the dtype)
//   min : cur.flag ? cur.x : min(prev.x, cur.x)
//   max : cur.flag ? cur.x : max(prev.x, cur.x)
// which is associative but not commutative: the operand order is kept
// everywhere.  Positions before the first flag hold the identity (0
// for fill/add, dtype max for min, dtype min for max) with the output
// flag clear, as in the Pallas kernel.
//
// Design.  The Pallas kernel is exact only because a TPU grid runs in
// order and a carry lives in SMEM from one block to the next.  CUDA
// blocks run in no order, so this is reduce-then-scan in three
// launches:
//   1. tile_reduce: each block folds its tile of kTile elements to one
//      aggregate (flag, columns);
//   2. carry_scan: one block scans the tile aggregates in order into
//      each tile's exclusive carry;
//   3. tile_apply: each block scans its tile again with its carry
//      folded in as "prev" and writes the outputs.
// Inside a block each thread folds kItems consecutive elements in
// order, the block scans the per-thread aggregates (Hillis-Steele in
// shared memory), and the exclusive prefix seeds each thread's run.
// Columns are int32, uint32, int64 or float32, mixed freely, carried
// as 64-bit words; the per-column dtype switch is uniform across a
// warp.  Any n works: a position past the end acts as the identity.
//
// Bound.  Memory traffic: the flag and every column are read and the
// output flag and columns written once, which is the floor
// (2 + 2 * sum(itemsize) bytes per element; 2 * itemsize for a plain
// prefix sum, which passes no flags).  Phase 1 reads the input
// once more, and phase 3 reads it twice (once for the thread
// aggregate, once to write), the second time from cache.  The
// arithmetic is a few integer ops per element and column.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { DT_I32 = 0, DT_U32 = 1, DT_I64 = 2, DT_F32 = 3 };
enum { K_FILL = 0, K_ADD = 1, K_MIN = 2, K_MAX = 3 };

constexpr int kMaxCols = 3;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

struct Cols {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int dt[kMaxCols];
  int n_cols;
};

struct Agg {
  int f;
  long long x[kMaxCols];
};

__device__ __forceinline__ long long load_word(const void* p, int dt,
                                               long long i) {
  switch (dt) {
    case DT_I32: return (long long)static_cast<const int*>(p)[i];
    case DT_U32: return (long long)static_cast<const unsigned*>(p)[i];
    case DT_I64: return static_cast<const long long*>(p)[i];
    default: return (long long)static_cast<const unsigned*>(p)[i];
  }
}

__device__ __forceinline__ void store_word(void* p, int dt, long long i,
                                           long long x) {
  switch (dt) {
    case DT_I32: static_cast<int*>(p)[i] = (int)x; break;
    case DT_U32: static_cast<unsigned*>(p)[i] = (unsigned)x; break;
    case DT_I64: static_cast<long long*>(p)[i] = x; break;
    default: static_cast<unsigned*>(p)[i] = (unsigned)x; break;
  }
}

__device__ __forceinline__ float as_f32(long long w) {
  return __int_as_float((int)(unsigned)w);
}

__device__ __forceinline__ long long from_f32(float f) {
  return (long long)(unsigned)__float_as_int(f);
}

template <int KIND>
__device__ __forceinline__ long long identity(int dt) {
  if (KIND == K_MIN) {
    switch (dt) {
      case DT_I32: return 2147483647LL;
      case DT_U32: return 4294967295LL;
      case DT_I64: return 9223372036854775807LL;
      default: return from_f32(INFINITY);
    }
  }
  if (KIND == K_MAX) {
    switch (dt) {
      case DT_I32: return -2147483647LL - 1;
      case DT_U32: return 0;
      case DT_I64: return -9223372036854775807LL - 1;
      default: return from_f32(-INFINITY);
    }
  }
  return 0;  // fill, add; +0.0f for float32
}

// prev (op) cur for the arithmetic kinds, in the column's dtype.
template <int KIND>
__device__ __forceinline__ long long apply_op(int dt, long long a,
                                              long long b) {
  if (KIND == K_ADD) {
    switch (dt) {
      case DT_I32: return (long long)(int)((unsigned)a + (unsigned)b);
      case DT_U32: return (long long)(unsigned)((unsigned)a + (unsigned)b);
      case DT_I64:
        return (long long)((unsigned long long)a + (unsigned long long)b);
      default: return from_f32(as_f32(a) + as_f32(b));
    }
  }
  const bool is_min = KIND == K_MIN;
  switch (dt) {
    case DT_I32:
    case DT_U32:
    case DT_I64:  // words hold the value itself: compare as int64
      return is_min ? (a < b ? a : b) : (a > b ? a : b);
    default: {
      const float fa = as_f32(a), fb = as_f32(b);
      if (isnan(fa)) return a;  // NaN propagates, as torch.minimum
      if (isnan(fb)) return b;
      return is_min ? (fb < fa ? b : a) : (fb > fa ? b : a);
    }
  }
}

template <int KIND>
__device__ __forceinline__ Agg combine(const Agg& p, const Agg& c,
                                       const Cols& cols) {
  Agg r;
  r.f = p.f | c.f;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    if (i < cols.n_cols) {
      if (c.f) {
        r.x[i] = c.x[i];
      } else if (KIND == K_FILL) {
        r.x[i] = p.x[i];
      } else {
        r.x[i] = apply_op<KIND>(cols.dt[i], p.x[i], c.x[i]);
      }
    } else {
      r.x[i] = 0;
    }
  }
  return r;
}

template <int KIND>
__device__ __forceinline__ Agg identity_agg(const Cols& cols) {
  Agg a;
  a.f = 0;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i)
    a.x[i] = i < cols.n_cols ? identity<KIND>(cols.dt[i]) : 0;
  return a;
}

// FLAGS false: no flag array (no segment heads), and no output flag.
template <int KIND, bool FLAGS>
__device__ __forceinline__ Agg load_elem(const unsigned char* flag,
                                         const Cols& cols, long long i,
                                         long long n) {
  if (i >= n) return identity_agg<KIND>(cols);
  Agg a;
  a.f = FLAGS ? flag[i] != 0 : 0;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
    a.x[c] = c < cols.n_cols ? load_word(cols.in[c], cols.dt[c], i) : 0;
  return a;
}

// Inclusive scan of one Agg per thread across the block, in thread
// order.  Ends with a barrier, so the shared arrays may be reused.
template <int KIND, int NT>
__device__ Agg block_scan(Agg a, const Cols& cols, int* sf,
                          long long (*sx)[NT]) {
  const int t = threadIdx.x;
  for (int off = 1; off < NT; off <<= 1) {
    sf[t] = a.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) sx[c][t] = a.x[c];
    __syncthreads();
    if (t >= off) {
      Agg p;
      p.f = sf[t - off];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) p.x[c] = sx[c][t - off];
      a = combine<KIND>(p, a, cols);
    }
    __syncthreads();
  }
  return a;
}

// The inclusive aggregate of thread t - 1 (identity for thread 0),
// given every thread's inclusive aggregate `inc`.  Also returns the
// block total.  Ends with a barrier.
template <int KIND, int NT>
__device__ Agg exclusive_from(const Agg& inc, const Cols& cols, int* sf,
                              long long (*sx)[NT], Agg* total) {
  const int t = threadIdx.x;
  sf[t] = inc.f;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) sx[c][t] = inc.x[c];
  __syncthreads();
  Agg ex = identity_agg<KIND>(cols);
  if (t > 0) {
    ex.f = sf[t - 1];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) ex.x[c] = sx[c][t - 1];
  }
  total->f = sf[NT - 1];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) total->x[c] = sx[c][NT - 1];
  __syncthreads();
  return ex;
}

// Tile aggregates live in `scratch` as [1 + kMaxCols][n_tiles] words:
// row 0 the flag, rows 1.. the columns.
__device__ __forceinline__ Agg load_agg(const long long* scratch,
                                        long long n_tiles, long long i) {
  Agg a;
  a.f = (int)scratch[i];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) a.x[c] = scratch[(c + 1) * n_tiles + i];
  return a;
}

__device__ __forceinline__ void store_agg(long long* scratch,
                                          long long n_tiles, long long i,
                                          const Agg& a) {
  scratch[i] = a.f;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) scratch[(c + 1) * n_tiles + i] = a.x[c];
}

template <int KIND, bool FLAGS>
__device__ __forceinline__ Agg thread_fold(const unsigned char* flag,
                                           const Cols& cols, long long first,
                                           long long n) {
  Agg a = identity_agg<KIND>(cols);
  for (int i = 0; i < kItems; ++i)
    a = combine<KIND>(a, load_elem<KIND, FLAGS>(flag, cols, first + i, n),
                      cols);
  return a;
}

template <int KIND, bool FLAGS>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const unsigned char* flag, Cols cols, long long n,
            long long* scratch, long long n_tiles) {
  __shared__ int sf[kThreads];
  __shared__ long long sx[kMaxCols][kThreads];
  const long long first = (long long)blockIdx.x * kTile +
                          (long long)threadIdx.x * kItems;
  Agg a = thread_fold<KIND, FLAGS>(flag, cols, first, n);
  a = block_scan<KIND, kThreads>(a, cols, sf, sx);
  if (threadIdx.x == kThreads - 1) store_agg(scratch, n_tiles, blockIdx.x, a);
}

// In place: scratch[i] becomes the aggregate of tiles 0 .. i-1.
template <int KIND>
__global__ void __launch_bounds__(kCarryThreads)
carry_scan(Cols cols, long long* scratch, long long n_tiles) {
  __shared__ int sf[kCarryThreads];
  __shared__ long long sx[kMaxCols][kCarryThreads];
  Agg carry = identity_agg<KIND>(cols);
  for (long long chunk = 0; chunk < n_tiles; chunk += kCarryThreads) {
    const long long i = chunk + threadIdx.x;
    Agg a = i < n_tiles ? load_agg(scratch, n_tiles, i)
                        : identity_agg<KIND>(cols);
    Agg inc = block_scan<KIND, kCarryThreads>(a, cols, sf, sx);
    Agg total;
    Agg ex = exclusive_from<KIND, kCarryThreads>(inc, cols, sf, sx, &total);
    if (i < n_tiles) store_agg(scratch, n_tiles, i, combine<KIND>(carry, ex, cols));
    carry = combine<KIND>(carry, total, cols);
  }
}

template <int KIND, bool FLAGS>
__global__ void __launch_bounds__(kThreads)
tile_apply(const unsigned char* flag, unsigned char* out_flag, Cols cols,
           long long n, const long long* scratch, long long n_tiles) {
  __shared__ int sf[kThreads];
  __shared__ long long sx[kMaxCols][kThreads];
  const long long first = (long long)blockIdx.x * kTile +
                          (long long)threadIdx.x * kItems;
  Agg a = thread_fold<KIND, FLAGS>(flag, cols, first, n);
  Agg inc = block_scan<KIND, kThreads>(a, cols, sf, sx);
  Agg total;
  Agg ex = exclusive_from<KIND, kThreads>(inc, cols, sf, sx, &total);
  Agg run = combine<KIND>(load_agg(scratch, n_tiles, blockIdx.x), ex, cols);
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + k;
    if (i >= n) break;
    run = combine<KIND>(run, load_elem<KIND, FLAGS>(flag, cols, i, n), cols);
    if (FLAGS) out_flag[i] = (unsigned char)run.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < cols.n_cols) store_word(cols.out[c], cols.dt[c], i, run.x[c]);
  }
}

template <int KIND, bool FLAGS>
cudaError_t run_scan(const unsigned char* flag, unsigned char* out_flag,
                     const Cols& cols, long long n, long long* scratch,
                     cudaStream_t st) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  tile_reduce<KIND, FLAGS><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      flag, cols, n, scratch, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_scan<KIND><<<1, kCarryThreads, 0, st>>>(cols, scratch, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tile_apply<KIND, FLAGS><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      flag, out_flag, cols, n, scratch, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// Elements per tile; the caller sizes `scratch` as
// (1 + 3) * ceil(n / tile) int64 words.
extern "C" int sr_flagged_scan_tile() { return kTile; }

// kind: 0 fill, 1 add, 2 min, 3 max.  dtN: 0 int32, 1 uint32,
// 2 int64, 3 float32.  flag / out_flag are n bytes of 0/1.  A null
// flag with a null out_flag is the plain prefix sum: kind "add" only,
// reading no flag and writing none.  Returns
// cudaGetLastError(); queued on `stream`, not synchronised.
extern "C" int sr_flagged_scan(int kind, const void* flag, void* out_flag,
                               int n_cols, const void* in0, const void* in1,
                               const void* in2, void* out0, void* out1,
                               void* out2, int dt0, int dt1, int dt2,
                               long long n, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n_cols < 1 || n_cols > kMaxCols) return (int)cudaErrorInvalidValue;
  Cols cols;
  cols.in[0] = in0;
  cols.in[1] = in1;
  cols.in[2] = in2;
  cols.out[0] = out0;
  cols.out[1] = out1;
  cols.out[2] = out2;
  cols.dt[0] = dt0;
  cols.dt[1] = dt1;
  cols.dt[2] = dt2;
  cols.n_cols = n_cols;
  const unsigned char* f = static_cast<const unsigned char*>(flag);
  unsigned char* of = static_cast<unsigned char*>(out_flag);
  long long* scr = static_cast<long long*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f == nullptr) {  // no segment heads: only the prefix sum
    if (kind != K_ADD || of != nullptr) return (int)cudaErrorInvalidValue;
    return run_scan<K_ADD, false>(f, of, cols, n, scr, st);
  }
  if (of == nullptr) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case K_FILL: return run_scan<K_FILL, true>(f, of, cols, n, scr, st);
    case K_ADD: return run_scan<K_ADD, true>(f, of, cols, n, scr, st);
    case K_MIN: return run_scan<K_MIN, true>(f, of, cols, n, scr, st);
    case K_MAX: return run_scan<K_MAX, true>(f, of, cols, n, scr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
