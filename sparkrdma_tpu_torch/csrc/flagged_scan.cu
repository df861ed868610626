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
// Bound.  Memory traffic: the flag and every column read once and the
// output flag and columns written once (2 + 2 * sum(itemsize) bytes per
// element; 2 * itemsize for a plain prefix sum, which passes no flags).
// The arithmetic is a few integer ops per element and column, far below
// the card's rate, so the bytes set the pace.
//
// Design: a single pass with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
// The Pallas kernel is exact only because a TPU grid runs in order and
// carries a sum in SMEM; CUDA blocks run in no order, so each block
// learns its carry from its predecessors' published aggregates.
//  - A block takes the next tile from an atomic counter, so every
//    predecessor of its tile has started and the look-back cannot wait
//    on a block that is not running.  A tile is 256 threads x 32 items
//    for one int32 column (prefix sums, 1-column scans) and x 16 items
//    otherwise (the 3-column fill would spill at 32, and the 64-bit
//    path's buffer would pass 48 KB).
//  - Loads and stores are coalesced: each column moves between device
//    memory and shared memory in striped order (16-byte vectors for
//    int32 columns, neighbouring lanes on neighbouring addresses) and is
//    transposed in shared memory (padded against bank conflicts) to
//    blocked order, consecutive items per thread; the flag bytes are
//    already blocked as 16-byte vectors.
//  - Each thread folds its items in registers; warps scan the thread
//    aggregates with __shfl_up_sync (earlier operand first), and one
//    warp scans the 8 warp totals.
//  - The block publishes its aggregate (status A), then warp 0 walks
//    back over its predecessors 32 at a time, folding A values in order
//    until it meets an inclusive prefix (status P), and publishes its
//    own P.  An aggregate is a flag and up to three 64-bit words, too
//    wide for one atomic, so one thread writes the words first and the
//    status word after them with st.release.gpu (a release orders the
//    same thread's earlier writes before it, as a __threadfence() would,
//    which measured slower); readers load the status with ld.acquire.gpu
//    before the words.
//  - Every element is read once and written once; the only other
//    traffic is the scratch status words, zeroed by one memset per call.
//  - Columns that are all int32 (the main path: cumsum_1d, and the 2-
//    and 3-column fills of ops/segment.py) compile with 32-bit words and
//    the dtype fixed; any other mix of int32, uint32, int64 and float32
//    carries 64-bit words and reads each column's dtype at run time.
//  256 threads.  ptxas (sm_90a): the prefix sum 56 registers and 36.9
//  KB of shared memory; one flagged int32 column 114-118 registers and
//  36.9 KB; 2-3 int32 columns capped at 80 registers (the 3-column fill
//  spills 112 bytes and still ran faster than uncapped at 120) and 18.5
//  KB; the 64-bit path 64-209 registers, 34-35 KB, no spills.
//  chip_smoke.py prints these lines.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { DT_I32 = 0, DT_U32 = 1, DT_I64 = 2, DT_F32 = 3 };
enum { K_FILL = 0, K_ADD = 1, K_MIN = 2, K_MAX = 3 };

constexpr int kMaxCols = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinTile = kThreads * 16;  // the smallest tile of any path
constexpr int kAggWords = 1 + kMaxCols;  // flag, then the column words
constexpr unsigned long long kStatusX = 0;  // nothing published yet
constexpr unsigned long long kStatusA = 1;  // the tile's own aggregate
constexpr unsigned long long kStatusP = 2;  // its inclusive prefix
constexpr unsigned kFull = 0xffffffffu;

struct Cols {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int dt[kMaxCols];
};

template <int NC, typename W>
struct Agg {
  int f;
  W x[NC];
};

__device__ __forceinline__ float as_f32(long long w) {
  return __int_as_float((int)(unsigned)w);
}

__device__ __forceinline__ long long from_f32(float f) {
  return (long long)(unsigned)__float_as_int(f);
}

// The column's dtype: fixed at compile time on the all-int32 path.
template <bool I32>
__device__ __forceinline__ int col_dt(const Cols& cols, int c) {
  return I32 ? (int)DT_I32 : cols.dt[c];
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

// prev (op) cur for the arithmetic kinds, in the column's dtype.  Words
// hold the value itself (uint32 zero-extended, float32 as its bits).
template <int KIND, typename W>
__device__ __forceinline__ W apply_op(int dt, W a, W b) {
  if (KIND == K_ADD) {
    switch (dt) {
      case DT_I32: return (W)(int)((unsigned)a + (unsigned)b);
      case DT_U32: return (W)(unsigned)((unsigned)a + (unsigned)b);
      case DT_I64:
        return (W)(long long)((unsigned long long)a + (unsigned long long)b);
      default: return (W)from_f32(as_f32(a) + as_f32(b));
    }
  }
  const bool is_min = KIND == K_MIN;
  switch (dt) {
    case DT_I32:
    case DT_U32:
    case DT_I64:
      return is_min ? (a < b ? a : b) : (a > b ? a : b);
    default: {
      const float fa = as_f32(a), fb = as_f32(b);
      if (isnan(fa)) return a;  // NaN propagates, as torch.minimum
      if (isnan(fb)) return b;
      return is_min ? (fb < fa ? b : a) : (fb > fa ? b : a);
    }
  }
}

template <int KIND, bool FLAGS, bool I32, int NC, typename W>
__device__ __forceinline__ Agg<NC, W> combine(const Agg<NC, W>& p,
                                              const Agg<NC, W>& c,
                                              const Cols& cols) {
  Agg<NC, W> r;
  r.f = FLAGS ? (p.f | c.f) : 0;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (FLAGS && c.f)
      r.x[i] = c.x[i];
    else if (KIND == K_FILL)
      r.x[i] = p.x[i];
    else
      r.x[i] = apply_op<KIND, W>(col_dt<I32>(cols, i), p.x[i], c.x[i]);
  }
  return r;
}

template <int KIND, bool I32, int NC, typename W>
__device__ __forceinline__ Agg<NC, W> identity_agg(const Cols& cols) {
  Agg<NC, W> a;
  a.f = 0;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    a.x[i] = (W)identity<KIND>(col_dt<I32>(cols, i));
  return a;
}

template <int NC, typename W>
__device__ __forceinline__ Agg<NC, W> shfl_up(const Agg<NC, W>& a, int off) {
  Agg<NC, W> r;
  r.f = __shfl_up_sync(kFull, a.f, off);
#pragma unroll
  for (int i = 0; i < NC; ++i) r.x[i] = __shfl_up_sync(kFull, a.x[i], off);
  return r;
}

template <int NC, typename W>
__device__ __forceinline__ Agg<NC, W> shfl_down(const Agg<NC, W>& a,
                                                int off) {
  Agg<NC, W> r;
  r.f = __shfl_down_sync(kFull, a.f, off);
#pragma unroll
  for (int i = 0; i < NC; ++i) r.x[i] = __shfl_down_sync(kFull, a.x[i], off);
  return r;
}

template <int NC, typename W>
__device__ __forceinline__ Agg<NC, W> shfl_idx(const Agg<NC, W>& a,
                                               int src) {
  Agg<NC, W> r;
  r.f = __shfl_sync(kFull, a.f, src);
#pragma unroll
  for (int i = 0; i < NC; ++i) r.x[i] = __shfl_sync(kFull, a.x[i], src);
  return r;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Scratch, in 64-bit words: [0] the tile counter, [1, 1 + T) the status
// of each of the T tiles, then T slots of kAggWords for the aggregates
// (status A) and T more for the inclusive prefixes (status P).
struct Scratch {
  long long* base;
  long long n_tiles;
  __device__ long long* status() const { return base + 1; }
  __device__ long long* slot(unsigned long long st, long long tile) const {
    return base + 1 + n_tiles * (st == kStatusP ? 1 + kAggWords : 1) +
           tile * kAggWords;
  }
};

template <int NC, typename W>
__device__ __forceinline__ void publish(const Scratch& s, long long tile,
                                        unsigned long long st,
                                        const Agg<NC, W>& a) {
  long long* w = s.slot(st, tile);
  w[0] = a.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) w[1 + i] = (long long)a.x[i];
  st_release(s.status() + tile, st);  // orders the words before it
}

// The exclusive prefix of `tile` (> 0), by warp 0: predecessors 32 at a
// time, nearest in lane 0, folded earliest first up to the nearest P.
template <int KIND, bool FLAGS, bool I32, int NC, typename W>
__device__ Agg<NC, W> look_back(const Scratch& s, long long tile,
                                const Cols& cols, int lane) {
  using A = Agg<NC, W>;
  A prefix = identity_agg<KIND, I32, NC, W>(cols);
  for (long long j0 = tile - 1;; j0 -= 32) {
    const long long j = j0 - lane;
    unsigned long long st = kStatusP;  // before tile 0: never folded in
    if (j >= 0) {
      do {
        st = ld_acquire(s.status() + j);
      } while (st == kStatusX);
    }
    const unsigned pmask = __ballot_sync(kFull, st == kStatusP);
    const int last = pmask ? __ffs(pmask) - 1 : 31;
    A v = identity_agg<KIND, I32, NC, W>(cols);
    if (lane <= last) {  // j >= 0 here: tile 0 publishes P
      const long long* w = s.slot(st, j);
      v.f = (int)__ldcg(w);
#pragma unroll
      for (int i = 0; i < NC; ++i) v.x[i] = (W)__ldcg(w + 1 + i);
    }
    // lane 0 gathers lanes last..0: the higher lane is the earlier tile
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const A o = shfl_down(v, off);
      if (lane + off < 32) v = combine<KIND, FLAGS, I32, NC, W>(o, v, cols);
    }
    prefix = combine<KIND, FLAGS, I32, NC, W>(shfl_idx(v, 0), prefix, cols);
    if (pmask) return prefix;
  }
}

// Shared-memory index of 16-byte vector i (int32 path) or of word i
// (64-bit path): one pad slot per 8 vectors or 16 words keeps both the
// striped and the blocked accesses free of bank conflicts.
__device__ __forceinline__ int vec_slot(int i) { return i + (i >> 3); }
__device__ __forceinline__ int word_slot(int i) { return i + (i >> 4); }

template <bool I32, int NC>
struct Tiling {
  static constexpr int kItems = I32 && NC == 1 ? 32 : 16;  // per thread
  static constexpr int kTile = kThreads * kItems;
  static constexpr int kBufBytes =  // the transpose buffer
      I32 ? (kTile / 4 + kTile / 32) * 16 : (kTile + kTile / 16) * 8;
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

// Column c of the tile into x[k] = item ITEMS t + k (blocked), positions
// past `valid` as `ident`.  Ends with a barrier.
template <bool I32, int ITEMS, typename W>
__device__ __forceinline__ void load_column(const Cols& cols, int c,
                                            long long base, int valid,
                                            W ident, unsigned char* sbuf,
                                            W (&x)[ITEMS]) {
  const int t = threadIdx.x;
  if constexpr (I32) {
    uint4* sv = reinterpret_cast<uint4*>(sbuf);
    const int* in = static_cast<const int*>(cols.in[c]) + base;
#pragma unroll
    for (int it = 0; it < ITEMS / 4; ++it) {
      const int vi = it * kThreads + t;
      uint4 val;
      if (vi * 4 + 3 < valid) {
        val = reinterpret_cast<const uint4*>(in)[vi];
      } else {
        int e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          e[u] = vi * 4 + u < valid ? in[vi * 4 + u] : (int)ident;
        val = make_uint4(e[0], e[1], e[2], e[3]);
      }
      sv[vec_slot(vi)] = val;
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < ITEMS / 4; ++v) {
      const uint4 val = sv[vec_slot(t * (ITEMS / 4) + v)];
      x[4 * v + 0] = (W)(int)val.x;
      x[4 * v + 1] = (W)(int)val.y;
      x[4 * v + 2] = (W)(int)val.z;
      x[4 * v + 3] = (W)(int)val.w;
    }
  } else {
    long long* sw = reinterpret_cast<long long*>(sbuf);
    const int dt = cols.dt[c];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int e = it * kThreads + t;
      sw[word_slot(e)] =
          e < valid ? load_word(cols.in[c], dt, base + e)
                    : (long long)ident;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) x[k] = (W)sw[word_slot(t * ITEMS + k)];
  }
  __syncthreads();
}

// x[k] (blocked) to column c of the tile, positions below `valid` only.
// Ends with a barrier.
template <bool I32, int ITEMS, typename W>
__device__ __forceinline__ void store_column(const Cols& cols, int c,
                                             long long base, int valid,
                                             unsigned char* sbuf,
                                             const W (&x)[ITEMS]) {
  const int t = threadIdx.x;
  if constexpr (I32) {
    uint4* sv = reinterpret_cast<uint4*>(sbuf);
#pragma unroll
    for (int v = 0; v < ITEMS / 4; ++v)
      sv[vec_slot(t * (ITEMS / 4) + v)] =
          make_uint4((unsigned)x[4 * v], (unsigned)x[4 * v + 1],
                     (unsigned)x[4 * v + 2], (unsigned)x[4 * v + 3]);
    __syncthreads();
    int* out = static_cast<int*>(cols.out[c]) + base;
#pragma unroll
    for (int it = 0; it < ITEMS / 4; ++it) {
      const int vi = it * kThreads + t;
      const uint4 val = sv[vec_slot(vi)];
      if (vi * 4 + 3 < valid) {
        reinterpret_cast<uint4*>(out)[vi] = val;
      } else {
        const int e[4] = {(int)val.x, (int)val.y, (int)val.z, (int)val.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (vi * 4 + u < valid) out[vi * 4 + u] = e[u];
      }
    }
  } else {
    long long* sw = reinterpret_cast<long long*>(sbuf);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      sw[word_slot(t * ITEMS + k)] = (long long)x[k];
    __syncthreads();
    const int dt = cols.dt[c];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int e = it * kThreads + t;
      if (e < valid) store_word(cols.out[c], dt, base + e, sw[word_slot(e)]);
    }
  }
  __syncthreads();
}

// The 2- and 3-column int32 path is capped at 85 registers so that 3
// blocks fit an SM (the 3-column fill needs 120 uncapped, which leaves
// 2, and measured slower).
template <int KIND, bool FLAGS, bool I32, int NC>
__global__ void __launch_bounds__(kThreads, I32 && NC > 1 ? 3 : 1)
    scan_tiles(const unsigned char* flag, unsigned char* out_flag, Cols cols,
               long long n, Scratch scratch) {
  using W = typename std::conditional<I32, int, long long>::type;
  using A = Agg<NC, W>;
  constexpr int kItems = Tiling<I32, NC>::kItems;
  constexpr int kTile = Tiling<I32, NC>::kTile;
  __shared__ __align__(16) unsigned char sbuf[Tiling<I32, NC>::kBufBytes];
  __shared__ A warp_agg[kWarps];  // totals, then exclusive prefixes
  __shared__ long long s_tile;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0)
    s_tile = (long long)atomicAdd(
        reinterpret_cast<unsigned long long*>(scratch.base), 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  const int valid = (int)min((long long)kTile, n - base);

  // flags: thread t's items are bytes kItems t .. kItems (t + 1) - 1
  // of the tile, 16-byte vectors
  unsigned char f[kItems];
  if (FLAGS) {
    if (t * kItems + kItems - 1 < valid) {
#pragma unroll
      for (int u = 0; u < kItems / 16; ++u) {
        const uint4 v = reinterpret_cast<const uint4*>(
            flag + base)[t * (kItems / 16) + u];
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          f[16 * u + k] = (w[k / 4] >> (8 * (k % 4))) & 1;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        f[k] = t * kItems + k < valid ? flag[base + t * kItems + k] != 0 : 0;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) f[k] = 0;
  }
  W x[NC][kItems];
  const A ident = identity_agg<KIND, I32, NC, W>(cols);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    load_column<I32, kItems, W>(cols, c, base, valid, ident.x[c], sbuf,
                                x[c]);

  // fold this thread's items, then scan across the warp
  A agg = ident;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    A item;
    item.f = f[k];
#pragma unroll
    for (int c = 0; c < NC; ++c) item.x[c] = x[c][k];
    agg = combine<KIND, FLAGS, I32, NC, W>(agg, item, cols);
  }
  A inc = agg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const A up = shfl_up(inc, off);
    if (lane >= off) inc = combine<KIND, FLAGS, I32, NC, W>(up, inc, cols);
  }
  A lane_ex = shfl_up(inc, 1);
  if (lane == 0) lane_ex = ident;
  if (lane == 31) warp_agg[warp] = inc;
  __syncthreads();

  if (warp == 0) {
    A w = lane < kWarps ? warp_agg[lane] : ident;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const A up = shfl_up(w, off);
      if (lane >= off) w = combine<KIND, FLAGS, I32, NC, W>(up, w, cols);
    }
    const A block = shfl_idx(w, kWarps - 1);
    A warp_ex = shfl_up(w, 1);
    if (lane == 0) warp_ex = ident;
    A prefix = ident;
    if (tile == 0) {
      if (lane == 0) publish(scratch, tile, kStatusP, block);
    } else {
      if (lane == 0) publish(scratch, tile, kStatusA, block);
      prefix = look_back<KIND, FLAGS, I32, NC, W>(scratch, tile, cols, lane);
      if (lane == 0)
        publish(scratch, tile, kStatusP,
                combine<KIND, FLAGS, I32, NC, W>(prefix, block, cols));
    }
    if (lane < kWarps)
      warp_agg[lane] = combine<KIND, FLAGS, I32, NC, W>(prefix, warp_ex, cols);
  }
  __syncthreads();

  // rescan this thread's items from its exclusive prefix
  A run = combine<KIND, FLAGS, I32, NC, W>(warp_agg[warp], lane_ex, cols);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    A item;
    item.f = f[k];
#pragma unroll
    for (int c = 0; c < NC; ++c) item.x[c] = x[c][k];
    run = combine<KIND, FLAGS, I32, NC, W>(run, item, cols);
    f[k] = (unsigned char)run.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c][k] = run.x[c];
  }
  if (FLAGS) {
    if (t * kItems + kItems - 1 < valid) {
#pragma unroll
      for (int u = 0; u < kItems / 16; ++u) {
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          w[k / 4] |= (unsigned)f[16 * u + k] << (8 * (k % 4));
        reinterpret_cast<uint4*>(out_flag + base)[t * (kItems / 16) + u] =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (t * kItems + k < valid) out_flag[base + t * kItems + k] = f[k];
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    store_column<I32, kItems, W>(cols, c, base, valid, sbuf, x[c]);
}

long long tiles_of(long long n, int tile) { return (n + tile - 1) / tile; }

// One call's operands, as the entry point received them.
struct Call {
  const unsigned char* flag;
  unsigned char* out_flag;
  Cols cols;
  long long n;
  long long* scratch;
  cudaStream_t st;
};

template <int KIND, bool FLAGS, bool I32, int NC>
cudaError_t launch(const Call& c) {
  Scratch s;
  s.base = c.scratch;
  s.n_tiles = tiles_of(c.n, Tiling<I32, NC>::kTile);
  if (s.n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      c.scratch, 0, sizeof(long long) * (size_t)(1 + s.n_tiles), c.st);
  if (err != cudaSuccess) return err;
  scan_tiles<KIND, FLAGS, I32, NC>
      <<<(unsigned)s.n_tiles, kThreads, 0, c.st>>>(c.flag, c.out_flag,
                                                   c.cols, c.n, s);
  return cudaGetLastError();
}

template <int KIND, bool I32>
cudaError_t launch_cols(const Call& c, int n_cols) {
  switch (n_cols) {
    case 1: return launch<KIND, true, I32, 1>(c);
    case 2: return launch<KIND, true, I32, 2>(c);
    case 3: return launch<KIND, true, I32, 3>(c);
    default: return cudaErrorInvalidValue;
  }
}

template <bool I32>
cudaError_t launch_kind(const Call& c, int kind, int n_cols) {
  switch (kind) {
    case K_FILL: return launch_cols<K_FILL, I32>(c, n_cols);
    case K_ADD: return launch_cols<K_ADD, I32>(c, n_cols);
    case K_MIN: return launch_cols<K_MIN, I32>(c, n_cols);
    case K_MAX: return launch_cols<K_MAX, I32>(c, n_cols);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Elements per tile for n_cols columns, all int32 or not.
extern "C" int sr_flagged_scan_tile(int n_cols, int all_int32) {
  if (all_int32 && n_cols == 1) return Tiling<true, 1>::kTile;
  return all_int32 ? Tiling<true, 2>::kTile : Tiling<false, 1>::kTile;
}

// Size in int64 words of the `scratch` that sr_flagged_scan needs for n
// elements, whatever the columns (the call zeroes the part it must).
extern "C" long long sr_flagged_scan_scratch_words(long long n) {
  return 1 + tiles_of(n, kMinTile) * (1 + 2 * kAggWords);
}

// kind: 0 fill, 1 add, 2 min, 3 max.  dtN: 0 int32, 1 uint32,
// 2 int64, 3 float32.  flag / out_flag are n bytes of 0/1.  A null
// flag with a null out_flag is the plain prefix sum: kind "add" and one
// column only, reading no flag and writing none.  Every pointer is
// 16-byte aligned.  One memset of the scratch status and one kernel
// launch; returns cudaGetLastError(); queued on `stream`, not
// synchronised.
extern "C" int sr_flagged_scan(int kind, const void* flag, void* out_flag,
                               int n_cols, const void* in0, const void* in1,
                               const void* in2, void* out0, void* out1,
                               void* out2, int dt0, int dt1, int dt2,
                               long long n, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n_cols < 1 || n_cols > kMaxCols) return (int)cudaErrorInvalidValue;
  Call c;
  c.flag = static_cast<const unsigned char*>(flag);
  c.out_flag = static_cast<unsigned char*>(out_flag);
  c.cols.in[0] = in0;
  c.cols.in[1] = in1;
  c.cols.in[2] = in2;
  c.cols.out[0] = out0;
  c.cols.out[1] = out1;
  c.cols.out[2] = out2;
  c.cols.dt[0] = dt0;
  c.cols.dt[1] = dt1;
  c.cols.dt[2] = dt2;
  c.n = n;
  c.scratch = static_cast<long long*>(scratch);
  c.st = static_cast<cudaStream_t>(stream);
  bool all_i32 = true;
  for (int i = 0; i < n_cols; ++i) all_i32 = all_i32 && c.cols.dt[i] == DT_I32;
  if (c.flag == nullptr) {  // no segment heads: only the prefix sum
    if (kind != K_ADD || c.out_flag != nullptr || n_cols != 1)
      return (int)cudaErrorInvalidValue;
    return all_i32 ? launch<K_ADD, false, true, 1>(c)
                   : launch<K_ADD, false, false, 1>(c);
  }
  if (c.out_flag == nullptr) return (int)cudaErrorInvalidValue;
  return all_i32 ? launch_kind<true>(c, kind, n_cols)
                 : launch_kind<false>(c, kind, n_cols);
}
