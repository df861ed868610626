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
// Bound.  At the bench shape (N = 8, S = 8192, d = 128, bf16, causal)
// the work is 4 d N S^2 / 2 = 137 GFLOP of unmasked products against
// 84 MB of inputs and outputs: bound by operations (tensor-core rate),
// 0.139 ms at 989 TFLOP/s.  Hopper reaches that rate only through
// wgmma, fed from shared memory that TMA fills, so the 16-bit design is
// built around both.
//
// Head sizes.  Each design is compiled at d = 64, 128 and 256, and past
// 256 runs as slabs of o (attention_wide, attention_f32_wide) at any
// multiple of 64; the wrapper (ops/attention.py) zero-pads q, k and v of
// any other d to the next of these and cuts o back, which is exact (zero
// columns add 0 to every score and give o columns that are cut off),
// with the scale of the unpadded d passed in.
//
// 16-bit design (bfloat16 or float16, one template over the element
// type E: the TMA element type, the wgmma operand type and the rounding
// of p).  One CTA per (batch n, tile of 128 query rows), 384 threads in
// three warpgroups:
//  - warpgroup 2, the producer, gives up its registers (setmaxnreg 24)
//    and one thread keeps TMA loads in flight: the q tile once, then K
//    and V tiles of kTK keys (128; 64 at d = 256) into a ring of 2
//    stages each, with 128-byte swizzle (a row of d columns is d / 64
//    panels of 64 columns).  Each stage has a
//    "full" mbarrier (TMA transaction bytes) and an "empty" one (one
//    arrival per consumer warp); K and V have their own, so the next K
//    tile loads while the current p . v runs.
//  - warpgroups 0 and 1, the consumers (setmaxnreg 240), own 64 query
//    rows each.  S = q . k^T is wgmma m64n{kTK}k16 with both operands
//    read from swizzled shared memory through descriptors (q stays
//    there for the whole loop); the f32 accumulators are the scores.
//    The softmax runs on them in registers; p, rounded to E (v's type),
//    becomes the A operand of o += p . v in registers (wgmma
//    m64n{d}k16, A from registers, V from shared memory as an MN-major
//    B), so the scores never touch shared memory.
//  - Within a warpgroup, tile j's q . k^T and tile j - 1's p . v are
//    issued together, and tile j's softmax runs while that p . v is in
//    flight (scores, p and o: kTK / 2 + kTK / 4 + d / 2 live registers,
//    160 at d = 128 and 176 at d = 256).  Between the
//    issue and the wait, nothing but wgmma touches an accumulator, or
//    ptxas serialises the wgmmas (its C7514/C7515 notes); that is why q
//    tiles masked throughout take a loop of their own.  The two consumer
//    warpgroups also run out of step, so one's softmax overlaps the
//    other's products (forcing them to alternate with named barriers
//    measured no faster).
//  - Causal tiles are skipped where the mask covers them whole: if
//    every row of the q tile sees key 0 (q_offset + q0 >= k_offset),
//    the K tiles that start past the tile's last visible key give
//    p = exp(NEG_INF - m) = 0, alpha = 1 and an unchanged m, so leaving
//    them out is exact.  A q tile with some row masked throughout visits
//    every tile (those rows need l = s_k and o = sum v); where every
//    row is masked throughout, the q . k^T product is skipped and the
//    scores are NEG_INF.  Only tiles that reach past the diagonal, and
//    the ragged last tile, compare positions per element.
//  - CTAs take the heaviest q tiles first (reversed tile order in
//    blockIdx), so the last wave holds the short ones.
//  - Exponentials are ex2.approx on (s_raw - m_raw) * scale * log2(e),
//    with m kept on the raw product (the scale is positive, so the row
//    max is the same element) and scaled once at the end: x == m gives
//    ex2(0) = 1 exactly, and NEG_INF stays NEG_INF.
//  Shared memory: q 128 x d, K and V 2 x kTK x d each, 16-bit: 80 KB at
//  d = 64, 160 KB at d = 128 and 192 KB at d = 256, one CTA per SM.
//  ptxas: 168 registers a thread at launch (setmaxnreg moves them to
//  the consumers), no spills at d = 64 or 128 (at 232 consumer
//  registers d = 128 spilled 40 bytes and ran slower); chip_smoke.py
//  prints these lines for every instantiation.
//
// float32 design: exact f32 FMAs on the CUDA cores (no TF32), 256
// threads on 64-row tiles, each holding a 4 x 4 block of scores and a
// 4 x d/16 block of o; every K/V tile is computed.  Shared memory
// 214 KB at d = 256.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------- bfloat16 and float16 (wgmma)

constexpr int kTileQ = 128;     // query rows per CTA
constexpr int kStages = 2;      // K and V tiles in flight, each
constexpr int kPanelCols = 64;  // 16-bit columns of one 128-byte swizzle row
constexpr int kQPanelBytes = kTileQ * 128;  // 128 q rows of one panel
constexpr int kConsumers = 2;   // warpgroups of 64 query rows
constexpr int kHopperThreads = (kConsumers + 1) * 128;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per K/V tile: 128, or 64 at d = 256, where 128-key tiles would
// need 64 KB of q and 2 stages x 64 KB each of K and V (256 KB > 227 KB).
template <int D>
constexpr int tile_k() {
  return D == 256 ? 64 : 128;
}

// The two 16-bit input types: the TMA element type, and p rounded to
// the type of v as the A fragments of p . v (the wgmma instruction names
// the type through kF16).
struct Bf16 {
  static constexpr bool kF16 = false;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

struct F16 {
  static constexpr bool kF16 = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);  // round to nearest
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

struct HopperArgs {
  CUtensorMap tq;  // [n, s_q, d], box 64 x 128 x 1, 128 B swizzle
  CUtensorMap tk;  // [n, s_k, d], box 64 x tile_k x 1
  CUtensorMap tv;  // [n, s_k, d]
  float* m;
  float* l;
  float* o;
  int n;
  int n_q_tiles;
  int s_q;
  int s_k;
  int q_offset;
  int k_offset;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// Byte offsets of the shared-memory layout (from a 1024-aligned base).
// q, K and V are stored as panels of 64 columns, each panel its rows of
// 128 bytes in the 128-byte swizzle.
template <int D>
struct Layout {
  static constexpr int kTK = tile_k<D>();
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kKPanelBytes = kTK * 128;  // kTK rows of one panel
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kTileBytes = kPanels * kKPanelBytes;  // K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  // full_q, then full_k, full_v, empty_k, empty_v: kStages each
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SR_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define SR_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define SR_REGS128                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
  "%127}"
#define SR_F8(b)                                                    \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),       \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define SR_F32 SR_F8(0), SR_F8(8), SR_F8(16), SR_F8(24)
#define SR_F64 SR_F32, SR_F8(32), SR_F8(40), SR_F8(48), SR_F8(56)
#define SR_F128                                                          \
  SR_F64, SR_F8(64), SR_F8(72), SR_F8(80), SR_F8(88), SR_F8(96),         \
      SR_F8(104), SR_F8(112), SR_F8(120)
// "f32.bf16.bf16" or "f32.f16.f16": the product's types for TY
#define SR_TYPES(TY) ".f32." TY "." TY " "

// d (+)= A . B, m64n128k16, A and B K-major in shared memory.
#define SR_SS_N128(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k16" SR_TYPES(TY)   \
                   SR_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"          \
               : SR_F64                                                 \
               : "l"(da), "l"(db), "r"(accumulate))
// The same at n = 64 (the scores of a 64-key tile).
#define SR_SS_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n64k16" SR_TYPES(TY)    \
                   SR_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"          \
               : SR_F32                                                 \
               : "l"(da), "l"(db), "r"(accumulate))
// d += A . B, A (16-bit fragments) in registers, B MN-major in shared
// memory: m64n{64,128,256}k16 (o of d = 64, 128, 256).  TAIL names the
// operands after the N / 2 accumulators: a[0..3], then the descriptor;
// FLAG the constant 1 that sets the scale-d predicate.
#define SR_RS(N, TY, REGS, OUTS, TAIL, FLAG)                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " FLAG ", 0;\n"        \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16" SR_TYPES(TY) \
                   REGS ", " TAIL ", p, 1, 1, 1;\n}\n"                   \
               : OUTS                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                 "r"(1))
#define SR_RS_N64(TY) \
  SR_RS(64, TY, SR_REGS32, SR_F32, "{%32, %33, %34, %35}, %36", "%37")
#define SR_RS_N128(TY) \
  SR_RS(128, TY, SR_REGS64, SR_F64, "{%64, %65, %66, %67}, %68", "%69")
#define SR_RS_N256(TY)                                                \
  SR_RS(256, TY, SR_REGS128, SR_F128, "{%128, %129, %130, %131}, %132", \
        "%133")

template <class E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (E::kF16)
    SR_SS_N128("f16");
  else
    SR_SS_N128("bf16");
}

template <class E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (E::kF16)
    SR_SS_N64("f16");
  else
    SR_SS_N64("bf16");
}

template <class E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    if constexpr (E::kF16)
      SR_RS_N64("f16");
    else
      SR_RS_N64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (E::kF16)
      SR_RS_N128("f16");
    else
      SR_RS_N128("bf16");
  } else {
    if constexpr (E::kF16)
      SR_RS_N256("f16");
    else
      SR_RS_N256("bf16");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q . k^T of this warpgroup's 64 rows against one K tile: issued and
// committed, not waited for (after a wgmma_fence()).
template <class E, int D>
__device__ __forceinline__ void issue_scores(float (&sacc)[tile_k<D>() / 2],
                                             uint32_t q, uint32_t k) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns of d per step; kk / 4 picks the 64-column panel
    const uint32_t col = (kk % 4) * 32;
    const uint64_t dq = sw128_desc(q + (kk / 4) * kQPanelBytes + col, 16,
                                   1024);
    const uint64_t dk = sw128_desc(k + (kk / 4) * L::kKPanelBytes + col, 16,
                                   1024);
    if constexpr (L::kTK == 128)
      wgmma_ss_n128<E>(sacc, dq, dk, kk > 0);
    else
      wgmma_ss_n64<E>(sacc, dq, dk, kk > 0);
  }
  wgmma_commit();
}

// o += p . v against one V tile of TK keys and D columns: issued and
// committed, not waited for (after a wgmma_fence()).
template <class E, int D, int TK = tile_k<D>()>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&pf)[TK / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    // 16 keys (rows of V) from kk * 16; panels of 64 columns TK * 128
    // bytes apart
    const uint64_t dv = sw128_desc(v + kk * 16 * 128, TK * 128, 1024);
    wgmma_rs<E, D>(oacc, pf[kk], dv);
  }
  wgmma_commit();
}

// Keeps p's registers (p . v's A operand) unchanged until its wgmma is
// waited for.
template <int KK>
__device__ __forceinline__ void pf_fence(uint32_t (&pf)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pf[kk][e])::"memory");
}

// Where the consumer thread sits: rows `row` and `row` + 8 of the q
// block; `wrow0` its warp's first row; `tig` its column pair in each
// 8-column chunk; (row, col) is causally masked when row - col < delta.
struct Seat {
  int row;
  int wrow0;
  int tig;
  int delta;
};

// The online softmax over one tile of TK raw scores in place: the mask
// (NEG_INF where masked, -inf past s_k, which the max drops and p turns
// into 0), the running max, p, the row sums into l; alpha rescales o.
template <int TK>
__device__ __forceinline__ void softmax_tile(float (&sacc)[TK / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2],
                                             const HopperArgs& a, int kbase,
                                             const Seat& at) {
  if (kbase + TK > a.s_k ||
      (a.causal && at.wrow0 - (kbase + TK - 1) < at.delta)) {
    // the ragged last tile, or a tile reaching past the diagonal
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const int col = kbase + (i / 4) * 8 + 2 * at.tig + (i & 1);
      const int r = at.row + ((i >> 1) & 1) * 8;
      if (col >= a.s_k)
        sacc[i] = -INFINITY;
      else if (a.causal && r - col < at.delta)
        sacc[i] = kNegInf;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < TK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    alpha[h] = ex2((m_run[h] - m_new) * a.scale_log2);
    m_run[h] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = ex2((sacc[i] - m_run[h]) * a.scale_log2);
    sacc[i] = p;
    rs[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + rs[h];
}

// p, rounded to E, as the A fragments of p . v (16 keys each): the score
// accumulator layout of m64n{TK} is the A layout of m64k16.
template <class E, int TK>
__device__ __forceinline__ void p_to_frag(const float (&sacc)[TK / 2],
                                          uint32_t (&pf)[TK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    pf[kk][0] = E::pack(sacc[8 * kk + 0], sacc[8 * kk + 1]);
    pf[kk][1] = E::pack(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pf[kk][2] = E::pack(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pf[kk][3] = E::pack(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// Which K tiles a q tile visits, the same in every thread of the CTA.
struct Visit {
  int n_tiles;
  bool all_masked;  // every row masked throughout: no q . k^T product
};

template <int TK>
__device__ __forceinline__ Visit plan_visit(const HopperArgs& a, int q0) {
  Visit v;
  v.n_tiles = (a.s_k + TK - 1) / TK;
  v.all_masked = false;
  if (a.causal) {
    const int q_last = min(q0 + kTileQ, a.s_q) - 1;
    // the last key column any row of the tile sees
    const long long c_max = (long long)a.q_offset + q_last - a.k_offset;
    if (c_max < 0) {
      v.all_masked = true;
    } else if ((long long)a.q_offset + q0 >= a.k_offset) {
      v.n_tiles = (int)min((long long)v.n_tiles, c_max / TK + 1);
    }  // else a row masked throughout needs every tile
  }
  return v;
}

template <class E, int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    attention_tc(const __grid_constant__ HopperArgs a) {
  using L = Layout<D>;
  constexpr int kTK = L::kTK;
  constexpr int kPanels = L::kPanels;
  extern __shared__ __align__(16) unsigned char hopper_smem[];
  const uint32_t raw = smem_u32(hopper_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t bars = base + L::kBars;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };
  auto sK = [&](int s) { return base + L::kK + (uint32_t)s * L::kTileBytes; };
  auto sV = [&](int s) { return base + L::kV + (uint32_t)s * L::kTileBytes; };

  // heaviest q tiles first: blockIdx runs over (tile descending, batch)
  const int n = blockIdx.x % a.n;
  const int q_tile = a.n_q_tiles - 1 - (int)(blockIdx.x / a.n);
  const int q0 = q_tile * kTileQ;
  const Visit visit = plan_visit<kTK>(a, q0);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumers * 4);
      mbar_init(empty_v(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(full_q, L::kQBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load_3d(sQ + p * kQPanelBytes, &a.tq, full_q, p * kPanelCols, q0,
                    n);
      for (int j = 0; j < visit.n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        if (!visit.all_masked) {
          mbar_wait(empty_k(s), ph);
          mbar_expect_tx(full_k(s), L::kTileBytes);
#pragma unroll
          for (int p = 0; p < kPanels; ++p)
            tma_load_3d(sK(s) + p * L::kKPanelBytes, &a.tk, full_k(s),
                        p * kPanelCols, j * kTK, n);
        }
        mbar_wait(empty_v(s), ph);
        mbar_expect_tx(full_v(s), L::kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load_3d(sV(s) + p * L::kKPanelBytes, &a.tv, full_v(s),
                      p * kPanelCols, j * kTK, n);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;   // row within an 8-row group
    const int tig = lane & 3;  // column pair within an 8-column chunk
    Seat at;
    at.wrow0 = q0 + wg * 64 + warp * 16;
    at.row = at.wrow0 + g;
    at.tig = tig;
    at.delta = a.k_offset - a.q_offset;
    const int row = at.row;
    const uint32_t q_rows = sQ + wg * 64 * 128;  // this warpgroup's rows

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // on the raw (unscaled) product
    float l_run[2] = {0.f, 0.f};          // this thread's columns only
    float alpha[2];
    float sacc[kTK / 2];
    uint32_t pf[kTK / 16][4];

    mbar_wait(full_q, 0);
    if (visit.all_masked) {
      // every row masked throughout: m stays NEG_INF and p = exp(0) = 1
      // on each key below s_k, so l = s_k and o = sum v; p . v only
      for (int j = 0; j < visit.n_tiles; ++j) {
        const int s = j % kStages;
#pragma unroll
        for (int i = 0; i < kTK / 2; ++i) {
          const int col = j * kTK + (i / 4) * 8 + 2 * tig + (i & 1);
          sacc[i] = col < a.s_k ? 1.f : 0.f;
          l_run[(i >> 1) & 1] += sacc[i];
        }
        p_to_frag<E, kTK>(sacc, pf);
        mbar_wait(full_v(s), (j / kStages) & 1);
        reg_fence(oacc);
        wgmma_fence();
        issue_pv<E, D>(oacc, pf, sV(s));
        wgmma_wait<0>();
        reg_fence(oacc);
        pf_fence(pf);
        if (lane == 0) mbar_arrive(empty_v(s));
      }
    } else {
      // Tile j's scores and softmax run while tile j - 1's p . v is in
      // flight; tile 0 starts the pipeline (o is 0: its alpha is unused).
      mbar_wait(full_k(0), 0);
      wgmma_fence();
      issue_scores<E, D>(sacc, q_rows, sK(0));
      wgmma_wait<0>();
      reg_fence(sacc);
      if (lane == 0) mbar_arrive(empty_k(0));
      softmax_tile<kTK>(sacc, m_run, l_run, alpha, a, 0, at);
      p_to_frag<E, kTK>(sacc, pf);
      for (int j = 1; j < visit.n_tiles; ++j) {
        const int s = j % kStages;
        const int sp = (j - 1) % kStages;
        // every wait and every touch of o before the two issues: nothing
        // but wgmma may run between them, or ptxas serialises the wgmmas
        mbar_wait(full_k(s), (j / kStages) & 1);
        mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
        reg_fence(oacc);
        wgmma_fence();
        issue_scores<E, D>(sacc, q_rows, sK(s));
        issue_pv<E, D>(oacc, pf, sV(sp));
        wgmma_wait<1>();  // the scores; p . v may still run
        reg_fence(sacc);
        if (lane == 0) mbar_arrive(empty_k(s));
        softmax_tile<kTK>(sacc, m_run, l_run, alpha, a, j * kTK, at);
        wgmma_wait<0>();
        reg_fence(oacc);
        pf_fence(pf);
        if (lane == 0) mbar_arrive(empty_v(sp));
        p_to_frag<E, kTK>(sacc, pf);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      }
      const int last = visit.n_tiles - 1;
      const int sp = last % kStages;
      mbar_wait(full_v(sp), (last / kStages) & 1);
      reg_fence(oacc);
      wgmma_fence();
      issue_pv<E, D>(oacc, pf, sV(sp));
      wgmma_wait<0>();
      reg_fence(oacc);
      pf_fence(pf);
      if (lane == 0) mbar_arrive(empty_v(sp));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      const int r = row + h * 8;
      if (r >= a.s_q) continue;
      const size_t out_row = (size_t)n * a.s_q + r;
      if (tig == 0) {
        a.m[out_row] = m_run[h] == kNegInf ? kNegInf : m_run[h] * a.scale;
        a.l[out_row] = l_run[h];
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float2 val = make_float2(oacc[4 * c + 2 * h],
                                       oacc[4 * c + 2 * h + 1]);
        *reinterpret_cast<float2*>(a.o + out_row * D + c * 8 + 2 * tig) =
            val;
      }
    }
  }
}

// ------------------------------- d_head > 256, bfloat16 and float16 (wgmma)
//
// At d = 512 a 128-row q tile alone is 128 KB of shared memory, and o of
// 64 rows x 512 float32 is 256 registers a thread, past the 240 a
// consumer warpgroup gets; so past d = 256 (d a multiple of 64, which the
// wrapper pads to) each CTA owns one slab of at most 256 columns of o and
// recomputes the scores over all of d.  The grid is (q tile, batch,
// slab); the CTA keeps attention_tc's warpgroups, 128-row q tile, online
// softmax and causal tile skip, with 64-key K/V tiles:
//  - the producer streams K (and, past d = 512, q) through a ring of
//    64-column panels: each stage one panel of the K tile (8 KB) and,
//    without a resident q, the same panel of the q tile (16 KB; 6
//    stages); up to d = 512 the q tile stays resident (at most 128 KB)
//    and the ring holds 4 K panels.  A tile's scores are d / 64 panels of
//    wgmma m64n64k16, accumulated in registers, each stage released as
//    soon as the panel's products are done (one wgmma group stays in
//    flight);
//  - V comes as the slab's columns of each K/V tile (2 stages), and
//    tile j - 1's p . v (m64n{SW}k16, A from registers, as attention_tc)
//    is issued with tile j's last score panel, so it runs under tile j's
//    softmax.
// Registers at SW = 256 are those of attention_tc<E, 256>: o 128, scores
// 32, p 16.  Shared memory at SW = 256: 64 KB of V, and 128 KB of q with
// 32 KB of K panels (d <= 512) or 144 KB of q and K panels.
// Work: the q . k^T products repeat once per slab (1.5x the operations of
// one pass at d = 512), and past d = 512 q is read from L2 once per K
// tile.  Slabs past the first write o only; every slab computes the same
// m and l, and slab 0 writes them.  o columns at or past d are computed
// on whatever V panels the producer skipped and never written.

constexpr int kWideTK = 64;        // keys per K/V tile
constexpr int kWideSlab = 256;     // o columns per CTA (the slab stride)
constexpr int kKPanel64 = kWideTK * 128;  // 64 keys of one 64-column panel
constexpr int kQResMax = 8;  // panels of a resident q tile (128 KB, d 512)

// The panel ring of attention_wide.  QRES: the q tile stays resident in
// shared memory (d <= 64 * kQResMax) and each stage carries one K panel;
// otherwise each stage carries a q panel and a K panel.
template <bool QRES>
struct PanelRing {
  static constexpr int kStagesP = QRES ? 4 : 6;
  static constexpr int kBytes = (QRES ? 0 : kQPanelBytes) + kKPanel64;
  // q panel p, in stage s of the ring at `ring` or resident at `sq`
  __device__ static __forceinline__ uint32_t q(uint32_t ring, uint32_t sq,
                                               int s, int p) {
    return QRES ? sq + (uint32_t)p * kQPanelBytes
                : ring + (uint32_t)s * kBytes;
  }
  __device__ static __forceinline__ uint32_t k(uint32_t ring, int s) {
    return ring + (uint32_t)s * kBytes + (QRES ? 0 : kQPanelBytes);
  }
};

// Byte offsets from a 1024-aligned base: the ring, V, the barriers
// (full_q, then full_p and empty_p per ring stage, full_v and empty_v per
// V stage), then the resident q tile, whose size follows d.
template <int SW, bool QRES>
struct WideLayout {
  using R = PanelRing<QRES>;
  static constexpr int kVTileBytes = (SW / kPanelCols) * kKPanel64;
  static constexpr int kV = R::kStagesP * R::kBytes;
  static constexpr int kBars = kV + kStages * kVTileBytes;
  static constexpr int kBarBytes = 8 * (1 + 2 * R::kStagesP + 2 * kStages);
  static constexpr int kQ = (kBars + kBarBytes + 1023) / 1024 * 1024;
  static int alloc(int panels) {  // with room to align the base
    return kQ + (QRES ? panels * kQPanelBytes : 0) + 1024;
  }
};

struct WideArgs {
  HopperArgs h;  // tq box 64 x 128 rows, tk and tv 64 x kWideTK
  int d;         // head size, a multiple of 64 (o's row stride)
  int panels;    // d / 64
  int n_slabs;   // slabs of this launch
  int slab0;     // the first slab's index
};

// One panel of S = q . k^T (64 columns of d, 4 steps of k16), added to
// the scores unless it is the first: issued and committed, not waited for
// (after a wgmma_fence()).
template <class E>
__device__ __forceinline__ void issue_panel(float (&sacc)[kWideTK / 2],
                                            uint32_t q, uint32_t k,
                                            bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dq = sw128_desc(q + kk * 32, 16, 1024);
    const uint64_t dk = sw128_desc(k + kk * 32, 16, 1024);
    wgmma_ss_n64<E>(sacc, dq, dk, (int)(!first || kk > 0));
  }
  wgmma_commit();
}

// The first `count` panels of a K tile's scores into sacc, from the
// ring's stage of panel counter t on: each is issued once its stage has
// filled, and each stage but the last is released once the next panel is
// issued and the products before it are done.  Returns with the last
// panel's wgmma group in flight and its stage held.
template <class E, bool QRES>
__device__ __forceinline__ void score_panels(float (&sacc)[kWideTK / 2],
                                             int count, int& t,
                                             uint32_t ring, uint32_t sq,
                                             uint32_t bars, uint32_t q_rows,
                                             int lane) {
  using R = PanelRing<QRES>;
  for (int p = 0; p < count; ++p, ++t) {
    const int s = t % R::kStagesP;
    mbar_wait(bars + 8u * (1 + s), (t / R::kStagesP) & 1);
    wgmma_fence();
    issue_panel<E>(sacc, R::q(ring, sq, s, p) + q_rows, R::k(ring, s),
                   p == 0);
    if (p > 0) {
      wgmma_wait<1>();
      if (lane == 0)
        mbar_arrive(bars +
                    8u * (1 + R::kStagesP + (t - 1) % R::kStagesP));
    }
  }
}

template <class E, int SW, bool QRES>
__global__ void __launch_bounds__(kHopperThreads, 1)
    attention_wide(const __grid_constant__ WideArgs w) {
  using L = WideLayout<SW, QRES>;
  using R = PanelRing<QRES>;
  constexpr int kP = R::kStagesP;
  const HopperArgs& a = w.h;
  extern __shared__ __align__(16) unsigned char hopper_smem[];
  const uint32_t raw = smem_u32(hopper_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the ring
  const uint32_t bars = base + L::kBars;
  const uint32_t sQ = base + L::kQ;  // the resident q tile (QRES)
  const uint32_t full_q = bars;
  auto full_p = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_p = [&](int s) { return bars + 8u * (1 + kP + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + 2 * kP + s); };
  auto empty_v = [&](int s) {
    return bars + 8u * (1 + 2 * kP + kStages + s);
  };
  auto sV = [&](int s) { return base + L::kV + (uint32_t)s * L::kVTileBytes; };

  // heaviest q tiles first: blockIdx runs over (tile descending, batch,
  // slab)
  const int slab = w.slab0 + (int)(blockIdx.x % w.n_slabs);
  const int rest = (int)(blockIdx.x / w.n_slabs);
  const int n = rest % a.n;
  const int q_tile = a.n_q_tiles - 1 - rest / a.n;
  const int q0 = q_tile * kTileQ;
  const int col0 = slab * kWideSlab;
  const int panels = w.panels;
  const Visit visit = plan_visit<kWideTK>(a, q0);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kP; ++s) {
      mbar_init(full_p(s), 1);
      mbar_init(empty_p(s), kConsumers * 4);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      // V panels of the slab that lie below d (the rest are never read
      // into a written column of o)
      const int v_panels = min(SW / kPanelCols, (w.d - col0) / kPanelCols);
      if (QRES && !visit.all_masked) {
        mbar_expect_tx(full_q, panels * kQPanelBytes);
        for (int p = 0; p < panels; ++p)
          tma_load_3d(sQ + p * kQPanelBytes, &a.tq, full_q, p * kPanelCols,
                      q0, n);
      }
      int t = 0;
      for (int j = 0; j < visit.n_tiles; ++j) {
        if (!visit.all_masked) {
          for (int p = 0; p < panels; ++p, ++t) {
            const int s = t % kP;
            mbar_wait(empty_p(s), ((t / kP) & 1) ^ 1);
            mbar_expect_tx(full_p(s), R::kBytes);
            if (!QRES)
              tma_load_3d(R::q(base, sQ, s, p), &a.tq, full_p(s),
                          p * kPanelCols, q0, n);
            tma_load_3d(R::k(base, s), &a.tk, full_p(s), p * kPanelCols,
                        j * kWideTK, n);
          }
        }
        const int s = j % kStages;
        mbar_wait(empty_v(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_v(s), v_panels * kKPanel64);
        for (int c = 0; c < v_panels; ++c)
          tma_load_3d(sV(s) + c * kKPanel64, &a.tv, full_v(s),
                      col0 + c * kPanelCols, j * kWideTK, n);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    Seat at;
    at.wrow0 = q0 + wg * 64 + warp * 16;
    at.row = at.wrow0 + g;
    at.tig = tig;
    at.delta = a.k_offset - a.q_offset;
    const int row = at.row;
    const uint32_t q_rows = wg * 64 * 128;  // this warpgroup's q rows

    float oacc[SW / 2];
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // on the raw (unscaled) product
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float sacc[kWideTK / 2];
    uint32_t pf[kWideTK / 16][4];

    if (visit.all_masked) {
      // every row masked throughout: p = 1 on each key below s_k
      for (int j = 0; j < visit.n_tiles; ++j) {
        const int s = j % kStages;
#pragma unroll
        for (int i = 0; i < kWideTK / 2; ++i) {
          const int col = j * kWideTK + (i / 4) * 8 + 2 * tig + (i & 1);
          sacc[i] = col < a.s_k ? 1.f : 0.f;
          l_run[(i >> 1) & 1] += sacc[i];
        }
        p_to_frag<E, kWideTK>(sacc, pf);
        mbar_wait(full_v(s), (j / kStages) & 1);
        reg_fence(oacc);
        wgmma_fence();
        issue_pv<E, SW, kWideTK>(oacc, pf, sV(s));
        wgmma_wait<0>();
        reg_fence(oacc);
        pf_fence(pf);
        if (lane == 0) mbar_arrive(empty_v(s));
      }
    } else {
      // Panels 0 .. d/64 - 2 of a tile run in score_panels; the last one
      // is issued here, with tile j - 1's p . v beside it from tile 1 on,
      // so that tile j's softmax runs while that p . v is in flight.
      int t = 0;  // panels consumed so far
      if (QRES) mbar_wait(full_q, 0);
      score_panels<E, QRES>(sacc, panels - 1, t, base, sQ, bars, q_rows,
                            lane);
      {
        const int s = t % kP;
        mbar_wait(full_p(s), (t / kP) & 1);
        wgmma_fence();
        issue_panel<E>(sacc, R::q(base, sQ, s, panels - 1) + q_rows,
                       R::k(base, s), panels == 1);
        ++t;
        wgmma_wait<0>();
        reg_fence(sacc);
        if (lane == 0) {
          if (panels > 1) mbar_arrive(empty_p((t - 2) % kP));
          mbar_arrive(empty_p((t - 1) % kP));
        }
      }
      softmax_tile<kWideTK>(sacc, m_run, l_run, alpha, a, 0, at);
      p_to_frag<E, kWideTK>(sacc, pf);
      for (int j = 1; j < visit.n_tiles; ++j) {
        const int sp = (j - 1) % kStages;
        score_panels<E, QRES>(sacc, panels - 1, t, base, sQ, bars, q_rows,
                              lane);
        const int s = t % kP;
        mbar_wait(full_p(s), (t / kP) & 1);
        mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
        reg_fence(oacc);
        wgmma_fence();
        issue_panel<E>(sacc, R::q(base, sQ, s, panels - 1) + q_rows,
                       R::k(base, s), panels == 1);
        issue_pv<E, SW, kWideTK>(oacc, pf, sV(sp));
        ++t;
        wgmma_wait<1>();  // the scores; p . v may still run
        reg_fence(sacc);
        if (lane == 0) {
          if (panels > 1) mbar_arrive(empty_p((t - 2) % kP));
          mbar_arrive(empty_p((t - 1) % kP));
        }
        softmax_tile<kWideTK>(sacc, m_run, l_run, alpha, a, j * kWideTK, at);
        wgmma_wait<0>();
        reg_fence(oacc);
        pf_fence(pf);
        if (lane == 0) mbar_arrive(empty_v(sp));
        p_to_frag<E, kWideTK>(sacc, pf);
#pragma unroll
        for (int i = 0; i < SW / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      }
      const int last = visit.n_tiles - 1;
      const int sl = last % kStages;
      mbar_wait(full_v(sl), (last / kStages) & 1);
      reg_fence(oacc);
      wgmma_fence();
      issue_pv<E, SW, kWideTK>(oacc, pf, sV(sl));
      wgmma_wait<0>();
      reg_fence(oacc);
      pf_fence(pf);
      if (lane == 0) mbar_arrive(empty_v(sl));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      const int r = row + h * 8;
      if (r >= a.s_q) continue;
      const size_t out_row = (size_t)n * a.s_q + r;
      if (slab == 0 && tig == 0) {
        a.m[out_row] = m_run[h] == kNegInf ? kNegInf : m_run[h] * a.scale;
        a.l[out_row] = l_run[h];
      }
#pragma unroll
      for (int c = 0; c < SW / 8; ++c) {
        const int col = col0 + c * 8 + 2 * tig;
        if (col < w.d) {
          const float2 val = make_float2(oacc[4 * c + 2 * h],
                                         oacc[4 * c + 2 * h + 1]);
          *reinterpret_cast<float2*>(a.o + out_row * w.d + col) = val;
        }
      }
    }
  }
}

#undef SR_REGS32
#undef SR_REGS64
#undef SR_REGS128
#undef SR_F8
#undef SR_F32
#undef SR_F64
#undef SR_F128
#undef SR_TYPES
#undef SR_SS_N128
#undef SR_SS_N64
#undef SR_RS
#undef SR_RS_N64
#undef SR_RS_N128
#undef SR_RS_N256

// --------------------------------------------------------------- float32

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
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

// Scaled, masked score of local (row, col); -INFINITY marks a key past
// s_k, which the row max ignores and p turns into 0.
__device__ __forceinline__ float mask_score(float s, int row, int col,
                                            const Args& a) {
  if (col >= a.s_k) return -INFINITY;
  s *= a.scale;
  if (a.causal && a.q_offset + row < a.k_offset + col) return kNegInf;
  return s;
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

template <int D>
size_t smem_f32() {
  return sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (D + 1) +
                          (size_t)kBlockK * D +
                          (size_t)kBlockQ * (kBlockK + 1) + kBlockQ);
}

// float32 past d = 256: attention_f32's arithmetic with the scores summed
// over 64-column chunks of d (q and K chunks through shared memory) and
// one slab of kWideSlab columns of o per CTA (grid: slab, q tile,
// batch).  Every slab computes the same m and l; slab 0 writes them.
// Shared memory 113 KB.
constexpr int kF32Chunk = 64;

struct WideF32Args {
  Args a;
  int d;        // head size, a multiple of 64 (o's row stride)
  int n_slabs;  // ceil(d / kWideSlab)
};

__global__ void __launch_bounds__(kF32Threads)
    attention_f32_wide(WideF32Args w) {
  const Args& a = w.a;
  constexpr int kQS = kF32Chunk + 1;  // padded row of q and k chunks
  constexpr int kPS = kBlockK + 1;
  constexpr int kDC = kWideSlab / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBlockQ * kQS;
  float* sV = sK + kBlockK * kQS;
  float* sP = sV + kBlockK * kWideSlab;
  float* sAlpha = sP + kBlockQ * kPS;

  const int D = w.d;
  const int col0 = (int)(blockIdx.x % w.n_slabs) * kWideSlab;
  const int rest = (int)(blockIdx.x / w.n_slabs);
  const int n = rest / a.n_q_tiles;
  const int q0 = (rest % a.n_q_tiles) * kBlockQ;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int srow = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const float* q = static_cast<const float*>(a.q) + (size_t)n * a.s_q * D;
  const float* k = static_cast<const float*>(a.k) + (size_t)n * a.s_k * D;
  const float* v = static_cast<const float*>(a.v) + (size_t)n * a.s_k * D;

  float acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int n_k_tiles = (a.s_k + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_k_tiles; ++t) {
    const int kbase = t * kBlockK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kF32Chunk) {
      __syncthreads();  // the last chunk's products (and tile's p . v)
      for (int c = threadIdx.x; c < kBlockQ * kF32Chunk; c += kF32Threads) {
        const int r = c / kF32Chunk, col = c0 + c % kF32Chunk;
        sQ[r * kQS + c % kF32Chunk] =
            q0 + r < a.s_q ? q[(size_t)(q0 + r) * D + col] : 0.f;
        sK[r * kQS + c % kF32Chunk] =
            kbase + r < a.s_k ? k[(size_t)(kbase + r) * D + col] : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < kF32Chunk; ++d) {
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
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(tr + 16 * i) * kPS + tc + 16 * j] = mask_score(
            s[i][j], q0 + tr + 16 * i, kbase + tc + 16 * j, a);
    for (int c = threadIdx.x; c < kBlockK * kWideSlab; c += kF32Threads) {
      const int r = c / kWideSlab, col = col0 + c % kWideSlab;
      sV[c] = kbase + r < a.s_k && col < D ? v[(size_t)(kbase + r) * D + col]
                                           : 0.f;
    }
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
      sP[srow * kPS + j] = p;
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
      for (int c = 0; c < kDC; ++c) vv[c] = sV[j * kWideSlab + tc + 16 * c];
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
  if (col0 == 0 && part == 0 && q0 + srow < a.s_q) {
    a.m[(size_t)n * a.s_q + q0 + srow] = m_run;
    a.l[(size_t)n * a.s_q + q0 + srow] = l_run;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r >= a.s_q) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = col0 + tc + 16 * c;
      if (col < D) a.o[((size_t)n * a.s_q + r) * D + col] = acc[i][c];
    }
  }
}

constexpr size_t kSmemF32Wide =
    sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (kF32Chunk + 1) +
                     (size_t)kBlockK * kWideSlab +
                     (size_t)kBlockQ * (kBlockK + 1) + kBlockQ);

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up in the libcuda that the
// CUDA runtime has loaded (the library is not linked against it).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// [n, rows, d] of 16-bit E as a 3-D map, boxes of 64 columns x
// `box_rows` rows x 1 with 128-byte swizzle; rows past `rows` of a batch
// read as zeros.
template <class E>
bool make_map(CUtensorMap* map, const void* ptr, int n, int rows, int d,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {kPanelCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, E::kMap, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The arguments of a 16-bit launch at head size d, with `box_k`-row K
// and V boxes; false where a tensor map cannot be built.
template <class E>
bool hopper_args(HopperArgs* a, const void* q, const void* k, const void* v,
                 float* m, float* l, float* o, int n, int s_q, int s_k,
                 int d, int box_k, int q_offset, int k_offset, int causal,
                 float scale) {
  if (!make_map<E>(&a->tq, q, n, s_q, d, kTileQ) ||
      !make_map<E>(&a->tk, k, n, s_k, d, box_k) ||
      !make_map<E>(&a->tv, v, n, s_k, d, box_k))
    return false;
  a->m = m;
  a->l = l;
  a->o = o;
  a->n = n;
  a->n_q_tiles = (s_q + kTileQ - 1) / kTileQ;
  a->s_q = s_q;
  a->s_k = s_k;
  a->q_offset = q_offset;
  a->k_offset = k_offset;
  a->causal = causal;
  a->scale = scale;
  a->scale_log2 = scale * kLog2e;
  return true;
}

template <class E, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, float* m,
                      float* l, float* o, int n, int s_q, int s_k,
                      int q_offset, int k_offset, int causal, float scale,
                      cudaStream_t st) {
  HopperArgs a;
  if (!hopper_args<E>(&a, q, k, v, m, l, o, n, s_q, s_k, D, tile_k<D>(),
                      q_offset, k_offset, causal, scale))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)a.n_q_tiles * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = Layout<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_tc<E, D><<<(unsigned)blocks, kHopperThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Slabs [slab0, slab0 + n_slabs) of attention_wide in one launch, with
// the q tile resident where it fits (d <= 64 * kQResMax).
template <class E, int SW, bool QRES>
cudaError_t launch_wide_q(const WideArgs& w, cudaStream_t st) {
  const long long blocks = (long long)w.h.n_q_tiles * w.h.n * w.n_slabs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = WideLayout<SW, QRES>::alloc(w.panels);
  cudaError_t err = cudaFuncSetAttribute(
      attention_wide<E, SW, QRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_wide<E, SW, QRES>
      <<<(unsigned)blocks, kHopperThreads, smem, st>>>(w);
  return cudaGetLastError();
}

template <class E, int SW>
cudaError_t launch_wide(WideArgs w, int slab0, int n_slabs, cudaStream_t st) {
  w.slab0 = slab0;
  w.n_slabs = n_slabs;
  if (w.panels <= kQResMax) return launch_wide_q<E, SW, true>(w, st);
  return launch_wide_q<E, SW, false>(w, st);
}

// The tensor-core kernel past d = 256 (d a multiple of 64): the 256-column
// slabs in one launch, and a narrower last slab (64, 128 or, for 192
// columns, 256 wide) in a second.
template <class E>
cudaError_t launch_wide_d(int d, const void* q, const void* k, const void* v,
                          float* m, float* l, float* o, int n, int s_q,
                          int s_k, int q_offset, int k_offset, int causal,
                          float scale, cudaStream_t st) {
  if (d % kPanelCols != 0) return cudaErrorInvalidValue;
  WideArgs w;
  if (!hopper_args<E>(&w.h, q, k, v, m, l, o, n, s_q, s_k, d, kWideTK,
                      q_offset, k_offset, causal, scale))
    return cudaErrorInvalidValue;
  w.d = d;
  w.panels = d / kPanelCols;
  const int full = d / kWideSlab, rest = d % kWideSlab;
  cudaError_t err = launch_wide<E, kWideSlab>(w, 0, full, st);
  if (err != cudaSuccess || rest == 0) return err;
  if (rest <= 64) return launch_wide<E, 64>(w, full, 1, st);
  if (rest <= 128) return launch_wide<E, 128>(w, full, 1, st);
  return launch_wide<E, kWideSlab>(w, full, 1, st);
}

// The tensor-core kernel at a compiled head size, or past 256.
template <class E>
cudaError_t launch_tc_d(int d, const void* q, const void* k, const void* v,
                        float* m, float* l, float* o, int n, int s_q,
                        int s_k, int q_offset, int k_offset, int causal,
                        float scale, cudaStream_t st) {
  if (d == 64)
    return launch_tc<E, 64>(q, k, v, m, l, o, n, s_q, s_k, q_offset,
                            k_offset, causal, scale, st);
  if (d == 128)
    return launch_tc<E, 128>(q, k, v, m, l, o, n, s_q, s_k, q_offset,
                             k_offset, causal, scale, st);
  if (d == 256)
    return launch_tc<E, 256>(q, k, v, m, l, o, n, s_q, s_k, q_offset,
                             k_offset, causal, scale, st);
  if (d > 256)
    return launch_wide_d<E>(d, q, k, v, m, l, o, n, s_q, s_k, q_offset,
                            k_offset, causal, scale, st);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_f32(const Args& a, unsigned blocks, cudaStream_t st) {
  const size_t smem = smem_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_f32<D><<<blocks, kF32Threads, smem, st>>>(a);
  return cudaGetLastError();
}

// float32 past d = 256 (d a multiple of 64): every slab in one launch.
cudaError_t launch_f32_wide(const Args& a, int n, int d, cudaStream_t st) {
  if (d % kF32Chunk != 0) return cudaErrorInvalidValue;
  WideF32Args w;
  w.a = a;
  w.d = d;
  w.n_slabs = (d + kWideSlab - 1) / kWideSlab;
  const long long blocks = (long long)a.n_q_tiles * n * w.n_slabs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemF32Wide);
  if (err != cudaSuccess) return err;
  attention_f32_wide<<<(unsigned)blocks, kF32Threads, kSmemF32Wide, st>>>(w);
  return cudaGetLastError();
}

}  // namespace

// Partials of q [n, s_q, d] against k, v [n, s_k, d] (contiguous, rows
// 16-byte aligned) into m, l [n, s_q] and o [n, s_q, d] (float32).
// dtype 0 = float32, 1 = bfloat16, 2 = float16; d is 64, 128, 256 or a
// multiple of 64 past 256 (the wrapper pads other head sizes).  Returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for another
// dtype or d, or when a tensor map cannot be built); queued on `stream`,
// not synchronised.  Past d = 256 a 16-bit call may be two launches.
extern "C" int sr_block_attention(const void* q, const void* k,
                                  const void* v, void* m, void* l, void* o,
                                  int n, int s_q, int s_k, int d,
                                  int q_offset, int k_offset, int causal,
                                  float scale, int dtype, void* stream) {
  if (n <= 0 || s_q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fm = static_cast<float*>(m);
  float* fl = static_cast<float*>(l);
  float* fo = static_cast<float*>(o);
  if (dtype == 1)
    return launch_tc_d<Bf16>(d, q, k, v, fm, fl, fo, n, s_q, s_k, q_offset,
                             k_offset, causal, scale, st);
  if (dtype == 2)
    return launch_tc_d<F16>(d, q, k, v, fm, fl, fo, n, s_q, s_k, q_offset,
                            k_offset, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.m = fm;
  a.l = fl;
  a.o = fo;
  a.n_q_tiles = (s_q + kBlockQ - 1) / kBlockQ;
  a.s_q = s_q;
  a.s_k = s_k;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.scale = scale;
  const long long blocks = (long long)a.n_q_tiles * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (d == 64) return launch_f32<64>(a, (unsigned)blocks, st);
  if (d == 128) return launch_f32<128>(a, (unsigned)blocks, st);
  if (d == 256) return launch_f32<256>(a, (unsigned)blocks, st);
  if (d > 256) return launch_f32_wide(a, n, d, st);
  return cudaErrorInvalidValue;
}
