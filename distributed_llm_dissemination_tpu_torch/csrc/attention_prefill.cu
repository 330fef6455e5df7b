// Tensor-core prefill attention for Hopper (sm_90a), bf16, f16 or f32 in,
// f32 out.
//
// Replaces, for every shape with many query rows per KV head, the
// Pallas TPU kernel `_attn_kernel` (distributed_llm_dissemination_tpu/ops/
// flash_attention.py:128, launched by `_block_attention_pallas` :176
// through `pl.pallas_call` :229).  Same contract as every block-attention
// kernel of the port: for qg [b, kvh, g, sq, hd] and k, v [b, kvh, t, hd]
// with global start positions q_off / k_off, the UNNORMALISED f32 value
// sum pv [b, kvh, g, sq, hd] and the row max m and normaliser l
// [b, kvh, g, sq] of the causal softmax.  A row that sees no key gets
// (0, -1e30, 0).
//
// The bf16 and f16 instances (prefill_wgmma_kernel).  Bound on an H100
// SXM: causal prefill at s = 2048, 32 heads, hd 128 is
// 4*hd per visible (query, key) pair, 34.4 GFLOP, ~35 us at the 989
// TFLOP/s bf16 tensor-core peak; it is operation-bound.  So the products
// run on the tensor cores through wgmma, the only way to their full rate:
//  - A CTA is one (batch, KV head) and a tile of BQ = 128 of its g*sq
//    query rows, flattened [g, sq] as the other kernels do, so a tile is
//    full even at small sq; row r has position q_off + r % sq.  Two
//    consumer warpgroups own 64 rows each.
//  - Q and K/V tiles of BK = 128 keys arrive by TMA (cp.async.bulk.tensor,
//    3-D maps [b*kvh, n, hd], completion on mbarriers) in a two-stage
//    shared-memory ring: the next tile's load is issued before this
//    tile's math.  Keys past t and rows past g*sq come in as TMA's zero
//    fill and are masked or not stored.
//  - Both TMA and wgmma use the 128-byte swizzle (64-byte at hd 32, whose
//    rows are 64 bytes), so shared-memory reads are free of bank conflicts.
//  - S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//    memory.  The row max, rescale, mask and exp2 run on the accumulator
//    fragment in registers.  P is rounded to T in registers and is the
//    A operand of the O += P V wgmma (m64n{hd}k16); V is the B operand
//    from shared memory, transposed by its descriptor (MN-major).  l is
//    summed from the f32 p.
//  - The KV loop stops at the tile holding the CTA's latest visible key,
//    so future tiles are never loaded; only tiles that cross the diagonal
//    or the end of t evaluate the mask.
//  - The two warpgroups are not held in step: a stage is refilled once
//    both have released it (an mbarrier each way), so one warpgroup's
//    softmax overlaps the other's products.  Row tiles run latest first,
//    so the CTAs with the most keys start early.
//  - Numerics: p is rounded to the input type for the PV product (as the
//    JAX model's gqa_attention rounds its probabilities to the model's
//    dtype), so per row |pv - pv_f32p| <= 2^-9 * l * max|v| for bf16 and
//    2^-11 * l * max|v| plus the f16 subnormal step 2^-25 per key for f16,
//    plus f32 summation slack.
//  - Types: the element type T is a template parameter (`dtype` 0 = bf16,
//    1 = f16 at the C interface).  It picks the wgmma kind (.bf16.bf16 or
//    .f16.f16), the rounding of P and the TMA map's data type; shared
//    memory, swizzles and descriptors are the same for both 2-byte types.
//
// The f32 instance (`dtype` 2) is its own kernel, prefill_tf32x3_kernel:
// its tiles, its split pass and its PV product share nothing with the
// 2-byte template but the helpers, the host-side maps and the contract
// above (flattened [g, sq] rows, the KV loop stopped at the latest visible
// key, masks only on tiles that cross the diagonal or t, (0, -1e30, 0)
// for a row that sees no key, hd 32, 64 and 128, one launch on the
// current stream, no allocation).
//  - Bound: s = 2048 at full width is 34.4 GFLOP.  f32 has no tensor-core
//    kind; TF32 (495 TFLOP/s dense) keeps 10 mantissa bits, which moves
//    logits of unit-normal q and k at hd 128 by ~7e-4, above f32's 1e-4
//    for m.  So every product is 3xTF32: x = hi + lo, hi = tf32(x)
//    (cvt.rna), lo = tf32(x - hi) (x - hi is exact in f32), and
//    a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi, f32-accumulated, the lo*lo
//    term (below 2^-22 of |a b|) dropped.  At 165 TFLOP/s effective the
//    call takes at least 0.208 ms; a kernel without tensor cores (67
//    TFLOP/s f32) at least 0.513 ms.  p stays f32 (the JAX kernel forms
//    both products in f32, and an f32 model's gqa_attention keeps p in
//    f32), so P is split too, in registers.
//  - S = Q K^T: wgmma m64n32k8 .tf32, both operands K-major as Q and K
//    land (.tf32 has no transpose): Q_hi K_lo + Q_lo K_hi + Q_hi K_hi.
//    Q_hi sits in shared memory (split in place over the landed Q, once
//    per CTA); Q_lo is the register A operand (64 registers a thread at
//    hd 128), since shared memory cannot hold it beside V^T.  Each K tile
//    is split in place once it lands (hi in place, lo beside it).
//  - O += P V: V [t, hd] is MN-major for this product and .tf32 takes no
//    transposed B, so each landed V tile is transposed into V^T's hi and
//    lo parts (hd rows of the tile's 32 keys, one 128-byte swizzle row
//    each, K-major), and the product is wgmma m64n{hd}k8 with P's parts
//    as the register A operand.  Within a k8 step V^T holds the keys in
//    the order 0, 2, 4, 6, 1, 3, 5, 7: then P's A fragment (k = i and
//    i + 4, i = lane % 4) is the thread's own S accumulators (keys 2i and
//    2i + 1), split in registers, with no shuffle.  (mma.sync m16n8k8
//    .tf32, whose B fragment the threads could load from V as it lands,
//    runs at about a quarter of wgmma's TF32 rate on this card, which
//    made the whole call 1.5x slower.)
//  - Shared memory at hd 128, f32 tiles twice bf16's: Q_hi 64 KB; a stage
//    of K (hi in place), K_lo, V as landed, V^T_hi and V^T_lo, 5 x 16 KB
//    at BK = 32 keys; two stages; 230,424 bytes in all with alignment
//    slack and barriers, of the 232,448 a block may use.  BK = 64 would
//    leave room for one stage only, and no load would overlap compute.
//    The 128-byte swizzle row holds 32 floats; every box is 32 columns.
//  - Per tile all 256 threads split K and transpose V (the generic-proxy
//    writes made visible to wgmma by fence.proxy.async), then one CTA
//    barrier; that barrier also shows every thread done with tile kt - 1,
//    and thread 0 refills its stage with tile kt + 1.  The two
//    warpgroups therefore run in step: the passes, the softmax and the
//    tensor-core products of a tile follow one another.  Each thread
//    issues all its loads of a pass before its first store.
//  - Launch order: the grid is (bh, row tiles), so blocks start with the
//    latest row tile of every (batch, KV head) and go down from there,
//    longest first over the whole grid; the 2-byte kernel's order (each
//    head's tiles latest first, heads one after another) leaves the last
//    of its ~4 waves of CTAs to a few long ones.
//
// The TMA descriptors are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;        // query rows per CTA
constexpr int BK = 128;        // keys per KV tile
constexpr int NTHREADS = 256;  // two warpgroups x 64 rows
constexpr float NEG_INF = -1e30f;  // finite, as the TPU kernel's _NEG_INF
constexpr int MAX_DEVICES = 64;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory layout of one head size.  A TMA box row is one swizzle
// span (SW bytes, COLS 2-byte elements); hd 128 is two boxes side by side.
template <int HD>
struct Tiles {
  static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;
  static constexpr int COLS = SW / 2;
  static constexpr int NBOX = HD / COLS;
  static constexpr int Q_BOX = BQ * SW;
  static constexpr int KV_BOX = BK * SW;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;  // K or V, one stage
  // 1024 bytes of slack to align the swizzle atoms, the tiles, 5 barriers.
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 5 * 8;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 3-D TMA box (c0 = column, c1 = row, c2 = batch x KV head) into
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// P rounded to the model's type, two values packed for a wgmma A register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The wgmma instructions below come in two kinds, `.f32.bf16.bf16` and
// `.f32.f16.f16` (f32 accumulators either way); `KIND` names the operand
// type and `if constexpr` picks one asm string per instance.  The
// accumulator operand lists are shared.
#define ACC16 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])

// D (64 x 128, f32) (+)= A (64 x 16) * B (128 x 16), both from shared
// memory through descriptors, both K-major; scale_d = 0 overwrites D.
#define SS_N128(KIND) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." KIND "." KIND " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
template <bool F16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (F16)
    asm volatile(SS_N128("f16") : ACC64 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(SS_N128("bf16") : ACC64 : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, in registers) * B (16 x N, from shared
// memory, MN-major: the hd dimension contiguous), N = 32, 64 or 128.
#define RS_N32(KIND) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." KIND "." KIND " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
#define RS_N64(KIND) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." KIND "." KIND " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define RS_N128(KIND) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." KIND "." KIND " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define A_REGS "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

template <int HD, bool F16>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) {
    if constexpr (F16)
      asm volatile(RS_N32("f16") : ACC16 : A_REGS, "l"(db), "r"(1));
    else
      asm volatile(RS_N32("bf16") : ACC16 : A_REGS, "l"(db), "r"(1));
  } else if constexpr (HD == 64) {
    if constexpr (F16)
      asm volatile(RS_N64("f16") : ACC32 : A_REGS, "l"(db), "r"(1));
    else
      asm volatile(RS_N64("bf16") : ACC32 : A_REGS, "l"(db), "r"(1));
  } else {
    static_assert(HD == 128, "head dims 32, 64, 128");
    if constexpr (F16)
      asm volatile(RS_N128("f16") : ACC64 : A_REGS, "l"(db), "r"(1));
    else
      asm volatile(RS_N128("bf16") : ACC64 : A_REGS, "l"(db), "r"(1));
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     float* __restrict__ pv, float* __restrict__ m_out,
                     float* __restrict__ l_out, int rows, int sq, int t,
                     long long q_off, long long k_off, float scale_log2) {
  using Tl = Tiles<HD>;
  constexpr bool F16 = std::is_same<T, __half>::value;
  static_assert(F16 || std::is_same<T, __nv_bfloat16>::value, "bf16 or f16");
  constexpr int NKT = BK / 8;  // key n-tiles of S (4 accumulators each)
  constexpr int NDT = HD / 8;  // hd n-tiles of O
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;  // swizzle atoms need 1024
  const uint32_t s_k = s_q + Tl::Q_BYTES;        // [2 stages][NBOX][BK][COLS]
  const uint32_t s_v = s_k + 2 * Tl::KV_BYTES;
  const uint32_t bar_q = s_v + 2 * Tl::KV_BYTES;
  const uint32_t bar_kv0 = bar_q + 8;      // stage loaded, + 8 * stage
  const uint32_t bar_free0 = bar_q + 24;   // stage consumed, + 8 * stage

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wwarp = (tid >> 5) & 3;
  const int bh = blockIdx.y;
  // Row tiles run latest first: under causality they carry the most keys,
  // so the long CTAs start early and the short ones fill the tail.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int r_last = min(r0 + BQ, rows) - 1;

  // Latest and earliest positions among the tile's rows ([g, sq] flat).
  const bool spans = r0 / sq != r_last / sq;
  const long long max_qpos = q_off + (spans ? sq - 1 : r_last % sq);
  const long long min_qpos = q_off + (spans ? 0 : r0 % sq);
  const int n_tiles = (t + BK - 1) / BK;
  int kt_end = 0;  // tiles [0, kt_end) hold a key some row can see
  if (max_qpos >= k_off)
    kt_end = (int)min((long long)n_tiles, (max_qpos - k_off) / BK + 1);

  // This thread's two rows (accumulator fragment rows).
  const int ra = r0 + wg * 64 + wwarp * 16 + (lane >> 2), rb = ra + 8;
  const long long pos_a = q_off + (ra < rows ? ra % sq : 0);
  const long long pos_b = q_off + (rb < rows ? rb % sq : 0);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  if (kt_end > 0) {
    if (tid == 0) {
      mbar_init(bar_q, 1);
      mbar_init(bar_kv0, 1);
      mbar_init(bar_kv0 + 8, 1);
      mbar_init(bar_free0, 2);  // one arrival per consumer warpgroup
      mbar_init(bar_free0 + 8, 2);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar_q, Tl::Q_BYTES);
      for (int bx = 0; bx < Tl::NBOX; ++bx)
        tma_load(s_q + bx * Tl::Q_BOX, &tm_q, bar_q, bx * Tl::COLS, r0, bh);
      mbar_expect_tx(bar_kv0, 2 * Tl::KV_BYTES);
      for (int bx = 0; bx < Tl::NBOX; ++bx) {
        tma_load(s_k + bx * Tl::KV_BOX, &tm_k, bar_kv0, bx * Tl::COLS, 0, bh);
        tma_load(s_v + bx * Tl::KV_BOX, &tm_v, bar_kv0, bx * Tl::COLS, 0, bh);
      }
    }
    mbar_wait(bar_q, 0);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1;
    if (tid == 0 && kt + 1 < kt_end) {
      // The other stage last held tile kt - 1: wait until both
      // warpgroups are done with it.  The warpgroups are not held in step
      // otherwise, so one's softmax overlaps the other's products.
      if (kt >= 1) mbar_wait(bar_free0 + 8 * (stage ^ 1), ((kt - 1) >> 1) & 1);
      const uint32_t bar = bar_kv0 + 8 * (stage ^ 1);
      const uint32_t off = (stage ^ 1) * Tl::KV_BYTES;
      mbar_expect_tx(bar, 2 * Tl::KV_BYTES);
      for (int bx = 0; bx < Tl::NBOX; ++bx) {
        tma_load(s_k + off + bx * Tl::KV_BOX, &tm_k, bar, bx * Tl::COLS,
                 (kt + 1) * BK, bh);
        tma_load(s_v + off + bx * Tl::KV_BOX, &tm_v, bar, bx * Tl::COLS,
                 (kt + 1) * BK, bh);
      }
    }
    __syncwarp();
    mbar_wait(bar_kv0 + 8 * stage, (kt >> 1) & 1);
    const uint32_t k_st = s_k + stage * Tl::KV_BYTES;
    const uint32_t v_st = s_v + stage * Tl::KV_BYTES;

    // S = Q K^T for the warpgroup's 64 rows x BK keys.
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int bx = kk * 16 / Tl::COLS;
      const int within = (kk * 16 % Tl::COLS) * 2;  // bytes into the row
      const uint64_t da = make_desc(
          s_q + bx * Tl::Q_BOX + wg * 64 * Tl::SW + within, 16, 8 * Tl::SW,
          Tl::LAYOUT);
      const uint64_t db = make_desc(k_st + bx * Tl::KV_BOX + within, 16,
                                    8 * Tl::SW, Tl::LAYOUT);
      wgmma_ss_n128<F16>(s, da, db, kk > 0);
    }
    wgmma_commit_wait();
    fence_regs(s);

    // Scale to log2 units; mask only tiles that cross the diagonal or t.
    const long long k_lo = k_off + (long long)kt * BK;
    const bool need_mask = (kt + 1) * BK > t || k_lo + BK - 1 > min_qpos;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (need_mask) {
        const int key = kt * BK + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
        const long long pos = (i & 2) ? pos_b : pos_a;
        if (key >= t || pos < k_off + key) x = NEG_INF;
      }
      s[i] = x;
    }

    // Online softmax on the fragment: row a (i % 4 < 2) and row b.
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // A row with nothing visible so far: p must be 0, not exp2(0) = 1.
    const bool live_a = mn_a > NEG_INF / 2, live_b = mn_b > NEG_INF / 2;
    const float al_a = live_a ? exp2f(m_a - mn_a) : 1.f;
    const float al_b = live_b ? exp2f(m_b - mn_b) : 1.f;
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[4 * j] = live_a ? exp2f(s[4 * j] - mn_a) : 0.f;
      s[4 * j + 1] = live_a ? exp2f(s[4 * j + 1] - mn_a) : 0.f;
      s[4 * j + 2] = live_b ? exp2f(s[4 * j + 2] - mn_b) : 0.f;
      s[4 * j + 3] = live_b ? exp2f(s[4 * j + 3] - mn_b) : 0.f;
      ps_a += s[4 * j] + s[4 * j + 1];
      ps_b += s[4 * j + 2] + s[4 * j + 3];
    }
    l_a = l_a * al_a + ps_a;  // per-thread partial; quad-reduced at the end
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    // O += P V: P (in T) from the S fragment is the A operand directly.
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 keys down from kk*16; the NBOX column boxes lie KV_BOX apart.
      const uint64_t db = make_desc(v_st + kk * 16 * Tl::SW, Tl::KV_BOX,
                                    8 * Tl::SW, Tl::LAYOUT);
      wgmma_pv<HD, F16>(o, a[kk], db);
    }
    wgmma_commit_wait();
    fence_regs(o);
    if ((tid & 127) == 0) mbar_arrive(bar_free0 + 8 * stage);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const int col = 2 * (lane & 3);
  if (ra < rows) {
    float* dst = pv + ((long long)bh * rows + ra) * HD + col;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[4 * j], o[4 * j + 1]);
    if ((lane & 3) == 0) {
      m_out[(long long)bh * rows + ra] = m_a > NEG_INF / 2 ? m_a * LN2 : NEG_INF;
      l_out[(long long)bh * rows + ra] = l_a;
    }
  }
  if (rb < rows) {
    float* dst = pv + ((long long)bh * rows + rb) * HD + col;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    if ((lane & 3) == 0) {
      m_out[(long long)bh * rows + rb] = m_b > NEG_INF / 2 ? m_b * LN2 : NEG_INF;
      l_out[(long long)bh * rows + rb] = l_b;
    }
  }
}

// ---------------------------------------------------------------- f32
//
// The f32 instance, 3xTF32 on the tensor cores (source note at the top).

constexpr int F32_BK = 32;  // keys per KV tile of the f32 kernel

// Shared-memory layout of the f32 kernel at one head size.  A TMA box
// row is one 128-byte swizzle span, 32 floats; hd 128 is four boxes side
// by side, hd 32 one.  Q's hi part takes BQ rows (split in place over the
// landed tile; its lo part lives in registers).  Each of the two stages
// holds K as landed and split in place to its hi part, K's lo part, V as
// landed, and V^T's hi and lo parts: hd rows of the tile's 32 keys, one
// 128-byte swizzle row each, K-major for the PV product.
template <int HD>
struct F32Tiles {
  static constexpr int SW = 128;
  static constexpr int COLS = 32;
  static constexpr int NBOX = HD / COLS;
  static constexpr int Q_BOX = BQ * SW;
  static constexpr int KV_BOX = F32_BK * SW;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;  // a K, V or V^T part
  static constexpr int STAGE = 5 * KV_BYTES;      // K, K lo, V, V^T hi, lo
  // hd 128: 1024 + 64 KB + 2 * 80 KB + 3 barriers = 230,424 bytes of the
  // 232,448 a block may use.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGE + 3 * 8;
};

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as an f32 whose low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// The lo part of x: tf32(x - tf32(x)) (x - tf32(x) is exact in f32).
__device__ __forceinline__ float tf32_lo(float x) {
  return tf32_rna(x - tf32_rna(x));
}

// Byte offset of element (row, col) in a tile of 32-column boxes `box`
// bytes apart, as TMA's 128-byte swizzle lays it down: row `row` of a box
// is 128 bytes, its 16-byte chunk c at c ^ (row % 8).
__device__ __forceinline__ int swizzled(int row, int col, int box) {
  return (col >> 5) * box + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

// Split BYTES of f32 in shared memory: each x becomes hi = tf32(x) in
// place and lo = tf32(x - hi) at the same offset of `lo`.  Elementwise, so
// the swizzled layout carries over as it is.  Each thread loads all of its
// 16-byte pieces before it stores any (the stores may alias later loads
// for all the compiler knows), so the loads are in flight together.
template <int BYTES>
__device__ __forceinline__ void split_tf32(unsigned char* hi,
                                           unsigned char* lo) {
  constexpr int N = BYTES / (16 * NTHREADS);
  static_assert(N * 16 * NTHREADS == BYTES, "whole 16-byte pieces");
  float4 x[N];
#pragma unroll
  for (int r = 0; r < N; ++r)
    x[r] = *reinterpret_cast<const float4*>(hi + (threadIdx.x + r * NTHREADS) * 16);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int i = (threadIdx.x + r * NTHREADS) * 16;
    const float4 h = make_float4(tf32_rna(x[r].x), tf32_rna(x[r].y),
                                 tf32_rna(x[r].z), tf32_rna(x[r].w));
    *reinterpret_cast<float4*>(hi + i) = h;
    *reinterpret_cast<float4*>(lo + i) =
        make_float4(tf32_rna(x[r].x - h.x), tf32_rna(x[r].y - h.y),
                    tf32_rna(x[r].z - h.z), tf32_rna(x[r].w - h.w));
  }
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The .tf32 wgmma kinds below take both operands K-major (.tf32 has no
// transpose); scale_d = 0 overwrites D.  A register fragment of A (64 x 8)
// holds, per thread, (row r, col c), (r + 8, c), (r, c + 4), (r + 8, c + 4)
// with r = 16 * warp + lane / 4 and c = lane % 4.
//
// D (64 x 32) (+)= A (64 x 8, shared memory) * B (32 x 8, shared memory).
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : ACC16
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N) += A (64 x 8, registers) * B (N x 8, shared memory), N = 32,
// 64 or 128.
#define RS_TF32_N32                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"    \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
#define RS_TF32_N64                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"                                                                \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
#define RS_TF32_N128                                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"                                            \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (N == 32) {
    asm volatile(RS_TF32_N32 : ACC16 : A_REGS, "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(RS_TF32_N64 : ACC32 : A_REGS, "l"(db), "r"(1));
  } else {
    static_assert(N == 128, "n 32, 64, 128");
    asm volatile(RS_TF32_N128 : ACC64 : A_REGS, "l"(db), "r"(1));
  }
}

// Tile `tile` of K and V into stage `st` of the f32 kernel; completion on
// the stage's barrier.
template <int HD>
__device__ __forceinline__ void load_kv_f32(const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v,
                                            uint32_t s_kv, uint32_t bar_kv0,
                                            int tile, int st, int bh) {
  using Tl = F32Tiles<HD>;
  const uint32_t bar = bar_kv0 + 8 * st;
  const uint32_t k_dst = s_kv + st * Tl::STAGE;
  mbar_expect_tx(bar, 2 * Tl::KV_BYTES);
  for (int bx = 0; bx < Tl::NBOX; ++bx) {
    tma_load(k_dst + bx * Tl::KV_BOX, tm_k, bar, bx * Tl::COLS,
             tile * F32_BK, bh);
    tma_load(k_dst + 2 * Tl::KV_BYTES + bx * Tl::KV_BOX, tm_v, bar,
             bx * Tl::COLS, tile * F32_BK, bh);
  }
}

// V (BK keys x HD, as landed) to V^T's hi and lo parts: row c of V^T holds
// column c of V, one 128-byte swizzle row of BK = 32 keys.  Within each
// k8 step the keys go in the order 0, 2, 4, 6, 1, 3, 5, 7, so that k = i
// and k = i + 4 of a thread's A fragment of P (i = lane % 4) are keys 2i
// and 2i + 1: the thread's own S accumulator registers.  A task is one
// 16-byte chunk q of a row: keys 8 (q / 2) + q % 2 + 2 e, e = 0..3.
// Loads before stores, as split_tf32.
template <int HD>
__device__ __forceinline__ void transpose_split_v(const unsigned char* v,
                                                  unsigned char* vt_hi,
                                                  unsigned char* vt_lo) {
  using Tl = F32Tiles<HD>;
  constexpr int N = HD * (F32_BK / 4) / NTHREADS;  // tasks per thread
  static_assert(N * NTHREADS == HD * (F32_BK / 4), "whole tasks");
  float x[N][4];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int task = threadIdx.x + r * NTHREADS;
    const int c = task % HD, q = task / HD;
    const int key0 = 8 * (q >> 1) + (q & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[r][e] = *reinterpret_cast<const float*>(
          v + swizzled(key0 + 2 * e, c, Tl::KV_BOX));
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int task = threadIdx.x + r * NTHREADS;
    const int c = task % HD, q = task / HD;
    const float4 h = make_float4(tf32_rna(x[r][0]), tf32_rna(x[r][1]),
                                 tf32_rna(x[r][2]), tf32_rna(x[r][3]));
    const int off = c * 128 + ((q ^ (c & 7)) << 4);
    *reinterpret_cast<float4*>(vt_hi + off) = h;
    *reinterpret_cast<float4*>(vt_lo + off) =
        make_float4(tf32_rna(x[r][0] - h.x), tf32_rna(x[r][1] - h.y),
                    tf32_rna(x[r][2] - h.z), tf32_rna(x[r][3] - h.w));
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
prefill_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      float* __restrict__ pv, float* __restrict__ m_out,
                      float* __restrict__ l_out, int rows, int sq, int t,
                      long long q_off, long long k_off, float scale_log2) {
  using Tl = F32Tiles<HD>;
  constexpr int BK = F32_BK;
  constexpr int NKT = BK / 8;  // key n-tiles of S (4 accumulators each)
  constexpr int NDT = HD / 8;  // hd n-tiles of O
  constexpr int KV = Tl::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;  // Q hi [NBOX][BQ][32]
  const uint32_t s_kv = s_q + Tl::Q_BYTES;       // 2 stages (F32Tiles)
  const uint32_t bar_q = s_kv + 2 * Tl::STAGE;
  const uint32_t bar_kv0 = bar_q + 8;  // stage loaded, + 8 * stage
  // The same shared memory through generic pointers, for the split and
  // transpose passes.
  unsigned char* const gen = smem_raw + (s_q - raw);

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wwarp = (tid >> 5) & 3;
  const int grp = lane >> 2, quad = lane & 3;  // fragment coordinates
  // The grid is (bh, row tiles) and blocks start in order of x fastest, so
  // rank y takes the tile with the y-th most keys over every (batch, KV
  // head): under causality, the tiles latest in their sequence.  When sq
  // is a multiple of BQ each head's tiles are whole: rank y is position
  // block T - 1 - y / g of head y % g (T = sq / BQ).  Otherwise tiles span
  // heads and run latest row first.  Long CTAs start early and short ones
  // fill the tail.
  const int bh = blockIdx.x, rank = blockIdx.y;
  int tile = gridDim.y - 1 - rank;
  if (sq % BQ == 0) {
    const int per_head = sq / BQ, heads = rows / sq;
    tile = (rank % heads) * per_head + per_head - 1 - rank / heads;
  }
  const int r0 = tile * BQ;
  const int r_last = min(r0 + BQ, rows) - 1;

  // Latest and earliest positions among the tile's rows ([g, sq] flat).
  const bool spans = r0 / sq != r_last / sq;
  const long long max_qpos = q_off + (spans ? sq - 1 : r_last % sq);
  const long long min_qpos = q_off + (spans ? 0 : r0 % sq);
  const int n_tiles = (t + BK - 1) / BK;
  int kt_end = 0;  // tiles [0, kt_end) hold a key some row can see
  if (max_qpos >= k_off)
    kt_end = (int)min((long long)n_tiles, (max_qpos - k_off) / BK + 1);

  // This thread's two rows (accumulator fragment rows), within the tile
  // and in all.
  const int row_a = wg * 64 + wwarp * 16 + grp;
  const int ra = r0 + row_a, rb = ra + 8;
  const long long pos_a = q_off + (ra < rows ? ra % sq : 0);
  const long long pos_b = q_off + (rb < rows ? rb % sq : 0);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  uint32_t q_lo[HD / 8][4];  // Q's lo part: the A fragment of each k-step

  if (kt_end > 0) {
    if (tid == 0) {
      mbar_init(bar_q, 1);
      mbar_init(bar_kv0, 1);
      mbar_init(bar_kv0 + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar_q, Tl::Q_BYTES);
      for (int bx = 0; bx < Tl::NBOX; ++bx)
        tma_load(s_q + bx * Tl::Q_BOX, &tm_q, bar_q, bx * Tl::COLS, r0, bh);
      load_kv_f32<HD>(&tm_k, &tm_v, s_kv, bar_kv0, 0, 0, bh);
      if (kt_end > 1) load_kv_f32<HD>(&tm_k, &tm_v, s_kv, bar_kv0, 1, 1, bh);
    }
    mbar_wait(bar_q, 0);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = *reinterpret_cast<const float*>(
            gen + swizzled(row_a + (i & 1) * 8, 8 * kk + quad + (i >> 1) * 4,
                           Tl::Q_BOX));
        q_lo[kk][i] = __float_as_uint(tf32_lo(x));
      }
    }
    __syncthreads();  // every lo part read before Q turns into its hi part
    for (int i = tid * 16; i < Tl::Q_BYTES; i += NTHREADS * 16) {
      float4* p = reinterpret_cast<float4*>(gen + i);
      const float4 x = *p;
      *p = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                       tf32_rna(x.w));
    }  // made visible to wgmma by the first tile's fence and barrier
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1;
    const uint32_t k_st = s_kv + stage * Tl::STAGE;  // K hi; K lo at + KV
    const uint32_t vt_st = k_st + 3 * KV;           // V^T hi; lo at + KV
    unsigned char* const k_gen = gen + (k_st - s_q);
    mbar_wait(bar_kv0 + 8 * stage, (kt >> 1) & 1);
    split_tf32<KV>(k_gen, k_gen + KV);
    transpose_split_v<HD>(k_gen + 2 * KV, k_gen + 3 * KV, k_gen + 4 * KV);
    fence_proxy_async();
    // Every thread's split is in place, and every thread is done with
    // tile kt - 1, so its stage may be refilled with tile kt + 1.
    __syncthreads();
    if (tid == 0 && kt >= 1 && kt + 1 < kt_end)
      load_kv_f32<HD>(&tm_k, &tm_v, s_kv, bar_kv0, kt + 1, stage ^ 1, bh);

    // S = Q K^T for the warpgroup's 64 rows x BK keys, as
    // Q_hi K_lo + Q_lo K_hi + Q_hi K_hi (small terms first).
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      // 8 floats (32 bytes) per k-step, 4 k-steps per 128-byte row.
      const int bx = kk / 4, within = (kk % 4) * 32;
      const uint32_t qa = s_q + bx * Tl::Q_BOX + wg * 64 * Tl::SW + within;
      const uint32_t ka = k_st + bx * Tl::KV_BOX + within;
      const uint64_t q_hi = make_desc(qa, 16, 8 * Tl::SW, 1);
      const uint64_t k_hi = make_desc(ka, 16, 8 * Tl::SW, 1);
      const uint64_t k_lo = make_desc(ka + KV, 16, 8 * Tl::SW, 1);
      wgmma_tf32_ss_n32(s, q_hi, k_lo, kk > 0);
      wgmma_tf32_rs<BK>(s, q_lo[kk], k_hi);
      wgmma_tf32_ss_n32(s, q_hi, k_hi, 1);
    }
    wgmma_commit_wait();
    fence_regs(s);

    // Scale to log2 units; mask only tiles that cross the diagonal or t.
    const long long k_first = k_off + (long long)kt * BK;
    const bool need_mask = (kt + 1) * BK > t || k_first + BK - 1 > min_qpos;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (need_mask) {
        const int key = kt * BK + (i >> 2) * 8 + 2 * quad + (i & 1);
        const long long pos = (i & 2) ? pos_b : pos_a;
        if (key >= t || pos < k_off + key) x = NEG_INF;
      }
      s[i] = x;
    }

    // Online softmax on the fragment: row a (i % 4 < 2) and row b.
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // A row with nothing visible so far: p must be 0, not exp2(0) = 1.
    const bool live_a = mn_a > NEG_INF / 2, live_b = mn_b > NEG_INF / 2;
    const float al_a = live_a ? exp2f(m_a - mn_a) : 1.f;
    const float al_b = live_b ? exp2f(m_b - mn_b) : 1.f;
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[4 * j] = live_a ? exp2f(s[4 * j] - mn_a) : 0.f;
      s[4 * j + 1] = live_a ? exp2f(s[4 * j + 1] - mn_a) : 0.f;
      s[4 * j + 2] = live_b ? exp2f(s[4 * j + 2] - mn_b) : 0.f;
      s[4 * j + 3] = live_b ? exp2f(s[4 * j + 3] - mn_b) : 0.f;
      ps_a += s[4 * j] + s[4 * j + 1];
      ps_b += s[4 * j + 2] + s[4 * j + 3];
    }
    l_a = l_a * al_a + ps_a;  // per-thread partial; quad-reduced at the end
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    // O += P V as P_lo V_hi + P_hi V_lo + P_hi V_hi.  P's A fragment of k8
    // step j is this thread's S accumulators in V^T's key order (keys 2i
    // and 2i + 1 at k = i and i + 4), split in registers.
    uint32_t p_hi[NKT][4], p_lo[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const float pa[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1],
                           s[4 * j + 3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = tf32_rna(pa[i]);
        p_hi[j][i] = __float_as_uint(h);
        p_lo[j][i] = __float_as_uint(tf32_rna(pa[i] - h));
      }
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      // 8 keys (32 bytes) per k-step along V^T's rows.
      const uint64_t v_hi = make_desc(vt_st + 32 * j, 16, 8 * Tl::SW, 1);
      const uint64_t v_lo = make_desc(vt_st + KV + 32 * j, 16, 8 * Tl::SW, 1);
      wgmma_tf32_rs<HD>(o, p_lo[j], v_hi);
      wgmma_tf32_rs<HD>(o, p_hi[j], v_lo);
      wgmma_tf32_rs<HD>(o, p_hi[j], v_hi);
    }
    wgmma_commit_wait();
    fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const int col = 2 * quad;
  if (ra < rows) {
    float* dst = pv + ((long long)bh * rows + ra) * HD + col;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[4 * j], o[4 * j + 1]);
    if (quad == 0) {
      m_out[(long long)bh * rows + ra] = m_a > NEG_INF / 2 ? m_a * LN2 : NEG_INF;
      l_out[(long long)bh * rows + ra] = l_a;
    }
  }
  if (rb < rows) {
    float* dst = pv + ((long long)bh * rows + rb) * HD + col;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    if (quad == 0) {
      m_out[(long long)bh * rows + rb] = m_b > NEG_INF / 2 ? m_b * LN2 : NEG_INF;
      l_out[(long long)bh * rows + rb] = l_b;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map of a contiguous [bh, n, hd] tensor of `type` (`item` bytes
// per element), boxes of [1, box_rows, cols] with the given swizzle;
// out-of-range rows read 0.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int item,
              const void* ptr, int bh, int n, int hd, int box_rows, int cols,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * item,
                                 (cuuint64_t)n * hd * item};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch attributes are set once per template instance and device, not
// on every launch.  `done` holds one flag per device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}
template <typename T, int HD>
bool configured[MAX_DEVICES] = {};

template <int HD>
bool configured_f32[MAX_DEVICES] = {};

// The f32 instance: prefill_tf32x3_kernel, f32 TMA maps of 32-column
// (128-byte) boxes, BQ-row Q boxes and F32_BK-row K/V boxes.
template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* pv,
                       void* m, void* l, int bh, int rows, int sq, int t,
                       long long q_off, long long k_off, float scale_log2,
                       cudaStream_t stream) {
  using Tl = F32Tiles<HD>;
  auto kernel = prefill_tf32x3_kernel<HD>;
  cudaError_t err = set_smem_once(kernel, Tl::SMEM, configured_f32<HD>);
  if (err != cudaSuccess) return err;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, type, 4, q, bh, rows, HD, BQ, Tl::COLS, swz))
    return cudaErrorInvalidValue;
  if (t == 0) {
    tk = tv = tq;  // an empty K/V has no address to map; no tile is loaded
  } else if (!make_map(&tk, type, 4, k, bh, t, HD, F32_BK, Tl::COLS, swz) ||
             !make_map(&tv, type, 4, v, bh, t, HD, F32_BK, Tl::COLS, swz)) {
    return cudaErrorInvalidValue;
  }
  if ((rows + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, (rows + BQ - 1) / BQ);
  kernel<<<grid, NTHREADS, Tl::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(pv), static_cast<float*>(m),
      static_cast<float*>(l), rows, sq, t, q_off, k_off, scale_log2);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_2byte(const void* q, const void* k, const void* v,
                         void* pv, void* m, void* l, int bh, int rows, int sq,
                         int t, long long q_off, long long k_off,
                         float scale_log2, cudaStream_t stream) {
  using Tl = Tiles<HD>;
  auto kernel = prefill_wgmma_kernel<T, HD>;
  cudaError_t err = set_smem_once(kernel, Tl::SMEM, configured<T, HD>);
  if (err != cudaSuccess) return err;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = Tl::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, type, 2, q, bh, rows, HD, BQ, Tl::COLS, swz))
    return cudaErrorInvalidValue;
  if (t == 0) {
    tk = tv = tq;  // an empty K/V has no address to map; no tile is loaded
  } else if (!make_map(&tk, type, 2, k, bh, t, HD, BK, Tl::COLS, swz) ||
             !make_map(&tv, type, 2, v, bh, t, HD, BK, Tl::COLS, swz)) {
    return cudaErrorInvalidValue;
  }
  dim3 grid((rows + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, Tl::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(pv), static_cast<float*>(m),
      static_cast<float*>(l), rows, sq, t, q_off, k_off, scale_log2);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* pv,
                   void* m, void* l, int bh, int rows, int sq, int t,
                   long long q_off, long long k_off, float scale_log2,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch_f32<HD>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                          scale_log2, stream);
  else
    return launch_2byte<T, HD>(q, k, v, pv, m, l, bh, rows, sq, t, q_off,
                               k_off, scale_log2, stream);
}

// The head-size instance of one element type.
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* pv, void* m, void* l, int bh, int rows, int sq,
                        int t, int hd, long long q_off, long long k_off,
                        float scale_log2, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                           scale_log2, s);
    case 64:
      return launch<T, 64>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                           scale_log2, s);
    case 128:
      return launch<T, 128>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                            scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bh = b * kvh, rows = g * sq; every tensor contiguous and 16-byte
// aligned, q/k/v of one type (dtype 0 = bf16, 1 = f16, 2 = f32), outputs
// f32.  scale_log2 = log2(e) / sqrt(hd).  Returns the CUDA error of the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int attention_prefill_fwd(const void* q, const void* k,
                                     const void* v, void* pv, void* m,
                                     void* l, int bh, int rows, int sq,
                                     int t, int hd, long long q_off,
                                     long long k_off, float scale_log2,
                                     int dtype, void* stream) {
  if (bh <= 0 || rows <= 0 || sq <= 0 || t < 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<__nv_bfloat16>(q, k, v, pv, m, l, bh, rows, sq,
                                             t, hd, q_off, k_off, scale_log2,
                                             s);
    case 1:
      return (int)dispatch_hd<__half>(q, k, v, pv, m, l, bh, rows, sq, t, hd,
                                      q_off, k_off, scale_log2, s);
    case 2:
      return (int)dispatch_hd<float>(q, k, v, pv, m, l, bh, rows, sq, t, hd,
                                     q_off, k_off, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
