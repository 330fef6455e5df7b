// Tensor-core prefill attention for Hopper (sm_90a), bf16 in, f32 out.
//
// Replaces, for every bf16 shape with many query rows per KV head, the
// Pallas TPU kernel `_attn_kernel` (distributed_llm_dissemination_tpu/ops/
// flash_attention.py:128, launched by `_block_attention_pallas` :176
// through `pl.pallas_call` :229).  Same contract as every block-attention
// kernel of the port: for qg [b, kvh, g, sq, hd] and k, v [b, kvh, t, hd]
// with global start positions q_off / k_off, the UNNORMALISED f32 value
// sum pv [b, kvh, g, sq, hd] and the row max m and normaliser l
// [b, kvh, g, sq] of the causal softmax.  A row that sees no key gets
// (0, -1e30, 0).
//
// Bound on an H100 SXM: causal prefill at s = 2048, 32 heads, hd 128 is
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
//    fragment in registers.  P is rounded to bf16 in registers and is the
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
//  - Numerics: p is rounded to bf16 for the PV product (as the JAX model's
//    gqa_attention rounds its probabilities), so per row
//    |pv - pv_f32p| <= 2^-9 * l * max|v| plus f32 summation slack.
//
// The TMA descriptors are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // query rows per CTA
constexpr int BK = 128;        // keys per KV tile
constexpr int NTHREADS = 256;  // two warpgroups x 64 rows
constexpr float NEG_INF = -1e30f;  // finite, as the TPU kernel's _NEG_INF
constexpr int MAX_DEVICES = 64;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory layout of one head size.  A TMA box row is one swizzle
// span (SW bytes, COLS bf16); hd 128 is two boxes side by side.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 128, f32) (+)= A (64 x 16) * B (128 x 16), both bf16 from shared
// memory through descriptors, both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers) * B (16 x 32, bf16
// from shared memory, MN-major: the hd dimension contiguous).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, bf16
// from shared memory, MN-major: the hd dimension contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, bf16
// from shared memory, MN-major: the hd dimension contiguous).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n32(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     float* __restrict__ pv, float* __restrict__ m_out,
                     float* __restrict__ l_out, int rows, int sq, int t,
                     long long q_off, long long k_off, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int NKT = BK / 8;  // key n-tiles of S (4 accumulators each)
  constexpr int NDT = HD / 8;  // hd n-tiles of O
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;  // swizzle atoms need 1024
  const uint32_t s_k = s_q + T::Q_BYTES;        // [2 stages][NBOX][BK][COLS]
  const uint32_t s_v = s_k + 2 * T::KV_BYTES;
  const uint32_t bar_q = s_v + 2 * T::KV_BYTES;
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
      mbar_expect_tx(bar_q, T::Q_BYTES);
      for (int bx = 0; bx < T::NBOX; ++bx)
        tma_load(s_q + bx * T::Q_BOX, &tm_q, bar_q, bx * T::COLS, r0, bh);
      mbar_expect_tx(bar_kv0, 2 * T::KV_BYTES);
      for (int bx = 0; bx < T::NBOX; ++bx) {
        tma_load(s_k + bx * T::KV_BOX, &tm_k, bar_kv0, bx * T::COLS, 0, bh);
        tma_load(s_v + bx * T::KV_BOX, &tm_v, bar_kv0, bx * T::COLS, 0, bh);
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
      const uint32_t off = (stage ^ 1) * T::KV_BYTES;
      mbar_expect_tx(bar, 2 * T::KV_BYTES);
      for (int bx = 0; bx < T::NBOX; ++bx) {
        tma_load(s_k + off + bx * T::KV_BOX, &tm_k, bar, bx * T::COLS,
                 (kt + 1) * BK, bh);
        tma_load(s_v + off + bx * T::KV_BOX, &tm_v, bar, bx * T::COLS,
                 (kt + 1) * BK, bh);
      }
    }
    __syncwarp();
    mbar_wait(bar_kv0 + 8 * stage, (kt >> 1) & 1);
    const uint32_t k_st = s_k + stage * T::KV_BYTES;
    const uint32_t v_st = s_v + stage * T::KV_BYTES;

    // S = Q K^T for the warpgroup's 64 rows x BK keys.
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int bx = kk * 16 / T::COLS;
      const int within = (kk * 16 % T::COLS) * 2;  // bytes into the row
      const uint64_t da = make_desc(
          s_q + bx * T::Q_BOX + wg * 64 * T::SW + within, 16, 8 * T::SW,
          T::LAYOUT);
      const uint64_t db = make_desc(k_st + bx * T::KV_BOX + within, 16,
                                    8 * T::SW, T::LAYOUT);
      wgmma_ss_n128(s, da, db, kk > 0);
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

    // O += P V: P (bf16) from the S fragment is the A operand directly.
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 keys down from kk*16; the NBOX column boxes lie KV_BOX apart.
      const uint64_t db = make_desc(v_st + kk * 16 * T::SW, T::KV_BOX,
                                    8 * T::SW, T::LAYOUT);
      wgmma_pv<HD>(o, a[kk], db);
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

// A 3-D map of a contiguous bf16 [bh, n, hd] tensor, boxes of
// [1, box_rows, cols] with the given swizzle; out-of-range rows read 0.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int n, int hd,
              int box_rows, int cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)n * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
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
template <int HD>
bool configured[MAX_DEVICES] = {};

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* pv,
                   void* m, void* l, int bh, int rows, int sq, int t,
                   long long q_off, long long k_off, float scale_log2,
                   cudaStream_t stream) {
  using T = Tiles<HD>;
  auto kernel = prefill_wgmma_kernel<HD>;
  cudaError_t err = set_smem_once(kernel, T::SMEM, configured<HD>);
  if (err != cudaSuccess) return err;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, rows, HD, BQ, T::COLS, swz))
    return cudaErrorInvalidValue;
  if (t == 0) {
    tk = tv = tq;  // an empty K/V has no address to map; no tile is loaded
  } else if (!make_map(&tk, k, bh, t, HD, BK, T::COLS, swz) ||
             !make_map(&tv, v, bh, t, HD, BK, T::COLS, swz)) {
    return cudaErrorInvalidValue;
  }
  dim3 grid((rows + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(pv), static_cast<float*>(m),
      static_cast<float*>(l), rows, sq, t, q_off, k_off, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// bh = b * kvh, rows = g * sq; every tensor contiguous and 16-byte
// aligned, q/k/v bf16, outputs f32.  scale_log2 = log2(e) / sqrt(hd).
// Returns the CUDA error of the launch (0 on success); the Python wrapper
// raises on anything else.
extern "C" int attention_prefill_fwd(const void* q, const void* k,
                                     const void* v, void* pv, void* m,
                                     void* l, int bh, int rows, int sq,
                                     int t, int hd, long long q_off,
                                     long long k_off, float scale_log2,
                                     void* stream) {
  if (bh <= 0 || rows <= 0 || sq <= 0 || t < 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch<32>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                             scale_log2, s);
    case 64:
      return (int)launch<64>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                             scale_log2, s);
    case 128:
      return (int)launch<128>(q, k, v, pv, m, l, bh, rows, sq, t, q_off,
                              k_off, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
