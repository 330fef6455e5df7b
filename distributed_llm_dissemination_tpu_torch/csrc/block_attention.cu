// Blockwise causal GQA partial attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (distributed_llm_dissemination_tpu/ops/flash_attention.py:128, launched by
// `_block_attention_pallas` :176 through `pl.pallas_call` :229).  Same
// function, same contract: for qg [b, kvh, g, sq, hd] and k, v [b, kvh, t, hd]
// (f32 or bf16) with global start positions q_off / k_off, write the
// UNNORMALISED f32 value sum pv [b, kvh, g, sq, hd] plus the row max m and
// normaliser l [b, kvh, g, sq] of the causal softmax over this KV block.  A
// row that sees no key gets (0, -1e30, 0).  The caller normalises (pv / l) or
// merges partials (merge_partials, ring attention).
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//  - prefill, b=1, s=2048, 32 heads, hd 128, causal: 4*s*s*hd*heads/2
//    = 34.4 GFLOP -> ~35 us at the tensor-core peak; operation-bound.
//  - decode step, sq=1, t=2048: K and V of 8 KV heads at hd 128 in bf16 are
//    8 MiB per layer -> ~2.5 us at the HBM rate; byte-bound.
//
// Design, and what it does about those bounds:
//  - The Pallas grid's sequential "arbitrary" KV axis becomes a loop inside
//    the CTA: one CTA owns a tile of BQ query rows of one (batch, KV head)
//    and streams KV tiles of BK keys through shared memory, keeping the
//    online-softmax state (m, l) and the f32 accumulator in registers.
//  - The query rows of one (batch, KV head) are its g*sq rows [g, sq]
//    flattened, so when sq >= BQ a CTA is one (b*kvh*g, Q tile) as on the
//    TPU, and when sq < BQ (decode: sq == 1) the g query heads that share a
//    KV head share one CTA and read that head's K/V once instead of g times
//    -- the decode step is byte-bound, so K/V bytes are what matter there.
//  - KV tiles wholly in the future of every row of the CTA are never loaded
//    (the `q_lo + tile_q - 1 >= k_lo` test of the TPU kernel, :143): the loop
//    stops at the first such tile, which halves causal prefill work.
//  - Ragged edges (rows past g*sq, keys past t) are masked in the kernel, so
//    any sq and t are accepted; hd is a template parameter (32, 64, 128).
//  - Arithmetic is scalar f32 FMA from shared memory (padded rows, no bank
//    conflicts).  This first version does not use the tensor cores, so it
//    sits far from the 35 us prefill bound; mma/wgmma tiles and a split-K
//    decode that fills all 132 SMs are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;        // query rows per CTA
constexpr int BK = 32;        // keys per KV tile
constexpr int NTHREADS = 128; // 4 threads per query row
constexpr float NEG_INF = -1e30f;  // finite, as the TPU kernel's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
block_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ pv,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int rows, int sq, int t, long long q_off,
                       long long k_off, float sqrt_hd) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);         // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);         // [BK][HD]
  float* Ps = Vs + BK * HD;               // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;   // this thread's query row in the tile
  const int quad = tid & 3;   // its quarter of the row's keys / columns
  const long long bh = blockIdx.y;
  const int r0 = blockIdx.x * BQ;
  const int r_last = min(r0 + BQ, rows) - 1;

  const T* qb = q + bh * rows * HD;
  const T* kb = k + bh * (long long)t * HD;
  const T* vb = v + bh * (long long)t * HD;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int gr = r0 + r;
    Qs[r * (HD + 1) + d] = gr < rows ? to_f32(qb[(long long)gr * HD + d]) : 0.f;
  }

  // Latest position among the tile's rows: rows are [g, sq] flattened.
  const int last_local = (r0 / sq != r_last / sq) ? sq - 1 : r_last % sq;
  const long long max_qpos = q_off + last_local;
  const int my_row = r0 + row;
  const bool row_ok = my_row < rows;
  const long long qpos = q_off + (row_ok ? my_row % sq : 0);

  float o[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) o[j] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  const int n_tiles = (t + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const long long k_lo = k_off + (long long)kt * BK;
    if (k_lo > max_qpos) break;  // this and every later tile is in the future
    __syncthreads();             // previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD, d = i % HD;
      const int key = kt * BK + r;
      const bool ok = key < t;
      Ks[r * (HD + 1) + d] = ok ? to_f32(kb[(long long)key * HD + d]) : 0.f;
      Vs[r * HD + d] = ok ? to_f32(vb[(long long)key * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[row * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        s[j] += qv * Ks[(quad + 4 * j) * (HD + 1) + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int key = kt * BK + quad + 4 * j;
      const long long kpos = k_off + key;
      s[j] = (key < t && qpos >= kpos) ? s[j] / sqrt_hd : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    // A row whose visible keys all lie beyond this tile: p must be 0, not
    // exp(-1e30 - -1e30) = 1 (the TPU kernel's where(m_new > NEG_INF / 2)).
    const bool live = m_new > NEG_INF / 2;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float p = live ? expf(s[j] - m_new) : 0.f;
      psum += p;
      Ps[row * (BK + 1) + quad + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) o[j] *= alpha;
    __syncthreads();

#pragma unroll 4
    for (int kc = 0; kc < BK; ++kc) {
      const float p = Ps[row * (BK + 1) + kc];
#pragma unroll
      for (int j = 0; j < HD / 4; ++j) o[j] += p * Vs[kc * HD + quad + 4 * j];
    }
  }

  if (row_ok) {
    float* pvb = pv + (bh * rows + my_row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) pvb[quad + 4 * j] = o[j];
    if (quad == 0) {
      m_out[bh * rows + my_row] = m_i;
      l_out[bh * rows + my_row] = l_i;
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* pv,
                   void* m, void* l, int bh, int rows, int sq, int t,
                   long long q_off, long long k_off, float sqrt_hd,
                   cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kernel = block_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(pv),
      static_cast<float*>(m), static_cast<float*>(l), rows, sq, t, q_off,
      k_off, sqrt_hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* pv, void* m, void* l, int bh, int rows, int sq,
                        int t, long long q_off, long long k_off, float sqrt_hd,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                           sqrt_hd, stream);
    case 64:
      return launch<T, 64>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                           sqrt_hd, stream);
    case 128:
      return launch<T, 128>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                            sqrt_hd, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bh = b * kvh, rows = g * sq; every tensor contiguous in the layouts above.
// is_bf16: 1 for bf16 q/k/v, 0 for f32.  Returns the CUDA error of the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int block_attention_fwd(const void* q, const void* k, const void* v,
                                   void* pv, void* m, void* l, int bh,
                                   int rows, int sq, int t, int hd,
                                   long long q_off, long long k_off,
                                   float sqrt_hd, int is_bf16, void* stream) {
  if (bh <= 0 || rows <= 0 || sq <= 0 || t < 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, pv, m, l, bh, rows, sq,
                                           t, q_off, k_off, sqrt_hd, s)
              : dispatch_hd<float>(hd, q, k, v, pv, m, l, bh, rows, sq, t,
                                   q_off, k_off, sqrt_hd, s);
  return (int)err;
}
