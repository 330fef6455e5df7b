// Blockwise causal GQA partial attention for Hopper (sm_90a), f32 inputs.
//
// Replaces, for f32 inputs, the Pallas TPU kernel `_attn_kernel`
// (distributed_llm_dissemination_tpu/ops/flash_attention.py:128, launched by
// `_block_attention_pallas` :176 through `pl.pallas_call` :229).  Same
// function, same contract: for qg [b, kvh, g, sq, hd] and k, v [b, kvh, t, hd]
// with global start positions q_off / k_off, write the UNNORMALISED f32 value
// sum pv [b, kvh, g, sq, hd] plus the row max m and normaliser l
// [b, kvh, g, sq] of the causal softmax over this KV block.  A row that sees
// no key gets (0, -1e30, 0).  The caller normalises (pv / l) or merges
// partials (merge_partials, ring attention).
//
// The port's bf16 calls (the whole serving path) go to the split-KV decode
// kernel (attention_decode.cu) or the tensor-core prefill kernel
// (attention_prefill.cu); the wrapper picks by (sq, g, dtype).  f32 inputs,
// which only the JAX package's test offsets bring, come here: bf16 tensor
// cores would round them.
//
// Bounds on an H100 SXM (67 TFLOP/s f32 without tensor cores, 3.35 TB/s
// HBM): prefill is operation-bound, a decode step byte-bound.
//
// Design:
//  - The Pallas grid's sequential "arbitrary" KV axis becomes a loop inside
//    the CTA: one CTA owns a tile of BQ query rows of one (batch, KV head)
//    and streams KV tiles of BK keys through shared memory, keeping the
//    online-softmax state (m, l) and the f32 accumulator in registers.
//  - The query rows of one (batch, KV head) are its g*sq rows [g, sq]
//    flattened, so the g query heads that share a KV head share a CTA and
//    read that head's K/V once.
//  - KV tiles wholly in the future of every row of the CTA are never loaded
//    (the `q_lo + tile_q - 1 >= k_lo` test of the TPU kernel, :143): the loop
//    stops at the first such tile, which halves causal prefill work.
//  - Ragged edges (rows past g*sq, keys past t) are masked in the kernel, so
//    any sq and t are accepted; hd is a template parameter (32, 64, 128).
//  - Arithmetic is scalar f32 FMA from shared memory (padded rows, no bank
//    conflicts).

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;        // query rows per CTA
constexpr int BK = 32;        // keys per KV tile
constexpr int NTHREADS = 128; // 4 threads per query row
constexpr float NEG_INF = -1e30f;  // finite, as the TPU kernel's _NEG_INF
constexpr int MAX_DEVICES = 64;

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
block_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ pv,
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

  const float* qb = q + bh * rows * HD;
  const float* kb = k + bh * (long long)t * HD;
  const float* vb = v + bh * (long long)t * HD;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int gr = r0 + r;
    Qs[r * (HD + 1) + d] = gr < rows ? qb[(long long)gr * HD + d] : 0.f;
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
      Ks[r * (HD + 1) + d] = ok ? kb[(long long)key * HD + d] : 0.f;
      Vs[r * HD + d] = ok ? vb[(long long)key * HD + d] : 0.f;
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
                   long long q_off, long long k_off, float sqrt_hd,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kernel = block_attention_kernel<HD>;
  cudaError_t err = set_smem_once(kernel, smem, configured<HD>);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + BQ - 1) / BQ, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(pv),
      static_cast<float*>(m), static_cast<float*>(l), rows, sq, t, q_off,
      k_off, sqrt_hd);
  return cudaGetLastError();
}

}  // namespace

// bh = b * kvh, rows = g * sq; every tensor f32 and contiguous in the
// layouts above.  Returns the CUDA error of the launch (0 on success); the
// Python wrapper raises on anything else.
extern "C" int block_attention_fwd(const void* q, const void* k, const void* v,
                                   void* pv, void* m, void* l, int bh,
                                   int rows, int sq, int t, int hd,
                                   long long q_off, long long k_off,
                                   float sqrt_hd, void* stream) {
  if (bh <= 0 || rows <= 0 || sq <= 0 || t < 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch<32>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                             sqrt_hd, s);
    case 64:
      return (int)launch<64>(q, k, v, pv, m, l, bh, rows, sq, t, q_off, k_off,
                             sqrt_hd, s);
    case 128:
      return (int)launch<128>(q, k, v, pv, m, l, bh, rows, sq, t, q_off,
                              k_off, sqrt_hd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
