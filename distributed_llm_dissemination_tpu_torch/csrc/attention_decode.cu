// Split-KV decode attention for Hopper (sm_90a), bf16 in, f32 out.
//
// Replaces, for the few-query-row shapes of a decode step, the Pallas TPU
// kernel `_attn_kernel` (distributed_llm_dissemination_tpu/ops/
// flash_attention.py:128, launched by `_block_attention_pallas` :176
// through `pl.pallas_call` :229).  Same contract as every block-attention
// kernel of the port: for qg [b, kvh, g, sq, hd] and k, v [b, kvh, t, hd]
// with global start positions q_off / k_off, the UNNORMALISED f32 value
// sum pv [b, kvh, g, sq, hd] and the row max m and normaliser l
// [b, kvh, g, sq] of the causal softmax.  A row that sees no key gets
// (0, -1e30, 0).
//
// Bound on an H100 SXM: a decode step reads each visible K/V row once and
// does 4*hd operations per (query row, key); at g*sq = 4 rows that is
// about 4 operations per byte, far below the ~295 the tensor cores need,
// so the call is byte-bound (t = 2048, 8 KV heads, hd 128: 8 MiB of K/V,
// ~2.5 us at 3.35 TB/s).  So this kernel runs on the CUDA cores and what
// it gets right is bytes and occupancy:
//  - Split KV.  The grid is (b*kvh, n_split): the host splits the visible
//    keys [0, n_vis) into chunks so that about two CTAs sit on each SM,
//    and every CTA reads its chunk of K and V exactly once.  All g*sq
//    query rows of the KV head share that read; their q sits in
//    registers.
//  - 16-byte loads.  HD/8 lanes cover one key row (8 bf16 each), so a
//    warp reads 32/(HD/8) consecutive rows as one contiguous run; each
//    thread keeps U rows of K and V in flight in registers before it
//    uses the first.
//  - Partials.  Each lane group keeps its own online-softmax state over
//    the keys it reads; the CTA merges its groups through shared memory
//    and writes one (pv, m, l) partial per split.  A second small kernel
//    merges the splits with the formulas of `merge_partials`.  With one
//    split the first kernel writes the outputs directly and the merge is
//    not launched.  A split, or a whole call, that sees no key never
//    reads K/V and yields (0, -1e30, 0).
//  - Numerics: scores and p stay f32 (exp2 of log2e-scaled scores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;  // finite, as the TPU kernel's _NEG_INF
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One CTA = one (batch, KV head) x one chunk of keys.  NR >= rows is the
// padded query-row count (rows = g*sq); U keys per lane group per step.
template <int HD, int NR>
__global__ void __launch_bounds__(NTHREADS)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    float* __restrict__ part_pv, float* __restrict__ part_m,
                    float* __restrict__ part_l, int rows, int sq, int t,
                    int n_vis, int chunk, long long q_off, long long k_off,
                    float scale_log2) {
  constexpr int LPK = HD / 8;             // lanes per key row
  constexpr int KPW = 32 / LPK;           // key rows per warp per step
  constexpr int GROUPS = NWARPS * KPW;    // independent key streams
  constexpr int U = NR <= 4 ? 4 : 2;      // key rows in flight per thread
  __shared__ float sm_m[GROUPS][NR];
  __shared__ float sm_l[GROUPS][NR];
  __shared__ float sm_acc[GROUPS][NR][HD];

  const long long bh = blockIdx.x;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK;                 // this lane's 8 dims
  const int grp = warp * KPW + lane / LPK;    // this lane's key stream
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, n_vis);

  float qr[NR][8];
  long long qpos[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (bh * rows + r) * HD + sub * 8);
      unpack8(raw, qr[r]);
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[r][i] *= scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[r][i] = 0.f;
    }
    qpos[r] = q_off + (r < rows ? r % sq : 0);
  }

  float m[NR], l[NR], acc[NR][8];  // m in log2 units
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

  const __nv_bfloat16* kb = k + bh * (long long)t * HD + sub * 8;
  const __nv_bfloat16* vb = v + bh * (long long)t * HD + sub * 8;
  // Uniform trip count across the CTA: shuffles need every lane.
  const int span = max(c1 - c0, 0);
  const int n_iter = (span + GROUPS * U - 1) / (GROUPS * U);
  for (int it = 0; it < n_iter; ++it) {
    const int base = c0 + it * GROUPS * U + grp;
    uint4 kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * GROUPS;
      if (j < c1) {
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(kb + (long long)j * HD));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(vb + (long long)j * HD));
      } else {
        kraw[u] = make_uint4(0, 0, 0, 0);
        vraw[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][NR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kraw[u], kf);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qr[r][i], kf[i], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const int j = base + u * GROUPS;
        s[u][r] = (j < c1 && qpos[r] >= k_off + j) ? d : NEG_INF;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float mx = s[0][r];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      const float m_new = fmaxf(m[r], mx);
      // A row with nothing visible so far: p must be 0, not exp2(0) = 1.
      const bool live = m_new > NEG_INF / 2;
      const float alpha = live ? exp2f(m[r] - m_new) : 1.f;
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = live ? exp2f(s[u][r] - m_new) : 0.f;
        psum += p[u];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        unpack8(vraw[u], vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(p[u], vf[i], acc[r][i]);
      }
    }
  }

  // Merge the CTA's key streams.
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (sub == 0) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[grp][r][sub * 8 + i] = acc[r][i];
  }
  __syncthreads();
  const long long out_row0 = (bh * n_split + split) * rows;
  for (int idx = threadIdx.x; idx < rows * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD;
    float mm = NEG_INF;
    for (int gi = 0; gi < GROUPS; ++gi) mm = fmaxf(mm, sm_m[gi][r]);
    float o = 0.f, ll = 0.f;
    if (mm > NEG_INF / 2) {
      for (int gi = 0; gi < GROUPS; ++gi) {
        const float w = exp2f(sm_m[gi][r] - mm);
        o = fmaf(sm_acc[gi][r][d], w, o);
        ll = fmaf(sm_l[gi][r], w, ll);
      }
    }
    part_pv[(out_row0 + r) * HD + d] = o;
    if (d == 0) {
      part_m[out_row0 + r] = mm > NEG_INF / 2 ? mm * LN2 : NEG_INF;
      part_l[out_row0 + r] = ll;
    }
  }
}

// Block-wide reduction over HD threads (HD a multiple of 32): `red` is
// HD/32 floats of shared memory; every thread gets the result.
template <int HD, bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < HD / 32; ++i) x = MAX ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

// Merge the n_split partials of one (batch, KV head, query row) into
// (pv, m, l): one CTA of HD threads per row.  The split weights are
// computed once, in parallel, into shared memory; then each thread sums
// its dimension over the splits with 8 independent partial sums, so the
// loads of the partials are in flight together, not one after another.
template <int HD>
__global__ void __launch_bounds__(HD)
decode_merge_kernel(const float* __restrict__ part_pv,
                    const float* __restrict__ part_m,
                    const float* __restrict__ part_l, float* __restrict__ pv,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int rows, int n_split) {
  extern __shared__ float w[];  // [n_split]
  __shared__ float red[HD / 32];
  const long long bh = blockIdx.x;
  const int r = blockIdx.y, d = threadIdx.x;
  const long long pr0 = bh * n_split * rows + r;  // split s: pr0 + s * rows
  float mm = NEG_INF;
  for (int s = d; s < n_split; s += HD)
    mm = fmaxf(mm, part_m[pr0 + (long long)s * rows]);
  mm = block_reduce<HD, true>(mm, red);
  const bool live = mm > NEG_INF / 2;
  float ll = 0.f;
  for (int s = d; s < n_split; s += HD) {
    const long long pr = pr0 + (long long)s * rows;
    const float ws = live ? expf(part_m[pr] - mm) : 0.f;
    w[s] = ws;
    ll = fmaf(part_l[pr], ws, ll);
  }
  ll = block_reduce<HD, false>(ll, red);  // its barriers also publish w
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  int s = 0;
  for (; s + 8 <= n_split; s += 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = fmaf(part_pv[(pr0 + (long long)(s + i) * rows) * HD + d],
                    w[s + i], acc[i]);
  }
  for (; s < n_split; ++s)
    acc[0] = fmaf(part_pv[(pr0 + (long long)s * rows) * HD + d], w[s], acc[0]);
  float o = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o += acc[i];
  pv[(bh * rows + r) * HD + d] = o;
  if (d == 0) {
    m_out[bh * rows + r] = live ? mm : NEG_INF;
    l_out[bh * rows + r] = ll;
  }
}

struct Args {
  const void *q, *k, *v;
  void *pv, *m, *l, *ppv, *pm, *pl;
  int bh, rows, sq, t, n_vis, n_split, chunk;
  long long q_off, k_off;
  float scale_log2;
  cudaStream_t stream;
};

template <int HD, int NR>
cudaError_t launch(const Args& a) {
  decode_split_kernel<HD, NR><<<dim3(a.bh, a.n_split), NTHREADS, 0,
                                a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<float*>(a.ppv),
      static_cast<float*>(a.pm), static_cast<float*>(a.pl), a.rows, a.sq,
      a.t, a.n_vis, a.chunk, a.q_off, a.k_off, a.scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  decode_merge_kernel<HD><<<dim3(a.bh, a.rows), HD,
                            a.n_split * (int)sizeof(float), a.stream>>>(
      static_cast<const float*>(a.ppv), static_cast<const float*>(a.pm),
      static_cast<const float*>(a.pl), static_cast<float*>(a.pv),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.rows,
      a.n_split);
  return cudaGetLastError();
}

// Rows are padded to 4 or 8: the padded rows' arithmetic is cheap next to
// the K/V bytes every row shares.
template <int HD>
cudaError_t dispatch_rows(const Args& a) {
  if (a.rows <= 4) return launch<HD, 4>(a);
  if (a.rows <= 8) return launch<HD, 8>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// bh = b * kvh, rows = g * sq (at most 8); every tensor contiguous and
// 16-byte aligned.  The visible keys [0, n_vis) are cut into n_split
// chunks of `chunk` keys.  With n_split > 1, ppv/pm/pl are f32 scratch of
// [bh, n_split, rows, hd] / [bh, n_split, rows]; with n_split == 1 they
// must be pv/m/l themselves.  Returns the CUDA error of the launches (0 on
// success); the Python wrapper raises on anything else.
extern "C" int attention_decode_fwd(const void* q, const void* k,
                                    const void* v, void* pv, void* m,
                                    void* l, void* ppv, void* pm, void* pl,
                                    int bh, int rows, int sq, int t, int hd,
                                    int n_vis, int n_split, int chunk,
                                    long long q_off, long long k_off,
                                    float scale_log2, void* stream) {
  if (bh <= 0 || rows <= 0 || sq <= 0 || t < 0 || n_split <= 0 ||
      n_split > 4096 || n_vis < 0 || n_vis > t ||
      (long long)n_split * chunk < n_vis)
    return (int)cudaErrorInvalidValue;
  if (n_split == 1 && (ppv != pv || pm != m || pl != l))
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,       v,     pv,     m,   l,     ppv,
               pm,    pl,      bh,    rows,   sq,  t,     n_vis,
               n_split, chunk, q_off, k_off, scale_log2,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: return (int)dispatch_rows<32>(a);
    case 64: return (int)dispatch_rows<64>(a);
    case 128: return (int)dispatch_rows<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
