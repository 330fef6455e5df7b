// Wire-blob dequantization for Hopper (sm_90a): K2 (int8) and K3 (int4) of
// the port.
//
// Replaces the JAX package's XLA programs `_decode_qblobs_impl` (int8,
// distributed_llm_dissemination_tpu/models/quant.py:276) and
// `_decode_q4blobs_impl` (int4, :305), jitted at :352-363 and dispatched by
// `device_decode_jit` (:478).  They are not Pallas, but they are the only
// device compute of the codec path, so the port writes them by hand.
//
// What they compute.  A wire blob holds its leaves in spec order, a leaf of
// shape (..., cols) flattened to (rows, cols):
//  - int8 ("q8" sections): `rows` f32 scales, then `rows x cols` int8
//    values; element (r, c) is `float(q[r, c]) * scale[r]`;
//  - int4: either a "q4" section, `rows x groups` f32 scales then
//    `rows x cols/2` packed bytes -- byte j of a row holds column j in its
//    low nibble and column j + cols/2 in its high nibble, and element (r, c)
//    is `float(nibble - 8) * scale[r, c / g]` with g = cols / groups -- or
//    a "raw" section (1-D leaves, odd cols): the leaf's bytes in the output
//    type, copied as they are.
// Every product is rounded once to the output type (bf16 or f16 by
// round-to-nearest-even, f16 with its subnormals and overflow to inf, or
// f32 as is): bit-identical to JAX's `(q.astype(f32) * scale).astype(dt)`.
//
// Bound on an H100 SXM: bytes.  One blob is read once and its leaves
// written once; a llama3-8b layer blob is 218 MB (int8) or 116 MB (int4) in
// and 436 MB of bf16 out: 0.195 / 0.165 ms at 3.35 TB/s.  One multiply per
// element is nothing beside that.
//
// Design:
//  - One launch per wire blob.  A small leaf table, passed by value as a
//    kernel parameter (so a launch needs no copy of its own and can be
//    captured in a CUDA graph), gives each leaf's offsets in the blob and
//    the address of its output: the wrapper points that at slot i of a
//    preallocated (n, *shape) tensor, so no stack copy follows.
//  - A work item is a run of RUN = 16 consecutive int8 values, packed int4
//    bytes or raw bytes of one row, counted across the leaves; a grid-stride
//    loop hands consecutive runs to consecutive threads, so loads and stores
//    coalesce.  An int4 run writes 16 low-nibble elements (columns j..j+15)
//    and 16 high-nibble ones (cols/2 + j..), both contiguous.
//  - An int8 row shares one scale.  An int4 scale group changes inside a
//    run only where the run crosses a multiple of g; the run tracks that
//    boundary instead of dividing per element.
//  - Nothing in the format aligns a leaf: its scale block starts wherever
//    the earlier leaves ended.  Scales are assembled from their 4 bytes, and
//    loads and stores take a 16-byte vector, 4-byte words or single
//    elements, whichever the address allows.  No path assumes an alignment
//    it did not test.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 16;  // a MoE layer blob has 10 leaves
constexpr int RUN = 16;         // values, packed bytes or raw bytes per item
constexpr int NTHREADS = 256;
constexpr int FIELDS = 10;      // int64 fields per leaf in the host table
constexpr int LAYOUT_Q8 = 0;
constexpr int LAYOUT_Q4 = 1;
constexpr int LAYOUT_RAW = 2;

struct Leaf {
  long long scale_off;   // byte offset of the f32 scales (raw: of the bytes)
  long long data_off;    // byte offset of the int8 values or packed bytes
  long long item_begin;  // first work item of the leaf
  long long dst;         // address of the leaf's output element (0, 0)
  long long nbytes;      // raw: bytes to copy
  int layout;
  int rows, cols;
  int groups;            // q4: scale groups per row
  int runs_per_row;      // q8: ceil(cols / RUN); q4: ceil((cols / 2) / RUN)
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n;
  long long items;
};

__device__ __forceinline__ float load_f32(const uint8_t* p) {
  uint32_t u = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return __uint_as_float(u);
}

// n (1..RUN) bytes at p into w[0..4), little-endian; bytes past n are 0.
__device__ __forceinline__ void load_run(const uint8_t* p, int n,
                                         uint32_t (&w)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == RUN && (a & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if (n == RUN && (a & 3) == 0) {
    const uint32_t* p32 = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(p32 + i);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0;
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
  }
}

// w[0..4) (n bytes) to p[0..n).
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t (&w)[4],
                                            int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == RUN && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (n == RUN && (a & 3) == 0) {
    uint32_t* p32 = reinterpret_cast<uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) p32[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) p[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// v[0..n) to dst[0..n), rounded to the output type.
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float (&v)[RUN],
                                          int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == RUN && (a & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    d[1] = make_uint4(pack_bf16(v[8], v[9]), pack_bf16(v[10], v[11]),
                      pack_bf16(v[12], v[13]), pack_bf16(v[14], v[15]));
  } else if (n == RUN && (a & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < RUN / 2; ++i) d[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) dst[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  return (uint32_t)__half_as_ushort(__float2half_rn(lo)) |
         ((uint32_t)__half_as_ushort(__float2half_rn(hi)) << 16);
}

__device__ __forceinline__ void store_run(__half* dst, const float (&v)[RUN],
                                          int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == RUN && (a & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(pack_f16(v[0], v[1]), pack_f16(v[2], v[3]),
                      pack_f16(v[4], v[5]), pack_f16(v[6], v[7]));
    d[1] = make_uint4(pack_f16(v[8], v[9]), pack_f16(v[10], v[11]),
                      pack_f16(v[12], v[13]), pack_f16(v[14], v[15]));
  } else if (n == RUN && (a & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < RUN / 2; ++i) d[i] = pack_f16(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) dst[i] = __float2half_rn(v[i]);
  }
}

__device__ __forceinline__ void store_run(float* dst, const float (&v)[RUN],
                                          int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == RUN && (a & 15) == 0) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = 0; i < RUN / 4; ++i)
      d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) dst[i] = v[i];
  }
}

// One int8 run: the n values at column j0 of row r.
template <typename OUT>
__device__ __forceinline__ void decode_q8(const uint8_t* blob, const Leaf& L,
                                          uint32_t local) {
  const uint32_t r = local / (uint32_t)L.runs_per_row;
  const int j0 = (int)(local - r * (uint32_t)L.runs_per_row) * RUN;
  const int n = min(RUN, L.cols - j0);
  const long long e0 = (long long)r * L.cols + j0;
  const float scale = load_f32(blob + L.scale_off + 4LL * r);
  uint32_t w[4];
  load_run(blob + L.data_off + e0, n, w);
  float v[RUN];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int8_t q = (int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xFF);
    v[i] = (float)q * scale;
  }
  store_run(reinterpret_cast<OUT*>(L.dst) + e0, v, n);
}

// The n values of one half (shift 0: low nibbles, 4: high) of an int4 run
// whose first element is column c of the row whose scales start at
// `scales`.  Only the first n columns exist, so only they may reach for a
// scale.
__device__ __forceinline__ void decode_half(const uint8_t* scales,
                                            const uint32_t (&w)[4], int shift,
                                            int c, int n, int g,
                                            float (&v)[RUN]) {
  int gi = c / g;
  int next = (gi + 1) * g;  // first column of the next group
  float scale = load_f32(scales + 4LL * gi);
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    if (i < n && c + i >= next) {  // the next group (g may be < RUN)
      gi = (c + i) / g;
      next = (gi + 1) * g;
      scale = load_f32(scales + 4LL * gi);
    }
    const int nib = (int)((w[i >> 2] >> (8 * (i & 3) + shift)) & 0xF);
    v[i] = (float)(nib - 8) * scale;
  }
}

// One int4 run: the n packed bytes at byte j0 of row r, both halves.
template <typename OUT>
__device__ __forceinline__ void decode_q4(const uint8_t* blob, const Leaf& L,
                                          uint32_t local) {
  const uint32_t r = local / (uint32_t)L.runs_per_row;
  const int j0 = (int)(local - r * (uint32_t)L.runs_per_row) * RUN;
  const int c2 = L.cols / 2;
  const int n = min(RUN, c2 - j0);
  uint32_t w[4];
  load_run(blob + L.data_off + (long long)r * c2 + j0, n, w);
  const uint8_t* scales = blob + L.scale_off + 4LL * r * L.groups;
  const int g = L.cols / L.groups;
  OUT* row = reinterpret_cast<OUT*>(L.dst) + (long long)r * L.cols;
  float v[RUN];
  decode_half(scales, w, 0, j0, n, g, v);
  store_run(row + j0, v, n);
  decode_half(scales, w, 4, c2 + j0, n, g, v);
  store_run(row + c2 + j0, v, n);
}

// One raw run: RUN bytes (fewer at the leaf's end) copied as they are.
__device__ __forceinline__ void copy_raw(const uint8_t* blob, const Leaf& L,
                                         long long local) {
  const long long off = local * RUN;
  const int n = (int)min((long long)RUN, L.nbytes - off);
  uint32_t w[4];
  load_run(blob + L.scale_off + off, n, w);
  store_bytes(reinterpret_cast<uint8_t*>(L.dst) + off, w, n);
}

// KIND: LAYOUT_Q8 for K2; LAYOUT_Q4 for K3, whose tables mix q4 and raw.
template <int KIND, typename OUT>
__global__ void __launch_bounds__(NTHREADS)
dequant_kernel(const uint8_t* __restrict__ blob,
               const __grid_constant__ Table table) {
  __shared__ Leaf leaves[MAX_LEAVES];
  for (int i = threadIdx.x; i < table.n; i += blockDim.x)
    leaves[i] = table.leaf[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  int li = 0;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       item < table.items; item += stride) {
    // Items only grow along the loop, so the leaf index only moves forward.
    while (li + 1 < table.n && item >= leaves[li + 1].item_begin) ++li;
    const Leaf& L = leaves[li];
    const long long local = item - L.item_begin;
    if (KIND == LAYOUT_Q8)
      decode_q8<OUT>(blob, L, (uint32_t)local);
    else if (L.layout == LAYOUT_RAW)
      copy_raw(blob, L, local);
    else
      decode_q4<OUT>(blob, L, (uint32_t)local);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}

template <int KIND>
int launch(const void* blob, const long long* geo, int n_leaves,
           long long items, int out_kind, void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES || items <= 0)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.n = n_leaves;
  t.items = items;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* g = geo + (long long)i * FIELDS;
    Leaf& L = t.leaf[i];
    L.layout = (int)g[0];
    L.scale_off = g[1];
    L.data_off = g[2];
    L.item_begin = g[3];
    L.dst = g[4];
    L.nbytes = g[5];
    L.rows = (int)g[6];
    L.cols = (int)g[7];
    L.groups = (int)g[8];
    L.runs_per_row = (int)g[9];
    const bool ok = KIND == LAYOUT_Q8
                        ? L.layout == LAYOUT_Q8
                        : (L.layout == LAYOUT_Q4 || L.layout == LAYOUT_RAW);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  long long blocks = (items + NTHREADS - 1) / NTHREADS;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(blob);
  if (out_kind == 0)
    dequant_kernel<KIND, __nv_bfloat16><<<(int)blocks, NTHREADS, 0, s>>>(b, t);
  else if (out_kind == 1)
    dequant_kernel<KIND, float><<<(int)blocks, NTHREADS, 0, s>>>(b, t);
  else if (out_kind == 2)
    dequant_kernel<KIND, __half><<<(int)blocks, NTHREADS, 0, s>>>(b, t);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// blob: the wire blob on the device.  geo: n_leaves * FIELDS host int64
// values per leaf, in order: layout (0 q8, 1 q4, 2 raw), scale_off,
// data_off, item_begin, dst, nbytes, rows, cols, groups, runs_per_row (the
// Python wrapper computes them from the leaf table and checks them against
// the blob and the outputs).  items: the total work items.  out_kind:
// 0 = bf16, 1 = f32, 2 = f16.  Each returns the CUDA error of the launch (0 on
// success); the wrapper raises on anything else.
extern "C" int dequant_int8_launch(const void* blob, const long long* geo,
                                   int n_leaves, long long items,
                                   int out_kind, void* stream) {
  return launch<LAYOUT_Q8>(blob, geo, n_leaves, items, out_kind, stream);
}

extern "C" int dequant_int4_launch(const void* blob, const long long* geo,
                                   int n_leaves, long long items,
                                   int out_kind, void* stream) {
  return launch<LAYOUT_Q4>(blob, geo, n_leaves, items, out_kind, stream);
}
