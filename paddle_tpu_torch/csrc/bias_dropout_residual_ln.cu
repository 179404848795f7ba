// Bias + dropout + residual + LayerNorm forward:
//   z = (x + bias) * mask * keep + res     (mask and keep only when training
//                                           with rate > 0; keep = 1/(1-rate))
//   y = (z - mean(z)) * rsqrt(var(z) + eps) * scale + lnb
// with the per-row mean and rstd = rsqrt(var + eps) written as f32.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/fused_ops.py:112
// (_bdrln_kernel, called from _bdrln_fwd_call at :138). Same function in
// f32 and the same order of operations: x + bias, times the mask, times
// keep, plus res; the mean, then the two-pass variance mean((z - mean)^2)
// (never E[z^2] - mean^2); y in x's dtype. The dropout mask is drawn
// outside the kernel, as in JAX, but as one byte per element (JAX draws
// it as f32). The Pallas kernel blocks 8-256 rows per grid step; here one
// warp owns one row, so the row's sums are warp shuffles, no shared memory
// or barrier is needed, and blocks need no order.
//
// Bound on the H100: bytes. At the (4096, 768) bf16 shape of BERT-base at
// batch 32 x 128 in training it reads x, res and the mask and writes y:
// 3 * 6.29 MB + 3.15 MB = 22.0 MB, 6.6 us at 3.35 TB/s, against ~11
// flops per element (0.03 GFLOP). Two paths, both one warp per row:
// - registers (H % 8 == 0, every row 16-byte aligned, H <= 4096): each
//   lane loads 8 consecutive elements at once (16 bytes of bf16) and holds
//   the row's z, at most kMaxVectors * 8 = 128 values a lane, so the
//   variance and output passes read no memory again;
// - generic (any other H or alignment): the lanes stride the row one
//   element at a time and recompute z in each of the three passes, the
//   re-reads served from L1/L2.
// Both form each z with the same operations in the same order; their row
// sums add in different orders.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;       // rows per block
constexpr int kVec = 8;         // elements a lane loads at once
constexpr int kMaxVectors = 16;  // register path: H <= 16 * 32 * 8 = 4096

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// 8 consecutive values as floats; p is 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 elements of a (H,) parameter, bf16 or f32 as the flag says, as f32.
__device__ __forceinline__ void load_param8(const void* p, bool bf16, int e,
                                            float* o) {
  if (bf16) load8(static_cast<const __nv_bfloat16*>(p) + e, o);
  else load8(static_cast<const float*>(p) + e, o);
}

__device__ __forceinline__ float load_param1(const void* p, bool bf16,
                                             int e) {
  return bf16 ? load1(static_cast<const __nv_bfloat16*>(p) + e)
              : load1(static_cast<const float*>(p) + e);
}

// Register path. Lane `lane` of the row's warp owns elements
// (v * 32 + lane) * 8 + j, v < NV, j < 8; a vector exists when its first
// element is < h (h % 8 == 0, so a vector is all in or all out).
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
bdrln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const void* __restrict__ bias,
                 const void* __restrict__ scale,
                 const void* __restrict__ lnb,
                 const uint8_t* __restrict__ mask, T* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int rows, int h, int param_bf16, int use_mask, float keep,
                 float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // no block-wide barrier below
  const long long base = row * h;
  const bool bias16 = param_bf16 & 1, scale16 = param_bf16 & 2,
             lnb16 = param_bf16 & 4;

  float z[NV][kVec];
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = (v * 32 + lane) * kVec;
    if (e >= h) continue;
    float xb[kVec], b[kVec], r[kVec];
    load8(x + base + e, xb);
    load_param8(bias, bias16, e, b);
    load8(res + base + e, r);
    uint2 mu = make_uint2(0u, 0u);
    if (use_mask) mu = *reinterpret_cast<const uint2*>(mask + base + e);
    const uint8_t* m = reinterpret_cast<const uint8_t*>(&mu);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float t = xb[j] + b[j];
      if (use_mask) t = t * static_cast<float>(m[j]) * keep;
      z[v][j] = t + r[j];
      sum += z[v][j];
    }
  }
  const float mean = ptt::warp_sum(sum) / static_cast<float>(h);
  float sq = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if ((v * 32 + lane) * kVec >= h) continue;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = z[v][j] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(ptt::warp_sum(sq) / static_cast<float>(h) + eps);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = (v * 32 + lane) * kVec;
    if (e >= h) continue;
    float s[kVec], lb[kVec], out[kVec];
    load_param8(scale, scale16, e, s);
    load_param8(lnb, lnb16, e, lb);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = (z[v][j] - mean) * rstd * s[j] + lb[j];
    store8(y + base + e, out);
  }
}

// Generic path: any h and alignment. The lanes stride the row and
// recompute z = (x + bias) * mask * keep + res in each pass.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bdrln_fwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const void* __restrict__ bias,
                         const void* __restrict__ scale,
                         const void* __restrict__ lnb,
                         const uint8_t* __restrict__ mask,
                         T* __restrict__ y, float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int rows, int h,
                         int param_bf16, int use_mask, float keep,
                         float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const long long base = row * h;
  const bool bias16 = param_bf16 & 1, scale16 = param_bf16 & 2,
             lnb16 = param_bf16 & 4;
  auto zf = [&](int e) {
    float t = load1(x + base + e) + load_param1(bias, bias16, e);
    if (use_mask) t = t * static_cast<float>(mask[base + e]) * keep;
    return t + load1(res + base + e);
  };
  float sum = 0.f;
  for (int e = lane; e < h; e += 32) sum += zf(e);
  const float mean = ptt::warp_sum(sum) / static_cast<float>(h);
  float sq = 0.f;
  for (int e = lane; e < h; e += 32) {
    const float d = zf(e) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(ptt::warp_sum(sq) / static_cast<float>(h) + eps);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  for (int e = lane; e < h; e += 32) {
    store1(y + base + e, (zf(e) - mean) * rstd * load_param1(scale, scale16, e)
                             + load_param1(lnb, lnb16, e));
  }
}

template <typename T, int NV>
cudaError_t launch(const void* x, const void* res, const void* bias,
                   const void* scale, const void* lnb, const void* mask,
                   void* y, void* mean, void* rstd, int rows, int h,
                   int param_bf16, int use_mask, float keep, float eps,
                   cudaStream_t st) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  bdrln_fwd_kernel<T, NV><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), bias, scale, lnb,
      static_cast<const uint8_t*>(mask), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, h,
      param_bf16, use_mask, keep, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, const void* x, const void* res,
                     const void* bias, const void* scale, const void* lnb,
                     const void* mask, void* y, void* mean, void* rstd,
                     int rows, int h, int param_bf16, int use_mask,
                     float keep, float eps, cudaStream_t st) {
  const int nv = (h + 32 * kVec - 1) / (32 * kVec);
  if (!vec || nv > kMaxVectors) {
    bdrln_fwd_generic_kernel<T><<<(rows + kWarps - 1) / kWarps, kWarps * 32,
                                  0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), bias, scale,
        lnb, static_cast<const uint8_t*>(mask), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, h,
        param_bf16, use_mask, keep, eps);
    return cudaGetLastError();
  }
#define PTT_BDRLN_CASE(N)                                                   \
  if (nv <= N)                                                              \
    return launch<T, N>(x, res, bias, scale, lnb, mask, y, mean, rstd, rows, \
                        h, param_bf16, use_mask, keep, eps, st);
  PTT_BDRLN_CASE(1)
  PTT_BDRLN_CASE(2)
  PTT_BDRLN_CASE(3)
  PTT_BDRLN_CASE(4)
  PTT_BDRLN_CASE(6)
  PTT_BDRLN_CASE(8)
  PTT_BDRLN_CASE(12)
  PTT_BDRLN_CASE(kMaxVectors)
#undef PTT_BDRLN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, res, y: (rows, h) row-major, bf16 when x_bf16 else f32; bias, scale,
// lnb: (h,), each bf16 or f32 as bits 0, 1, 2 of param_bf16 say; mask:
// (rows, h) bytes, read only when use_mask; mean, rstd: (rows,) f32. vec
// (the caller's promise): h % 8 == 0, x, res, y, bias, scale and lnb
// 16-byte aligned and the mask 8-byte aligned; with h <= 4096 it takes
// the register path.
PTT_EXPORT int ptt_bdrln_fwd(const void* x, const void* res, const void* bias,
                             const void* scale, const void* lnb,
                             const void* mask, void* y, void* mean,
                             void* rstd, int rows, int h, int x_bf16,
                             int param_bf16, int use_mask, float keep,
                             float eps, int vec, void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? dispatch<__nv_bfloat16>(vec, x, res, bias, scale, lnb, mask,
                                       y, mean, rstd, rows, h, param_bf16,
                                       use_mask, keep, eps, st)
             : dispatch<float>(vec, x, res, bias, scale, lnb, mask, y, mean,
                               rstd, rows, h, param_bf16, use_mask, keep, eps,
                               st);
  return static_cast<int>(err);
}
