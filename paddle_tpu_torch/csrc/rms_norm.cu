// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, and the per-row
// r = rsqrt(mean(x^2) + eps) in f32; and its backward (below).
//
// Forward: replaces the Pallas kernel paddle_tpu/ops/pallas/rms_norm.py:59
// (_fwd_kernel, called from _fwd at :70). The Pallas kernel blocks 256
// rows per grid step; here one block owns one row and the row's
// reduction stays inside the block, so blocks need no order.
//
// Bound on the H100: bytes. At the serving path's shapes, (8, 1536) per
// decode step and (g * bucket, 1536) per prefill, it moves 2 bytes per
// element each way and does 4 flops per element, far under the ~295
// flop/byte ridge. At (8, 1536) the whole call moves ~50 KB, which the
// card streams in ~15 ns, so launch latency dominates. The design reads
// the row once for the sum of squares and once more (from L1) for the
// output, accumulates in f32 with a warp-shuffle then shared-memory
// reduction, and takes any D (1536 is not a power of two).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ r,
                    int d, float eps) {
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * d;
  __nv_bfloat16* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = __bfloat162float(xr[i]);
    ss += v * v;
  }
  ss = ptt::warp_sum(ss);
  __shared__ float partial[kThreads / 32];
  __shared__ float rstd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
    rstd = rsqrtf(total / static_cast<float>(d) + eps);
    r[row] = rstd;
  }
  __syncthreads();
  const float rs = rstd;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = __float2bfloat16(__bfloat162float(xr[i]) * rs *
                             __bfloat162float(w[i]));
  }
}

// Backward: replaces the Pallas kernel paddle_tpu/ops/pallas/rms_norm.py:100
// (_bwd_kernel, called from _bwd_call at :129). Per row,
//   dx = r * (g*w - x * r^2 * mean(g*w*x)),
// and over rows dw = sum g*x*r, db = sum g. The Pallas kernel adds dw/db
// across row blocks in grid order (:113-126); Hopper blocks run in no
// order, so each block owns a strip of rows and writes the strip's f32
// partial sums, and a second launch adds the strips per column in strip
// order: deterministic, no atomics. The strip's column sums live in
// shared memory, each column owned by one thread (no races); a row's
// mean(g*w*x) is a warp-shuffle then shared-memory sum.
//
// Bound on the H100: bytes. At the training shape (6144, 1536) it reads
// x and g and writes dx, 2 bytes each per element (56.6 MB, 16.9 us at
// 3.35 TB/s); the strips' partials add 2 * strips * d * 4 bytes each way
// (4.7 MB at 16-row strips). x and g are read twice per row, the second
// time from L1.
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ r,
                    const __nv_bfloat16* __restrict__ g,
                    __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ partial, int n, int d,
                    int strip_rows) {
  extern __shared__ float acc[];  // [2][d]: the strip's dw then db sums
  __shared__ float red[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * strip_rows;
  const int rows = min(strip_rows, n - row0);
  for (int i = threadIdx.x; i < d; i += kThreads) acc[i] = acc[d + i] = 0.f;
  for (int rr = 0; rr < rows; ++rr) {
    const size_t row = static_cast<size_t>(row0 + rr);
    const __nv_bfloat16* xr = x + row * d;
    const __nv_bfloat16* gr = g + row * d;
    const float rs = r[row];
    float part = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      part += __bfloat162float(gr[i]) * __bfloat162float(w[i]) *
              __bfloat162float(xr[i]);
    }
    part = ptt::warp_sum(part);
    // two slots, alternating by row: the slot written at row rr + 2 was
    // last read before every thread passed row rr + 1's barrier
    float* slot = red[rr & 1];
    if (lane == 0) slot[warp] = part;
    __syncthreads();
    float inner = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) inner += slot[i];
    inner /= static_cast<float>(d);
    __nv_bfloat16* dxr = dx + row * d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = __bfloat162float(xr[i]);
      const float gv = __bfloat162float(gr[i]);
      const float gw = gv * __bfloat162float(w[i]);
      dxr[i] = __float2bfloat16(rs * (gw - xv * (rs * rs) * inner));
      acc[i] += gv * xv * rs;
      acc[d + i] += gv;
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    out[i] = acc[i];
    out[d + i] = acc[d + i];
  }
}

// dw[i] = sum over strips of partial[s][0][i], db likewise, in strip order.
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_reduce_kernel(const float* __restrict__ partial, int strips,
                           int d, __nv_bfloat16* __restrict__ dw,
                           __nv_bfloat16* __restrict__ db) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  float sw = 0.f, sb = 0.f;
  for (int s = 0; s < strips; ++s) {
    const float* p = partial + static_cast<size_t>(s) * 2 * d;
    sw += p[i];
    sb += p[d + i];
  }
  dw[i] = __float2bfloat16(sw);
  db[i] = __float2bfloat16(sb);
}

}  // namespace

// x, y: (n, d) bf16 row-major; w: (d,) bf16; r: (n,) f32.
PTT_EXPORT int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                void* r, int n, int d, float eps,
                                void* stream) {
  rms_norm_fwd_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(r), d, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: (n, d) bf16 row-major; w, dw, db: (d,) bf16; r: (n,) f32;
// partial: (ceil(n / strip_rows), 2, d) f32 scratch.
PTT_EXPORT int ptt_rms_norm_bwd(const void* x, const void* w, const void* r,
                                const void* g, void* dx, void* dw, void* db,
                                void* partial, int n, int d, int strip_rows,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int strips = (n + strip_rows - 1) / strip_rows;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rms_norm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_bwd_kernel<<<strips, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(r),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(partial), n, d, strip_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_bwd_reduce_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                               st>>>(
      static_cast<const float*>(partial), strips, d,
      static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db));
  return static_cast<int>(cudaGetLastError());
}
