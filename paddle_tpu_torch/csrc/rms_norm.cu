// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w + b, and the
// per-row r = rsqrt(mean(x^2) + eps) in f32; and its backward (below).
//
// Forward: replaces the Pallas kernel paddle_tpu/ops/pallas/rms_norm.py:59
// (_fwd_kernel, called from _fwd at :77), bias (has_bias) included. The
// Pallas kernel blocks 256 rows per grid step; here one warp owns one row
// and a block holds up to 8 rows (fewer where 8 would leave SMs without a
// block: the decode step's 8 rows take 8 SMs), so blocks need no order.
//
// Bound on the H100: bytes. It moves 2 bytes per element each way and
// does ~5 flops per element, far under the ~295 flop/byte ridge: 11.3 us
// at the training shape (6144, 1536) at 3.35 TB/s. At the decode step's
// (8, 1536) the call moves ~50 KB, which the card streams in ~15 ns, so
// launch latency dominates. Design:
// - One warp per row: the row's sum of squares is a warp-shuffle
//   reduction, with no shared memory and no block barrier.
// - 16-byte loads and stores, 8 bf16 a lane (6 vectors a lane at D =
//   1536), and the row held in registers between the sum of squares and
//   the output: x is read from memory once. The weight's and the bias's
//   16-byte vectors (from L1/L2) are loaded with the row's, before the
//   reduction, so that one memory latency stands before the output.
// - A null weight scales by 1 and a null bias adds nothing, in the same
//   pass (a branch uniform over the launch).
// - Rows wider than 16 vectors a lane (D > 4096), a D that is not a
//   multiple of 8, or a pointer that is not 16-byte aligned take a second
//   kernel of the same shape that strides over the row one element a lane
//   and reads it twice (the second time from L1).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = kThreads / 32;  // forward: rows per block, a warp each
constexpr int kMaxVecs = 16;             // forward: 16-byte vectors a lane

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// one row a warp, blockDim.x / 32 rows a block; kVecs 16-byte vectors a lane
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ r,
                    int n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const int nvec = d / 8;
  const auto* xr = reinterpret_cast<const uint4*>(x + row * d);
  const auto* wv = reinterpret_cast<const uint4*>(w);
  const auto* bv = reinterpret_cast<const uint4*>(bias);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xs[kVecs], ws[kVecs], bs[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    const bool in = c < nvec;
    xs[i] = in ? xr[c] : zero;
    ws[i] = in && w != nullptr ? wv[c] : zero;
    bs[i] = in && bias != nullptr ? bv[c] : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    float f[8];
    unpack8(xs[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = fmaf(f[j], f[j], ss);
  }
  const float rs = rsqrtf(ptt::warp_sum(ss) / static_cast<float>(d) + eps);
  if (lane == 0) r[row] = rs;
  auto* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      float f[8], wf[8], bf[8];
      unpack8(xs[i], f);
      unpack8(ws[i], wf);
      unpack8(bs[i], bf);
      uint4 o;
      auto* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float w0 = w != nullptr ? wf[j] : 1.f;
        const float w1 = w != nullptr ? wf[j + 1] : 1.f;
        op[j / 2] = ptt::pack_bf16(f[j] * rs * w0 + bf[j],
                                   f[j + 1] * rs * w1 + bf[j + 1]);
      }
      yr[c] = o;
    }
  }
}

// Any D and alignment: one element a lane at a time, the row read twice.
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_strided_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const __nv_bfloat16* __restrict__ bias,
                            __nv_bfloat16* __restrict__ y,
                            float* __restrict__ r, int n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const __nv_bfloat16* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = __bfloat162float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float rs = rsqrtf(ptt::warp_sum(ss) / static_cast<float>(d) + eps);
  if (lane == 0) r[row] = rs;
  __nv_bfloat16* yr = y + row * d;
  for (int i = lane; i < d; i += 32) {
    const float wv = w != nullptr ? __bfloat162float(w[i]) : 1.f;
    const float bv = bias != nullptr ? __bfloat162float(bias[i]) : 0.f;
    yr[i] = __float2bfloat16(__bfloat162float(xr[i]) * rs * wv + bv);
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

// x, y: (n, d) bf16 row-major; w, b: (d,) bf16 or null (a scale of 1,
// no bias); r: (n,) f32.
PTT_EXPORT int ptt_rms_norm_fwd(const void* x, const void* w, const void* b,
                                void* y, void* r, int n, int d, float eps,
                                void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* rp = static_cast<float*>(r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // 8 rows a block, or fewer where 8 would leave SMs without a block
  int rows = kMaxRows;
  while (rows > 1 && (n + rows - 1) / rows < sms) rows /= 2;
  const int blocks = (n + rows - 1) / rows, threads = rows * 32;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(y);
  const int vecs = (d / 8 + 31) / 32;  // 16-byte vectors a lane
#define PTT_RMS_FWD(V)                                                   \
  rms_norm_fwd_kernel<V><<<blocks, threads, 0, st>>>(xp, wp, bp, yp, rp, \
                                                     n, d, eps)
  if (d % 8 != 0 || addr % 16 != 0 || vecs > kMaxVecs) {
    rms_norm_fwd_strided_kernel<<<blocks, threads, 0, st>>>(xp, wp, bp, yp,
                                                            rp, n, d, eps);
  } else if (vecs <= 1) {
    PTT_RMS_FWD(1);
  } else if (vecs <= 2) {
    PTT_RMS_FWD(2);
  } else if (vecs <= 3) {  // BERT-base, D = 768
    PTT_RMS_FWD(3);
  } else if (vecs <= 4) {
    PTT_RMS_FWD(4);
  } else if (vecs <= 6) {  // the 438M model, D = 1536
    PTT_RMS_FWD(6);
  } else if (vecs <= 8) {
    PTT_RMS_FWD(8);
  } else if (vecs <= 12) {
    PTT_RMS_FWD(12);
  } else {
    PTT_RMS_FWD(kMaxVecs);
  }
#undef PTT_RMS_FWD
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
