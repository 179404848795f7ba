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
// - Rows wider than 16 vectors a lane (D > 4096) take the wide kernel
//   (rms_norm_wide.cu): a block a row, up to D = 16384.
// - A D that is not a multiple of 8, a pointer that is not 16-byte
//   aligned, or D > 16384 take a kernel of the vector kernel's shape
//   that strides over the row one element a lane and reads it twice (the
//   second time from L1).
// - float32 (the Pallas kernel is generic in its dtype, :59-66, and the JAX
//   model's default is f32): x, weight, bias and y all f32 take a twin of
//   the vector kernel (the bf16 one keeps its code, and so its SASS) and
//   the f32 instantiations of the wide and strided kernels. A 16-byte
//   vector then holds 4 values: 12 vectors a lane at D = 1536, the row in
//   a warp's registers up to D = 2048, in a block's past it. The bound
//   doubles with the bytes.
#include "common.cuh"

// The forward for rows wider than a warp holds: a block a row (defined in
// rms_norm_wide.cu, a source of its own: compiled beside it, the vector
// kernel below came out as other SASS). Returns false, having launched
// nothing, for a row it does not take (D past its width).
template <typename T>
bool launch_rms_fwd_wide(const T* x, const T* w, const T* b, T* y, float* r,
                         int n, int d, float eps, cudaStream_t st);

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = kThreads / 32;  // forward: rows per block, a warp each
constexpr int kMaxVecs = 16;             // 16-byte vectors a lane, at most

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

// The same in f32: a 16-byte vector holds 4 values.
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y,
                        float* __restrict__ r, int n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const int nvec = d / 4;
  const auto* xr = reinterpret_cast<const float4*>(x + row * d);
  const auto* wv = reinterpret_cast<const float4*>(w);
  const auto* bv = reinterpret_cast<const float4*>(bias);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
  float4 xs[kVecs], ws[kVecs], bs[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    const bool in = c < nvec;
    xs[i] = in ? xr[c] : zero;
    ws[i] = in && w != nullptr ? wv[c] : one;
    bs[i] = in && bias != nullptr ? bv[c] : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    ss = fmaf(xs[i].x, xs[i].x, ss);
    ss = fmaf(xs[i].y, xs[i].y, ss);
    ss = fmaf(xs[i].z, xs[i].z, ss);
    ss = fmaf(xs[i].w, xs[i].w, ss);
  }
  const float rs = rsqrtf(ptt::warp_sum(ss) / static_cast<float>(d) + eps);
  if (lane == 0) r[row] = rs;
  auto* yr = reinterpret_cast<float4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      yr[c] = make_float4(xs[i].x * rs * ws[i].x + bs[i].x,
                          xs[i].y * rs * ws[i].y + bs[i].y,
                          xs[i].z * rs * ws[i].z + bs[i].z,
                          xs[i].w * rs * ws[i].w + bs[i].w);
    }
  }
}

// Any D and alignment: one element a lane at a time, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_strided_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ bias, T* __restrict__ y,
                            float* __restrict__ r, int n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = ptt::to_float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float rs = rsqrtf(ptt::warp_sum(ss) / static_cast<float>(d) + eps);
  if (lane == 0) r[row] = rs;
  T* yr = y + row * d;
  for (int i = lane; i < d; i += 32) {
    const float wv = w != nullptr ? ptt::to_float(w[i]) : 1.f;
    const float bv = bias != nullptr ? ptt::to_float(bias[i]) : 0.f;
    yr[i] = ptt::from_float<T>(ptt::to_float(xr[i]) * rs * wv + bv);
  }
}

// Backward: replaces the Pallas kernel paddle_tpu/ops/pallas/rms_norm.py:100
// (_bwd_kernel, called from _bwd_call at :129). Per row,
//   dx = r * (g*w - x * r^2 * mean(g*w*x)),
// and over rows dw = sum g*x*r, db = sum g. The Pallas kernel adds dw/db
// across row blocks in grid order (:113-126); Hopper blocks run in no
// order, so each block writes its rows' f32 column sums to a partial of
// its own, and a second launch adds the partials per column in block
// order: deterministic, no atomics.
//
// Bound on the H100: bytes. At the training shape (6144, 1536) it reads
// x and g and writes dx, 2 bytes each per element (56.6 MB, 16.9 us at
// 3.35 TB/s); the blocks' partials add 2 * blocks * d * 4 bytes each way
// (1.6 MB at 132 blocks), from L2. Design, as the forward's:
// - One warp a row and no block barrier: mean(g*w*x) is a warp-shuffle
//   sum. 16-byte loads of x and g, 8 bf16 a lane (6 vectors a lane at
//   D = 1536, 12 at 3072), held in registers between the row's sum and
//   dx, so that x and g come from memory once; up to D = 1536 each warp
//   loads w once, past it at each use (from L1).
// - Each lane owns its columns' dw/db f32 sums across its warp's rows:
//   in registers up to kBwdRegVecs vectors a lane (D = 1536), past it in
//   a slice of shared memory that only its warp touches, stored
//   lane-major as float4s (no bank conflict, no barrier).
// - As many blocks as fit on the card at once (the occupancy), each warp
//   walking the rows warp, warp + all warps, ...: every SM keeps several
//   rows' loads in flight. At the end the block's warps' sums are added
//   in warp order through shared memory into the block's partial.
// - The sum over partials takes 2 D / kSumCols blocks (192 at D = 1536),
//   each 16 columns by 16 row groups, the groups then added in order.
// A D that is not a multiple of 8, a pointer that is not 16-byte
// aligned, or D > 4096 takes the first design: a block walks a strip of
// rows one row at a time (a block barrier a row), one element a thread,
// its column sums in shared memory; its partials go to the same sum.
constexpr int kBwdRegVecs = 6;  // vectors a lane whose sums stay in registers
constexpr int kSumCols = 16;    // columns a block of the partials' sum

template <int kVecs>  // warps a block of the vector backward
constexpr int kBwdWarps = kVecs <= kBwdRegVecs ? 8 : 4;
template <int kVecs>  // floats of a warp's dw and db sums
constexpr int kBwdSlice = 2 * kVecs * 256;
template <int kVecs>
constexpr size_t kBwdSmem =
    static_cast<size_t>(kBwdWarps<kVecs>) * kBwdSlice<kVecs> * 4;

__device__ __forceinline__ void add8(float4* p, const float (&v)[8]) {
  // a lane's 8 columns as two float4s, 32 lanes apart (p[0], p[32])
  float4 a = p[0], b = p[32];
  a.x += v[0];
  a.y += v[1];
  a.z += v[2];
  a.w += v[3];
  b.x += v[4];
  b.y += v[5];
  b.z += v[6];
  b.w += v[7];
  p[0] = a;
  p[32] = b;
}

template <int kVecs>
__global__ void __launch_bounds__(kBwdWarps<kVecs> * 32)
rms_norm_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ r,
                         const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ dx,
                         float* __restrict__ partial, int n, int d) {
  constexpr int kWarps = kBwdWarps<kVecs>;
  constexpr bool kRegs = kVecs <= kBwdRegVecs;
  constexpr int kSlice = kBwdSlice<kVecs>;
  // [kWarps][2][kVecs][2][32][4]: warp, dw or db, vector, half, lane
  extern __shared__ __align__(16) float bwd_sums[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = d / 8;
  auto* sums = reinterpret_cast<float4*>(bwd_sums + warp * kSlice);
  const auto* wv = reinterpret_cast<const uint4*>(w);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // w's vectors: held in registers beside the sums; past them read at
  // each use (from L1), so that x and g fit in registers
  uint4 ws[kRegs ? kVecs : 1];
#pragma unroll
  for (int i = 0; i < (kRegs ? kVecs : 0); ++i) {
    const int c = i * 32 + lane;
    ws[i] = c < nvec ? wv[c] : zero;
  }
  auto w_at = [&](int i) {
    const int c = i * 32 + lane;
    return kRegs ? ws[kRegs ? i : 0] : c < nvec ? wv[c] : zero;
  };
  float sw[kRegs ? kVecs : 1][8], sb[kRegs ? kVecs : 1][8];
#pragma unroll
  for (int i = 0; i < (kRegs ? kVecs : 1); ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sw[i][j] = sb[i][j] = 0.f;
  if (!kRegs) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4 * kVecs; ++i) sums[i * 32 + lane] = z;
  }

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
       row < n; row += stride) {
    const auto* xr = reinterpret_cast<const uint4*>(x + row * d);
    const auto* gr = reinterpret_cast<const uint4*>(g + row * d);
    uint4 xs[kVecs], gs[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = i * 32 + lane;
      xs[i] = c < nvec ? xr[c] : zero;
      gs[i] = c < nvec ? gr[c] : zero;
    }
    const float rs = r[row];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float xf[8], gf[8], wf[8];
      unpack8(xs[i], xf);
      unpack8(gs[i], gf);
      unpack8(w_at(i), wf);
#pragma unroll
      for (int j = 0; j < 8; ++j) part = fmaf(gf[j] * wf[j], xf[j], part);
    }
    const float inner = ptt::warp_sum(part) / static_cast<float>(d);
    const float c2 = rs * rs * inner;
    auto* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float xf[8], gf[8], wf[8], gx[8];
        unpack8(xs[i], xf);
        unpack8(gs[i], gf);
        unpack8(w_at(i), wf);
        uint4 o;
        auto* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          op[j / 2] = ptt::pack_bf16(rs * fmaf(-xf[j], c2, gf[j] * wf[j]),
                                     rs * fmaf(-xf[j + 1], c2,
                                               gf[j + 1] * wf[j + 1]));
        }
        dxr[c] = o;
#pragma unroll
        for (int j = 0; j < 8; ++j) gx[j] = gf[j] * xf[j] * rs;
        if constexpr (kRegs) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sw[i][j] += gx[j];
            sb[i][j] += gf[j];
          }
        } else {
          add8(sums + (2 * i) * 32 + lane, gx);
          add8(sums + (2 * (kVecs + i)) * 32 + lane, gf);
        }
      }
    }
  }

  if constexpr (kRegs) {  // the lane's sums into its warp's slice
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      sums[(2 * i) * 32 + lane] = make_float4(sw[i][0], sw[i][1], sw[i][2],
                                              sw[i][3]);
      sums[(2 * i + 1) * 32 + lane] = make_float4(sw[i][4], sw[i][5],
                                                  sw[i][6], sw[i][7]);
      sums[(2 * (kVecs + i)) * 32 + lane] = make_float4(
          sb[i][0], sb[i][1], sb[i][2], sb[i][3]);
      sums[(2 * (kVecs + i) + 1) * 32 + lane] = make_float4(
          sb[i][4], sb[i][5], sb[i][6], sb[i][7]);
    }
  }
  __syncthreads();
  // the block's partial: the warps' slices added in warp order
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int idx = threadIdx.x; idx < kSlice; idx += kWarps * 32) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += bwd_sums[k * kSlice + idx];
    // idx = (((a * kVecs + i) * 2 + h) * 32 + l) * 4 + e
    const int e = idx % 4, l = idx / 4 % 32, h = idx / 128 % 2;
    const int i = idx / 256 % kVecs, a = idx / (256 * kVecs);
    const int col = 8 * (i * 32 + l) + 4 * h + e;
    if (col < d) out[a * d + col] = s;
  }
}

// Any D and alignment (the first design): a block walks a strip of
// strip_rows rows one row at a time, one element a thread, the strip's
// column sums in shared memory (each column owned by one thread), a
// row's mean(g*w*x) a warp-shuffle then shared-memory sum. x and g are
// read twice per row, the second time from L1.
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

// dw[i] (column i of the 2 d) and db[i] (column d + i): the sum over
// partials p of partial[p][col], in a fixed order: row group k of a block
// adds partials k, k + 16, ..., then the 16 groups are added in order.
// Both backwards, T their type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_sum_kernel(const float* __restrict__ partial, int parts, int d,
                        T* __restrict__ dw, T* __restrict__ db) {
  constexpr int kGroups = kThreads / kSumCols;
  __shared__ float red[kGroups][kSumCols];
  const int cl = threadIdx.x % kSumCols, k = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + cl;
  float s = 0.f;
  if (col < 2 * d) {
#pragma unroll 4
    for (int p = k; p < parts; p += kGroups) {
      s += partial[static_cast<size_t>(p) * 2 * d + col];
    }
  }
  red[k][cl] = s;
  __syncthreads();
  if (k == 0 && col < 2 * d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) t += red[i][cl];
    if (col < d) {
      dw[col] = ptt::from_float<T>(t);
    } else {
      db[col - d] = ptt::from_float<T>(t);
    }
  }
}

// The backward in f32 (x, w, g, dx, dw, db all f32; the Pallas kernel is
// generic in its dtype, :100-126, and the JAX model trains in f32): the
// bf16 vector backward's design with 4 values a 16-byte vector. Bound:
// bytes, now 4 per element each way: at (6144, 1536) x and g in and dx
// out are 113.2 MB, 33.8 us at 3.35 TB/s, plus the partials (2 * blocks
// * D * 4 bytes each way, from L2).
// - A row holds 4 times the vectors it holds in bf16: 384 at D = 1536, 12
//   a lane of one warp. x and g alone would then take 96 registers a lane
//   and the dw/db sums 96 more, so a row is spread over `split` warps of
//   the block (a group; 2 at D = 1536, so 6 vectors a lane, as the bf16
//   kernel holds at 1536): the group's warps' mean(g*w*x) parts meet in
//   shared memory behind a barrier of the group's threads alone (named
//   barrier 1 + group, two slots alternating by row, as in the strip
//   kernel), and no other warp waits. On the H100 at (6144, 1536): 2
//   warps a row 43.7 us, 4 44.2, 8 45.7; at most 128 registers (two
//   blocks an SM) spilled and took 54.8 (tools/torch_rms_variants.py).
// - x and g in 16-byte loads, held in registers between the row's sum
//   and dx: x and g come from memory once. w's vectors in registers.
// - Each lane sums its columns' dw and db across its group's rows: in
//   registers up to kBwdF32RegVecs vectors a lane (D = 6144 at 8 warps a
//   row), past it (D up to MAX_D: 16 vectors a lane, a block a row) in
//   the lane's own float4s of shared memory, w then read at each use
//   (from L1).
// - As many blocks as fit on the card at once, at most `cap` (the
//   partials' rows), each group walking the rows group, group + all
//   groups, ...; at the end the block's groups' sums are added in group
//   order into the block's partial, and rms_norm_bwd_sum_kernel<float>
//   adds the partials in a fixed order: dw and db the same bits at every
//   call, no atomics.
// A D that is not a multiple of 4 or a pointer that is not 16-byte
// aligned takes the first design: a block walks a strip of rows one row
// at a time (a block barrier a row), one value a thread, its column sums
// in shared memory; its partials go to the same sum.
constexpr int kBwdF32RegVecs = 6;
constexpr int kBwdF32MaxVecs = 16;

// bytes of a block's dw and db sums: float4s [2][kVecs][kThreads]
template <int kVecs>
constexpr size_t kBwdF32Smem = static_cast<size_t>(2) * kVecs * kThreads * 16;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// a barrier of `threads` threads (whole warps) under id (1-15)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int kVecs>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_f32_rows_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ r,
                             const float* __restrict__ g,
                             float* __restrict__ dx,
                             float* __restrict__ partial, int n, int d,
                             int split) {
  constexpr bool kRegs = kVecs <= kBwdF32RegVecs;
  // float4 [2][kVecs][kThreads]: dw or db, vector, thread
  extern __shared__ __align__(16) float4 bwd_f32_sums[];
  __shared__ float parts[2][kThreads / 32];  // a row's warp sums, by parity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kThreads / 32 / split, group = warp / split;
  const int span = split * 32;  // the group's lanes
  const int glane = static_cast<int>(threadIdx.x) - group * span;
  const int nvec = d / 4;  // the lane's vectors: i * span + glane
  const auto* wv = reinterpret_cast<const float4*>(w);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ws[kRegs ? kVecs : 1];
#pragma unroll
  for (int i = 0; i < (kRegs ? kVecs : 0); ++i) {
    const int c = i * span + glane;
    ws[i] = c < nvec ? wv[c] : zero;
  }
  auto w_at = [&](int i) {
    const int c = i * span + glane;
    return kRegs ? ws[kRegs ? i : 0] : c < nvec ? __ldg(wv + c) : zero;
  };
  float4 sw[kRegs ? kVecs : 1], sb[kRegs ? kVecs : 1];
#pragma unroll
  for (int i = 0; i < (kRegs ? kVecs : 1); ++i) sw[i] = sb[i] = zero;
  if (!kRegs) {
#pragma unroll
    for (int i = 0; i < 2 * kVecs; ++i) {
      bwd_f32_sums[i * kThreads + threadIdx.x] = zero;
    }
  }

  int parity = 0;
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  for (long long row = static_cast<long long>(blockIdx.x) * groups + group;
       row < n; row += stride, parity ^= 1) {
    const auto* xr = reinterpret_cast<const float4*>(x + row * d);
    const auto* gr = reinterpret_cast<const float4*>(g + row * d);
    float4 xs[kVecs], gs[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = i * span + glane;
      xs[i] = c < nvec ? xr[c] : zero;
      gs[i] = c < nvec ? gr[c] : zero;
    }
    const float rs = r[row];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const float4 wf = w_at(i);
      part = fmaf(gs[i].x * wf.x, xs[i].x, part);
      part = fmaf(gs[i].y * wf.y, xs[i].y, part);
      part = fmaf(gs[i].z * wf.z, xs[i].z, part);
      part = fmaf(gs[i].w * wf.w, xs[i].w, part);
    }
    float inner = ptt::warp_sum(part);
    if (split > 1) {  // the group's warp sums, in warp order
      if (lane == 0) parts[parity][warp] = inner;
      group_sync(1 + group, span);
      inner = 0.f;
      for (int k = 0; k < split; ++k) inner += parts[parity][group * split + k];
    }
    const float c2 = rs * rs * (inner / static_cast<float>(d));
    auto* dxr = reinterpret_cast<float4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = i * span + glane;
      if (c < nvec) {
        const float4 xf = xs[i], gf = gs[i], wf = w_at(i);
        dxr[c] = make_float4(rs * fmaf(-xf.x, c2, gf.x * wf.x),
                             rs * fmaf(-xf.y, c2, gf.y * wf.y),
                             rs * fmaf(-xf.z, c2, gf.z * wf.z),
                             rs * fmaf(-xf.w, c2, gf.w * wf.w));
        const float4 gx = make_float4(gf.x * xf.x * rs, gf.y * xf.y * rs,
                                      gf.z * xf.z * rs, gf.w * xf.w * rs);
        if constexpr (kRegs) {
          add4(sw[i], gx);
          add4(sb[i], gf);
        } else {
          add4(bwd_f32_sums[i * kThreads + threadIdx.x], gx);
          add4(bwd_f32_sums[(kVecs + i) * kThreads + threadIdx.x], gf);
        }
      }
    }
  }

  if constexpr (kRegs) {  // the lane's sums into its own slots
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      bwd_f32_sums[i * kThreads + threadIdx.x] = sw[i];
      bwd_f32_sums[(kVecs + i) * kThreads + threadIdx.x] = sb[i];
    }
  }
  __syncthreads();
  // the block's partial: each vector's sums over the groups, in group
  // order; item (a, i, gl) is vector i * span + gl of dw (a = 0) or db
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int item = threadIdx.x; item < 2 * kVecs * span; item += kThreads) {
    const int gl = item % span, i = item / span % kVecs;
    const int a = item / span / kVecs, c = i * span + gl;
    if (c >= nvec) continue;
    const float4* slot = bwd_f32_sums + (a * kVecs + i) * kThreads + gl;
    float4 t = slot[0];
    for (int k = 1; k < groups; ++k) add4(t, slot[k * span]);
    *reinterpret_cast<float4*>(out + a * d + 4 * c) = t;
  }
}

// Any D and alignment (the first design): a block walks a strip of
// strip_rows rows one row at a time, one value a thread, the strip's
// column sums in shared memory (each column owned by one thread), a row's
// mean(g*w*x) a warp-shuffle then shared-memory sum.
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ r,
                        const float* __restrict__ g, float* __restrict__ dx,
                        float* __restrict__ partial, int n, int d,
                        int strip_rows) {
  // [2][d]: the strip's dw then db sums
  extern __shared__ __align__(16) float bwd_f32_acc[];
  __shared__ float red[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * strip_rows;
  const int rows = min(strip_rows, n - row0);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    bwd_f32_acc[i] = bwd_f32_acc[d + i] = 0.f;
  }
  for (int rr = 0; rr < rows; ++rr) {
    const size_t row = static_cast<size_t>(row0 + rr);
    const float* xr = x + row * d;
    const float* gr = g + row * d;
    const float rs = r[row];
    float part = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      part += gr[i] * w[i] * xr[i];
    }
    part = ptt::warp_sum(part);
    // two slots, alternating by row, as in rms_norm_bwd_kernel
    float* slot = red[rr & 1];
    if (lane == 0) slot[warp] = part;
    __syncthreads();
    float inner = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) inner += slot[i];
    inner /= static_cast<float>(d);
    float* dxr = dx + row * d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = xr[i], gv = gr[i];
      dxr[i] = rs * (gv * w[i] - xv * (rs * rs) * inner);
      bwd_f32_acc[i] += gv * xv * rs;
      bwd_f32_acc[d + i] += gv;
    }
  }
  // each thread writes the columns it owns: no barrier needed
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    out[i] = bwd_f32_acc[i];
    out[d + i] = bwd_f32_acc[d + i];
  }
}

// The f32 vector backward: `split` warps a row, as many blocks as fit on
// the card at once, at most one a group of rows and at most `cap`;
// `parts` gets the blocks launched.
template <int kVecs>
cudaError_t launch_rms_bwd_f32_rows(const float* x, const float* w,
                                    const float* r, const float* g, float* dx,
                                    float* partial, int n, int d, int split,
                                    int sms, int cap, int& parts,
                                    cudaStream_t st) {
  constexpr size_t kSmem = kBwdF32Smem<kVecs>;
  cudaError_t err = cudaFuncSetAttribute(
      rms_norm_bwd_f32_rows_kernel<kVecs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  static int per_sm = 0;  // asked once, as in launch_rms_bwd_rows
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rms_norm_bwd_f32_rows_kernel<kVecs>, kThreads, kSmem);
    if (err != cudaSuccess) return err;
  }
  const int groups = kThreads / 32 / split;
  const int rows = (n + groups - 1) / groups;
  parts = sms * per_sm < rows ? sms * per_sm : rows;
  parts = parts < cap ? parts : cap;
  parts = parts > 1 ? parts : 1;
  rms_norm_bwd_f32_rows_kernel<kVecs><<<parts, kThreads, kSmem, st>>>(
      x, w, r, g, dx, partial, n, d, split);
  return cudaGetLastError();
}

// The vector backward: as many blocks as fit on the card at once, at most
// one a kWarps rows and at most `strips`, the partials' rows; `parts` gets
// the blocks launched.
template <int kVecs>
cudaError_t launch_rms_bwd_rows(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                const float* r, const __nv_bfloat16* g,
                                __nv_bfloat16* dx, float* partial, int n,
                                int d, int sms, int strips, int& parts,
                                cudaStream_t st) {
  constexpr int kWarps = kBwdWarps<kVecs>;
  constexpr size_t kSmem = kBwdSmem<kVecs>;
  cudaError_t err = cudaFuncSetAttribute(
      rms_norm_bwd_rows_kernel<kVecs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  // blocks an SM holds, asked once: the query takes longer than a launch
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rms_norm_bwd_rows_kernel<kVecs>, kWarps * 32, kSmem);
    if (err != cudaSuccess) return err;
  }
  const int rows = (n + kWarps - 1) / kWarps;
  parts = sms * per_sm < rows ? sms * per_sm : rows;
  parts = parts < strips ? parts : strips;
  parts = parts > 1 ? parts : 1;
  rms_norm_bwd_rows_kernel<kVecs><<<parts, kWarps * 32, kSmem, st>>>(
      x, w, r, g, dx, partial, n, d);
  return cudaGetLastError();
}

template <typename T>
int launch_rms_fwd(const void* x, const void* w, const void* b, void* y,
                   void* r, int n, int d, float eps, void* stream) {
  const auto* xp = static_cast<const T*>(x);
  const auto* wp = static_cast<const T*>(w);
  const auto* bp = static_cast<const T*>(b);
  auto* yp = static_cast<T*>(y);
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
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a vector
  const int vecs = (d / kPer + 31) / 32;  // 16-byte vectors a lane
  // bf16 and f32 take kernels of their own (the bf16 one as first built)
#define PTT_RMS_FWD(V)                                                   \
  if constexpr (sizeof(T) == 2) {                                        \
    rms_norm_fwd_kernel<V><<<blocks, threads, 0, st>>>(xp, wp, bp, yp,   \
                                                       rp, n, d, eps);   \
  } else {                                                               \
    rms_norm_fwd_f32_kernel<V><<<blocks, threads, 0, st>>>(xp, wp, bp,   \
                                                           yp, rp, n, d, \
                                                           eps);         \
  }
  if (d % kPer == 0 && addr % 16 == 0 && vecs > kMaxVecs &&
      launch_rms_fwd_wide<T>(xp, wp, bp, yp, rp, n, d, eps, st)) {
    return static_cast<int>(cudaGetLastError());
  }
  if (d % kPer != 0 || addr % 16 != 0 || vecs > kMaxVecs) {
    rms_norm_fwd_strided_kernel<T><<<blocks, threads, 0, st>>>(
        xp, wp, bp, yp, rp, n, d, eps);
  } else if (vecs <= 1) {
    PTT_RMS_FWD(1);
  } else if (vecs <= 2) {
    PTT_RMS_FWD(2);
  } else if (vecs <= 3) {  // BERT-base, D = 768 in bf16
    PTT_RMS_FWD(3);
  } else if (vecs <= 4) {
    PTT_RMS_FWD(4);
  } else if (vecs <= 6) {  // the 438M model, D = 1536 in bf16
    PTT_RMS_FWD(6);
  } else if (vecs <= 8) {
    PTT_RMS_FWD(8);
  } else if (vecs <= 12) {  // D = 1536 in f32, 3072 in bf16
    PTT_RMS_FWD(12);
  } else {
    PTT_RMS_FWD(kMaxVecs);
  }
#undef PTT_RMS_FWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n, d) bf16 row-major; w, b: (d,) bf16 or null (a scale of 1,
// no bias); r: (n,) f32.
PTT_EXPORT int ptt_rms_norm_fwd(const void* x, const void* w, const void* b,
                                void* y, void* r, int n, int d, float eps,
                                void* stream) {
  return launch_rms_fwd<__nv_bfloat16>(x, w, b, y, r, n, d, eps, stream);
}

// The same with x, y, w and b all f32.
PTT_EXPORT int ptt_rms_norm_fwd_f32(const void* x, const void* w,
                                    const void* b, void* y, void* r, int n,
                                    int d, float eps, void* stream) {
  return launch_rms_fwd<float>(x, w, b, y, r, n, d, eps, stream);
}

// x, g, dx: (n, d) bf16 row-major; w, dw, db: (d,) bf16; r: (n,) f32;
// partial: (ceil(n / strip_rows), 2, d) f32 scratch. The vector kernel
// takes at most that many blocks; the strided one strips of strip_rows.
PTT_EXPORT int ptt_rms_norm_bwd(const void* x, const void* w, const void* r,
                                const void* g, void* dx, void* dw, void* db,
                                void* partial, int n, int d, int strip_rows,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* rp = static_cast<const float*>(r);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  auto* dxp = static_cast<__nv_bfloat16*>(dx);
  auto* pp = static_cast<float*>(partial);
  const int strips = (n + strip_rows - 1) / strip_rows;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
  const int vecs = (d / 8 + 31) / 32;  // 16-byte vectors a lane
  int parts = strips;
  cudaError_t err = cudaSuccess;
  if (d % 8 != 0 || addr % 16 != 0 || vecs > kMaxVecs) {
    const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
    err = cudaFuncSetAttribute(rms_norm_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rms_norm_bwd_kernel<<<strips, kThreads, smem, st>>>(
        xp, wp, rp, gp, dxp, pp, n, d, strip_rows);
  } else {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
#define PTT_RMS_BWD(V) \
  launch_rms_bwd_rows<V>(xp, wp, rp, gp, dxp, pp, n, d, sms, strips, parts, st)
    if (vecs <= 1) {
      err = PTT_RMS_BWD(1);
    } else if (vecs <= 2) {
      err = PTT_RMS_BWD(2);
    } else if (vecs <= 3) {  // BERT-base, D = 768
      err = PTT_RMS_BWD(3);
    } else if (vecs <= 4) {
      err = PTT_RMS_BWD(4);
    } else if (vecs <= 6) {  // the 438M model, D = 1536
      err = PTT_RMS_BWD(6);
    } else if (vecs <= 8) {
      err = PTT_RMS_BWD(8);
    } else if (vecs <= 12) {  // Phi-3-mini, D = 3072
      err = PTT_RMS_BWD(12);
    } else {
      err = PTT_RMS_BWD(kMaxVecs);
    }
#undef PTT_RMS_BWD
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_bwd_sum_kernel<__nv_bfloat16>
      <<<(2 * d + kSumCols - 1) / kSumCols, kThreads, 0, st>>>(
          pp, parts, d, static_cast<__nv_bfloat16*>(dw),
          static_cast<__nv_bfloat16*>(db));
  return static_cast<int>(cudaGetLastError());
}

// The same with x, w, g, dx, dw and db all f32; partial: (cap, 2, d) f32
// scratch with cap >= ceil(n / strip_rows). The vector kernel (D a
// multiple of 4 up to 16 vectors a thread of a block, 16-byte aligned)
// takes at most cap blocks; the strip kernel (any D up to the shared
// memory's 2 * D floats, any alignment) strips of strip_rows.
PTT_EXPORT int ptt_rms_norm_bwd_f32(const void* x, const void* w,
                                    const void* r, const void* g, void* dx,
                                    void* dw, void* db, void* partial, int n,
                                    int d, int strip_rows, int cap,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* rp = static_cast<const float*>(r);
  const auto* gp = static_cast<const float*>(g);
  auto* dxp = static_cast<float*>(dx);
  auto* pp = static_cast<float*>(partial);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
  const int nvec = d / 4;
  int parts = (n + strip_rows - 1) / strip_rows;
  cudaError_t err = cudaSuccess;
  if (d % 4 != 0 || addr % 16 != 0 || nvec > kBwdF32MaxVecs * kThreads) {
    const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
    err = cudaFuncSetAttribute(rms_norm_bwd_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rms_norm_bwd_f32_kernel<<<parts, kThreads, smem, st>>>(
        xp, wp, rp, gp, dxp, pp, n, d, strip_rows);
  } else {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // the fewest warps a row (a power of 2) that hold it at kBwdF32RegVecs
    // vectors a lane; past the block's 8 warps, 16 vectors a lane
    int split = 1;
    while (split < kThreads / 32 && nvec > kBwdF32RegVecs * 32 * split) {
      split *= 2;
    }
    const int vecs = (nvec + 32 * split - 1) / (32 * split);
#define PTT_RMS_BWD_F32(V)                                                  \
  launch_rms_bwd_f32_rows<V>(xp, wp, rp, gp, dxp, pp, n, d, split, sms, cap, \
                             parts, st)
    if (vecs <= 1) {
      err = PTT_RMS_BWD_F32(1);
    } else if (vecs <= 2) {
      err = PTT_RMS_BWD_F32(2);
    } else if (vecs <= 4) {
      err = PTT_RMS_BWD_F32(4);
    } else if (vecs <= kBwdF32RegVecs) {  // the 438M model, D = 1536: 2 warps
      err = PTT_RMS_BWD_F32(kBwdF32RegVecs);
    } else {
      err = PTT_RMS_BWD_F32(kBwdF32MaxVecs);
    }
#undef PTT_RMS_BWD_F32
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_bwd_sum_kernel<float>
      <<<(2 * d + kSumCols - 1) / kSumCols, kThreads, 0, st>>>(
          pp, parts, d, static_cast<float*>(dw), static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}
