// The RMSNorm forward for rows wider than a warp holds. With rms_norm.cu's
// kernels it replaces the Pallas kernel paddle_tpu/ops/pallas/rms_norm.py:59
// (_fwd_kernel): this one takes D a multiple of 8 (bf16) or 4 (f32) past
// 4096 / 2048, up to kWideMaxD, with 16-byte aligned pointers, called from
// rms_norm.cu's entries, which take every other row. It is a source of its
// own: compiled in rms_norm.cu's translation unit, it changed the SASS that
// nvcc gave the vector kernel there.
//
// Mistral-Large-2's hidden 12288 is 1536 16-byte vectors. rms_norm.cu's
// strided kernel gives such a row one warp, which walks it one element a
// lane, twice: ~770 dependent 64-byte loads a row on one SM (29 us at (8,
// 12288) on the H100). Here a row is spread over the kWideThreads threads
// of a block:
// - each thread holds up to kVecs of the row's 16-byte vectors, vector
//   i * kWideThreads + thread, with w's and b's beside them, all loaded
//   before the reduction: x is read from memory once, and one memory
//   latency stands before the output (3 vectors a thread at 12288 bf16);
// - the sum of squares: a warp shuffle, each warp's sum to shared memory,
//   one barrier, then every warp adds the kWideWarps sums in one order;
// - r is written once a row; a null weight scales by 1 and a null bias
//   adds nothing.
// One block a row leaves most SMs idle at the decode step's 8 rows, but
// the row is latency, not bytes: clusters of 2 and 4 blocks a row, their
// sums met through distributed shared memory behind a cluster barrier,
// took 3.0-3.3 us at (8, 12288) bf16 on the H100 against one block's
// 2.2 (256 threads a block: 2.35), so a row keeps one block
// (tools/torch_rms_variants.py). Bound: bytes, as the vector kernel: at
// (8, 12288) bf16 0.39 MB, 0.12 us at 3.35 TB/s; float32 doubles them.
#include "common.cuh"

namespace {

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxD = 16384;

// 16 bytes of T as floats and back: 8 bf16 or 4 f32
template <typename T>
struct Vec16;
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    ptt::unpack_bf16x8(u, f);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(ptt::pack_bf16(f[0], f[1]), ptt::pack_bf16(f[2], f[3]),
                      ptt::pack_bf16(f[4], f[5]), ptt::pack_bf16(f[6], f[7]));
  }
};
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// one row a block; kVecs 16-byte vectors a thread
template <typename T, int kVecs>
__global__ void __launch_bounds__(kWideThreads)
rms_norm_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ y,
                         float* __restrict__ r, int d, float eps) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  __shared__ float red[kWideWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long row = blockIdx.x;
  const int nvec = d / kN;
  const auto* xr = reinterpret_cast<const uint4*>(x + row * d);
  const auto* wv = reinterpret_cast<const uint4*>(w);
  const auto* bv = reinterpret_cast<const uint4*>(bias);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xs[kVecs], ws[kVecs], bs[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * kWideThreads + static_cast<int>(threadIdx.x);
    const bool in = c < nvec;
    xs[i] = in ? xr[c] : zero;
    ws[i] = in && w != nullptr ? wv[c] : zero;
    bs[i] = in && bias != nullptr ? bv[c] : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    float f[kN];
    V::unpack(xs[i], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) ss = fmaf(f[j], f[j], ss);
  }
  ss = ptt::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  // the block's warp sums in one order, the same bits in every warp
  const float rs = rsqrtf(
      ptt::warp_sum(lane < kWideWarps ? red[lane] : 0.f) /
          static_cast<float>(d) + eps);
  if (threadIdx.x == 0) r[row] = rs;
  auto* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * kWideThreads + static_cast<int>(threadIdx.x);
    if (c < nvec) {
      float f[kN], wf[kN], bf[kN], o[kN];
      V::unpack(xs[i], f);
      V::unpack(ws[i], wf);
      V::unpack(bs[i], bf);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        o[j] = f[j] * rs * (w != nullptr ? wf[j] : 1.f) + bf[j];
      }
      yr[c] = V::pack(o);
    }
  }
}

}  // namespace

// The wide kernel at the vectors a thread holds (bf16: at most 4, f32: 8);
// false, having launched nothing, past kWideMaxD.
template <typename T>
bool launch_rms_fwd_wide(const T* x, const T* w, const T* b, T* y, float* r,
                         int n, int d, float eps, cudaStream_t st) {
  if (d > kWideMaxD) return false;
  constexpr int kPass = Vec16<T>::kN * kWideThreads;  // values a block pass
  const int vecs = (d + kPass - 1) / kPass;
#define PTT_RMS_WIDE(V)                                                  \
  rms_norm_fwd_wide_kernel<T, V><<<n, kWideThreads, 0, st>>>(x, w, b, y, r, \
                                                             d, eps)
  if (vecs <= 2) {
    PTT_RMS_WIDE(2);
  } else if (vecs <= 3) {  // Mistral-Large-2, D = 12288 in bf16
    PTT_RMS_WIDE(3);
  } else if constexpr (sizeof(T) == 2) {
    PTT_RMS_WIDE(4);
  } else if (vecs <= 4) {
    PTT_RMS_WIDE(4);
  } else if (vecs <= 6) {  // D = 12288 in f32
    PTT_RMS_WIDE(6);
  } else {
    PTT_RMS_WIDE(8);
  }
#undef PTT_RMS_WIDE
  return true;
}

template bool launch_rms_fwd_wide<__nv_bfloat16>(
    const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
    __nv_bfloat16*, float*, int, int, float, cudaStream_t);
template bool launch_rms_fwd_wide<float>(const float*, const float*,
                                         const float*, float*, float*, int,
                                         int, float, cudaStream_t);
