// Flash-attention backward: dK/dV and dQ of O = softmax(Q K^T * scale
// [+ causal mask]) V from the forward's per-row lse and
// delta = rowsum(dO * O) (formed outside, in f32), never forming the
// (Sq, Sk) score matrix in memory. With P = exp(S * scale - lse) and
// dS = P * (dO V^T - delta) * scale:
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
//
// Replaces the Pallas kernels paddle_tpu/ops/pallas/flash_attention.py:181
// (_bwd_dkdv_kernel, called from _bwd at :328) and :245 (_bwd_dq_kernel,
// called at :371). Same function: causal rows see keys c <= r + (sk - sq),
// GQA query head h reads kv head h / (H / KVH) by index, and dK/dV sum the
// whole group in f32. The Pallas dK/dV grid revisits one output block
// across the group in grid order; Hopper blocks run in no order, so here
// one block owns a tile of kTile key rows of one (b, kv head) and loops
// over every query head of its group and over the causal range of query
// tiles, with dK and dV in f32 registers, and writes them once. The dQ
// block owns a tile of kTile query rows of one (b, h) and loops over the
// causal range of key tiles. Segment-id masking is not ported (no caller
// passes it).
//
// Bound on the H100 at the training shape (4, 1536, 12, 128), causal,
// 56.66 M (query, key) pairs: operations. dK/dV does 4 products of
// 2 * D flops per pair (58.0 GFLOP, 58.7 us at the bf16 tensor-core
// peak), dQ 3 (43.5 GFLOP, 44.0 us); the bytes (q, k, v, dO, lse, delta
// in, the gradients out) take ~22 us. This first version runs in f32 on
// the CUDA cores: tiles of Q, dO, K and V staged in shared memory as f32
// (rows padded to D + 1 floats, so that the 16 rows a warp reads at one
// column fall in 16 banks) and reused by the whole block; each thread
// owns a 4 x 4 micro-tile of the kTile x kTile score tile (rows ty + 16i,
// columns tx + 16j) and a 4 x D/16 micro-tile of its output rows. P and
// dS pass through shared memory between the score products and the
// gradient products. A wgmma/TMA version is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kPStride = kTile + 1;

template <int D>
constexpr size_t smem_floats(int tiles) {
  return static_cast<size_t>(tiles) * kTile * (D + 1) +
         static_cast<size_t>(kTile) * kPStride;
}

// Rows [row0, row0 + kTile) of a bf16 matrix whose row i starts at
// base + i * row_stride, into the f32 tile dst[kTile][D + 1]; rows at or
// past nrows are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int kPairs = D / 2;
  for (int i = threadIdx.x; i < kTile * kPairs; i += kThreads) {
    const int r = i / kPairs, c = (i % kPairs) * 2;
    float2 f = make_float2(0.f, 0.f);
    if (row0 + r < nrows) {
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          base + (row0 + r) * row_stride + c));
    }
    dst[r * (D + 1) + c] = f.x;
    dst[r * (D + 1) + c + 1] = f.y;
  }
}

// s[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d] over two f32 tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int sq, int sk,
                      int heads, int kv_heads, float scale, int causal) {
  constexpr int kStride = D + 1;
  constexpr int kDj = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kStride;
  float* qs = vs + kTile * kStride;
  float* dos = qs + kTile * kStride;
  float* ps = dos + kTile * kStride;  // P and dS, [kTile][kPStride] each
  float* dss = ps + kTile * kPStride;
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int group = heads / kv_heads;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = sk - sq;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_base = (static_cast<long long>(b) * sk * kv_heads + kh) * D;

  load_tile<D>(ks, k + kv_base, kv_row, k0, sk);
  load_tile<D>(vs, v + kv_base, kv_row, k0, sk);

  // this thread's rows of the key tile: ty + 16i; its dims: tx + 16j
  float dk_acc[4][kDj], dv_acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows r with r + off < k0 see nothing of this key tile
  const int q_first = causal ? max(k0 - off, 0) / kTile : 0;
  const int n_qt = (sq + kTile - 1) / kTile;

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
    const long long row_base = (static_cast<long long>(b) * heads + h) * sq;
    for (int qt = q_first; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last tile's readers are done with qs..dss
      load_tile<D>(qs, q + q_base, q_row, q0, sq);
      load_tile<D>(dos, dout + q_base, q_row, q0, sq);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse[row_base + r] : 0.f;
        delta_s[threadIdx.x] = r < sq ? delta[row_base + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(qs, ks, ty, tx, s);
      tile_dot<D>(dos, vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = ty + 16 * i, r = q0 + rl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx + 16 * j, c = k0 + cl;
          const bool keep = r < sq && c < sk && (!causal || c <= r + off);
          const float p = keep ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
          ps[rl * kPStride + cl] = p;
          dss[rl * kPStride + cl] = p * (dp[i][j] - delta_s[rl]) * scale;
        }
      }
      __syncthreads();
      // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] Q[r][d]
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[4], dsv[4], dov[kDj], qv[kDj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * kPStride + ty + 16 * i];
          dsv[i] = dss[r * kPStride + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          dov[j] = dos[r * kStride + tx + 16 * j];
          qv[j] = qs[r * kStride + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDj; ++j) {
            dv_acc[i][j] += pv[i] * dov[j];
            dk_acc[i][j] += dsv[i] * qv[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= sk) continue;
    const long long o = kv_base + static_cast<long long>(c) * kv_row;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      dk[o + tx + 16 * j] = __float2bfloat16(dk_acc[i][j]);
      dv[o + tx + 16 * j] = __float2bfloat16(dv_acc[i][j]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int sq, int sk,
                    int heads, int kv_heads, float scale, int causal) {
  constexpr int kStride = D + 1;
  constexpr int kDj = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kStride;
  float* ks = dos + kTile * kStride;
  float* vs = ks + kTile * kStride;
  float* dss = vs + kTile * kStride;
  __shared__ float lse_s[kTile], delta_s[kTile];

  // the last query tiles see the most keys: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = sk - sq;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_base = (static_cast<long long>(b) * sk * kv_heads + kh) * D;
  const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
  const long long row_base = (static_cast<long long>(b) * heads + h) * sq;

  load_tile<D>(qs, q + q_base, q_row, q0, sq);
  load_tile<D>(dos, dout + q_base, q_row, q0, sq);
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < sq ? lse[row_base + r] : 0.f;
    delta_s[threadIdx.x] = r < sq ? delta[row_base + r] : 0.f;
  }

  float dq_acc[4][kDj];  // rows ty + 16i, dims tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dq_acc[i][j] = 0.f;

  // causal: the tile's last row r_last sees keys c <= r_last + off
  int k_end = sk;
  if (causal) k_end = max(min(sk, min(q0 + kTile, sq) + off), 0);
  const int n_kt = (k_end + kTile - 1) / kTile;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done with ks..dss
    load_tile<D>(ks, k + kv_base, kv_row, k0, sk);
    load_tile<D>(vs, v + kv_base, kv_row, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = k0 + cl;
        const bool keep = r < sq && c < sk && (!causal || c <= r + off);
        const float p = keep ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        dss[rl * kPStride + cl] = p * (dp[i][j] - delta_s[rl]) * scale;
      }
    }
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] K[c][d]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDj; ++j) kv[j] = ks[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) dq_acc[i][j] += dsv[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const long long o = q_base + static_cast<long long>(r) * q_row;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      dq[o + tx + 16 * j] = __float2bfloat16(dq_acc[i][j]);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int b, sq, sk, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_dkdv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv) {
  const size_t smem = smem_floats<D>(4) * sizeof(float) +
                      static_cast<size_t>(kTile) * kPStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sk + kTile - 1) / kTile, a.kv_heads, a.b);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.sq, a.sk, a.heads,
      a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, __nv_bfloat16* dq) {
  const size_t smem = smem_floats<D>(4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kTile - 1) / kTile, a.heads, a.b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.sq, a.sk, a.heads,
      a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int b, int sq, int sk,
               int heads, int kv_heads, float scale, int causal,
               void* stream) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              b, sq, sk, heads, kv_heads, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, dout: (b, sq, heads, d); k, v, dk, dv: (b, sk, kv_heads, d), all bf16
// row-major; lse, delta: (b, heads, sq) f32. d is 64 or 128.
PTT_EXPORT int ptt_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
    int sk, int heads, int kv_heads, int d, float scale, int causal,
    void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, b, sq, sk, heads,
                           kv_heads, scale, causal, stream);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (d == 128) return launch_dkdv<128>(a, dkp, dvp);
  if (d == 64) return launch_dkdv<64>(a, dkp, dvp);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq: (b, sq, heads, d) bf16; the other arguments as above.
PTT_EXPORT int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int sq, int sk,
    int heads, int kv_heads, int d, float scale, int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, b, sq, sk, heads,
                           kv_heads, scale, causal, stream);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  if (d == 128) return launch_dq<128>(a, dqp);
  if (d == 64) return launch_dq<64>(a, dqp);
  return static_cast<int>(cudaErrorInvalidValue);
}
