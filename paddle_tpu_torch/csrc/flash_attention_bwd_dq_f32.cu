// Flash-attention backward in float32, dQ: dQ = dS K of O = softmax(Q K^T *
// scale [+ causal mask]) V, with P = exp(S * scale - lse) and
// dS = P * (dO V^T - delta) * scale, every product in 3xTF32 on the
// tensor cores.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/flash_attention.py:245
// (_bwd_dq_kernel, called from _bwd at :371) on f32 inputs. The function,
// the numerics, the bound, the fragment layout and this kernel's design
// are set out in csrc/flash_attention_bwd_f32.cu, which holds dK/dV: two
// sources, so that nvcc builds them in parallel.
#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// keys a tile of the dQ loop (at D = 256 a ring of two 32-key tiles
// would take 266 KB of shared memory beside Q and dO)
template <int D>
constexpr int kDqKeyTile = D <= 64 ? 64 : D <= 128 ? 32 : 16;

template <int D, int kWarps, bool kSegments>
constexpr int dq_smem_bytes() {
  // Q, dO; two stages of K and V; with segments the query ids and two
  // stages of key ids
  constexpr int kBK = kDqKeyTile<D>, BQ = kWarps * 16;
  return (2 * BQ + 4 * kBK) * (D + 4) * 4 +
         (kSegments ? (BQ + 2 * kBK) * 4 : 0);
}

template <int D, int kWarps, bool kSegments>
__global__ void __launch_bounds__(kWarps * 32, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, const ptt::SegIds seg, int sq,
                        int sk, int heads, int kv_heads, float scale,
                        int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dims of whole float4 runs");
  constexpr int BQ = kWarps * 16;  // query rows: 16 a warp
  constexpr int kThreads = kWarps * 32;
  constexpr int kBK = kDqKeyTile<D>;
  constexpr int S = D + 4;      // shared row stride, floats
  constexpr int kKd = D / 8;    // k-steps of S and dP
  constexpr int kNs = kBK / 8;  // score n-blocks of a key tile
  constexpr int kNo = D / 8;    // dQ n-blocks
  extern __shared__ __align__(16) unsigned char dq_f32_smem[];
  float* qs = reinterpret_cast<float*>(dq_f32_smem);     // [BQ][S]
  float* dos = qs + BQ * S;                              // [BQ][S]
  float* ks = dos + BQ * S;                              // [2][kBK][S]
  float* vs = ks + 2 * kBK * S;                          // [2][kBK][S]
  int* qid_s = reinterpret_cast<int*>(vs + 2 * kBK * S);  // [BQ]
  int* kid_s = qid_s + BQ;                                // [2][kBK]

  // the last query tiles see the most keys: schedule them first
  const int n_qt = (sq + BQ - 1) / BQ;
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % hb % heads, b = blockIdx.x % hb / heads;
  const int kh = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * BQ, off = sk - sq;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
  const long long kv_base =
      (static_cast<long long>(b) * sk * kv_heads + kh) * D;
  const float* kb = k + kv_base;
  const float* vb = v + kv_base;

  // causal: the tile's last row sees keys c <= r_last + off
  int k_end = sk;
  if (causal) k_end = max(min(sk, min(q0 + BQ, sq) + off), 0);
  const int n_kt = (k_end + kBK - 1) / kBK;

  // segments: the key tiles whose id range meets this query tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<BQ>(seg.q_lo + b * nq32,
                                         seg.q_hi + b * nq32, nq32, q0);
    return ptt::seg_window<kBK>(seg.k_lo + b * nk32, seg.k_hi + b * nk32,
                                nk32, base, n_kt, want);
  };
  ptt::SegWalk walk;
  // K, V (and with segments the key ids) of tile kt into a stage
  auto stage_kv = [&](int kt, int stage) {
    const int c0 = kt * kBK, at = stage * kBK * S;
    ptt::cp_async_rows_f32<kBK, D, kThreads>(ks + at, kb, kv_row, c0, sk);
    ptt::cp_async_rows_f32<kBK, D, kThreads>(vs + at, vb, kv_row, c0, sk);
    if (kSegments && threadIdx.x < kBK) {
      const int c = c0 + threadIdx.x;
      const int* kid = seg.k + static_cast<long long>(b) * sk;
      ptt::cp_async_4(kid_s + stage * kBK + threadIdx.x,
                      kid + (c < sk ? c : 0), c < sk ? 4 : 0);
    }
  };

  ptt::cp_async_rows_f32<BQ, D, kThreads>(qs, q + q_base, q_row, q0, sq);
  ptt::cp_async_rows_f32<BQ, D, kThreads>(dos, dout + q_base, q_row, q0, sq);
  if (kSegments && threadIdx.x < BQ) {
    const int r = q0 + threadIdx.x;
    const int* qid = seg.q + static_cast<long long>(b) * sq;
    ptt::cp_async_4(qid_s + threadIdx.x, qid + (r < sq ? r : 0),
                    r < sq ? 4 : 0);
  }
  int kt = 0;  // the first key tile (the walk's reads overlap the copies)
  if (kSegments) {
    walk.start(0, window);
    kt = walk.next(n_kt, window);
  }
  if (kt < n_kt) stage_kv(kt, 0);
  ptt::cp_async_commit();

  // this thread's rows: row and row + 8. Rows past sq read Q = dO = 0 and
  // take lse = delta = 0, so their dS is 0; they are never stored.
  const int row = q0 + warp * 16 + g;
  const long long row_base = (static_cast<long long>(b) * heads + h) * sq;
  float lb[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    lb[r] = rr < sq ? lse[row_base + rr] * kLog2e : 0.f;
    dl[r] = rr < sq ? delta[row_base + rr] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row
  // Q's (dO's) A fragment of k-step kk: rows 0-7 and 8-15 of the warp's 16,
  // at columns 8 kk .. + 3 and 8 kk + 4 .. + 7
  const int a_frag = (warp * 16 + mrow + 8 * (mat & 1)) * S + 4 * (mat >> 1);
  // K's (V's) B fragments of n-blocks 2j, 2j + 1: key row n / 2 + 4 (n % 2)
  const int b_frag = (8 * (mat >> 1) + (mrow >> 1) + 4 * (mrow & 1)) * S +
                     4 * (mat & 1);
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // it counts the tiles visited; unmasked it equals kt
  for (int it = 0; kt < n_kt; ++it) {
    const int nkt = kSegments ? walk.next(n_kt, window) : kt + 1;
    const int step = kSegments ? it : kt;
    const int c0 = kt * kBK, stage = step & 1;
    if (nkt < n_kt) {
      stage_kv(nkt, stage ^ 1);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kst = ks + stage * kBK * S;
    const float* vst = vs + stage * kBK * S;

    // S = Q K^T and dP = dO V^T over this warp's 16 rows and the tile's keys
    float s[kNs][4], dp[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      uint32_t raw[4], qh[4], ql[4], oh[4], ol[4];
      ptt::ldmatrix_x4<false>(raw, qs + a_frag + kk * 8);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ptt::split_tf32(__uint_as_float(raw[a]), qh[a], ql[a]);
      }
      ptt::ldmatrix_x4<false>(raw, dos + a_frag + kk * 8);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ptt::split_tf32(__uint_as_float(raw[a]), oh[a], ol[a]);
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t bh[2][2], bl[2][2];
        ptt::ldmatrix_x4<false>(raw, kst + b_frag + 16 * j * S + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), bh[a >> 1][a & 1],
                          bl[a >> 1][a & 1]);
        }
        ptt::mma_3xtf32(s[2 * j], qh, ql, bh[0], bl[0]);
        ptt::mma_3xtf32(s[2 * j + 1], qh, ql, bh[1], bl[1]);
        ptt::ldmatrix_x4<false>(raw, vst + b_frag + 16 * j * S + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), bh[a >> 1][a & 1],
                          bl[a >> 1][a & 1]);
        }
        ptt::mma_3xtf32(dp[2 * j], oh, ol, bh[0], bl[0]);
        ptt::mma_3xtf32(dp[2 * j + 1], oh, ol, bh[1], bl[1]);
      }
    }

    // P = exp(S scale - lse) and dS = P (dP - delta) scale, in place of dP:
    // entry e of n-block n is row row + 8 (e >> 1), key c0 + 8 n + t +
    // 4 (e & 1); the mask only on tiles that cross the diagonal or the end
    const bool need_mask =
        kSegments || c0 + kBK > sk || (causal && c0 + kBK - 1 > q0 + off);
    int rid[2] = {0, 0};  // this thread's rows' ids
    if (kSegments) {
      rid[0] = qid_s[warp * 16 + g];
      rid[1] = qid_s[warp * 16 + g + 8];
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      int cid[2] = {0, 0};  // the ids of keys t and t + 4 of the n-block
      if (kSegments) {
        cid[0] = kid_s[stage * kBK + n * 8 + t];
        cid[1] = kid_s[stage * kBK + n * 8 + t + 4];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -lb[e >> 1]));
        if (need_mask) {
          const int c = c0 + n * 8 + t + 4 * (e & 1);
          const int r = row + (e >> 1) * 8;
          if (c >= sk || (causal && c > r + off) ||
              (kSegments && cid[e & 1] != rid[e >> 1])) {
            p = 0.f;
          }
        }
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;
      }
    }

    // dQ += dS K, 4 n-blocks at a time: the tile's products summed from
    // zero on the tensor core and added to the sums in f32. n-block kk of
    // dS is the A fragment of keys 8 kk + (t, t + 4); K rows t and t + 4
    // the B fragments, as float4
#pragma unroll
    for (int c = 0; c < kNo / 4; ++c) {
      float tq[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) tq[e][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNs; ++kk) {
        uint32_t sh[4], sl[4];
        ptt::split_tf32(dp[kk][0], sh[0], sl[0]);  // (g, t)
        ptt::split_tf32(dp[kk][2], sh[1], sl[1]);  // (g + 8, t)
        ptt::split_tf32(dp[kk][1], sh[2], sl[2]);  // (g, t + 4)
        ptt::split_tf32(dp[kk][3], sh[3], sl[3]);  // (g + 8, t + 4)
        const float* k0p = kst + (kk * 8 + t) * S + g * kNo + 4 * c;
        const float4 a = *reinterpret_cast<const float4*>(k0p);
        const float4 z = *reinterpret_cast<const float4*>(k0p + 4 * S);
        const float ka[4] = {a.x, a.y, a.z, a.w};
        const float kz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t bh[2], bl[2];
          ptt::split_tf32(ka[e], bh[0], bl[0]);
          ptt::split_tf32(kz[e], bh[1], bl[1]);
          ptt::mma_3xtf32(tq[e], sh, sl, bh, bl);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[4 * c + e][i] += tq[e][i];
    }
    __syncthreads();  // every warp is done with this stage
    kt = nkt;
  }
  ptt::cp_async_wait<0>();  // with no key tile, the Q/dO copies
  __syncthreads();          // Q rows are free for the output

  // acc[j][2 r + e] is dQ at row g + 8 r, column (2 t + e) D / 8 + j
  float* os = qs + warp * 16 * S;  // this warp's own Q rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = os + (g + 8 * r) * S + (2 * t + e) * kNo;
#pragma unroll
      for (int c = 0; c < kNo / 4; ++c) {
        *reinterpret_cast<float4*>(dst + 4 * c) =
            make_float4(acc[4 * c][2 * r + e], acc[4 * c + 1][2 * r + e],
                        acc[4 * c + 2][2 * r + e], acc[4 * c + 3][2 * r + e]);
      }
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = j * 32 + lane;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int qr = q0 + warp * 16 + r;
    if (qr < sq) {
      *reinterpret_cast<float4*>(dq + q_base + qr * q_row + c) =
          *reinterpret_cast<const float4*>(os + r * S + c);
    }
  }
}

template <int D, int kWarps, bool kSegments>
int launch_dq_warps(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    float* dq, const ptt::SegIds& seg, int b, int sq, int sk,
                    int heads, int kv_heads, float scale, int causal,
                    cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D, kWarps, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D, kWarps, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (sq + kWarps * 16 - 1) / (kWarps * 16) * heads * b;
  flash_bwd_dq_f32_kernel<D, kWarps, kSegments>
      <<<blocks, kWarps * 32, smem, stream>>>(q, k, v, dout, lse, delta, dq,
                                              seg, sq, sk, heads, kv_heads,
                                              scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// 4 warps and 64 query rows a block; at D = 128, where such a block takes
// 135 KB of shared memory and so has its SM alone, 8 warps and 128 rows
// while that grid still covers the SMs (0.788 against 0.891 ms at the
// training shape on the H100; on GQA's 96-block grid 0.113 against 0.075)
template <int D, bool kSegments>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, const ptt::SegIds& seg, int b, int sq, int sk,
              int heads, int kv_heads, float scale, int causal,
              cudaStream_t stream) {
  if constexpr (D == 128) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((sq + 127) / 128 * heads * b >= sms) {
      return launch_dq_warps<D, 8, kSegments>(q, k, v, dout, lse, delta, dq,
                                              seg, b, sq, sk, heads,
                                              kv_heads, scale, causal,
                                              stream);
    }
  }
  return launch_dq_warps<D, 4, kSegments>(q, k, v, dout, lse, delta, dq, seg,
                                          b, sq, sk, heads, kv_heads, scale,
                                          causal, stream);
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, const ptt::SegIds& seg, int b, int sq, int sk,
              int heads, int kv_heads, float scale, int causal,
              cudaStream_t stream) {
  if (seg.q != nullptr) {
    return launch_dq<D, true>(q, k, v, dout, lse, delta, dq, seg, b, sq, sk,
                              heads, kv_heads, scale, causal, stream);
  }
  return launch_dq<D, false>(q, k, v, dout, lse, delta, dq, seg, b, sq, sk,
                             heads, kv_heads, scale, causal, stream);
}

}  // namespace

// q, dout, dq: (b, sq, heads, d); k, v: (b, sk, kv_heads, d), all f32
// row-major, 16-byte aligned; lse, delta: (b, heads, sq) f32. d is 32, 64,
// 96, 128 or 256; scale is the caller's; the segment arguments as
// ptt_flash_attention_bwd_dq's.
PTT_EXPORT int ptt_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const int* q_seg,
    const int* k_seg, const int* q_lo, const int* q_hi, const int* k_lo,
    const int* k_hi, int b, int sq, int sk, int heads, int kv_heads, int d,
    float scale, int causal, void* stream) {
  const ptt::SegIds seg{q_seg, k_seg, q_lo, q_hi, k_lo, k_hi};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dop = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dqp = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(qp, kp, vp, dop, lp, dlp, dqp, seg, b, sq, sk,
                           heads, kv_heads, scale, causal, st);
    case 64:
      return launch_dq<64>(qp, kp, vp, dop, lp, dlp, dqp, seg, b, sq, sk,
                           heads, kv_heads, scale, causal, st);
    case 96:
      return launch_dq<96>(qp, kp, vp, dop, lp, dlp, dqp, seg, b, sq, sk,
                           heads, kv_heads, scale, causal, st);
    case 128:
      return launch_dq<128>(qp, kp, vp, dop, lp, dlp, dqp, seg, b, sq, sk,
                            heads, kv_heads, scale, causal, st);
    case 256:
      return launch_dq<256>(qp, kp, vp, dop, lp, dlp, dqp, seg, b, sq, sk,
                            heads, kv_heads, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
