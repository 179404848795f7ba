// Flash-attention forward in float32: O = softmax(Q K^T * scale [+ causal
// mask]) V and the per-row log-sum-exp, online softmax, never forming the
// (Sq, Sk) score matrix in memory, with every product in f32.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/flash_attention.py:86
// (_fwd_kernel, called from _fwd at :137) on f32 inputs. The Pallas kernel
// is generic in its dtype and forms S, P and P V in f32 (:111-129); the
// JAX model's default dtype is f32. The same function as the bf16 kernel
// (csrc/flash_attention.cu): causal rows see keys c <= r + (sk - sq), GQA
// reads kv head h / (H / KVH) by index, lse = m + log(max(l, 1e-30)),
// masked scores are -1e30; the kSegments instantiation counts an entry
// only where the query's int32 id equals the key's and skips key tiles
// whose id range does not meet the query tile's (ptt::SegWalk); a query
// row with no visible key gets out = 0 and lse = -1e30.
//
// Numerics: no tensor core here. bf16 operands would round Q, K, P and V
// to 8 bits, and TF32 to 11; JAX's f32 kernel rounds none of them. Every
// product is an f32 FMA (SIMT), summed in f32, so the kernel agrees with
// an f32 matmul composition to ~1e-6 relative.
//
// Bound on the H100: the f32 FMA rate outside the tensor cores (67
// TFLOP/s) at the training shape (4, 1536, 12, 128) causal (28.99 GFLOP,
// 433 us); bytes at the serving prefill (8, 128, 12, 128) causal (25.2 MB
// of q, k, v and out, 7.5 us at 3.35 TB/s). Design, for the FMA pipes:
// - A block of 256 threads owns kBQ = 64 query rows of one (b, h) and
//   walks kBK = 32-key tiles up to the tile's causal limit. Thread (rg,
//   cg), rg = tid / 16 and cg = tid % 16, holds rows 4 rg .. 4 rg + 3: for
//   S = Q K^T the keys cg and cg + 16 of the tile (8 scores), and for O
//   the 16-byte column chunks cg, cg + 16, ... (D / 64 chunks, 4 rows each:
//   32 f32 accumulators at D = 128, 64 at 256). The 16 threads of a row
//   group are one half-warp, so row max and row sum reduce with 4
//   shuffles and P passes through shared memory with no block barrier.
// - Q, K and V rows sit in shared memory with a stride of D + 4 floats,
//   read as float4: a half-warp's 16 K rows fall in distinct bank groups
//   (2 wavefronts for 256 bytes), and its Q and P reads are broadcasts.
//   Each k-step of Q K^T is 6 float4 loads for 32 FMAs, each key of P V
//   1 + D / 64 float4 loads for 4 D / 16 FMAs.
// - K and V tiles are staged with 16-byte cp.async in a ring of two, the
//   next tile's copies in flight while the current one is multiplied.
//   Shared memory: 108 KB at D = 128 (two blocks an SM), 204 KB at 256
//   (one). Causal tiles run heaviest first, as in the bf16 kernel.
//
// Head dims: instantiated at D = 32, 64, 96, 128 and 256, the bf16 kernel's
// widths, so the wrapper's padded route (ops/cuda/flash_attention.py)
// serves the others up to 256 the same way. At D = 32 and 96 some threads
// own one chunk fewer of O (D / 4 chunks over 16 threads).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 32;        // keys a tile
constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 threads
constexpr int kRows = 4;       // rows a thread
constexpr int kKeys = kBK / 16;  // keys a thread holds in S
constexpr int kPs = kBK + 4;   // P's shared row stride, floats
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int kChunks = (D / 4 + 15) / 16;  // O's 16-byte chunks a thread

template <int D, bool kSegments>
constexpr int smem_bytes() {
  // Q, two stages of K and V, P; with segments the query ids and two
  // stages of key ids
  return ((kBQ + 4 * kBK) * (D + 4) + kBQ * kPs) * 4 +
         (kSegments ? (kBQ + 2 * kBK) * 4 : 0);
}

template <int D, bool kSegments>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const ptt::SegIds seg, int sq,
                     int sk, int heads, int kv_heads, float scale,
                     int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dims of whole bank rows");
  constexpr int S = D + 4;         // Q, K, V shared row stride, floats
  constexpr int kNC = kChunks<D>;  // O chunks a thread
  constexpr bool kFull = (D / 4) % 16 == 0;  // every thread owns kNC chunks
  extern __shared__ __align__(16) unsigned char fwd_f32_smem[];
  float* qs = reinterpret_cast<float*>(fwd_f32_smem);  // [kBQ][S]
  float* ks = qs + kBQ * S;                            // [2][kBK][S]
  float* vs = ks + 2 * kBK * S;                        // [2][kBK][S]
  float* ps = vs + 2 * kBK * S;                        // [kBQ][kPs]
  int* qid_s = reinterpret_cast<int*>(ps + kBQ * kPs);  // [kBQ]
  int* kid_s = qid_s + kBQ;                              // [2][kBK]

  // the last query tiles see the most keys: schedule them first
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % hb % heads, b = blockIdx.x % hb / heads;
  const int kh = h / (heads / kv_heads);
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int q0 = qt * kBQ, off = sk - sq;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const float* qb = q + (static_cast<long long>(b) * sq * heads + h) * D;
  const long long kv_base =
      (static_cast<long long>(b) * sk * kv_heads + kh) * D;
  const float* kb = k + kv_base;
  const float* vb = v + kv_base;

  // causal: the tile's last row sees keys c <= r_last + off
  int k_end = sk;
  if (causal) k_end = max(min(sk, min(q0 + kBQ, sq) + off), 0);
  const int n_kt = (k_end + kBK - 1) / kBK;

  // segments: the key tiles whose id range meets this query tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<kBQ>(seg.q_lo + b * nq32,
                                          seg.q_hi + b * nq32, nq32, q0);
    return ptt::seg_window<kBK>(seg.k_lo + b * nk32, seg.k_hi + b * nk32,
                                nk32, base, n_kt, want);
  };
  ptt::SegWalk walk;
  // K, V (and with segments the key ids) of tile kt into a stage
  auto stage_kv = [&](int kt, int stage) {
    const int k0 = kt * kBK, at = stage * kBK * S;
    ptt::cp_async_rows_f32<kBK, D, kThreads>(ks + at, kb, kv_row, k0, sk);
    ptt::cp_async_rows_f32<kBK, D, kThreads>(vs + at, vb, kv_row, k0, sk);
    if (kSegments && threadIdx.x < kBK) {
      const int c = k0 + threadIdx.x;
      const int* kid = seg.k + static_cast<long long>(b) * sk;
      ptt::cp_async_4(kid_s + stage * kBK + threadIdx.x,
                      kid + (c < sk ? c : 0), c < sk ? 4 : 0);
    }
  };

  ptt::cp_async_rows_f32<kBQ, D, kThreads>(qs, qb, q_row, q0, sq);
  if (kSegments && threadIdx.x < kBQ) {
    const int r = q0 + threadIdx.x;
    const int* qid = seg.q + static_cast<long long>(b) * sq;
    ptt::cp_async_4(qid_s + threadIdx.x, qid + (r < sq ? r : 0),
                    r < sq ? 4 : 0);
  }
  int kt = 0;  // the first key tile (the walk's reads overlap the Q copies)
  if (kSegments) {
    walk.start(0, window);
    kt = walk.next(n_kt, window);
  }
  if (kt < n_kt) stage_kv(kt, 0);
  ptt::cp_async_commit();

  const int r0 = rg * kRows;  // this thread's rows in the tile: r0 .. r0 + 3
  float acc[kRows][kNC][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kNC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = ptt::kNegInf;
    l[i] = 0.f;
  }

  // it counts the tiles visited; unmasked it equals kt
  for (int it = 0; kt < n_kt; ++it) {
    const int nkt = kSegments ? walk.next(n_kt, window) : kt + 1;
    const int step = kSegments ? it : kt;
    const int k0 = kt * kBK, stage = step & 1;
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

    // S = Q K^T: rows r0 .. r0 + 3, keys cg and cg + 16
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * S + d0);
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(kst + (cg + 16 * j) * S + d0);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    const bool need_mask =
        kSegments || k0 + kBK > sk || (causal && k0 + kBK - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = q0 + r0 + i;
      const int rid = kSegments ? qid_s[r0 + i] : 0;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] *= scale;
        if (need_mask) {
          const int c = k0 + cg + 16 * j;
          if (c >= sk || (causal && c > r + off) ||
              (kSegments && kid_s[stage * kBK + cg + 16 * j] != rid)) {
            s[i][j] = ptt::kNegInf;
          }
        }
      }
    }

    // online softmax: the row max over the half-warp, then P = exp(S - m)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      }
      const float alpha = exp2f((m[i] - mx) * kLog2e);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kNC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
      m[i] = mx;
      // a row with no visible key yet keeps m = -1e30: its P must be 0
      const float mb = (mx == ptt::kNegInf ? 0.f : mx) * kLog2e;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = exp2f(fmaf(s[i][j], kLog2e, -mb));
        l[i] += p;
        ps[(r0 + i) * kPs + cg + 16 * j] = p;
      }
    }
    __syncwarp();  // P of this half-warp's rows is written

    // O += P V: 4 keys a step, P as float4 of each row
#pragma unroll 2
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * kPs + c0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = vst + (c0 + kk) * S;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int ch = cg + 16 * j;
          if (kFull || ch < D / 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * ch);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float p = kk == 0   ? pv[i].x
                              : kk == 1 ? pv[i].y
                              : kk == 2 ? pv[i].z
                                        : pv[i].w;
              acc[i][j][0] = fmaf(p, vv.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p, vv.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p, vv.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p, vv.w, acc[i][j][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and with P
    kt = nkt;
  }
  ptt::cp_async_wait<0>();  // with no key tile, the Q copies

  float* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int o2 = 8; o2 > 0; o2 >>= 1) {
      li += __shfl_xor_sync(0xffffffffu, li, o2);
    }
    const int r = q0 + r0 + i;
    if (r < sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int ch = cg + 16 * j;
        if (kFull || ch < D / 4) {
          *reinterpret_cast<float4*>(ob + r * q_row + 4 * ch) =
              make_float4(acc[i][j][0] * inv, acc[i][j][1] * inv,
                          acc[i][j][2] * inv, acc[i][j][3] * inv);
        }
      }
      if (cg == 0) {
        lse[(static_cast<long long>(b) * heads + h) * sq + r] =
            m[i] + logf(fmaxf(li, 1e-30f));
      }
    }
  }
}

template <int D, bool kSegments>
int launch_fwd_f32(const float* q, const float* k, const float* v, float* o,
                   float* lse, const ptt::SegIds& seg, int b, int sq, int sk,
                   int heads, int kv_heads, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (sq + kBQ - 1) / kBQ * heads * b;
  flash_fwd_f32_kernel<D, kSegments><<<blocks, kThreads, smem, stream>>>(
      q, k, v, o, lse, seg, sq, sk, heads, kv_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_f32(const float* q, const float* k, const float* v, float* o,
                   float* lse, const ptt::SegIds& seg, int b, int sq, int sk,
                   int heads, int kv_heads, float scale, int causal,
                   cudaStream_t stream) {
  if (seg.q != nullptr) {
    return launch_fwd_f32<D, true>(q, k, v, o, lse, seg, b, sq, sk, heads,
                                   kv_heads, scale, causal, stream);
  }
  return launch_fwd_f32<D, false>(q, k, v, o, lse, seg, b, sq, sk, heads,
                                  kv_heads, scale, causal, stream);
}

}  // namespace

// q, o: (b, sq, heads, d); k, v: (b, sk, kv_heads, d), all f32 row-major,
// 16-byte aligned; lse: (b, heads, sq) f32. d is 32, 64, 96, 128 or 256;
// scale is the caller's; the segment arguments as ptt_flash_attention_fwd's.
PTT_EXPORT int ptt_flash_attention_fwd_f32(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           const int* q_seg, const int* k_seg,
                                           const int* q_lo, const int* q_hi,
                                           const int* k_lo, const int* k_hi,
                                           int b, int sq, int sk, int heads,
                                           int kv_heads, int d, float scale,
                                           int causal, void* stream) {
  const ptt::SegIds seg{q_seg, k_seg, q_lo, q_hi, k_lo, k_hi};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_fwd_f32<32>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                                kv_heads, scale, causal, st);
    case 64:
      return launch_fwd_f32<64>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                                kv_heads, scale, causal, st);
    case 96:
      return launch_fwd_f32<96>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                                kv_heads, scale, causal, st);
    case 128:
      return launch_fwd_f32<128>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                                 kv_heads, scale, causal, st);
    case 256:
      return launch_fwd_f32<256>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                                 kv_heads, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
