// Flash-attention forward in float32: O = softmax(Q K^T * scale [+ causal
// mask]) V and the per-row log-sum-exp, online softmax, never forming the
// (Sq, Sk) score matrix in memory, with both products in 3xTF32 on the
// tensor cores.
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
// Numerics: every product is 3xTF32 (ptt::mma_3xtf32): each f32 operand
// (Q, K, P, V) is split into two TF32 terms, hi (its rounding to nearest)
// and lo (the rest, truncated), and a b is hi hi + hi lo + lo hi, summed
// in f32, about 2^-21 relative per product.
// One TF32 product (1xTF32, what allow_tf32 gives a matmul) keeps 11 bits
// and misses the f32 gate (1e-4 + 1e-4 relative against the plain f32
// version): tests/test_torch_flash_rounding.py emulates both on the CPU
// against JAX's f32 Pallas kernel. The softmax is f32, as before.
//
// Bound on the H100: the tensor cores at the training shape (4, 1536, 12,
// 128) causal: 3 x 28.99 GFLOP of TF32 products at 495 TFLOP/s, 176 us
// (the f32 FMA rate outside the tensor cores, 67 TFLOP/s, would give 433
// us: the first design, SIMT FMAs, ran at 46% of that); bytes at the
// serving prefill (8, 128, 12, 128) causal (25.2 MB of q, k, v and out,
// 7.5 us at 3.35 TB/s). Design, the bf16 kernel's:
// - A block of 4 warps owns kBQ = 64 query rows of one (b, h), each warp
//   16 of them, and walks key tiles (kKeyTile<D>: 64 keys up to D = 64,
//   32 past it, so that two blocks share an SM up to D = 128) up to the
//   tile's causal limit, heaviest causal tiles first.
// - Every product is mma.sync m16n8k8 TF32 with f32 accumulators, three
//   a step. Q's A fragments come from shared memory by ldmatrix (8 x 16
//   bytes is 8 rows of 4 floats: lane (g, t) gets [g][t], the TF32
//   layout) and are split once (kQInRegisters<D>: D <= 64) or at each
//   k-step; K's B fragments by ldmatrix too, split at each k-step.
// - The keys of an 8-key block are taken in the order t, t + 4: K's row
//   for score column n is key n / 2 + 4 (n % 2), so that the score a
//   lane holds at columns 2t and 2t + 1 is P at keys t and t + 4, which
//   is the A fragment of P V as it stands (no shuffle), and V's B
//   fragment is rows t and t + 4 in order.
// - O's columns are taken in the order n-block j, column n -> n D / 8 + j,
//   so that a lane's V values for all n-blocks are D / 8 neighbouring
//   floats of a row: float4 loads (no bank conflict at D = 128). The
//   output tile is written back in order through the block's Q rows.
// - K and V tiles are staged with 16-byte cp.async in a ring of two, the
//   next tile's copies in flight while the current one is multiplied;
//   rows padded by 4 floats (ldmatrix's 8 rows in distinct bank groups).
//   Shared memory 101 KB at D = 128 (two blocks an SM), 200 KB at 256
//   (one).
//
// Head dims: instantiated at D = 32, 64, 96, 128 and 256, the bf16 kernel's
// widths, so the wrapper's padded route (ops/cuda/flash_attention.py)
// serves the others up to 256 the same way.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows a block: 4 warps x 16
constexpr int kThreads = kBQ / 16 * 32;
constexpr float kLog2e = 1.4426950408889634f;

// keys a tile, and whether a warp holds its Q fragments (split) in
// registers
template <int D>
constexpr int kKeyTile = D <= 64 ? 64 : 32;
template <int D>
constexpr bool kQInRegisters = D <= 64;

template <int D, bool kSegments>
constexpr int smem_bytes() {
  // Q, and two stages of K and V; with segments the Q tile's ids and two
  // stages of key ids
  constexpr int kBK = kKeyTile<D>;
  return (kBQ + 4 * kBK) * (D + 4) * 4 +
         (kSegments ? (kBQ + 2 * kBK) * 4 : 0);
}

template <int D, bool kSegments>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const ptt::SegIds seg, int sq,
                     int sk, int heads, int kv_heads, float scale,
                     int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dims of whole float4 runs");
  constexpr int kBK = kKeyTile<D>;
  constexpr bool kQRegs = kQInRegisters<D>;
  constexpr int S = D + 4;      // shared row stride, floats
  constexpr int kKd = D / 8;    // k-steps of Q K^T
  constexpr int kNs = kBK / 8;  // score n-blocks of a key tile
  constexpr int kNo = D / 8;    // output n-blocks
  extern __shared__ __align__(16) unsigned char fwd_f32_smem[];
  float* qs = reinterpret_cast<float*>(fwd_f32_smem);  // [kBQ][S]
  float* ks = qs + kBQ * S;                            // [2][kBK][S]
  float* vs = ks + 2 * kBK * S;                        // [2][kBK][S]
  int* qid_s = reinterpret_cast<int*>(vs + 2 * kBK * S);  // [kBQ]
  int* kid_s = qid_s + kBQ;                               // [2][kBK]

  // the last query tiles see the most keys: schedule them first
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % hb % heads, b = blockIdx.x % hb / heads;
  const int kh = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
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

  const int row = q0 + warp * 16 + g;  // this thread's rows: row, row + 8
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row
  // Q's A fragment of k-step kk: rows 0-7 and 8-15 of the warp's 16, at
  // columns 8 kk .. + 3 and 8 kk + 4 .. + 7
  const float* q_frag = qs + (warp * 16 + mrow + 8 * (mat & 1)) * S +
                        4 * (mat >> 1);
  // K's B fragments of n-blocks 2j, 2j + 1: key row n / 2 + 4 (n % 2)
  const int k_frag = (8 * (mat >> 1) + (mrow >> 1) + 4 * (mrow & 1)) * S +
                     4 * (mat & 1);
  uint32_t qh[kQRegs ? kKd : 1][4], ql[kQRegs ? kKd : 1][4];
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {ptt::kNegInf, ptt::kNegInf}, l[2] = {0.f, 0.f};

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
    if (kQRegs && step == 0) {
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk) {
        uint32_t raw[4];
        ptt::ldmatrix_x4<false>(raw, q_frag + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), qh[kk][a], ql[kk][a]);
        }
      }
    }
    const float* kst = ks + stage * kBK * S;
    const float* vst = vs + stage * kBK * S;

    // S = Q K^T over this warp's 16 rows and the tile's keys
    float s[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      if (!kQRegs) {  // this k-step's Q fragment, from the Q rows
        uint32_t raw[4];
        ptt::ldmatrix_x4<false>(raw, q_frag + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), qh[0][a], ql[0][a]);
        }
      }
      const uint32_t(&qfh)[4] = qh[kQRegs ? kk : 0];
      const uint32_t(&qfl)[4] = ql[kQRegs ? kk : 0];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t raw[4], bh[2][2], bl[2][2];
        ptt::ldmatrix_x4<false>(raw, kst + k_frag + 16 * j * S + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), bh[a >> 1][a & 1],
                          bl[a >> 1][a & 1]);
        }
        ptt::mma_3xtf32(s[2 * j], qfh, qfl, bh[0], bl[0]);
        ptt::mma_3xtf32(s[2 * j + 1], qfh, qfl, bh[1], bl[1]);
      }
    }

    const bool need_mask =
        kSegments || k0 + kBK > sk || (causal && k0 + kBK - 1 > q0 + off);
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
        s[n][e] *= scale;
        if (need_mask) {
          const int c = k0 + n * 8 + t + 4 * (e & 1);
          const int r = row + (e >> 1) * 8;
          if (c >= sk || (causal && c > r + off) ||
              (kSegments && cid[e & 1] != rid[e >> 1])) {
            s[n][e] = ptt::kNegInf;
          }
        }
      }
    }

    // online softmax: the row max over the quad, then P = exp(S - m)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f((m[r] - mx[r]) * kLog2e);
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
      // a row with no visible key yet keeps m = -1e30: its P must be 0
      mb[r] = (mx[r] == ptt::kNegInf ? 0.f : mx[r]) * kLog2e;
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], kLog2e, -mb[e >> 1]));
      }
      l[0] += s[n][0] + s[n][1];
      l[1] += s[n][2] + s[n][3];
    }

    // O += P V: n-block kk of P is the A fragment of keys 8 kk + (t, t + 4)
#pragma unroll
    for (int kk = 0; kk < kNs; ++kk) {
      uint32_t ph[4], pl[4];
      ptt::split_tf32(s[kk][0], ph[0], pl[0]);  // (g, t)
      ptt::split_tf32(s[kk][2], ph[1], pl[1]);  // (g + 8, t)
      ptt::split_tf32(s[kk][1], ph[2], pl[2]);  // (g, t + 4)
      ptt::split_tf32(s[kk][3], ph[3], pl[3]);  // (g + 8, t + 4)
      const float* v0 = vst + (kk * 8 + t) * S + g * kNo;
      const float* v1 = v0 + 4 * S;
#pragma unroll
      for (int c = 0; c < kNo / 4; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(v0 + 4 * c);
        const float4 z = *reinterpret_cast<const float4*>(v1 + 4 * c);
        const float va[4] = {a.x, a.y, a.z, a.w};
        const float vz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t bh[2], bl[2];
          ptt::split_tf32(va[e], bh[0], bl[0]);
          ptt::split_tf32(vz[e], bh[1], bl[1]);
          ptt::mma_3xtf32(acc[4 * c + e], ph, pl, bh, bl);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    kt = nkt;
  }
  ptt::cp_async_wait<0>();  // with no key tile, the Q copies
  __syncthreads();          // Q rows are free for the output

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // acc[j][2 r + e] is O at row g + 8 r, column (2 t + e) D / 8 + j
  float* os = qs + warp * 16 * S;  // this warp's own Q rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = os + (g + 8 * r) * S + (2 * t + e) * kNo;
#pragma unroll
      for (int c = 0; c < kNo / 4; ++c) {
        *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(
            acc[4 * c][2 * r + e] * inv[r], acc[4 * c + 1][2 * r + e] * inv[r],
            acc[4 * c + 2][2 * r + e] * inv[r],
            acc[4 * c + 3][2 * r + e] * inv[r]);
      }
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  float* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = j * 32 + lane;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int qr = q0 + warp * 16 + r;
    if (qr < sq) {
      *reinterpret_cast<float4*>(ob + qr * q_row + c) =
          *reinterpret_cast<const float4*>(os + r * S + c);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r < sq) {
        lse[(static_cast<long long>(b) * heads + h) * sq + row + 8 * r] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
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
