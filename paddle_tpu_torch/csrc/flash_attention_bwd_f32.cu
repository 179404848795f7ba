// Flash-attention backward in float32: dK/dV and dQ of O = softmax(Q K^T *
// scale [+ causal mask]) V from the forward's per-row lse and
// delta = rowsum(dO * O) (formed outside, in f32), never forming the
// (Sq, Sk) score matrix in memory, with every product in 3xTF32 on the
// tensor cores. With P = exp(S * scale - lse) and
// dS = P * (dO V^T - delta) * scale:
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
// This source holds dK/dV; dQ is csrc/flash_attention_bwd_dq_f32.cu (two
// sources, so that nvcc builds them in parallel), described here too.
//
// Replaces the Pallas kernels paddle_tpu/ops/pallas/flash_attention.py:181
// (_bwd_dkdv_kernel, called from _bwd at :328) and :245 (_bwd_dq_kernel,
// called at :371) on f32 inputs. The Pallas kernels are generic in their
// dtype and form S, P and dS in f32 (:197-216, :262-281); the JAX model's
// default dtype is f32. The same function as the bf16 kernels
// (csrc/flash_attention_bwd.cu): causal rows see keys c <= r + (sk - sq),
// GQA query head h reads kv head h / (H / KVH), and a kv head's dK and dV
// sum over its group inside one block, in f32, with no atomics (the same
// bits every run). The kSegments instantiations count an entry only where
// the query's int32 id equals the key's and skip tiles whose id ranges do
// not meet (ptt::SegWalk over the host-built (min, max) table per 32
// positions); P of every masked entry is set to 0, so a query row with no
// visible key (lse -1e30, where exp(S - lse) is inf) adds nothing.
//
// Numerics: every product is 3xTF32 (ptt::mma_3xtf32), as in the f32
// forward (csrc/flash_attention_f32.cu): each f32 operand (Q, K, V, dO, P,
// dS) is split into hi, its TF32 rounding to nearest, and lo, the rest,
// which the tensor core truncates; a b is hi hi + hi lo + lo hi, summed in
// f32, about 2^-21 relative per product. One TF32 product (1xTF32) keeps
// 11 bits and misses the f32 gate (1e-4 + 1e-4 relative against the plain
// f32 version): tests/test_torch_flash_rounding.py emulates both tile
// loops on the CPU against JAX's f32 Pallas backward. exp, the mask and
// dS are f32, as before. dV, dK and dQ sum over every query (the GQA group
// times sq) or key: a tile's products, 4 n-blocks at a time, are summed
// from zero on the tensor core and added to the sums by f32 adds. Summed
// on the tensor core alone from tile to tile, dK's and dV's errors grew
// with the chain and passed the gate at (2, 2048, 16, 256) on 2 kv heads
// (4.6e-4 and 8.1e-4, 2048 steps a row; 3.7e-5 and 6.9e-5 at the training
// shape's 192), where the chunked sums hold 4.2e-5 and 4.6e-5 (H100).
//
// Bound on the H100: the tensor cores. At the training shape (4, 1536, 12,
// 128), causal, 56.66 M visible (query, key) pairs: dK/dV does 4 products
// of 2 * D flops a pair (58.0 GFLOP), dQ 3 (43.5 GFLOP); three TF32
// products a flop at 495 TFLOP/s give 0.352 and 0.264 ms (the f32 FMA
// rate outside the tensor cores, 67 TFLOP/s, would give 0.866 and 0.650:
// the first design, SIMT FMAs, ran at 46% and 43% of that); the bytes
// (q, k, v, dO in, the gradients out, ~150 MB) take ~45 us.
//
// Fragments (m16n8k8 TF32, lane = 4 g + t; common.cuh): a fragment of
// 8 rows of 4 floats comes from shared memory by ldmatrix (8 x 16 bytes:
// lane (g, t) gets [g][t]). Taking the B side's rows of an 8-block in the
// order t, t + 4 (row n / 2 + 4 (n % 2) for column n) leaves the
// accumulator of a product holding, at columns 2t and 2t + 1, rows t and
// t + 4 of that side: the A fragment of the next product as it stands.
// The next product's output columns are taken in the order n-block j,
// column n -> n W / 8 + j (W its width), so that a lane's B values for all
// n-blocks are W / 8 neighbouring floats of one row: float4 loads.
//
// dQ (the forward's design): a block of 4 warps (8 at D = 128 on a full
// grid) owns 16 query rows a warp of one (b, h), Q and dO staged once, lse
// and delta of the lane's two rows in registers, and walks key tiles
// (kDqKeyTile<D>: 64 keys up to D = 64, 32 up to 128, 16 at 256) up to the
// tile's causal limit, K and V in a cp.async ring of two; the last query
// tiles, which see the most keys, go first. S = Q K^T and dP = dO V^T
// take Q and dO as A fragments, K and V rows as B in the order t, t + 4;
// P and dS = P (dP - delta) scale are formed in the accumulators, and dS
// is the A fragment of dQ += dS K, whose B is K rows t and t + 4 as
// float4. dQ is written once, through the warp's Q rows in shared memory.
//
// dK/dV: a block of 8 warps owns BK key rows of one (b, kv head) (64, or
// 32 where 64-row tiles would leave SMs idle at D = 64 or 128, as the bf16
// kernel; 32 at D = 256), K and V staged once, and walks the query tiles
// of every head of its group from the causal start max(k0 - (sk - sq), 0),
// Q, dO, lse and delta of each tile in a cp.async ring of two; key tile 0,
// which sees the most query tiles under a causal mask, goes first. The
// warps split the key rows (BK / 16, 16 rows a warp), D (kDSlices: 2 at
// D = 256, so that dK and dV stay 128 registers a lane) and the staged
// tile's queries (the rest, QW queries a warp). A warp forms S^T = K Q^T
// and dP^T = V dO^T over all of D with K and V as A fragments and its
// queries' Q and dO rows as B in the order t, t + 4; P^T and dS^T, formed
// in the accumulators with lse and delta of query columns t and t + 4
// from the ring, are the A fragments of dV += P^T dO and dK += dS^T Q over
// its D slice, whose B is dO or Q rows t and t + 4 as float4. No shared
// memory and no barrier stand between the two pairs of products. At the
// end the warps of the query groups leave their partial dK and dV in
// shared memory, which the block sums in a fixed order and writes once.
//
// Rows are padded by 4 floats (ldmatrix's 8 rows in distinct bank groups);
// the mask runs only on tiles that cross the diagonal or the end.
// Head dims: instantiated at D = 32, 64, 96, 128 and 256, the bf16 kernels'
// widths, so the wrapper's padded route (ops/cuda/flash_attention.py)
// serves the others up to 256.
#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---- dK/dV

constexpr int kDkdvThreads = 256;  // 8 warps

template <int D>
constexpr int kDSlices = D > 128 ? 2 : 1;  // warps along D

// queries a warp takes of each staged tile: 32, or 16 with 32-row key tiles
template <int BK>
constexpr int kQW = BK >= 64 ? 32 : 16;

// warps along the staged tile's queries, and the tile's queries
template <int D, int BK>
constexpr int kQGroups = 8 / (BK / 16) / kDSlices<D>;
template <int D, int BK>
constexpr int kBQ = kQGroups<D, BK> * kQW<BK>;

template <int D, int BK, bool kSegments>
constexpr int dkdv_smem_bytes() {
  // K, V; two stages of Q and dO; two stages of lse, delta (and with
  // segments of the query ids). The partial sums reuse K, V and the ring.
  constexpr int bq = kBQ<D, BK>;
  return (2 * BK + 4 * bq) * (D + 4) * 4 + (kSegments ? 6 : 4) * bq * 4;
}

template <int D, int BK, bool kSegments>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const ptt::SegIds seg, int sq, int sk, int heads,
                          int kv_heads, float scale, int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dims of whole float4 runs");
  constexpr int kRowG = BK / 16;           // warps along the key rows
  constexpr int kDS = kDSlices<D>;         // warps along D
  constexpr int kQG = kQGroups<D, BK>;     // warps along the queries
  constexpr int QW = kQW<BK>;              // queries a warp
  constexpr int BQ = kBQ<D, BK>;           // queries a staged tile
  constexpr int DW = D / kDS;              // dK, dV columns a warp
  constexpr int S = D + 4;                 // shared row stride, floats
  constexpr int kKd = D / 8;               // k-steps of S^T and dP^T
  constexpr int kNq = QW / 8;              // query n-blocks of a warp
  constexpr int kNo = DW / 8;              // dK, dV n-blocks of a warp
  static_assert(kRowG * kDS * kQG == 8 && QW % 16 == 0, "8 warps");
  extern __shared__ __align__(16) unsigned char dkdv_f32_smem[];
  float* ks = reinterpret_cast<float*>(dkdv_f32_smem);  // [BK][S]
  float* vs = ks + BK * S;                              // [BK][S]
  float* qs = vs + BK * S;                              // [2][BQ][S]
  float* dos = qs + 2 * BQ * S;                         // [2][BQ][S]
  float* lse_s = dos + 2 * BQ * S;                      // [2][BQ]
  float* dlt_s = lse_s + 2 * BQ;                        // [2][BQ]
  int* qid_s = reinterpret_cast<int*>(dlt_s + 2 * BQ);  // [2][BQ]

  // key tile 0 sees the most query tiles when causal: schedule it first
  const int kvb = gridDim.x / ((sk + BK - 1) / BK);
  const int kt = blockIdx.x / kvb;
  const int kh = blockIdx.x % kvb % kv_heads, b = blockIdx.x % kvb / kv_heads;
  const int k0 = kt * BK, off = sk - sq, group = heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowG;               // key rows 16 rg ..
  const int ds = warp / kRowG % kDS;         // columns DW ds ..
  const int qg = warp / (kRowG * kDS);       // queries QW qg .. of a tile
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_base =
      (static_cast<long long>(b) * sk * kv_heads + kh) * D;

  // causal: query rows r with r + off < k0 see nothing of this key tile
  const int q_first = causal ? max(k0 - off, 0) / BQ : 0;
  const int n_qt = (sq + BQ - 1) / BQ;

  // segments: the query tiles whose id range meets this key tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<BK>(seg.k_lo + b * nk32,
                                         seg.k_hi + b * nk32, nk32, k0);
    return ptt::seg_window<BQ>(seg.q_lo + b * nq32, seg.q_hi + b * nq32,
                               nq32, base, n_qt, want);
  };
  ptt::SegWalk walk;

  // the step (query head gi of the group, query tile qt) -> stage: Q, dO,
  // lse and delta of its tile (and with segments its query ids)
  auto prefetch = [&](int gi, int qt, int stage) {
    const int h = kh * group + gi, q0 = qt * BQ;
    const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
    ptt::cp_async_rows_f32<BQ, D, kDkdvThreads>(qs + stage * BQ * S,
                                                q + q_base, q_row, q0, sq);
    ptt::cp_async_rows_f32<BQ, D, kDkdvThreads>(dos + stage * BQ * S,
                                                dout + q_base, q_row, q0, sq);
    const int i = threadIdx.x % BQ, r = q0 + i;
    const long long row_base = (static_cast<long long>(b) * heads + h) * sq;
    const int at = stage * BQ + i;
    if (threadIdx.x < BQ) {
      ptt::cp_async_4(lse_s + at, lse + row_base + (r < sq ? r : 0),
                      r < sq ? 4 : 0);
    } else if (threadIdx.x < 2 * BQ) {
      ptt::cp_async_4(dlt_s + at, delta + row_base + (r < sq ? r : 0),
                      r < sq ? 4 : 0);
    } else if (kSegments && threadIdx.x < 3 * BQ) {
      const int* qid = seg.q + static_cast<long long>(b) * sq;
      ptt::cp_async_4(qid_s + at, qid + (r < sq ? r : 0), r < sq ? 4 : 0);
    }
  };

  ptt::cp_async_rows_f32<BK, D, kDkdvThreads>(ks, k + kv_base, kv_row, k0,
                                              sk);
  ptt::cp_async_rows_f32<BK, D, kDkdvThreads>(vs, v + kv_base, kv_row, k0,
                                              sk);
  // the first step (the walk's reads overlap the K/V copies); gi == group:
  // no step at all
  int gi = 0, qt = q_first;
  if (kSegments) {
    walk.start(q_first, window);
    qt = walk.next(n_qt, window);
  }
  if (qt >= n_qt) gi = group;
  if (gi < group) prefetch(gi, qt, 0);
  ptt::cp_async_commit();

  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row
  // K's (V's) A fragment of k-step kk: rows 0-7 and 8-15 of the warp's 16,
  // at columns 8 kk .. + 3 and 8 kk + 4 .. + 7
  const int a_frag = (rg * 16 + mrow + 8 * (mat & 1)) * S + 4 * (mat >> 1);
  // Q's (dO's) B fragments of query n-blocks 2j, 2j + 1 of the warp's
  // queries: query row n / 2 + 4 (n % 2)
  const int b_frag =
      (qg * QW + 8 * (mat >> 1) + (mrow >> 1) + 4 * (mrow & 1)) * S +
      4 * (mat & 1);
  // this lane's key rows c_row, c_row + 8; its dK, dV columns of n-block j:
  // DW ds + (2 t + e) DW / 8 + j
  const int c_row = k0 + rg * 16 + g;
  float dk_acc[kNo][4], dv_acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  int cid[2] = {0, 0};  // with segments: the ids of key rows c_row, + 8
  if (kSegments) {
    const int* kid = seg.k + static_cast<long long>(b) * sk;
    cid[0] = c_row < sk ? kid[c_row] : 0;
    cid[1] = c_row + 8 < sk ? kid[c_row + 8] : 0;
  }

  for (int it = 0; gi < group; ++it) {
    // the next step: the next query tile of this head, else the first of
    // the next head
    int ngi = gi, nqt = kSegments ? walk.next(n_qt, window) : qt + 1;
    if (nqt >= n_qt) {
      ++ngi;
      nqt = q_first;
      if (kSegments) {
        walk.start(q_first, window);
        nqt = walk.next(n_qt, window);
      }
    }
    const int stage = it & 1;
    if (ngi < group) {
      prefetch(ngi, nqt, stage ^ 1);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * BQ;
    const float* qst = qs + stage * BQ * S;
    const float* dost = dos + stage * BQ * S;
    const float* lse_t = lse_s + stage * BQ;
    const float* dlt_t = dlt_s + stage * BQ;
    const int* qid_t = qid_s + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 key rows x its QW
    // queries, over all of D
    float st[kNq][4], dpt[kNq][4];
#pragma unroll
    for (int n = 0; n < kNq; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      uint32_t raw[4], kah[4], kal[4], vah[4], val[4];
      ptt::ldmatrix_x4<false>(raw, ks + a_frag + kk * 8);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ptt::split_tf32(__uint_as_float(raw[a]), kah[a], kal[a]);
      }
      ptt::ldmatrix_x4<false>(raw, vs + a_frag + kk * 8);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ptt::split_tf32(__uint_as_float(raw[a]), vah[a], val[a]);
      }
#pragma unroll
      for (int j = 0; j < QW / 16; ++j) {
        uint32_t bh[2][2], bl[2][2];
        ptt::ldmatrix_x4<false>(raw, qst + b_frag + 16 * j * S + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), bh[a >> 1][a & 1],
                          bl[a >> 1][a & 1]);
        }
        ptt::mma_3xtf32(st[2 * j], kah, kal, bh[0], bl[0]);
        ptt::mma_3xtf32(st[2 * j + 1], kah, kal, bh[1], bl[1]);
        ptt::ldmatrix_x4<false>(raw, dost + b_frag + 16 * j * S + kk * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ptt::split_tf32(__uint_as_float(raw[a]), bh[a >> 1][a & 1],
                          bl[a >> 1][a & 1]);
        }
        ptt::mma_3xtf32(dpt[2 * j], vah, val, bh[0], bl[0]);
        ptt::mma_3xtf32(dpt[2 * j + 1], vah, val, bh[1], bl[1]);
      }
    }

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale: entry
    // e of n-block n is key row c_row + 8 (e >> 1), query column
    // QW qg + 8 n + t + 4 (e & 1) of the tile
    const bool need_mask =
        kSegments || q0 + BQ > sq || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int n = 0; n < kNq; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ql = qg * QW + n * 8 + t + 4 * h, r = q0 + ql;
        const float lb = lse_t[ql] * kLog2e, dl = dlt_t[ql];
        const int rid = kSegments ? qid_t[ql] : 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half + h;
          float p = exp2f(fmaf(st[n][e], scale_log2, -lb));
          if (need_mask) {
            const int c = c_row + 8 * half;
            if (r >= sq || (causal && c > r + off) ||
                (kSegments && rid != cid[half])) {
              p = 0.f;
            }
          }
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl) * scale;
        }
      }
    }

    // dV += P^T dO, then dK += dS^T Q, over the warp's queries and D slice,
    // 4 n-blocks at a time: the tile's products are summed from zero on the
    // tensor core and added to the sums in f32. n-block kk of P^T (dS^T)
    // is the A fragment of queries 8 kk + (t, t + 4); B is dO (Q) rows t
    // and t + 4, as float4
    auto product = [&](const float(&w)[kNq][4], const float* zs,
                       float(&acc)[kNo][4]) {
#pragma unroll
      for (int c = 0; c < kNo / 4; ++c) {
        float tile[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) tile[e][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kNq; ++kk) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {  // (g, t), (g + 8, t), (g, t + 4), ..
            ptt::split_tf32(w[kk][2 * (a & 1) + (a >> 1)], ah[a], al[a]);
          }
          const float* z0 =
              zs + (qg * QW + kk * 8 + t) * S + ds * DW + g * kNo + 4 * c;
          const float4 a4 = *reinterpret_cast<const float4*>(z0);
          const float4 z4 = *reinterpret_cast<const float4*>(z0 + 4 * S);
          const float za[4] = {a4.x, a4.y, a4.z, a4.w};
          const float zz[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t bh[2], bl[2];
            ptt::split_tf32(za[e], bh[0], bl[0]);
            ptt::split_tf32(zz[e], bh[1], bl[1]);
            ptt::mma_3xtf32(tile[e], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[4 * c + e][i] += tile[e][i];
      }
    };
    product(st, dost, dv_acc);
    product(dpt, qst, dk_acc);
    __syncthreads();  // every warp is done with this stage
    gi = ngi;
    qt = nqt;
  }
  ptt::cp_async_wait<0>();  // with no query tile, the K/V copies
  __syncthreads();          // K, V and the ring are free

  // the query groups' partial dK (then dV) into [kQG][BK][S], summed in
  // group order and written once, 16 bytes a thread
  float* part = ks;
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  auto flush = [&](const float(&acc)[kNo][4], float* dst_g) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = part + (qg * BK + rg * 16 + g + 8 * half) * S + ds * DW +
                     (2 * t + e) * kNo;
#pragma unroll
        for (int c = 0; c < kNo / 4; ++c) {
          *reinterpret_cast<float4*>(dst + 4 * c) =
              make_float4(acc[4 * c][2 * half + e],
                          acc[4 * c + 1][2 * half + e],
                          acc[4 * c + 2][2 * half + e],
                          acc[4 * c + 3][2 * half + e]);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BK * kChunks; i += kDkdvThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      if (k0 + r < sk) {
        float4 sum = *reinterpret_cast<const float4*>(part + r * S + c);
#pragma unroll
        for (int p = 1; p < kQG; ++p) {
          const float4 x =
              *reinterpret_cast<const float4*>(part + (p * BK + r) * S + c);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        *reinterpret_cast<float4*>(dst_g + kv_base + (k0 + r) * kv_row + c) =
            sum;
      }
    }
    __syncthreads();  // the partials are read before the next are written
  };
  flush(dk_acc, dk);
  flush(dv_acc, dv);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  ptt::SegIds seg;
  int b, sq, sk, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, int BK, bool kSegments>
int launch_dkdv_tile(const Args& a, float* dk, float* dv) {
  constexpr int smem = dkdv_smem_bytes<D, BK, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D, BK, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.sk + BK - 1) / BK * a.kv_heads * a.b;
  flash_bwd_dkdv_f32_kernel<D, BK, kSegments>
      <<<blocks, kDkdvThreads, smem, a.stream>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.seg, a.sq, a.sk,
          a.heads, a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BK>
int launch_dkdv_tile(const Args& a, float* dk, float* dv) {
  if (a.seg.q != nullptr) return launch_dkdv_tile<D, BK, true>(a, dk, dv);
  return launch_dkdv_tile<D, BK, false>(a, dk, dv);
}

// 64-key tiles, or 32 where 64 would leave SMs without a block (the GQA
// case: 2 x 4 kv heads x 512 keys is 64 blocks of 64 keys on 132 SMs, 128
// of 32); D = 32 and 96 only 64, as the bf16 kernel; D = 256 only 32 (dK,
// dV of 16 rows x 128 columns a warp)
template <int D>
int launch_dkdv(const Args& a, float* dk, float* dv) {
  if constexpr (D > 128) {
    return launch_dkdv_tile<D, 32>(a, dk, dv);
  } else if constexpr (D % 64 != 0) {
    return launch_dkdv_tile<D, 64>(a, dk, dv);
  } else {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((a.sk + 63) / 64 * a.kv_heads * a.b >= sms) {
      return launch_dkdv_tile<D, 64>(a, dk, dv);
    }
    return launch_dkdv_tile<D, 32>(a, dk, dv);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const int* q_seg,
               const int* k_seg, const int* q_lo, const int* q_hi,
               const int* k_lo, const int* k_hi, int b, int sq, int sk,
               int heads, int kv_heads, float scale, int causal,
               void* stream) {
  return Args{static_cast<const float*>(q),
              static_cast<const float*>(k),
              static_cast<const float*>(v),
              static_cast<const float*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              ptt::SegIds{q_seg, k_seg, q_lo, q_hi, k_lo, k_hi},
              b, sq, sk, heads, kv_heads, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, dout: (b, sq, heads, d); k, v, dk, dv: (b, sk, kv_heads, d), all f32
// row-major, 16-byte aligned; lse, delta: (b, heads, sq) f32. d is 32, 64,
// 96, 128 or 256; scale is the caller's; the segment arguments as
// ptt_flash_attention_bwd_dkdv's.
PTT_EXPORT int ptt_flash_attention_bwd_dkdv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const int* q_seg,
    const int* k_seg, const int* q_lo, const int* q_hi, const int* k_lo,
    const int* k_hi, int b, int sq, int sk, int heads, int kv_heads, int d,
    float scale, int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, q_seg, k_seg, q_lo,
                           q_hi, k_lo, k_hi, b, sq, sk, heads, kv_heads,
                           scale, causal, stream);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  switch (d) {
    case 32: return launch_dkdv<32>(a, dkp, dvp);
    case 64: return launch_dkdv<64>(a, dkp, dvp);
    case 96: return launch_dkdv<96>(a, dkp, dvp);
    case 128: return launch_dkdv<128>(a, dkp, dvp);
    case 256: return launch_dkdv<256>(a, dkp, dvp);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
