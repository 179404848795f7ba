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
// one block owns a tile of key rows of one (b, kv head), loops over every
// query head of its group and over the causal range of query tiles
// (starting at max(k0 - (sk - sq), 0), :209), keeps dK and dV in f32
// registers and writes them once: no atomics, the same bits every run.
// The dQ block owns a tile of query rows of one (b, h), loops over the
// causal range of key tiles and writes each dQ row once, also without
// atomics.
//
// Segment masking (the Pallas kernels' masked=True, :224-226 and :278-280)
// is the kSegments instantiation of both kernels: an entry counts only
// where the query's int32 id equals the key's. A block keeps the ids of its
// own rows (dK/dV: its key rows, in registers; dQ: its query rows, in
// shared memory beside Q) and stages the streamed side's 64 ids with each
// tile in the same cp.async ring. Every visited tile takes the per-element
// mask, in the accumulator layout (lane l: rows l/4, l/4 + 8; columns
// 2(l%4) + {0, 1} of each n-block), and P of a masked entry is set to 0
// explicitly: a query row that sees no key has lse = -1e30, where
// exp(S - lse) would give inf rather than 0, so such a row adds nothing to
// dQ, dK or dV. A tile pair whose id ranges do not meet is skipped
// (ptt::SegWalk over the host-built (min, max) table per 32 positions; the
// ring prefetches the next tile that is not skipped). dK/dV walks the
// query tiles from its causal start for each head of the group; dQ walks
// the key tiles up to its causal limit. The unmasked instantiations keep
// their code path.
//
// Bound on the H100 at the training shape (4, 1536, 12, 128), causal,
// 56.66 M (query, key) pairs: operations. dK/dV does 4 products of
// 2 * D flops per pair (58.0 GFLOP, 58.7 us at the bf16 tensor-core
// peak), dQ 3 (43.5 GFLOP, 44.0 us); the bytes (q, k, v, dO, lse, delta
// in, the gradients out) take ~22 us. With segments the pairs are the
// visible, same-segment ones, counted from the ids (chip_smoke.py), and
// the bytes add the ids.
//
// dK/dV runs on the tensor cores. A block of 8 warps owns BK = 64 key rows
// (32 where 64-row tiles would leave SMs idle) and walks 64-row query
// tiles. With the key rows as the M side, S^T = K Q^T and dP^T = V dO^T
// are bf16 mma.sync.m16n8k16 products with f32 accumulators: BK / 16
// warps split the key rows and the rest split the tile's queries. P^T and
// dS^T are formed in the accumulators and pass through small padded tiles
// in shared memory, each as two bf16 parts (its rounding and the rounding
// of the rest, ptt::split_bf16: ~16 bits, where the Pallas kernel keeps P
// and dS in f32; one rounding misses the port's gate, as
// tests/test_torch_flash_rounding.py shows). Then dV += P^T dO and
// dK += dS^T Q run, each part an A operand, with the warps split over the
// key rows and D, so the f32 dK and dV of a warp are
// 2 x 16 x D / (8 / (BK / 16)) values. The tensor cores do 6 products'
// work where the function needs 4.
// Q, dO, lse and delta are staged by cp.async (16 bytes a lane for the
// rows, 4 for lse and delta) in a ring of two tiles, the next tile's
// copies in flight during the current one's products; K and V are staged
// once. Shared rows are padded by 8 bf16, so ldmatrix (dO and Q through
// .trans) is free of bank conflicts. Key tile 0, which sees the most query
// tiles under a causal mask, is scheduled first. The mask is applied only on
// the query tiles that cross the diagonal or the end of the rows.
//
// dQ runs on the same machinery with the query rows as the M side. A block of
// 4 warps owns 64 query rows, 16 a warp, and walks 64-key tiles up to the
// tile's causal limit, the last query tiles launched first (blocks of 8 warps
// and 128 rows, which stage each K/V tile once for twice the queries, were
// slower at all three timed shapes on the H100: PERF.md). Q and dO are staged
// once; K and V by cp.async in a ring of two tiles, the next tile's copies in
// flight during the current one's products; rows padded by 8 bf16. S = Q K^T
// and dP = dO V^T are mma.sync products (Q and dO rows as A through ldmatrix,
// K and V rows as B), and dS = P (dP - delta) scale is formed in the
// accumulators, whose layout is the A operand's of the next product: dS never
// leaves the registers. dQ += dS K takes dS as two bf16 parts (one rounding
// misses the gate, tests/test_torch_flash_rounding.py) and K through
// ldmatrix.trans, into 16 x D f32 accumulators a warp, written once as bf16
// through the warp's Q rows in shared memory. The tensor cores do 4 products'
// work where the function needs 3; the mask runs only on the key tiles that
// cross the diagonal or the end of the keys.
//
// Head dims: both kernels are instantiated at D = 32, 64, 96, 128 and 256,
// as the forward (csrc/flash_attention.cu); the wrapper pads any other
// D <= 256 to the next of these. Every loop over D steps by 16. dK/dV
// splits D over kColG = 8 / (BK / 16) warps in slices of DW = D / kColG,
// which must be whole 16-column slices: 64-key tiles (kColG 2) take any of
// the five widths up to 128, 32-key tiles (kColG 4) only D % 64 == 0, so
// D = 32 and 96 always take 64-key tiles. At D = 256 a 64-key tile would
// need 235 KB of shared memory and 128 registers of dK and dV a thread, so
// it takes 32-key tiles (189 KB, one block of 8 warps an SM). dQ's f32
// accumulator is 16 x D a warp, 128 registers a thread at D = 256, so
// there it walks 32-key tiles (S and dP 32 registers, not 64). D <= 128
// keeps its tiles and code.
#include "common.cuh"

namespace {

// ---- dK/dV on the tensor cores (see the note at the top of the file)

constexpr int kDkdvThreads = 256;  // 8 warps
constexpr int kBQd = 64;           // query rows per tile of the loop
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BK, bool kSegments>
constexpr size_t dkdv_smem_bytes() {
  // K, V; two stages of Q and dO; P^T and dS^T as hi and lo bf16 parts;
  // two stages of lse and delta (and with segments of the query ids)
  return static_cast<size_t>(2 * BK + 4 * kBQd) * (D + 8) * 2 +
         static_cast<size_t>(4 * BK) * (kBQd + 8) * 2 +
         (kSegments ? 6 : 4) * kBQd * 4;
}

template <int D, int BK, bool kSegments>
__global__ void __launch_bounds__(kDkdvThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, const ptt::SegIds seg,
                      int sq, int sk, int heads, int kv_heads, float scale,
                      int causal) {
  constexpr int S = D + 8;           // shared row stride of K, V, Q, dO
  constexpr int PS = kBQd + 8;       // shared row stride of P^T, dS^T
  constexpr int kRowG = BK / 16;     // warps along the key rows
  constexpr int kColG = 8 / kRowG;   // warps along queries, then along D
  constexpr int QW = kBQd / kColG;   // queries per warp in S^T, dP^T
  constexpr int DW = D / kColG;      // head dims per warp in dK, dV
  static_assert(QW % 16 == 0 && DW % 16 == 0, "warp tiles of 16");
  static_assert(BK * (D / 8) % kDkdvThreads == 0, "whole write-back rounds");
  extern __shared__ __align__(16) unsigned char dkdv_smem[];
  auto* ks = reinterpret_cast<__nv_bfloat16*>(dkdv_smem);
  __nv_bfloat16* vs = ks + BK * S;
  __nv_bfloat16* qs = vs + BK * S;          // [2][kBQd][S]
  __nv_bfloat16* dos = qs + 2 * kBQd * S;   // [2][kBQd][S]
  __nv_bfloat16* pts = dos + 2 * kBQd * S;  // P^T [hi, lo][BK][PS]
  __nv_bfloat16* dss = pts + 2 * BK * PS;   // dS^T [hi, lo][BK][PS]
  auto* lse_s = reinterpret_cast<float*>(dss + 2 * BK * PS);  // [2][kBQd]
  float* dlt_s = lse_s + 2 * kBQd;                        // [2][kBQd]
  int* qid_s = reinterpret_cast<int*>(dlt_s + 2 * kBQd);  // [2][kBQd]

  // key tile 0 loops over the most query tiles when causal: schedule first
  const int kvb = gridDim.x / ((sk + BK - 1) / BK);
  const int kt = blockIdx.x / kvb;
  const int kh = blockIdx.x % kvb % kv_heads, b = blockIdx.x % kvb / kv_heads;
  const int k0 = kt * BK, off = sk - sq, group = heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, quad = lane >> 3;
  const int rg = warp % kRowG, cg = warp / kRowG;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_base = (static_cast<long long>(b) * sk * kv_heads + kh) * D;

  // causal: query rows r with r + off < k0 see nothing of this key tile
  const int q_first = causal ? max(k0 - off, 0) / kBQd : 0;
  const int n_qt = (sq + kBQd - 1) / kBQd;

  // segments: the query tiles whose id range meets this key tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<BK>(seg.k_lo + b * nk32,
                                         seg.k_hi + b * nk32, nk32, k0);
    return ptt::seg_window<kBQd>(seg.q_lo + b * nq32, seg.q_hi + b * nq32,
                                 nq32, base, n_qt, want);
  };
  ptt::SegWalk walk;

  // the step (query head gi of the group, query tile qt) -> stage: Q, dO,
  // lse and delta of its tile (and with segments its query ids)
  auto prefetch = [&](int gi, int qt, int stage) {
    const int h = kh * group + gi, q0 = qt * kBQd;
    const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
    ptt::cp_async_rows<kBQd, D, kDkdvThreads>(qs + stage * kBQd * S,
                                              q + q_base, q_row, q0, sq);
    ptt::cp_async_rows<kBQd, D, kDkdvThreads>(dos + stage * kBQd * S,
                                              dout + q_base, q_row, q0, sq);
    const int i = threadIdx.x % kBQd, r = q0 + i;
    const long long row_base = (static_cast<long long>(b) * heads + h) * sq;
    const float* src = threadIdx.x < kBQd ? lse : delta;
    if (threadIdx.x < 2 * kBQd) {
      ptt::cp_async_4((threadIdx.x < kBQd ? lse_s : dlt_s) + stage * kBQd + i,
                      src + row_base + (r < sq ? r : 0), r < sq ? 4 : 0);
    } else if (kSegments && threadIdx.x < 3 * kBQd) {
      const int* qid = seg.q + static_cast<long long>(b) * sq;
      ptt::cp_async_4(qid_s + stage * kBQd + i, qid + (r < sq ? r : 0),
                      r < sq ? 4 : 0);
    }
  };

  ptt::cp_async_rows<BK, D, kDkdvThreads>(ks, k + kv_base, kv_row, k0, sk);
  ptt::cp_async_rows<BK, D, kDkdvThreads>(vs, v + kv_base, kv_row, k0, sk);
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

  // this warp's key rows k0 + 16 rg + (g, g + 8), head dims cg * DW + ...
  float dk_acc[DW / 8][4], dv_acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int c_row = k0 + rg * 16 + g;
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
    const int q0 = qt * kBQd;
    const __nv_bfloat16* qst = qs + stage * kBQd * S;
    const __nv_bfloat16* dost = dos + stage * kBQd * S;
    const float* lse_t = lse_s + stage * kBQd;
    const float* dlt_t = dlt_s + stage * kBQd;
    const int* qid_t = qid_s + stage * kBQd;

    // S^T = K Q^T and dP^T = V dO^T: 16 key rows x QW queries per warp
    float st[QW / 8][4], dpt[QW / 8][4];
#pragma unroll
    for (int n = 0; n < QW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (rg * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ptt::ldmatrix_x4<false>(ka, ks + a_off);
      ptt::ldmatrix_x4<false>(va, vs + a_off);
#pragma unroll
      for (int j = 0; j < QW / 16; ++j) {
        const int b_off = (cg * QW + j * 16 + (quad >> 1) * 8 + (lane & 7)) * S +
                          kk * 16 + (quad & 1) * 8;
        uint32_t bq[4], bo[4];
        ptt::ldmatrix_x4<false>(bq, qst + b_off);
        ptt::mma_bf16(st[2 * j], ka, bq[0], bq[1]);
        ptt::mma_bf16(st[2 * j + 1], ka, bq[2], bq[3]);
        ptt::ldmatrix_x4<false>(bo, dost + b_off);
        ptt::mma_bf16(dpt[2 * j], va, bo[0], bo[1]);
        ptt::mma_bf16(dpt[2 * j + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale, each
    // split into two bf16 parts in shared memory for the gradient products
    const bool need_mask =
        kSegments || q0 + kBQd > sq || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int n = 0; n < QW / 8; ++n) {
      int2 rid = make_int2(0, 0);  // the ids of query columns 2t, 2t + 1
      if (kSegments) {
        rid = *reinterpret_cast<const int2*>(qid_t + cg * QW + n * 8 + 2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = cg * QW + n * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(st[n][e], scale_log2, -lse_t[rl] * kLog2e));
        if (need_mask) {
          const int r = q0 + rl, c = c_row + (e >> 1) * 8;
          if (r >= sq || (causal && c > r + off) ||
              (kSegments && (e & 1 ? rid.y : rid.x) != cid[e >> 1])) {
            p = 0.f;
          }
        }
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dlt_t[rl]) * scale;
      }
      const int col = cg * QW + n * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // key rows g, then g + 8
        const int at = (rg * 16 + g + 8 * half) * PS + col;
        auto* dst = reinterpret_cast<uint32_t*>(pts + at);
        ptt::split_bf16(st[n][2 * half], st[n][2 * half + 1], dst[0],
                        dst[BK * PS / 2]);
        dst = reinterpret_cast<uint32_t*>(dss + at);
        ptt::split_bf16(dpt[n][2 * half], dpt[n][2 * half + 1], dst[0],
                        dst[BK * PS / 2]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: 16 key rows x DW head dims per warp
#pragma unroll
    for (int kk = 0; kk < kBQd / 16; ++kk) {
      uint32_t pa[2][4], da[2][4];  // [hi, lo]
      const int a_off = (rg * 16 + (lane & 15)) * PS + kk * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        ptt::ldmatrix_x4<false>(pa[part], pts + part * BK * PS + a_off);
        ptt::ldmatrix_x4<false>(da[part], dss + part * BK * PS + a_off);
      }
#pragma unroll
      for (int j = 0; j < DW / 16; ++j) {
        const int b_off = (kk * 16 + (quad & 1) * 8 + (lane & 7)) * S +
                          cg * DW + j * 16 + (quad >> 1) * 8;
        uint32_t bo[4], bq[4];
        ptt::ldmatrix_x4<true>(bo, dost + b_off);
        ptt::ldmatrix_x4<true>(bq, qst + b_off);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          ptt::mma_bf16(dv_acc[2 * j], pa[part], bo[0], bo[1]);
          ptt::mma_bf16(dv_acc[2 * j + 1], pa[part], bo[2], bo[3]);
          ptt::mma_bf16(dk_acc[2 * j], da[part], bq[0], bq[1]);
          ptt::mma_bf16(dk_acc[2 * j + 1], da[part], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and P^T, dS^T
    gi = ngi;
    qt = nqt;
  }
  ptt::cp_async_wait<0>();  // with no query tile, the K/V copies
  __syncthreads();

  // dK, dV through the K and V tiles in shared memory, 16 bytes a lane
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = cg * DW + n * 8 + 2 * t;
    const int r0 = (rg * 16 + g) * S + col, r8 = r0 + 8 * S;
    *reinterpret_cast<uint32_t*>(ks + r0) = ptt::pack_bf16(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<uint32_t*>(ks + r8) = ptt::pack_bf16(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<uint32_t*>(vs + r0) = ptt::pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(vs + r8) = ptt::pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
  __syncthreads();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < BK * kChunks / kDkdvThreads; ++j) {
    const int i = j * kDkdvThreads + threadIdx.x;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (k0 + r < sk) {
      const long long o = kv_base + (k0 + r) * kv_row + c;
      *reinterpret_cast<uint4*>(dk + o) =
          *reinterpret_cast<const uint4*>(ks + r * S + c);
      *reinterpret_cast<uint4*>(dv + o) =
          *reinterpret_cast<const uint4*>(vs + r * S + c);
    }
  }
}

// ---- dQ on the tensor cores (see the note at the top of the file)

constexpr int kBQq = 64;   // query rows of a dQ block: 4 warps x 16
constexpr int kDqThreads = kBQq / 16 * 32;

// keys per tile of the dQ loop
template <int D>
constexpr int kDqKeyTile = D <= 128 ? 64 : 32;

template <int D, bool kSegments>
constexpr size_t dq_smem_bytes() {
  // Q and dO, two stages of K and V; with segments the query ids and two
  // stages of key ids
  constexpr int kBKq = kDqKeyTile<D>;
  return static_cast<size_t>(2 * kBQq + 4 * kBKq) * (D + 8) * 2 +
         (kSegments ? (kBQq + 2 * kBKq) * 4 : 0);
}

template <int D, bool kSegments>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, const ptt::SegIds seg,
                    int sq, int sk, int heads, int kv_heads, float scale,
                    int causal) {
  static_assert(D % 16 == 0 && D <= 256, "head dims of whole k-steps");
  constexpr int BQ = kBQq;
  constexpr int kBKq = kDqKeyTile<D>;
  constexpr int kThreadsQ = kDqThreads;
  constexpr int S = D + 8;         // shared row stride, bf16
  constexpr int kKd = D / 16;      // k-steps of S and dP
  constexpr int kNs = kBKq / 8;    // score n-blocks of a key tile
  constexpr int kNo = D / 8;       // dQ n-blocks
  extern __shared__ __align__(16) unsigned char dq_smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(dq_smem);
  __nv_bfloat16* dos = qs + BQ * S;
  __nv_bfloat16* ks = dos + BQ * S;       // [2][kBKq][S]
  __nv_bfloat16* vs = ks + 2 * kBKq * S;  // [2][kBKq][S]
  int* qid_s = reinterpret_cast<int*>(vs + 2 * kBKq * S);  // [BQ]
  int* kid_s = qid_s + BQ;                                 // [2][kBKq]

  // the last query tiles see the most keys: schedule them first
  const int n_qt = (sq + BQ - 1) / BQ;
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % hb % heads, b = blockIdx.x % hb / heads;
  const int kh = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, quad = lane >> 3;
  const int q0 = qt * BQ, off = sk - sq;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
  const long long kv_base = (static_cast<long long>(b) * sk * kv_heads + kh) * D;
  const __nv_bfloat16* kb = k + kv_base;
  const __nv_bfloat16* vb = v + kv_base;

  // causal: the tile's last row sees keys c <= r_last + off
  int k_end = sk;
  if (causal) k_end = max(min(sk, min(q0 + BQ, sq) + off), 0);
  const int n_kt = (k_end + kBKq - 1) / kBKq;

  // segments: the key tiles whose id range meets this query tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<BQ>(seg.q_lo + b * nq32,
                                         seg.q_hi + b * nq32, nq32, q0);
    return ptt::seg_window<kBKq>(seg.k_lo + b * nk32, seg.k_hi + b * nk32,
                                 nk32, base, n_kt, want);
  };
  ptt::SegWalk walk;
  // K, V (and with segments the key ids) of tile kt into a stage
  auto stage_kv = [&](int kt, int stage) {
    const int k0 = kt * kBKq, at = stage * kBKq * S;
    ptt::cp_async_rows<kBKq, D, kThreadsQ>(ks + at, kb, kv_row, k0, sk);
    ptt::cp_async_rows<kBKq, D, kThreadsQ>(vs + at, vb, kv_row, k0, sk);
    if (kSegments && threadIdx.x < kBKq) {
      const int c = k0 + threadIdx.x;
      const int* kid = seg.k + static_cast<long long>(b) * sk;
      ptt::cp_async_4(kid_s + stage * kBKq + threadIdx.x,
                      kid + (c < sk ? c : 0), c < sk ? 4 : 0);
    }
  };

  ptt::cp_async_rows<BQ, D, kThreadsQ>(qs, q + q_base, q_row, q0, sq);
  ptt::cp_async_rows<BQ, D, kThreadsQ>(dos, dout + q_base, q_row, q0, sq);
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
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    lse2[r] = rr < sq ? lse[row_base + rr] * kLog2e : 0.f;
    dlt[r] = rr < sq ? delta[row_base + rr] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // it counts the tiles visited; unmasked it equals kt
  for (int it = 0; kt < n_kt; ++it) {
    const int nkt = kSegments ? walk.next(n_kt, window) : kt + 1;
    const int k0 = kt * kBKq, stage = (kSegments ? it : kt) & 1;
    if (nkt < n_kt) {
      stage_kv(nkt, stage ^ 1);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * kBKq * S;
    const __nv_bfloat16* vst = vs + stage * kBKq * S;

    // S = Q K^T and dP = dO V^T over this warp's 16 rows and the tile's keys
    float s[kNs][4], dp[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      uint32_t qa[4], oa[4];
      const int a_off = (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ptt::ldmatrix_x4<false>(qa, qs + a_off);
      ptt::ldmatrix_x4<false>(oa, dos + a_off);
#pragma unroll
      for (int j = 0; j < kBKq / 16; ++j) {
        const int b_off = (j * 16 + (quad >> 1) * 8 + (lane & 7)) * S +
                          kk * 16 + (quad & 1) * 8;
        uint32_t bk[4], bv[4];
        ptt::ldmatrix_x4<false>(bk, kst + b_off);
        ptt::mma_bf16(s[2 * j], qa, bk[0], bk[1]);
        ptt::mma_bf16(s[2 * j + 1], qa, bk[2], bk[3]);
        ptt::ldmatrix_x4<false>(bv, vst + b_off);
        ptt::mma_bf16(dp[2 * j], oa, bv[0], bv[1]);
        ptt::mma_bf16(dp[2 * j + 1], oa, bv[2], bv[3]);
      }
    }

    // P = exp(S scale - lse) and dS = P (dP - delta) scale, in place of dP;
    // the mask only on tiles that cross the diagonal or the end of the keys
    const bool need_mask =
        kSegments || k0 + kBKq > sk || (causal && k0 + kBKq - 1 > q0 + off);
    int rid[2] = {0, 0};  // this thread's rows' ids
    if (kSegments) {
      rid[0] = qid_s[warp * 16 + g];
      rid[1] = qid_s[warp * 16 + g + 8];
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      int2 cid = make_int2(0, 0);  // the ids of columns 2t, 2t + 1
      if (kSegments) {
        cid = *reinterpret_cast<const int2*>(kid_s + stage * kBKq + n * 8 +
                                             2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        if (need_mask) {
          const int c = k0 + n * 8 + 2 * t + (e & 1);
          const int r = row + (e >> 1) * 8;
          if (c >= sk || (causal && c > r + off) ||
              (kSegments && (e & 1 ? cid.y : cid.x) != rid[e >> 1])) {
            p = 0.f;
          }
        }
        dp[n][e] = p * (dp[n][e] - dlt[e >> 1]) * scale;
      }
    }

    // dQ += dS K: dS, in registers in the A-operand layout, split into two
    // bf16 parts; K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBKq / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // rows g, g + 8 by a & 1; keys by a >> 1
        const float* d2 = dp[2 * kk + (a >> 1)] + 2 * (a & 1);
        ptt::split_bf16(d2[0], d2[1], hi[a], lo[a]);
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bk[4];
        ptt::ldmatrix_x4<true>(
            bk, kst + (kk * 16 + (quad & 1) * 8 + (lane & 7)) * S + j * 16 +
                    (quad >> 1) * 8);
        ptt::mma_bf16(acc[2 * j], hi, bk[0], bk[1]);
        ptt::mma_bf16(acc[2 * j], lo, bk[0], bk[1]);
        ptt::mma_bf16(acc[2 * j + 1], hi, bk[2], bk[3]);
        ptt::mma_bf16(acc[2 * j + 1], lo, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    kt = nkt;
  }
  ptt::cp_async_wait<0>();  // with no key tile, the Q and dO copies
  __syncthreads();          // Q rows are free for the output

  // dQ through this warp's own Q rows in shared memory, 16 bytes a lane
  __nv_bfloat16* os = qs + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < kNo; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * S + n * 8 + 2 * t) =
        ptt::pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * S + n * 8 + 2 * t) =
        ptt::pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = j * 32 + lane;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int qr = q0 + warp * 16 + r;
    if (qr < sq) {
      *reinterpret_cast<uint4*>(dq + q_base + qr * q_row + c) =
          *reinterpret_cast<const uint4*>(os + r * S + c);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  ptt::SegIds seg;
  int b, sq, sk, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, int BK, bool kSegments>
int launch_dkdv_tile(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv) {
  constexpr size_t smem = dkdv_smem_bytes<D, BK, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, BK, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.sk + BK - 1) / BK * a.kv_heads * a.b;
  flash_bwd_dkdv_kernel<D, BK, kSegments>
      <<<blocks, kDkdvThreads, smem, a.stream>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.seg, a.sq, a.sk,
          a.heads, a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BK>
int launch_dkdv_tile(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv) {
  if (a.seg.q != nullptr) return launch_dkdv_tile<D, BK, true>(a, dk, dv);
  return launch_dkdv_tile<D, BK, false>(a, dk, dv);
}

// 64-key tiles, or 32 where 64 would leave SMs without a block (the GQA
// case: 2 x 4 kv heads x 512 keys is 64 blocks of 64 keys on 132 SMs);
// D = 32 and 96 take only 64 (a 32-key tile's D / 4 slices would not be
// whole k-steps), D = 256 only 32 (see the note at the top of the file)
template <int D>
int launch_dkdv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv) {
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

template <int D, bool kSegments>
int launch_dq(const Args& a, __nv_bfloat16* dq) {
  constexpr size_t smem = dq_smem_bytes<D, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.sq + kBQq - 1) / kBQq * a.heads * a.b;
  flash_bwd_dq_kernel<D, kSegments><<<blocks, kDqThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.seg, a.sq, a.sk, a.heads,
      a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, __nv_bfloat16* dq) {
  if (a.seg.q != nullptr) return launch_dq<D, true>(a, dq);
  return launch_dq<D, false>(a, dq);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const int* q_seg,
               const int* k_seg, const int* q_lo, const int* q_hi,
               const int* k_lo, const int* k_hi, int b, int sq, int sk,
               int heads, int kv_heads, float scale, int causal,
               void* stream) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              ptt::SegIds{q_seg, k_seg, q_lo, q_hi, k_lo, k_hi},
              b, sq, sk, heads, kv_heads, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, dout: (b, sq, heads, d); k, v, dk, dv: (b, sk, kv_heads, d), all bf16
// row-major; lse, delta: (b, heads, sq) f32. d is 32, 64, 96, 128 or 256;
// scale is the caller's (1 / sqrt of the unpadded head dim). The segment
// ids and range tables as ptt_flash_attention_fwd takes them; q_seg null:
// no segment mask.
PTT_EXPORT int ptt_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const int* q_seg,
    const int* k_seg, const int* q_lo, const int* q_hi, const int* k_lo,
    const int* k_hi, int b, int sq, int sk, int heads, int kv_heads, int d,
    float scale, int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, q_seg, k_seg, q_lo,
                           q_hi, k_lo, k_hi, b, sq, sk, heads, kv_heads,
                           scale, causal, stream);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  switch (d) {
    case 32: return launch_dkdv<32>(a, dkp, dvp);
    case 64: return launch_dkdv<64>(a, dkp, dvp);
    case 96: return launch_dkdv<96>(a, dkp, dvp);
    case 128: return launch_dkdv<128>(a, dkp, dvp);
    case 256: return launch_dkdv<256>(a, dkp, dvp);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dq: (b, sq, heads, d) bf16; the other arguments as above.
PTT_EXPORT int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const int* q_seg,
    const int* k_seg, const int* q_lo, const int* q_hi, const int* k_lo,
    const int* k_hi, int b, int sq, int sk, int heads, int kv_heads, int d,
    float scale, int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, q_seg, k_seg, q_lo,
                           q_hi, k_lo, k_hi, b, sq, sk, heads, kv_heads,
                           scale, causal, stream);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  switch (d) {
    case 32: return launch_dq<32>(a, dqp);
    case 64: return launch_dq<64>(a, dqp);
    case 96: return launch_dq<96>(a, dqp);
    case 128: return launch_dq<128>(a, dqp);
    case 256: return launch_dq<256>(a, dqp);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
