// Flash-attention backward in float32: dK/dV and dQ of O = softmax(Q K^T *
// scale [+ causal mask]) V from the forward's per-row lse and
// delta = rowsum(dO * O) (formed outside, in f32), never forming the
// (Sq, Sk) score matrix in memory, with every product in f32. With
// P = exp(S * scale - lse) and dS = P * (dO V^T - delta) * scale:
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
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
// Numerics: no tensor core. bf16 operands would round Q, K, V, dO, P and
// dS to 8 bits and TF32 to 11; JAX's f32 kernels round none of them. Every
// product is an f32 FMA (SIMT), summed in f32, so the kernels agree with
// an f32 matmul composition to ~1e-6 relative.
//
// Bound on the H100: operations, at the f32 FMA rate outside the tensor
// cores (67 TFLOP/s). At the training shape (4, 1536, 12, 128), causal,
// 56.66 M visible (query, key) pairs: dK/dV does 4 products of 2 * D flops
// a pair (58.0 GFLOP, 0.866 ms), dQ 3 (43.5 GFLOP, 0.650 ms); the bytes
// (q, k, v, dO in, the gradients out, ~150 MB) take ~45 us.
//
// Design, for the FMA pipes, the layout of the f32 forward
// (csrc/flash_attention_f32.cu). A block of 256 threads owns R rows (64,
// or 32 at D = 256) of one side and walks 32-row tiles of the other:
// - dK/dV: R key rows of one (b, kv head), K and V staged once; it walks
//   the query tiles of every head of the group from the causal start
//   max(k0 - (sk - sq), 0), Q, dO, lse and delta of each tile staged by
//   16-byte (rows) and 4-byte cp.async in a ring of two, the next tile's
//   copies in flight while the current one is multiplied. Key tile 0,
//   which sees the most query tiles under a causal mask, runs first.
// - dQ: R query rows of one (b, h), Q, dO and the rows' lse and delta
//   staged once; it walks the key tiles up to the tile's causal limit, K
//   and V in the ring. The last query tiles, which see the most keys, run
//   first.
// Thread (rg, cg), rg = tid / 16 and cg = tid % 16, owns rows R / 16 * rg
// .. + R / 16 - 1. For S and dP (S^T and dP^T in dK/dV) it holds the
// streamed rows cg and cg + 16 of the tile; P^T and dS^T (dK/dV) or dS
// (dQ) pass through shared memory, a row group being one half-warp, so a
// __syncwarp and no block barrier stands between forming them and using
// them. For the gradients it holds the 16-byte column chunks cg, cg + 16,
// ... of its rows (D / 64 chunks: dK and dV 2 x 4 x 32 = 64 floats a
// thread at D = 128, dQ 32), written once at the end as float4. Rows sit
// in shared memory with a stride of D + 4 floats, read as float4: the 16
// streamed rows of a half-warp fall in distinct bank groups, the owned
// rows are broadcasts. Shared memory: dK/dV 151 KB at D = 128, 205 KB at
// 256; dQ 141 KB and 200 KB: one block an SM.
//
// Head dims: instantiated at D = 32, 64, 96, 128 and 256, the bf16 kernels'
// widths, so the wrapper's padded route (ops/cuda/flash_attention.py)
// serves the others up to 256. At D = 32 and 96 some threads own one chunk
// fewer (D / 4 chunks over 16 threads).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 threads
constexpr int kBS = 32;        // rows of a streamed tile, 2 a thread
constexpr int kPs = kBS + 4;   // P / dS shared row stride, floats
constexpr float kLog2e = 1.4426950408889634f;

// rows a block owns: dK/dV its keys, dQ its queries
template <int D>
constexpr int kOwn = D <= 128 ? 64 : 32;

template <int D>
constexpr int kChunks = (D / 4 + 15) / 16;  // 16-byte column chunks a thread

template <int D, bool kSegments>
constexpr int dkdv_smem_bytes() {
  // K, V; two stages of Q and dO; P^T and dS^T; two stages of lse, delta
  // (and with segments of the query ids)
  return ((2 * kOwn<D> + 4 * kBS) * (D + 4) + 2 * kOwn<D> * kPs) * 4 +
         (kSegments ? 6 : 4) * kBS * 4;
}

template <int D, bool kSegments>
constexpr int dq_smem_bytes() {
  // Q, dO; two stages of K and V; dS; with segments the query ids and two
  // stages of key ids
  return ((2 * kOwn<D> + 4 * kBS) * (D + 4) + kOwn<D> * kPs) * 4 +
         (kSegments ? (kOwn<D> + 2 * kBS) * 4 : 0);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// acc[i][j] += sum_d a[r0 + i][d] x[cg + 16 j][d] and the same of b with y:
// R / 16 owned rows (broadcast in the half-warp) against this thread's two
// streamed rows, both products in one pass over D.
template <int D, int kR>
__device__ __forceinline__ void two_products(const float* as, const float* bs,
                                             const float* xs, const float* ys,
                                             int r0, int cg,
                                             float (&s)[kR][2],
                                             float (&t)[kR][2]) {
  constexpr int S = D + 4;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    s[i][0] = s[i][1] = t[i][0] = t[i][1] = 0.f;
  }
#pragma unroll 4
  for (int d0 = 0; d0 < D; d0 += 4) {
    float4 xv[2], yv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      xv[j] = *reinterpret_cast<const float4*>(xs + (cg + 16 * j) * S + d0);
      yv[j] = *reinterpret_cast<const float4*>(ys + (cg + 16 * j) * S + d0);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int at = (r0 + i) * S + d0;
      const float4 av = *reinterpret_cast<const float4*>(as + at);
      const float4 bv = *reinterpret_cast<const float4*>(bs + at);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = dot4(av, xv[j], s[i][j]);
        t[i][j] = dot4(bv, yv[j], t[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_c w[r0 + i][c] z[c][chunk cg + 16 j] over the kBS rows c
// of a streamed tile: w is P, P^T or dS^T in shared memory (stride kPs),
// z the tile's rows (stride D + 4).
template <int D, int kR>
__device__ __forceinline__ void accumulate(const float* ws, const float* zs,
                                           int r0, int cg,
                                           float (&acc)[kR][kChunks<D>][4]) {
  constexpr int S = D + 4;
  constexpr bool kFull = (D / 4) % 16 == 0;  // every thread owns all chunks
#pragma unroll 2
  for (int c0 = 0; c0 < kBS; c0 += 4) {
    float4 wv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      wv[i] = *reinterpret_cast<const float4*>(ws + (r0 + i) * kPs + c0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* zrow = zs + (c0 + kk) * S;
#pragma unroll
      for (int j = 0; j < kChunks<D>; ++j) {
        const int ch = cg + 16 * j;
        if (kFull || ch < D / 4) {
          const float4 zv = *reinterpret_cast<const float4*>(zrow + 4 * ch);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const float w = lane4(wv[i], kk);
            acc[i][j][0] = fmaf(w, zv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(w, zv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(w, zv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(w, zv.w, acc[i][j][3]);
          }
        }
      }
    }
  }
}

// Row r (of kR owned rows) of acc into dst + r * row_stride, the chunks
// this thread owns, for the rows below nrows.
template <int D, int kR>
__device__ __forceinline__ void store_rows(float* dst, long long row_stride,
                                           int row0, int nrows, int cg,
                                           float (&acc)[kR][kChunks<D>][4]) {
  constexpr bool kFull = (D / 4) % 16 == 0;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (row0 + i < nrows) {
#pragma unroll
      for (int j = 0; j < kChunks<D>; ++j) {
        const int ch = cg + 16 * j;
        if (kFull || ch < D / 4) {
          *reinterpret_cast<float4*>(dst + (row0 + i) * row_stride + 4 * ch) =
              make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                          acc[i][j][3]);
        }
      }
    }
  }
}

template <int D, int kR>
__device__ __forceinline__ void zero(float (&acc)[kR][kChunks<D>][4]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kChunks<D>; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// ---- dK/dV: a block owns R key rows of one (b, kv head)
template <int D, bool kSegments>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const ptt::SegIds seg, int sq, int sk, int heads,
                          int kv_heads, float scale, int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dims of whole bank rows");
  constexpr int R = kOwn<D>;
  constexpr int kR = R / 16;  // key rows a thread
  constexpr int S = D + 4;
  constexpr int kNC = kChunks<D>;
  extern __shared__ __align__(16) unsigned char dkdv_f32_smem[];
  float* ks = reinterpret_cast<float*>(dkdv_f32_smem);  // [R][S]
  float* vs = ks + R * S;                               // [R][S]
  float* qs = vs + R * S;                               // [2][kBS][S]
  float* dos = qs + 2 * kBS * S;                        // [2][kBS][S]
  float* pts = dos + 2 * kBS * S;                       // P^T [R][kPs]
  float* dss = pts + R * kPs;                           // dS^T [R][kPs]
  float* lse_s = dss + R * kPs;                         // [2][kBS]
  float* dlt_s = lse_s + 2 * kBS;                       // [2][kBS]
  int* qid_s = reinterpret_cast<int*>(dlt_s + 2 * kBS);  // [2][kBS]

  // key tile 0 sees the most query tiles when causal: schedule it first
  const int kvb = gridDim.x / ((sk + R - 1) / R);
  const int kt = blockIdx.x / kvb;
  const int kh = blockIdx.x % kvb % kv_heads, b = blockIdx.x % kvb / kv_heads;
  const int k0 = kt * R, off = sk - sq, group = heads / kv_heads;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int r0 = rg * kR;  // this thread's key rows in the tile
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_base =
      (static_cast<long long>(b) * sk * kv_heads + kh) * D;

  // causal: query rows r with r + off < k0 see nothing of this key tile
  const int q_first = causal ? max(k0 - off, 0) / kBS : 0;
  const int n_qt = (sq + kBS - 1) / kBS;

  // segments: the query tiles whose id range meets this key tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<R>(seg.k_lo + b * nk32,
                                        seg.k_hi + b * nk32, nk32, k0);
    return ptt::seg_window<kBS>(seg.q_lo + b * nq32, seg.q_hi + b * nq32,
                                nq32, base, n_qt, want);
  };
  ptt::SegWalk walk;

  // the step (query head gi of the group, query tile qt) -> stage: Q, dO,
  // lse and delta of its tile (and with segments its query ids)
  auto prefetch = [&](int gi, int qt, int stage) {
    const int h = kh * group + gi, q0 = qt * kBS;
    const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
    ptt::cp_async_rows_f32<kBS, D, kThreads>(qs + stage * kBS * S, q + q_base,
                                             q_row, q0, sq);
    ptt::cp_async_rows_f32<kBS, D, kThreads>(dos + stage * kBS * S,
                                             dout + q_base, q_row, q0, sq);
    const int i = threadIdx.x % kBS, r = q0 + i;
    const long long row_base = (static_cast<long long>(b) * heads + h) * sq;
    const int at = stage * kBS + i;
    if (threadIdx.x < kBS) {
      ptt::cp_async_4(lse_s + at, lse + row_base + (r < sq ? r : 0),
                      r < sq ? 4 : 0);
    } else if (threadIdx.x < 2 * kBS) {
      ptt::cp_async_4(dlt_s + at, delta + row_base + (r < sq ? r : 0),
                      r < sq ? 4 : 0);
    } else if (kSegments && threadIdx.x < 3 * kBS) {
      const int* qid = seg.q + static_cast<long long>(b) * sq;
      ptt::cp_async_4(qid_s + at, qid + (r < sq ? r : 0), r < sq ? 4 : 0);
    }
  };

  ptt::cp_async_rows_f32<R, D, kThreads>(ks, k + kv_base, kv_row, k0, sk);
  ptt::cp_async_rows_f32<R, D, kThreads>(vs, v + kv_base, kv_row, k0, sk);
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

  float dk_acc[kR][kNC][4], dv_acc[kR][kNC][4];
  zero<D, kR>(dk_acc);
  zero<D, kR>(dv_acc);
  const float scale_log2 = scale * kLog2e;
  int cid[kR];  // with segments: the ids of this thread's key rows
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = k0 + r0 + i;
    cid[i] = kSegments && c < sk ? seg.k[static_cast<long long>(b) * sk + c]
                                 : 0;
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
    const int q0 = qt * kBS;
    const float* qst = qs + stage * kBS * S;
    const float* dost = dos + stage * kBS * S;

    // S^T = K Q^T and dP^T = V dO^T: key rows r0 .., queries cg, cg + 16
    float st[kR][2], dpt[kR][2];
    two_products<D, kR>(ks, vs, qst, dost, r0, cg, st, dpt);

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale, into
    // shared memory for this half-warp's gradient products
    const bool need_mask =
        kSegments || q0 + kBS > sq || (causal && k0 + R - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cl = cg + 16 * j, r = q0 + cl;
      const float lb = lse_s[stage * kBS + cl] * kLog2e;
      const float dl = dlt_s[stage * kBS + cl];
      const int rid = kSegments ? qid_s[stage * kBS + cl] : 0;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float p = exp2f(fmaf(st[i][j], scale_log2, -lb));
        if (need_mask) {
          const int c = k0 + r0 + i;
          if (r >= sq || (causal && c > r + off) ||
              (kSegments && rid != cid[i])) {
            p = 0.f;
          }
        }
        pts[(r0 + i) * kPs + cl] = p;
        dss[(r0 + i) * kPs + cl] = p * (dpt[i][j] - dl) * scale;
      }
    }
    __syncwarp();  // P^T and dS^T of this half-warp's key rows are written

    // dV += P^T dO and dK += dS^T Q over the tile's queries
    accumulate<D, kR>(pts, dost, r0, cg, dv_acc);
    accumulate<D, kR>(dss, qst, r0, cg, dk_acc);
    __syncthreads();  // every warp is done with this stage
    gi = ngi;
    qt = nqt;
  }
  ptt::cp_async_wait<0>();  // with no query tile, the K/V copies

  store_rows<D, kR>(dk + kv_base, kv_row, k0 + r0, sk, cg, dk_acc);
  store_rows<D, kR>(dv + kv_base, kv_row, k0 + r0, sk, cg, dv_acc);
}

// ---- dQ: a block owns R query rows of one (b, h)
template <int D, bool kSegments>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, const ptt::SegIds seg, int sq,
                        int sk, int heads, int kv_heads, float scale,
                        int causal) {
  static_assert(D % 32 == 0 && D <= 256, "head dims of whole bank rows");
  constexpr int R = kOwn<D>;
  constexpr int kR = R / 16;  // query rows a thread
  constexpr int S = D + 4;
  constexpr int kNC = kChunks<D>;
  extern __shared__ __align__(16) unsigned char dq_f32_smem[];
  float* qs = reinterpret_cast<float*>(dq_f32_smem);  // [R][S]
  float* dos = qs + R * S;                            // [R][S]
  float* ks = dos + R * S;                            // [2][kBS][S]
  float* vs = ks + 2 * kBS * S;                       // [2][kBS][S]
  float* dss = vs + 2 * kBS * S;                      // dS [R][kPs]
  int* qid_s = reinterpret_cast<int*>(dss + R * kPs);  // [R]
  int* kid_s = qid_s + R;                              // [2][kBS]

  // the last query tiles see the most keys: schedule them first
  const int n_qt = (sq + R - 1) / R;
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % hb % heads, b = blockIdx.x % hb / heads;
  const int kh = h / (heads / kv_heads);
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int r0 = rg * kR;  // this thread's query rows in the tile
  const int q0 = qt * R, off = sk - sq;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = (static_cast<long long>(b) * sq * heads + h) * D;
  const long long kv_base =
      (static_cast<long long>(b) * sk * kv_heads + kh) * D;
  const float* kb = k + kv_base;
  const float* vb = v + kv_base;

  // causal: the tile's last row sees keys c <= r_last + off
  int k_end = sk;
  if (causal) k_end = max(min(sk, min(q0 + R, sq) + off), 0);
  const int n_kt = (k_end + kBS - 1) / kBS;

  // segments: the key tiles whose id range meets this query tile's
  const int nq32 = (sq + ptt::kSegChunk - 1) / ptt::kSegChunk;
  const int nk32 = (sk + ptt::kSegChunk - 1) / ptt::kSegChunk;
  auto window = [&](int base) {
    const int2 want = ptt::seg_range<R>(seg.q_lo + b * nq32,
                                        seg.q_hi + b * nq32, nq32, q0);
    return ptt::seg_window<kBS>(seg.k_lo + b * nk32, seg.k_hi + b * nk32,
                                nk32, base, n_kt, want);
  };
  ptt::SegWalk walk;
  // K, V (and with segments the key ids) of tile kt into a stage
  auto stage_kv = [&](int kt, int stage) {
    const int c0 = kt * kBS, at = stage * kBS * S;
    ptt::cp_async_rows_f32<kBS, D, kThreads>(ks + at, kb, kv_row, c0, sk);
    ptt::cp_async_rows_f32<kBS, D, kThreads>(vs + at, vb, kv_row, c0, sk);
    if (kSegments && threadIdx.x < kBS) {
      const int c = c0 + threadIdx.x;
      const int* kid = seg.k + static_cast<long long>(b) * sk;
      ptt::cp_async_4(kid_s + stage * kBS + threadIdx.x,
                      kid + (c < sk ? c : 0), c < sk ? 4 : 0);
    }
  };

  ptt::cp_async_rows_f32<R, D, kThreads>(qs, q + q_base, q_row, q0, sq);
  ptt::cp_async_rows_f32<R, D, kThreads>(dos, dout + q_base, q_row, q0, sq);
  if (kSegments && threadIdx.x < R) {
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

  // lse (in log2 units) and delta of this thread's rows
  float lb[kR], dl[kR];
  const long long row_base = (static_cast<long long>(b) * heads + h) * sq;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + r0 + i;
    lb[i] = r < sq ? lse[row_base + r] * kLog2e : 0.f;
    dl[i] = r < sq ? delta[row_base + r] : 0.f;
  }
  float acc[kR][kNC][4];
  zero<D, kR>(acc);
  const float scale_log2 = scale * kLog2e;

  // it counts the tiles visited; unmasked it equals kt
  for (int it = 0; kt < n_kt; ++it) {
    const int nkt = kSegments ? walk.next(n_kt, window) : kt + 1;
    const int step = kSegments ? it : kt;
    const int c0 = kt * kBS, stage = step & 1;
    if (nkt < n_kt) {
      stage_kv(nkt, stage ^ 1);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kst = ks + stage * kBS * S;
    const float* vst = vs + stage * kBS * S;

    // S = Q K^T and dP = dO V^T: query rows r0 .., keys cg, cg + 16
    float s[kR][2], dp[kR][2];
    two_products<D, kR>(qs, dos, kst, vst, r0, cg, s, dp);

    // P = exp(S scale - lse), dS = P (dP - delta) scale into shared memory
    const bool need_mask =
        kSegments || c0 + kBS > sk || (causal && c0 + kBS - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = q0 + r0 + i;
      const int rid = kSegments ? qid_s[r0 + i] : 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = cg + 16 * j;
        float p = exp2f(fmaf(s[i][j], scale_log2, -lb[i]));
        if (need_mask) {
          const int c = c0 + cl;
          if (c >= sk || (causal && c > r + off) ||
              (kSegments && kid_s[stage * kBS + cl] != rid)) {
            p = 0.f;
          }
        }
        dss[(r0 + i) * kPs + cl] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncwarp();  // dS of this half-warp's query rows is written

    // dQ += dS K over the tile's keys
    accumulate<D, kR>(dss, kst, r0, cg, acc);
    __syncthreads();  // every warp is done with this stage
    kt = nkt;
  }
  ptt::cp_async_wait<0>();  // with no key tile, the Q/dO copies

  store_rows<D, kR>(dq + q_base, q_row, q0 + r0, sq, cg, acc);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  ptt::SegIds seg;
  int b, sq, sk, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, bool kSegments>
int launch_dkdv(const Args& a, float* dk, float* dv) {
  constexpr int smem = dkdv_smem_bytes<D, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.sk + kOwn<D> - 1) / kOwn<D> * a.kv_heads * a.b;
  flash_bwd_dkdv_f32_kernel<D, kSegments><<<blocks, kThreads, smem,
                                             a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.seg, a.sq, a.sk,
      a.heads, a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const Args& a, float* dk, float* dv) {
  if (a.seg.q != nullptr) return launch_dkdv<D, true>(a, dk, dv);
  return launch_dkdv<D, false>(a, dk, dv);
}

template <int D, bool kSegments>
int launch_dq(const Args& a, float* dq) {
  constexpr int smem = dq_smem_bytes<D, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.sq + kOwn<D> - 1) / kOwn<D> * a.heads * a.b;
  flash_bwd_dq_f32_kernel<D, kSegments><<<blocks, kThreads, smem,
                                           a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.seg, a.sq, a.sk, a.heads,
      a.kv_heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, float* dq) {
  if (a.seg.q != nullptr) return launch_dq<D, true>(a, dq);
  return launch_dq<D, false>(a, dq);
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

// dq: (b, sq, heads, d) f32; the other arguments as above.
PTT_EXPORT int ptt_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const int* q_seg,
    const int* k_seg, const int* q_lo, const int* q_hi, const int* k_lo,
    const int* k_hi, int b, int sq, int sk, int heads, int kv_heads, int d,
    float scale, int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, q_seg, k_seg, q_lo,
                           q_hi, k_lo, k_hi, b, sq, sk, heads, kv_heads,
                           scale, causal, stream);
  auto* dqp = static_cast<float*>(dq);
  switch (d) {
    case 32: return launch_dq<32>(a, dqp);
    case 64: return launch_dq<64>(a, dqp);
    case 96: return launch_dq<96>(a, dqp);
    case 128: return launch_dq<128>(a, dqp);
    case 256: return launch_dq<256>(a, dqp);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
