// Paged decode attention: one new query token per sequence attends over
// that sequence's KV pages, GQA, online softmax in f32.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/decode_attention.py:58
// (_decode_kernel, called from paged_attention at :115). Same function:
// q (B, H, D) against pools (P, page, KVH, D) through block tables
// (B, cols) and lengths (B,); the walk is capped at pages_per_seq columns
// (:139-142); positions at or past a row's length are masked; a row with
// no visible key gives 0. The Pallas kernel gets the tables by scalar
// prefetch and carries (m, l, acc) across page steps of a sequential grid.
// Here a block reads its own table row and length, and only for tokens
// t < length, so it never dereferences a table cell at or past
// ceil(length / page): in the serving engine those cells hold the dump
// page and the scratch columns. Page ids are clamped into the pool, as
// the Pallas kv_map (:150-156) clamps them.
//
// Bound on the H100: bytes, the K/V rows the lengths reach, read once
// (at e2's decode, B = 8, H = KVH = 12, D = 128, lengths 9-183: ~2.4 MB,
// ~1.2 us at 3.35 TB/s); flops are 4 a K/V element a query head. What
// costs the time at such sizes is latency: a sequence's tokens are a
// chain of dependent loads (length, table cell, K/V row), so the work is
// spread thin, over many blocks each a short chain.
//
// One kernel, paged_decode_kernel<T>, for every case: T is bf16 or f32
// (the Pallas kernel is generic in its dtype, :112, :179, and the JAX
// engine's pool takes the parameters' dtype, f32 by default), the
// arithmetic f32 either way; any D from 1 to 256; any GQA group.
//
// * Token splits. A block takes one item (split s, kv head, chunk of
//   query heads, row b): tokens [s ts, (s + 1) ts) of row b, ts a multiple
//   of kTile = 32. ts and the split count come from the shapes alone
//   (split_plan in ops/cuda/decode_attention.py: B, kv heads, group,
//   max_tokens and the SM count, never the lengths), so a CUDA graph of
//   the call stays valid as the lengths grow. A split that starts at or
//   past its row's length leaves at once and writes nothing: the merge
//   reads only a row's ceil(len / ts) non-empty splits, each holding at
//   least one visible key, so no empty state ever meets another.
// * Staging. The block copies its tokens' K and V rows, kTile at a time,
//   into shared memory with 16-byte cp.async wherever D * sizeof(T) is a
//   multiple of 16 and the pools are 16-byte aligned (bf16 D = 64, 72, 80,
//   96, 128, 256; f32 any D divisible by 4); other widths take the narrow
//   path inside the same kernel (element loads and stores, the same tile
//   loop on the element width). The pools are read at their own width,
//   never padded. A split of several tiles double-buffers them, the next
//   tile's copies in flight while the current one is attended.
// * Attention on a tile. A chunk of 8 heads or more in bf16, D a
//   multiple of 16, takes the tensor cores: S = K Q^T and P V by mma.sync
//   m16n8k16 with f32 sums, K and V by ldmatrix from the staged rows (V
//   transposed), q staged as bf16 (the products are exact, the scale
//   comes after in f32), P fed as two bf16 parts (its rounding and the
//   rounding of the rest, as the flash kernels feed it), the rows past a
//   short tile staged as zeros; a warp 16 keys x 8 heads of S, and
//   8-column steps of P V. Fewer heads (where most of the MMA's 16 rows
//   would be padding: e2 at 1 head ran 7.7 us this way, 7.1 in SIMT),
//   other widths and f32 take SIMT steps: scores 4 threads a key row, its
//   K vector loaded once from shared memory and dotted with every head (q
//   staged as f32, already scaled), the 4 parts summed by shuffles; P V a
//   thread a (head, column vector) item, the key rows split over the
//   threads left over when items are few, the parts summed in a fixed
//   order through shared memory at the split's end. Softmax, both: a warp
//   a query head, a lane a key row, the running (m, l) in shared memory.
//   [Tried and dropped: a warp's lanes a row each for the scores with the
//   softmax in the same phase, and P V items of 4 heads: slower on the
//   H100, 1 head leaving 3 warps idle and 12-16 heads no faster.]
// * GQA groups. A block holds up to kMaxChunk = 16 query heads of one kv
//   head in shared memory and registers (the scores' 16 accumulators, 32
//   P V accumulators a thread), so a group up to 16 takes one block an
//   item, reading its kv head's K/V rows once; a larger group (multi-query
//   attention's all) is cut into ceil(group / 16) chunks of near-equal
//   size, a block each, the chunks re-reading the rows mostly from L2.
//   (The cut is across blocks, not warps: the scores and P V threads of a
//   block already span the chunk's heads.)
// * The merge. A row of one non-empty split writes its output directly.
//   Otherwise each split writes (m, l, acc) to scratch and thread 0 takes
//   a ticket from a counter per (row, kv head, chunk) with an acq_rel
//   atomic (after a barrier: it releases the block's partial and, for the
//   last, acquires the others'); the block that draws the last ticket
//   resets the counter to 0 and merges the splits in split order, 8 at a
//   time (their loads issued together, folded in with an online
//   rescaling), so two launches, and a graph replay and an eager call,
//   give the same bits whichever block finishes last. The scratch and
//   counters are the caller's, kept across calls, one set per (device,
//   stream) (ops/cuda/decode_attention.py): the counters are at rest (0)
//   between launches.
// * The grid is (item, split), so the blocks go out split by split and
//   the splits with work, every row's first, are not queued behind the
//   empty ones.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // key rows staged at a time
constexpr int kQParts = kThreads / kTile;  // threads a score
constexpr int kMaxChunk = 16;    // query heads a block
constexpr int kMaxSplits = 64;
constexpr int kAccFloats = 32;   // a thread's P V accumulators
constexpr int kMaxD = 256;
constexpr int kMaxDevices = 64;
constexpr int kQLoads = 8;       // q loads a thread issues together
constexpr int kMergeLoads = 8;   // splits a merging thread loads at once

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* tables;
  const int* lengths;
  void* o;
  // (B * KVH * chunks, nsplit) records of rec floats: acc (per, dpad),
  // then m (per), then l (per); dpad = d rounded up to 4
  float* part;
  int* counters;  // (B * KVH * chunks,), at rest 0
  int heads, kv_heads, d, page_size, n_pages, table_cols, max_tokens;
  int chunks, per, ts, nsplit, rec;
  int kst;        // bytes between staged rows
  int qbytes;     // the staged q's region ahead of the K/V buffers
  bool mma;       // bf16 rows of whole 16-value steps: the tensor cores
  float scale;
};

// CW values of T at p (shared memory) as floats: one 16-byte load, or a
// single element at CW = 1
template <typename T, int CW>
__device__ __forceinline__ void smem_vals(const T* p, float (&out)[CW]) {
  if constexpr (CW == 1) {
    out[0] = ptt::to_float(p[0]);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 2) {
      static_assert(CW == 8, "8 bf16 in 16 bytes");
      ptt::unpack_bf16x8(u, out);
    } else {
      static_assert(CW == 4, "4 floats in 16 bytes");
      out[0] = __uint_as_float(u.x);
      out[1] = __uint_as_float(u.y);
      out[2] = __uint_as_float(u.z);
      out[3] = __uint_as_float(u.w);
    }
  }
}

// Key rows [t0, t0 + nr) of row b, kv head kh, into kbuf / vbuf (rows kst
// bytes apart): 16-byte cp.async at CW > 1, element copies at CW = 1.
// Table cells are read only for these tokens, all below the length.
template <typename T, int CW>
__device__ __forceinline__ void stage_tile(const Params& p, char* kbuf,
                                           char* vbuf, int b, int kh, int t0,
                                           int nr) {
  const int* trow = p.tables + static_cast<long long>(b) * p.table_cols;
  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  const int d = p.d, cpr = d / CW;  // copies a row
  for (int i = threadIdx.x; i < nr * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * CW, t = t0 + r;
    int page = __ldg(trow + t / p.page_size);
    page = min(max(page, 0), p.n_pages - 1);
    const long long off =
        ((static_cast<long long>(page) * p.page_size + t % p.page_size) *
             p.kv_heads + kh) * d + c;
    T* kd = reinterpret_cast<T*>(kbuf + r * p.kst) + c;
    T* vd = reinterpret_cast<T*>(vbuf + r * p.kst) + c;
    if constexpr (CW > 1) {
      ptt::cp_async_16(kd, kp + off, 16);
      ptt::cp_async_16(vd, vp + off, 16);
    } else {
      *kd = kp[off];
      *vd = vp[off];
    }
  }
  ptt::cp_async_commit();  // an empty group on the narrow path
}

// Rows nr .. kTile - 1 of kbuf and vbuf as zeros (16-byte cp.async of
// nothing), for the MMA's whole 16-key steps past a short tile.
__device__ __forceinline__ void zero_tail(const Params& p, char* kbuf,
                                          char* vbuf, int nr) {
  const int cpr = p.d / 8;  // 16-byte chunks a bf16 row
  for (int i = nr * cpr + threadIdx.x; i < kTile * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 16;
    ptt::cp_async_16(kbuf + r * p.kst + c, p.k_pages, 0);
    ptt::cp_async_16(vbuf + r * p.kst + c, p.v_pages, 0);
  }
}

// Scores of the tile's nr rows against the chunk's cnt query heads into
// sc[h * kTile + r]: thread (r, part) dots the columns part * CW,
// (part + kQParts) * CW, ... of key row r with every head, its K vector
// loaded once from shared memory for all of them.
template <typename T, int CW>
__device__ __forceinline__ void tile_scores(const Params& p, const char* kbuf,
                                            const float* qs, float* sc,
                                            int nr, int cnt) {
  const int r = threadIdx.x / kQParts, part = threadIdx.x % kQParts;
  const int d = p.d;
  float acc[kMaxChunk];
#pragma unroll
  for (int h = 0; h < kMaxChunk; ++h) acc[h] = 0.f;
  if (r < nr) {
    const T* kr = reinterpret_cast<const T*>(kbuf + r * p.kst);
    for (int c = part * CW; c < d; c += kQParts * CW) {
      float kv[CW];
      smem_vals<T, CW>(kr + c, kv);
#pragma unroll
      for (int h = 0; h < kMaxChunk; ++h) {
        if (h >= cnt) break;  // uniform across the block
        const float* qh = qs + h * d + c;
        if constexpr (CW % 4 == 0) {
#pragma unroll
          for (int j = 0; j < CW; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qh + j);
            acc[h] += qv.x * kv[j] + qv.y * kv[j + 1] + qv.z * kv[j + 2] +
                      qv.w * kv[j + 3];
          }
        } else {
          acc[h] += qh[0] * kv[0];
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kMaxChunk; ++h) {
    if (h >= cnt) break;
#pragma unroll
    for (int o = 1; o < kQParts; o <<= 1) {
      acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], o);
    }
    if (r < nr && part == 0) sc[h * kTile + r] = acc[h];
  }
}

// The P V items of this thread: cnt * (d / CW) items of CW columns; with
// fewer items than threads, `parts` threads share an item's key rows.
struct PvMap {
  int items, per_row, parts, item, part;
  __device__ __forceinline__ PvMap(int cnt, int d, int cw) {
    per_row = d / cw;
    items = cnt * per_row;
    parts = items >= kThreads ? 1 : kThreads / items;
    item = items >= kThreads ? threadIdx.x : threadIdx.x % items;
    part = items >= kThreads ? 0 : threadIdx.x / items;
  }
};

// acc (this thread's items, rescaled by alpha) += P V over the tile's nr
// rows of vbuf; P in sc.
template <typename T, int CW>
__device__ __forceinline__ void tile_pv(const Params& p, const PvMap& m,
                                        const char* vbuf, const float* sc,
                                        const float* alpha, int nr,
                                        float (&acc)[kAccFloats]) {
  constexpr int kItems = kAccFloats / CW;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int it = m.item + j * kThreads;
    if (m.part >= m.parts || it >= m.items) break;
    const int h = it / m.per_row, c = (it - h * m.per_row) * CW;
    const float al = alpha[h];
    float a[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) a[i] = acc[j * CW + i] * al;
    const float* ph = sc + h * kTile;
#pragma unroll 4
    for (int r = m.part; r < nr; r += m.parts) {
      float v[CW];
      smem_vals<T, CW>(reinterpret_cast<const T*>(vbuf + r * p.kst) + c, v);
      const float pr = ph[r];
#pragma unroll
      for (int i = 0; i < CW; ++i) a[i] += pr * v[i];
    }
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[j * CW + i] = a[i];
  }
}

// bf16 rows of whole 16-value steps (the mma flag): the tile's scores
// and P V on the tensor cores, mma.sync m16n8k16 with f32 sums. Scores:
// S (32 keys x 16 heads) = K Q^T, warp w the keys 16 (w & 1) .. and the
// heads 8 (w >> 1) .., K from the staged rows and q (bf16, unscaled, 16
// rows of qld) by ldmatrix; the products are exact and the scale comes
// after, in f32. Rows past the tile are staged zeros, q rows past the
// chunk zeros.
__device__ __forceinline__ void tile_scores_mma(const Params& p,
                                                const char* kbuf,
                                                const __nv_bfloat16* qb,
                                                int qld, float* sc, int nr,
                                                int cnt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
  if (m0 >= nr || n0 >= cnt) return;  // uniform across the warp
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const char* arow = kbuf + (m0 + (lane & 7) + (lane & 8)) * p.kst +
                     (lane >> 4) * 16;
  const __nv_bfloat16* brow = qb + (n0 + (lane & 7)) * qld + (lane & 8);
  for (int k0 = 0; k0 < p.d; k0 += 16) {
    uint32_t a[4], bb[2];
    ptt::ldmatrix_x4<false>(a, arow + k0 * 2);
    ptt::ldmatrix_x2<false>(bb, brow + k0);
    ptt::mma_bf16(c, a, bb[0], bb[1]);
  }
  // c[0..1]: key m0 + g, heads n0 + 2t, + 1; c[2..3]: key m0 + g + 8
  const int g = lane >> 2, t = lane & 3, h = n0 + 2 * t;
  sc[h * kTile + m0 + g] = c[0] * p.scale;
  sc[(h + 1) * kTile + m0 + g] = c[1] * p.scale;
  sc[h * kTile + m0 + g + 8] = c[2] * p.scale;
  sc[(h + 1) * kTile + m0 + g + 8] = c[3] * p.scale;
}

// O (16 heads x D) += P V on the tensor cores: P, f32 in sc, fed as two
// bf16 parts (its rounding and the rounding of the rest, so P V keeps ~16
// bits of P, as the flash kernels do), V by ldmatrix.trans from the
// staged rows; warp w the 8-column steps w, w + 4, ..., accumulators in
// fragment order (head g and g + 8, columns 2t, 2t + 1 of each step).
__device__ __forceinline__ void tile_pv_mma(const Params& p, const char* vbuf,
                                            const float* sc,
                                            const float* alpha, int nr,
                                            float (&acc)[kAccFloats]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, steps = p.d / 8;
  const float a0 = alpha[g], a1 = alpha[g + 8];
#pragma unroll
  for (int j = 0; j < kAccFloats / 4; ++j) {
    if (warp + j * kWarps >= steps) break;
    acc[4 * j] *= a0;
    acc[4 * j + 1] *= a0;
    acc[4 * j + 2] *= a1;
    acc[4 * j + 3] *= a1;
  }
  for (int k0 = 0; k0 < nr; k0 += 16) {
    const float* p0 = sc + g * kTile + k0 + 2 * t;
    const float* p1 = p0 + 8 * kTile;
    uint32_t hi[4], lo[4];
    ptt::split_bf16(p0[0], p0[1], hi[0], lo[0]);
    ptt::split_bf16(p1[0], p1[1], hi[1], lo[1]);
    ptt::split_bf16(p0[8], p0[9], hi[2], lo[2]);
    ptt::split_bf16(p1[8], p1[9], hi[3], lo[3]);
    const char* vrow = vbuf + (k0 + (lane & 7) + (lane & 8)) * p.kst;
#pragma unroll
    for (int j = 0; j < kAccFloats / 4; ++j) {
      const int n = warp + j * kWarps;
      if (n >= steps) break;
      uint32_t bb[2];
      ptt::ldmatrix_x2<true>(bb, vrow + n * 16);
      float cj[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                     acc[4 * j + 3]};
      ptt::mma_bf16(cj, lo, bb[0], bb[1]);
      ptt::mma_bf16(cj, hi, bb[0], bb[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] = cj[i];
    }
  }
}

// One item: q staged, the split's tiles attended, then the output (a
// row's only non-empty split) or the split's partial and the merge. kMma:
// the tensor-core tile steps (bf16, D a multiple of 16).
template <typename T, int CW, bool kMma>
__device__ __forceinline__ void attend(const Params& p, char* smem, int b,
                                       int kh, int c, int s, int len,
                                       float* sc, float* m_s, float* l_s,
                                       float* alpha, int* last) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = p.d, group = p.heads / p.kv_heads;
  const int h0 = c * p.per, cnt = min(p.per, group - h0);
  const int t0 = s * p.ts, t_end = min(len, t0 + p.ts);
  const int ntiles = (t_end - t0 + kTile - 1) / kTile;
  const int nne = (len + p.ts - 1) / p.ts;  // the row's non-empty splits
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem);
  const int qld = d + 8;  // the MMA's q rows: an odd number of 16 bytes
  char* bufs = smem + p.qbytes;
  const int buf_bytes = 2 * kTile * p.kst;  // K then V

  if constexpr (kMma) {
    zero_tail(p, bufs, bufs + kTile * p.kst, min(kTile, t_end - t0));
  }
  stage_tile<T, CW>(p, bufs, bufs + kTile * p.kst, b, kh, t0,
                    min(kTile, t_end - t0));
  const T* qg = static_cast<const T*>(p.q) +
                (static_cast<long long>(b) * p.heads + kh * group + h0) * d;
  if constexpr (kMma) {
    // bf16 as it is, 16 bytes a copy, rows of whole 8-head steps, zeros
    // past the chunk's heads
    const int cpr = d / 8, nq = (cnt + 7) / 8 * 8 * cpr;
    for (int i0 = tid; i0 < nq; i0 += kThreads * kQLoads) {
      uint4 v[kQLoads];  // a thread's loads issued together
#pragma unroll
      for (int u = 0; u < kQLoads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < cnt * cpr ? *reinterpret_cast<const uint4*>(qg + i * 8)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kQLoads; ++u) {
        const int i = i0 + u * kThreads, r = i / cpr;
        if (i < nq) {
          *reinterpret_cast<uint4*>(qb + r * qld + (i - r * cpr) * 8) = v[u];
        }
      }
    }
  } else {
    for (int i0 = tid; i0 < cnt * d; i0 += kThreads * kQLoads) {
      float v[kQLoads];  // a thread's loads issued together
#pragma unroll
      for (int u = 0; u < kQLoads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < cnt * d ? ptt::to_float(qg[i]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kQLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i < cnt * d) qs[i] = v[u] * p.scale;
      }
    }
  }
  if (tid < cnt) {
    m_s[tid] = ptt::kNegInf;
    l_s[tid] = 0.f;
  }

  const PvMap pv(cnt, d, CW);
  float acc[kAccFloats];
#pragma unroll
  for (int i = 0; i < kAccFloats; ++i) acc[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int tt = t0 + i * kTile, nr = min(kTile, t_end - tt);
    char* kbuf = bufs + (i & 1) * buf_bytes;
    if (i + 1 < ntiles) {  // the next tile's copies in flight meanwhile
      char* nb = bufs + ((i + 1) & 1) * buf_bytes;
      const int nnr = min(kTile, t_end - tt - kTile);
      if constexpr (kMma) zero_tail(p, nb, nb + kTile * p.kst, nnr);
      stage_tile<T, CW>(p, nb, nb + kTile * p.kst, b, kh, tt + kTile, nnr);
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kMma) {
      tile_scores_mma(p, kbuf, qb, qld, sc, nr, cnt);
    } else {
      tile_scores<T, CW>(p, kbuf, qs, sc, nr, cnt);
    }
    __syncthreads();
    for (int h = warp; h < cnt; h += kWarps) {  // softmax, a warp a head
      float* sh = sc + h * kTile;
      const float sv = lane < nr ? sh[lane] : ptt::kNegInf;
      float mt = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      }
      const float mo = m_s[h], mn = fmaxf(mo, mt);
      const float pr = lane < nr ? expf(sv - mn) : 0.f;
      if (kMma || lane < nr) sh[lane] = pr;  // the MMA's steps read 0s
      const float ls = ptt::warp_sum(pr);
      if (lane == 0) {
        const float al = expf(mo - mn);
        alpha[h] = al;
        l_s[h] = l_s[h] * al + ls;
        m_s[h] = mn;
      }
    }
    __syncthreads();
    if constexpr (kMma) {
      tile_pv_mma(p, kbuf + kTile * p.kst, sc, alpha, nr, acc);
    } else {
      tile_pv<T, CW>(p, pv, kbuf + kTile * p.kst, sc, alpha, nr, acc);
    }
    __syncthreads();  // the buffer and sc are free for the next tile
  }

  T* out = static_cast<T*>(p.o) +
           (static_cast<long long>(b) * p.heads + kh * group + h0) * d;
  const long long item = (static_cast<long long>(b) * p.kv_heads + kh) *
                             p.chunks + c;
  const int dpad = (d + 3) / 4 * 4, ml = p.per * dpad;
  float* mine = p.part + (item * p.nsplit + s) * p.rec;
  if constexpr (kMma) {
    // the fragments: heads g and g + 8, columns 8 n + 2t, + 1
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kAccFloats / 4; ++j) {
      const int col = (warp + j * kWarps) * 8 + 2 * t;
      if (col >= d) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = g + 8 * hh;
        if (h >= cnt) break;
        const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if (nne == 1) {  // the row's only split: the output itself
          const float lt = fmaxf(l_s[h], 1e-30f);
          out[h * d + col] = ptt::from_float<T>(v0 / lt);
          out[h * d + col + 1] = ptt::from_float<T>(v1 / lt);
        } else {
          mine[h * dpad + col] = v0;
          mine[h * dpad + col + 1] = v1;
        }
      }
    }
    if (nne == 1) return;
  } else {
    // the parts of an item summed in part order (through the first
    // buffer, part-major so that neighbouring threads touch neighbouring
    // words)
    if (pv.parts > 1) {
      float* red = reinterpret_cast<float*>(bufs);
      const int n = pv.parts * pv.items;
      if (pv.part < pv.parts) {
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          red[i * n + pv.part * pv.items + pv.item] = acc[i];
        }
      }
      __syncthreads();
      if (tid < pv.items) {
#pragma unroll
        for (int i = 0; i < CW; ++i) acc[i] = red[i * n + tid];
        for (int q = 1; q < pv.parts; ++q) {
#pragma unroll
          for (int i = 0; i < CW; ++i) {
            acc[i] += red[i * n + q * pv.items + tid];
          }
        }
      }
    }
    const bool owner = pv.parts > 1 ? tid < pv.items : true;
    constexpr int kItems = kAccFloats / CW;
    if (nne == 1) {  // the row's only split: the output itself
      if (owner) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int it = tid + j * kThreads;
          if (it >= pv.items) break;
          const int h = it / pv.per_row, col = (it - h * pv.per_row) * CW;
          const float lt = fmaxf(l_s[h], 1e-30f);
#pragma unroll
          for (int i = 0; i < CW; ++i) {
            out[h * d + col + i] = ptt::from_float<T>(acc[j * CW + i] / lt);
          }
        }
      }
      return;
    }
    if (owner) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int it = tid + j * kThreads;
        if (it >= pv.items) break;
        const int h = it / pv.per_row, col = (it - h * pv.per_row) * CW;
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          mine[h * dpad + col + i] = acc[j * CW + i];
        }
      }
    }
  }
  if (tid < cnt) {
    mine[ml + tid] = m_s[tid];
    mine[ml + p.per + tid] = l_s[tid];
  }
  // the block's partial stores, then thread 0's ticket: an acq_rel atomic
  // releases them (ordered before it by the barrier) and, for the last
  // block, acquires the other splits' (the barrier after it orders the
  // other threads' reads)
  __syncthreads();
  if (tid == 0) {
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(p.counters + item) : "memory");
    *last = ticket == nne - 1;
    if (*last) p.counters[item] = 0;  // at rest for the next launch
  }
  __syncthreads();
  if (!*last) return;

  // the last block: the row's nne splits merged in split order, a thread
  // 4 columns of a head; kMergeLoads splits' (m, l, acc) loaded at once,
  // folded in with an online rescaling, so one round of loads for up to
  // kMergeLoads splits
  const float* base = p.part + item * p.nsplit * p.rec;
  const int q4 = dpad / 4;
  for (int i = tid; i < cnt * q4; i += kThreads) {
    const int h = i / q4, col = (i - h * q4) * 4;
    float mx = ptt::kNegInf, big_l = 0.f, v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nne; s0 += kMergeLoads) {
      float mv[kMergeLoads], lv[kMergeLoads];
      float4 x[kMergeLoads];
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        const float* ps = base + (s0 + u) * p.rec;
        const bool ok = s0 + u < nne;
        mv[u] = ok ? __ldcg(ps + ml + h) : ptt::kNegInf;
        lv[u] = ok ? __ldcg(ps + ml + p.per + h) : 0.f;
        x[u] = ok ? __ldcg(reinterpret_cast<const float4*>(ps + h * dpad +
                                                            col))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mn = mx;
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) mn = fmaxf(mn, mv[u]);
      const float al = expf(mx - mn);
      big_l *= al;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] *= al;
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        if (s0 + u >= nne) break;
        const float e = expf(mv[u] - mn);
        big_l += lv[u] * e;
        v[0] += x[u].x * e;
        v[1] += x[u].y * e;
        v[2] += x[u].z * e;
        v[3] += x[u].w * e;
      }
      mx = mn;
    }
    const float lt = fmaxf(big_l, 1e-30f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col + k < d) out[h * d + col + k] = ptt::from_float<T>(v[k] / lt);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
paged_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float sc[kMaxChunk * kTile];  // a tile's scores, then P
  __shared__ float m_s[kMaxChunk], l_s[kMaxChunk], alpha[kMaxChunk];
  __shared__ int last;
  // x walks the items (row, kv head, chunk) and y the splits, so the
  // blocks go out split by split: every row's first splits, the ones with
  // work, before the later ones, mostly empty, that leave at once
  const int s = blockIdx.y;
  const int b = blockIdx.x / (p.kv_heads * p.chunks);
  const int kc = blockIdx.x - b * (p.kv_heads * p.chunks);
  const int kh = kc / p.chunks, c = kc - kh * p.chunks;
  const int len = max(min(__ldg(p.lengths + b), p.max_tokens), 0);
  if (len == 0) {  // no visible key: exactly 0, written by split 0
    if (s == 0) {
      const int group = p.heads / p.kv_heads, h0 = c * p.per;
      const int n = min(p.per, group - h0) * p.d;
      T* out = static_cast<T*>(p.o) +
               (static_cast<long long>(b) * p.heads + kh * group + h0) * p.d;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        out[i] = ptt::from_float<T>(0.f);
      }
    }
    return;
  }
  if (s * p.ts >= len) return;  // an empty split: nothing to merge
  const bool vec = (p.d * static_cast<int>(sizeof(T))) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.k_pages) |
                     reinterpret_cast<uintptr_t>(p.v_pages)) % 16) == 0;
  if constexpr (sizeof(T) == 2) {
    if (p.mma) {
      attend<T, 8, true>(p, smem, b, kh, c, s, len, sc, m_s, l_s, alpha,
                         &last);
      return;
    }
  }
  if (vec) {
    attend<T, 16 / sizeof(T), false>(p, smem, b, kh, c, s, len, sc, m_s,
                                     l_s, alpha, &last);
  } else {
    attend<T, 1, false>(p, smem, b, kh, c, s, len, sc, m_s, l_s, alpha,
                        &last);
  }
}

// Bytes between staged rows: D * sizeof(T) rounded to 16, then to 64
// past a multiple of 128, so that the 8 lanes of a quarter warp reading
// two rows' first 64 bytes each fall on distinct banks.
int row_stride(int d, int elem) {
  const int bytes = (d * elem + 15) / 16 * 16;
  if (bytes <= 64) return 64;
  return (bytes - 64 + 127) / 128 * 128 + 64;
}

template <typename T>
int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* tables, const void* lengths, void* o, void* part,
                 void* counters, int b, int heads, int kv_heads, int d,
                 int page_size, int n_pages, int table_cols, int max_tokens,
                 int chunks, int per, int ts, int nsplit, int rec,
                 float scale, void* stream) {
  const int group = kv_heads > 0 ? heads / kv_heads : 0;
  if (kv_heads < 1 || heads % kv_heads || d < 1 || d > kMaxD || b < 1 ||
      per < 1 || per > kMaxChunk || chunks < 1 ||
      (chunks - 1) * per >= group || chunks * per < group ||
      static_cast<long long>(b) * kv_heads * chunks > 0x7fffffff ||
      ts < kTile ||
      ts % kTile || nsplit < 1 || nsplit > kMaxSplits ||
      rec % 4 || rec < per * ((d + 3) / 4 * 4) + 2 * per ||
      (nsplit > 1 && (part == nullptr || counters == nullptr ||
                      reinterpret_cast<uintptr_t>(part) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.d = d;
  p.page_size = page_size;
  p.n_pages = n_pages;
  p.table_cols = table_cols;
  p.max_tokens = max_tokens;
  p.chunks = chunks;
  p.per = per;
  p.ts = ts;
  p.nsplit = nsplit;
  p.rec = rec;
  const bool vec = (d * static_cast<int>(sizeof(T))) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k_pages) |
                     reinterpret_cast<uintptr_t>(v_pages)) % 16) == 0;
  // the tensor cores from a chunk of 8 heads: below it, most of the MMA's
  // 16 rows of heads would be padding, and the SIMT steps are faster
  p.mma = sizeof(T) == 2 && vec && d % 16 == 0 && per >= 8 &&
          reinterpret_cast<uintptr_t>(q) % 16 == 0;
  // the MMA's ldmatrix reads 8 rows of 16 bytes at one column: rows an odd
  // number of 16 bytes apart fall on distinct banks
  p.kst = p.mma ? (d * 2 / 16 | 1) * 16 : row_stride(d, sizeof(T));
  p.qbytes = p.mma ? kMaxChunk * (d + 8) * 2 : per * d * 4;
  p.scale = scale;
  // q (f32), then the K/V buffers, which also take the P V parts' sums
  const int stages = ts > kTile ? 2 : 1;
  const int bufs = stages * 2 * kTile * p.kst;
  const int red = kThreads * 8 * 4;  // a thread's CW (<= 8) sums
  const int smem = p.qbytes + (bufs > red ? bufs : red);
  // above 48 KB only by opting in, once a device to the largest size seen
  static int opted[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 40 * 1024 && dev < kMaxDevices && opted[dev] < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = smem;
  }
  paged_decode_kernel<T>
      <<<dim3(b * kv_heads * chunks, nsplit), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (b, heads, d) bf16; k_pages, v_pages: (n_pages, page_size,
// kv_heads, d) bf16; tables: (b, table_cols) int32; lengths: (b,) int32.
// max_tokens = pages_per_seq * page_size caps the walk. d is 1 to 256,
// heads a multiple of kv_heads. The split plan (chunks of per query heads,
// nsplit splits of ts tokens) is split_plan's; part holds b * kv_heads *
// chunks * nsplit records of rec floats (rec a multiple of 4, at least
// per * dpad + 2 * per, dpad = d rounded up to 4), 16-byte aligned, and
// counters b * kv_heads * chunks ints at 0 (both may be null when nsplit
// is 1).
PTT_EXPORT int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* o, void* part,
                                   void* counters, int b, int heads,
                                   int kv_heads, int d, int page_size,
                                   int n_pages, int table_cols, int max_tokens,
                                   int chunks, int per, int ts, int nsplit,
                                   int rec, float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(
      q, k_pages, v_pages, tables, lengths, o, part, counters, b, heads,
      kv_heads, d, page_size, n_pages, table_cols, max_tokens, chunks, per,
      ts, nsplit, rec, scale, stream);
}

// The same with q, the pools and o f32.
PTT_EXPORT int ptt_paged_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* o, void* part,
    void* counters, int b, int heads, int kv_heads, int d, int page_size,
    int n_pages, int table_cols, int max_tokens, int chunks, int per, int ts,
    int nsplit, int rec, float scale, void* stream) {
  return launch_paged<float>(q, k_pages, v_pages, tables, lengths, o, part,
                             counters, b, heads, kv_heads, d, page_size,
                             n_pages, table_cols, max_tokens, chunks, per, ts,
                             nsplit, rec, scale, stream);
}
