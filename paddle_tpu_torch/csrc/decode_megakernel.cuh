// The decode megakernel: the attention half of one decoder layer's decode
// step, for every sequence of the batch, in one launch.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/decode_megakernel.py:189
// (_megakernel, called from fused_decode_layer at :322). For each row b
// (one new token per sequence, pre-append depth len = max(lengths[b], 0)):
//   xn = T(T(x * rsqrt(mean x^2 + eps1)) * ln1)
//   q, k, v = xn @ wq, wk, wv                          (f32)
//   neox RoPE of q and k at position clip(len, 0, rope_rows - 1)
//   store T(k), T(v) at (tables[b, len / page], len % page), skipped when
//   len / page lies past the table
//   online-softmax attention of the query heads over positions [0, len] of
//   the first walk_cols table columns, the new row taken in f32
//   o = T(att) @ wo summed in f32; h_mid = T(x + T(o))
//   y2 = T(T(h_mid * rsqrt(mean h_mid^2 + eps2)) * ln2)
// T is the model's type, bf16 or f32 (x, norm scales, weights, pools and
// outputs of one type; RoPE tables f32). The rounding points are the Pallas
// kernel's (:211-319); in f32 nothing rounds, and the layer is the unfused
// composition (reference_decode_layer :439-485). Every even head dim up to
// 256, every GQA group, hidden a multiple of 8 up to kMaxHidden, any batch
// up to kMaxBatch.
//
// Bound on the H100: bytes. The layer's four weight matrices plus the K/V
// rows the lengths reach, read once: at Phi-3-mini's widths (hidden 3072,
// 32 heads of 96) 75.5 MB of weights and ~18.5 MB of K/V at e2's depths,
// ~28 us at 3.35 TB/s; at the 438M widths (hidden 1536, 12 heads of 128)
// 18.9 MB and ~9.2 MB, ~8.4 us. Flops are 2 a weight element a row.
//
// So each weight is read once a step for all rows, spread over every SM:
// one persistent cooperative grid (occupancy x SMs blocks, all resident,
// launched with cudaLaunchAttributeCooperative) walks its stages between
// grid barriers of its own (grid_sync: one atomic a block on a counter
// that resets itself; a bounded spin, then __trap(), so a fault ends the
// launch with an error instead of hanging it). Every stage but the two
// GEMV streams is a handful of dependent loads (L2 latency, ~1 us under
// the streams' load), so each is written as one round of loads a thread,
// spread over every block.
//
//   A. q | k | v = xn @ [wq | wk | wv]. The output columns are cut into
//      tiles of kCols columns (no tile crosses a matrix) x a slice of the
//      hidden rows, and the batch into groups of kRows rows; the tile list
//      is fixed by the shapes alone (gemm_plan), never by the SM count, so
//      the bits are the same on any card. Block i walks tiles i, i + G, ...
//      (G blocks), so that at any time the grid reads neighbouring column
//      groups of the same weight rows. [Changed from contiguous tile
//      ranges a block: each block then read its own rows, and stage A ran
//      at ~1 TB/s instead of ~2.] The tiles stream through a cp.async ring
//      of kRing 16 KB chunks (kRing - 2 in flight an SM, ~96 KB, over what
//      3.35 TB/s / 132 SMs needs at the loaded HBM latency), running on
//      across tile boundaries, and each chunk is read once for the kRows
//      rows of its group. The B operand (xn of the group, T) sits in
//      shared memory as a window of up to kWin rows: each block computes
//      it from x (a warp a row's sum of squares, then T(T(x r1) ln1)), then
//      starts the ring. bf16 runs on the tensor cores, mma.sync m16n8k16
//      with the weights as A (ldmatrix.trans from the chunk, whose rows
//      are padded so that 8 rows fall on distinct banks) and the 8 rows as
//      N: the bf16 products are exact, the sums f32. f32 uses FMAs (no
//      TF32). Each tile writes its f32 partial to scratch.
//   barrier; A2. For each (row, head, pair of columns j, j + D / 2) of q,
//      k and v: the slices' partials summed in slice order, RoPE on q and
//      k, the roped f32 values to scratch, T(k) and T(v) appended to the
//      pools. [Changed from summing the partials in every attention item:
//      each query head's partials were then read again by every item of
//      its row. And from counters that let a head's last tile finalise it
//      without a barrier: the release fence a tile then needs waits for
//      the ring's copies in flight, ~10 us a tile on the H100.]
//   barrier; B. Attention. Items are (row b, kv head g, chunk of at most 8
//      query heads, token split of ts positions). [Changed from chunks of
//      single heads: the deepest row of a batch (510 of 512 at e2) would
//      still set the stage's time on one SM, and single-head chunks read
//      the K/V rows once a head. Token splits balance the rows and read
//      each K/V row once a chunk.] The rows' split counts are summed into
//      a prefix table in shared memory first. A block double-buffers its
//      items: the next item's q, new k/v and K/V rows stream into shared
//      memory by cp.async while the current one is attended (attend_item:
//      a thread a score, a warp a head's softmax, a thread two columns of
//      P V). A row's only split writes T(att) to scratch; a row of several
//      splits writes each split's (m, l, acc).
//   barrier; B2. Rows of several splits: for each (row, head, 4 columns)
//      the splits merged in split order into T(att).
//   barrier; C. o = T(att) @ wo: tiles of wo's hidden columns x slices of
//      its heads * D rows, read once for the batch, the same MMA or FMA
//      path as stage A (the B operand is att, copied from scratch by
//      cp.async; the ring's first chunks were issued before the barrier),
//      f32 partials to scratch.
//   barrier; D. A block a row: o summed over the slices in slice order
//      (the MMA's own order inside a slice), h_mid = T(x + T(o)), the
//      row's sum of squares, y2 = T(T(h_mid * rsqrt(mean + eps2)) * ln2).
// No float atomics anywhere: two launches give the same bits.
//
// A larger batch than kRows walks row groups of kRows, reading the weights
// ceil(B / kRows) times.
//
// The scratch (partials, roped q/k/v, split partials, att) and the state
// (the barrier, at rest between launches) are the caller's, kept across
// launches, one set per (device, stream): the launch writes no other
// memory than its outputs, the scratch and the appended pool rows.
//
// Rows that share a page (the serving engine's idle rows, all on its dump
// page) store into the same cell in no fixed order; their outputs are never
// used, and every value stored is finite.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;             // batch rows a pass (the MMA's N)
constexpr int kCols = 64;            // output columns of a tile
constexpr int kRing = 8;             // weight chunks in the ring
// one chunk: KC rows of kCols values, 16 KB, each row padded by 16 bytes
// so that the reads of 8 rows at one column fall on distinct banks
constexpr int kChunkBytes = 128 * (128 + 16);
constexpr int kMaxSliceRows = 1024;  // rows of a tile
constexpr int kOpBytes = kRows * 4104 * 2;  // the B operand window
constexpr int kRedBytes = 16384;     // tile sums across warps
constexpr int kTargetTiles = 1024;   // tiles a GEMM stage aims at
constexpr int kMaxHidden = 4096;
constexpr int kMaxD = 256;
constexpr int kMaxBatch = 4096;      // the attention's row tables
constexpr int kChunkHeads = 8;       // query heads of an attention item
constexpr int kKvBytes = 65536;      // K and V rows of one attention item
constexpr int kMaxItemTokens = 128;
// q, new k and v (f32), then K and V rows padded by up to 32 bytes
constexpr int kItemHead = (kChunkHeads + 2) * kMaxD * 4;
constexpr int kItemBytes = kItemHead + kKvBytes + 2 * kMaxItemTokens * 32;
constexpr int kSmemGemm = kRing * kChunkBytes + kOpBytes + kRedBytes;
constexpr int kPageTable = 4096;     // rows x visible columns in smem
constexpr int kSmemAttn = 2 * kItemBytes + kChunkHeads * kMaxItemTokens * 4
                          + 2 * kChunkHeads * 4 + (2 * kMaxBatch + 1) * 4
                          + kPageTable * 4;
constexpr int kSmemBytes = kSmemGemm > kSmemAttn ? kSmemGemm : kSmemAttn;
constexpr int kBarrierInts = 32;     // the barrier's count, a line
constexpr unsigned kMaxPolls = 1u << 28;  // ~seconds of polling, then trap
constexpr int kMaxDevices = 64;

// Per element type: rows of a ring chunk, values in 16 bytes, the rows of
// the B operand window, and its row stride: op[kRows][kOpLd], bf16 at a
// stride of 4 (mod 32) words, so that the B fragment's 32-bit loads fall
// on 32 distinct banks.
template <typename T>
struct Kind;
template <>
struct Kind<__nv_bfloat16> {
  static constexpr int KC = 128, E = 8, kWin = 4096, kOpLd = kWin + 8;
  static constexpr int kRowBytes = 128 + 16;  // a chunk row in smem
};
template <>
struct Kind<float> {
  static constexpr int KC = 64, E = 4, kWin = 2048, kOpLd = kWin + 4;
  static constexpr int kRowBytes = 256 + 16;
};

// v rounded to T and back: bf16 rounding, or nothing in f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ptt::to_float(ptt::from_float<T>(v));
}

// One matrix of a GEMM stage: its column groups are [cg0, cg0 + its
// ceil(cols / kCols)); its output columns start at out_off.
struct Seg {
  const void* w;  // rows of cols values, contiguous
  int cols, out_off, cg0;
};

// A GEMM stage: part[s][b][out_cols] (f32) = the slice s rows of the
// operand times the slice s rows of the matrices. Tile t: column group
// t % ncg, slice (t / ncg) % slices, row group t / (ncg * slices). The
// B operand window holds win_rows rows (whole slices) of a row group.
struct Gemm {
  Seg seg[3];
  int nseg, K, ncg, slices, slice_rows, win_rows, nwin, tiles;
  int out_cols;
  int vec;  // every chunk row 16-byte aligned: 16-byte copies
  float* part;
};

// Slices: about enough for kTargetTiles tiles, rounded down to a divisor
// of the KC-row chunks (so that the slices end together with K's last
// chunk; at most kMaxSliceRows rows a tile). Each slice adds a partial
// that stages A2 and D read back.
template <typename T>
Gemm gemm_plan(int K, int nrg, const int* cols, int nseg, int out_cols) {
  Gemm p{};
  int ncg = 0, off = 0;
  for (int i = 0; i < nseg; ++i) {
    p.seg[i].cols = cols[i];
    p.seg[i].out_off = off;
    p.seg[i].cg0 = ncg;
    off += cols[i];
    ncg += (cols[i] + kCols - 1) / kCols;
  }
  p.nseg = nseg;
  p.K = K;
  p.ncg = ncg;
  p.out_cols = out_cols;
  const int kc = Kind<T>::KC, nk = (K + kc - 1) / kc;
  int s = (kTargetTiles + nrg * ncg - 1) / (nrg * ncg);
  const int smin = (nk * kc + kMaxSliceRows - 1) / kMaxSliceRows;
  s = s > nk ? nk : (s < 1 ? 1 : s);
  while (nk % s) --s;
  while (s < smin || nk % s) ++s;
  p.slices = s;
  p.slice_rows = kc * (nk / s);
  p.win_rows = (Kind<T>::kWin / p.slice_rows) * p.slice_rows;
  p.nwin = (p.slices * p.slice_rows + p.win_rows - 1) / p.win_rows;
  p.tiles = nrg * p.slices * ncg;
  return p;
}

// The scratch of one launch: byte offsets into the work buffer, and the
// state's int count. Computed from the shapes alone.
struct Layout {
  long long part_a, qkv, spart, att, part_c, work_bytes;
  int state_ints;
  int nchunks, per, ts, maxsplit, kst;
};

template <typename T>
Layout layout(int b, int hidden, int heads, int kvh, int d, int page,
              int walk_cols, Gemm* ga, Gemm* gc) {
  const int nrg = (b + kRows - 1) / kRows;
  const int na = (heads + 2 * kvh) * d, hd = heads * d;
  const int cols_a[3] = {hd, kvh * d, kvh * d};
  *ga = gemm_plan<T>(hidden, nrg, cols_a, 3, na);
  *gc = gemm_plan<T>(hd, nrg, &hidden, 1, hidden);
  Layout l{};
  const int group = heads / kvh;
  l.nchunks = (group + kChunkHeads - 1) / kChunkHeads;
  l.per = (group + l.nchunks - 1) / l.nchunks;
  const int row = d * static_cast<int>(sizeof(T));
  int ts = kKvBytes / (2 * row);
  ts = ts > kMaxItemTokens ? kMaxItemTokens : ts / 8 * 8;
  l.ts = ts;
  // a K/V row's stride in shared memory: 16-byte units an odd count, so
  // that 16-byte loads of 8 neighbouring rows fall on distinct banks
  l.kst = row % 16 ? row + 8 : ((row / 16) % 2 ? row + 32 : row + 16);
  const long long ntok = static_cast<long long>(walk_cols) * page;
  l.maxsplit = ntok > 0 ? static_cast<int>((ntok + ts - 1) / ts) : 1;
  auto align = [](long long v) { return (v + 255) / 256 * 256; };
  long long off = 0;
  l.part_a = off;
  off = align(off + 4LL * ga->slices * b * na);
  l.qkv = off;
  off = align(off + 4LL * b * na);
  l.spart = off;
  off = align(off + 4LL * b * kvh * l.nchunks * l.maxsplit * l.per * (d + 2));
  l.att = off;
  off = align(off + static_cast<long long>(sizeof(T)) * b * hd);
  l.part_c = off;
  off = align(off + 4LL * gc->slices * b * hidden);
  l.work_bytes = off;
  l.state_ints = kBarrierInts;
  return l;
}

template <typename T>
struct Args {
  const T* x;
  const T* ln1;
  const T* ln2;
  const float* rope_cos;
  const float* rope_sin;
  T* k_pages;
  T* v_pages;
  const int* tables;
  const int* lengths;
  T* h_mid;
  T* y2;
  float* qkv;
  float* spart;
  T* att;
  float* part_c;
  unsigned* bar;
  Gemm ga, gc;
  int b, hidden, heads, kvh, d, rope_rows, page, n_pages, table_cols,
      walk_cols;
  int nchunks, per, ts, maxsplit, kst;
  int vec_kv;   // pool rows and q/k/v rows 16-byte aligned
  int vec_ln;   // ln1 16-byte aligned
  int vec_att;  // att rows 16-byte aligned
  float eps1, eps2, scale;
};

// ---- grid-wide synchronisation ----------------------------------------

// Every block of the grid arrives before any leaves; what a block wrote
// before is visible to every block after. One atomic add a block on *bar:
// block 0 adds 2^31 - (blocks - 1) and every other block 1, so the adds of
// one barrier sum to 2^31: bar's top bit flips when the last block
// arrives, and its low bits are back where they were (zero at rest: the
// barrier resets itself). Each block polls until the top bit differs from
// what it saw on arrival. (cooperative_groups' grid sync counts the same
// way; this one gives up after kMaxPolls with __trap().)
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned seen = atomicAdd(bar, add);
    const volatile unsigned* vb = bar;
    unsigned polls = 0;
    while (((seen ^ *vb) & 0x80000000u) == 0) {
      if (++polls == kMaxPolls) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Sum over the block; buf holds kWarps floats. Every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  v = ptt::warp_sum(v);
  if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += buf[w];
  __syncthreads();
  return t;
}

// The values of T in 16 bytes
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// kVec<T> values of T at p as floats: one 16-byte load (p 16-byte aligned)
// through L2 (kCg: data written in this launch) or the read-only path;
// else n <= kVec<T> values one by one, zeros after them.
template <typename T, bool kCg>
__device__ __forceinline__ void load_vec(const T* p, bool vec, int n,
                                         float* out) {
  constexpr int CW = kVec<T>;
  if (vec && n == CW) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 u = kCg ? __ldcg(q) : __ldg(q);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[2 * j] = f.x;
        out[2 * j + 1] = f.y;
      }
    } else {
      const float4 f = *reinterpret_cast<const float4*>(&u);
      out[0] = f.x;
      out[1] = f.y;
      out[2] = f.z;
      out[3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      out[j] = j < n ? ptt::to_float(kCg ? __ldcg(p + j) : p[j]) : 0.f;
    }
  }
}

// 16 bytes of T in shared memory (16-byte aligned) as floats
__device__ __forceinline__ void smem_vec(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void smem_vec(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

// ---- the GEMM stages (A and C) ------------------------------------------

// Byte offset of the 16-byte unit cc of chunk row rr (rows padded by 16
// bytes: 8 rows at one column fall on 8 distinct groups of 4 banks)
template <typename T>
__device__ __forceinline__ int chunk_off(int rr, int cc) {
  return rr * Kind<T>::kRowBytes + (cc << 4);
}

// Accumulators of one thread: bf16 one m16n8 fragment (4 floats); f32
// kRows rows x 4 columns.
template <typename T>
struct Acc;
template <>
struct Acc<__nv_bfloat16> {
  float c[4];
};
template <>
struct Acc<float> {
  float c[kRows * 4];
};

// One chunk of KC rows into the accumulators, krow its first row in the
// window op[kRows][kOpLd]. bf16: warp w takes the 16 columns 16 (w % 4)
// and the k-steps 4 (w / 4) .. +3 of the chunk. f32: thread t takes
// columns 4 (t % 16) .. +3 and rows t / 16 + 16 i.
__device__ __forceinline__ void chunk_mma(Acc<__nv_bfloat16>& acc,
                                          const char* slot,
                                          const __nv_bfloat16* op, int krow) {
  constexpr int ld = Kind<__nv_bfloat16>::kOpLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mb = warp & 3, kp = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3, q = lane >> 3, r8 = lane & 7;
  const uint32_t* opw = reinterpret_cast<const uint32_t*>(op + g * ld);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k = kp * 64 + ks * 16;
    const int row = k + (q >> 1) * 8 + r8;
    uint32_t a[4];
    ptt::ldmatrix_x4<true>(
        a, slot + chunk_off<__nv_bfloat16>(row, mb * 2 + (q & 1)));
    const int kk = krow + k + 2 * t4;
    ptt::mma_bf16(acc.c, a, opw[kk >> 1], opw[(kk + 8) >> 1]);
  }
}

__device__ __forceinline__ void chunk_mma(Acc<float>& acc, const char* slot,
                                          const float* op, int krow) {
  constexpr int ld = Kind<float>::kOpLd;
  const int cq = threadIdx.x & 15, r16 = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r16 + 16 * i;
    const float4 wv = *reinterpret_cast<const float4*>(
        slot + r * Kind<float>::kRowBytes + cq * 16);
#pragma unroll
    for (int bb = 0; bb < kRows; ++bb) {
      const float xv = op[bb * ld + krow + r];
      acc.c[bb * 4 + 0] += xv * wv.x;
      acc.c[bb * 4 + 1] += xv * wv.y;
      acc.c[bb * 4 + 2] += xv * wv.z;
      acc.c[bb * 4 + 3] += xv * wv.w;
    }
  }
}

// A tile's sums across the block, in a fixed order, to part: out(col,
// row) for col < ncols and row < rows of the group.
__device__ __forceinline__ void tile_out(const Acc<__nv_bfloat16>& acc,
                                         float* red, float* out, int ncols,
                                         int rows, long long ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mb = warp & 3, kp = warp >> 2, g = lane >> 2, t4 = lane & 3;
  if (kp == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(mb * 32 + lane) * 4 + i] = acc.c[i];
  }
  __syncthreads();
  if (kp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = mb * 16 + g + (i >= 2 ? 8 : 0);
      const int bb = 2 * t4 + (i & 1);
      if (col < ncols && bb < rows) {
        out[bb * ld + col] = acc.c[i] + red[(mb * 32 + lane) * 4 + i];
      }
    }
  }
}

__device__ __forceinline__ void tile_out(Acc<float>& acc, float* red,
                                         float* out, int ncols, int rows,
                                         long long ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cq = lane & 15;
  // row groups 2w and 2w + 1 of warp w, then the warps in order
#pragma unroll
  for (int k = 0; k < kRows * 4; ++k) {
    acc.c[k] += __shfl_xor_sync(0xffffffffu, acc.c[k], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int bb = 0; bb < kRows; ++bb) {
      *reinterpret_cast<float4*>(red + (warp * kRows + bb) * kCols + cq * 4) =
          make_float4(acc.c[bb * 4], acc.c[bb * 4 + 1], acc.c[bb * 4 + 2],
                      acc.c[bb * 4 + 3]);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
    const int bb = o / kCols, col = o % kCols;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(w * kRows + bb) * kCols + col];
    if (col < ncols && bb < rows) out[bb * ld + col] = v;
  }
}

// One GEMM stage's walk over this block's tiles: tiles bid, bid + G, ...,
// so that at any time the grid reads neighbouring column groups of the
// same weight rows. Every field the walk reads is held here, in registers:
// the cp.async statements clobber memory, and a field read through a
// reference would be read again after each of them (measured: issuing a
// ring of 7 chunks took 16.8 us that way, 2.4 us this way). prologue()
// issues the ring's first kRing - 1 chunks (weights only, so it can run
// ahead of the stage that produces the B operand); run() copies the B
// operand window of the first tile (the src rows: xn in stage A, att in
// stage C) by cp.async, waits for it and walks the tiles. A later window
// (a second row group, or K past kWin rows) is loaded the same way,
// synchronously. No fence or atomic inside the walk: a fence waits for the
// ring's copies in flight, which stalls the stream (measured: ~10 us a
// tile). (Bulk copies of the Tensor Memory Accelerator, one a 128-byte
// row, were tried in place of cp.async: 2-3x slower, the copies too small
// for it.)
template <typename T>
struct Walk {
  static constexpr int KC = Kind<T>::KC, E = Kind<T>::E, ld = Kind<T>::kOpLd;
  const T* w0;
  const T* w1;
  const T* w2;
  int cols0, cols1, cols2, cg1, cg2, off1, off2;
  int K, ncg, slices, slice_rows, win_rows, nwin, out_cols, nb;
  bool wvec;  // the weights' rows 16-byte aligned
  bool ovec;  // stage C: att's rows 16-byte aligned; stage A: ln1
  float* part;
  const T* src;
  long long lds;
  const T* ln1;  // stage A: src is x, and the window is xn
  float eps1;
  int nkc, total;
  char* ring;
  T* op;
  float* red;

  __device__ __forceinline__ Walk(const Gemm& gp, const T* src_,
                                  long long lds_, bool ovec_, int nb_,
                                  char* smem, const T* ln1_ = nullptr,
                                  float eps1_ = 0.f) {
    ln1 = ln1_;
    eps1 = eps1_;
    const int ns = gp.nseg;
    w0 = static_cast<const T*>(gp.seg[0].w);
    w1 = static_cast<const T*>(gp.seg[ns > 1 ? 1 : 0].w);
    w2 = static_cast<const T*>(gp.seg[ns > 2 ? 2 : 0].w);
    cols0 = gp.seg[0].cols;
    cols1 = gp.seg[ns > 1 ? 1 : 0].cols;
    cols2 = gp.seg[ns > 2 ? 2 : 0].cols;
    cg1 = ns > 1 ? gp.seg[1].cg0 : gp.ncg;
    cg2 = ns > 2 ? gp.seg[2].cg0 : gp.ncg;
    off1 = gp.seg[ns > 1 ? 1 : 0].out_off;
    off2 = gp.seg[ns > 2 ? 2 : 0].out_off;
    K = gp.K;
    ncg = gp.ncg;
    slices = gp.slices;
    slice_rows = gp.slice_rows;
    win_rows = gp.win_rows;
    nwin = gp.nwin;
    out_cols = gp.out_cols;
    nb = nb_;
    wvec = gp.vec;
    ovec = ovec_;
    part = gp.part;
    src = src_;
    lds = lds_;
    nkc = slice_rows / KC;
    const int G = gridDim.x, bid = blockIdx.x;
    total = (bid < gp.tiles ? (gp.tiles - bid + G - 1) / G : 0) * nkc;
    ring = smem;
    op = reinterpret_cast<T*>(smem + kRing * kChunkBytes);
    red = reinterpret_cast<float*>(smem + kRing * kChunkBytes + kOpBytes);
  }

  // column group cg's matrix, its first column, columns and output offset
  __device__ __forceinline__ void seg(int cg, const T*& w, int& c0,
                                      int& cols, int& out_off) const {
    if (cg >= cg2) {
      w = w2, c0 = (cg - cg2) * kCols, cols = cols2, out_off = off2;
    } else if (cg >= cg1) {
      w = w1, c0 = (cg - cg1) * kCols, cols = cols1, out_off = off1;
    } else {
      w = w0, c0 = cg * kCols, cols = cols0, out_off = 0;
    }
  }

  // Chunk j of this block's walk into ring slot j % kRing by cp.async (16
  // bytes a copy where the rows are 16-byte aligned, else 4), one commit
  // group; zeros past K and past the columns.
  __device__ __forceinline__ void issue(int j) const {
    if (j < total) {
      const int tid = threadIdx.x;
      const int t = blockIdx.x + (j / nkc) * gridDim.x, kc = j % nkc;
      const int cg = t % ncg, s = (t / ncg) % slices;
      const T* w;
      int c0, cols, out_off;
      seg(cg, w, c0, cols, out_off);
      const int ncols = min(kCols, cols - c0);
      const int r0 = s * slice_rows + kc * KC;
      w += c0;
      char* dst = ring + (j % kRing) * kChunkBytes;
      if (wvec) {
#pragma unroll
        for (int k = 0; k < KC * (kCols / E) / kThreads; ++k) {
          const int i = tid + k * kThreads;
          const int rr = i / (kCols / E), cc = i % (kCols / E);
          const int row = r0 + rr;
          const bool ok = row < K && cc * E < ncols;
          ptt::cp_async_16(dst + chunk_off<T>(rr, cc),
                           ok ? w + static_cast<long long>(row) * cols + cc * E
                              : w,
                           ok ? 16 : 0);
        }
      } else {  // rows not 16-byte aligned: 4 bytes (2 bf16 | 1 f32) a copy
        constexpr int W4 = kCols * static_cast<int>(sizeof(T)) / 4;
        constexpr int P4 = 4 / static_cast<int>(sizeof(T));
#pragma unroll 4
        for (int k = 0; k < KC * W4 / kThreads; ++k) {
          const int i = tid + k * kThreads;
          const int rr = i / W4, e = i % W4;
          const int row = r0 + rr, col = e * P4;
          const bool ok = row < K && col < ncols;
          ptt::cp_async_4(dst + chunk_off<T>(rr, e >> 2) + ((e & 3) << 2),
                          ok ? w + static_cast<long long>(row) * cols + col
                             : w,
                          ok ? 4 : 0);
        }
      }
    }
    ptt::cp_async_commit();
  }

  __device__ __forceinline__ void prologue() const {
#pragma unroll 1
    for (int j = 0; j < kRing - 1; ++j) issue(j);
  }

  // copies of window win of row group rg: zeros past the batch and past K
  __device__ __forceinline__ void window(int rg, int win) const {
    const int row0 = win * win_rows;
    const int nrows = min(win_rows, K - row0);
    const int span = min(win_rows, slices * slice_rows - row0);
    const int rows = min(kRows, nb - rg * kRows);
    const int per = (ovec ? 16 : 4) / static_cast<int>(sizeof(T));
    for (int bb = 0; bb < kRows; ++bb) {
      const T* sr = src + (rg * kRows + bb) * lds + row0;
      T* dr = op + bb * ld;
      for (int col = threadIdx.x * per; col < span; col += kThreads * per) {
        const bool ok = bb < rows && col < nrows;
        if (ovec) {
          ptt::cp_async_16(dr + col, ok ? sr + col : src, ok ? 16 : 0);
        } else {
          ptt::cp_async_4(dr + col, ok ? sr + col : src, ok ? 4 : 0);
        }
      }
    }
  }

  // Stage A's window: xn = T(T(x rsqrt(mean x^2 + eps1)) ln1) of row
  // group rg computed into op from x's rows (src, K = hidden columns): a
  // warp a row's sum of squares, then kVec<T> values a thread at a time,
  // every load of a round issued before its stores. r1s holds kRows
  // floats.
  __device__ __forceinline__ void norm_window(int rg, int win,
                                              float* r1s) const {
    constexpr int CW = kVec<T>, kPer = kMaxHidden / CW / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row0 = win * win_rows;
    const int nrows = min(win_rows, K - row0);
    const int span = min(win_rows, slices * slice_rows - row0);
    const int rows = min(kRows, nb - rg * kRows);
    if (warp < rows) {
      const T* xr = src + (rg * kRows + warp) * lds;
      float ss = 0.f;
#pragma unroll 4
      for (int u = 0; u < kPer; ++u) {
        const int c = (lane + 32 * u) * CW;
        if (c < K) {
          float v[CW];
          load_vec<T, false>(xr + c, true, CW, v);
#pragma unroll
          for (int j = 0; j < CW; ++j) ss += v[j] * v[j];
        }
      }
      ss = ptt::warp_sum(ss);
      if (lane == 0) r1s[warp] = rsqrtf(ss / K + eps1);
    } else if (lane == 0) {
      r1s[warp] = 0.f;  // a row past the batch: its zeros stay zeros
    }
    __syncthreads();
    constexpr int kBatch = 4;
    const int per = span / CW, n = kRows * per;
    for (int base = threadIdx.x; base < n; base += kThreads * kBatch) {
      float v[kBatch][CW], l[kBatch][CW];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int o = base + u * kThreads;
        const int bb = o / per, c = (o % per) * CW;
        const bool ok = o < n && bb < rows && c < nrows;
        load_vec<T, false>(src + (rg * kRows + bb) * lds + row0 + c, true,
                           ok ? CW : 0, v[u]);
        load_vec<T, false>(ln1 + row0 + c, ovec, ok ? CW : 0, l[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int o = base + u * kThreads;
        if (o < n) {
          const int bb = o / per, c = (o % per) * CW;
          const float r1 = r1s[bb];
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            op[bb * ld + c + j] =
                ptt::from_float<T>(round_to<T>(v[u][j] * r1) * l[u][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // kNorm: stage A (the first window built from x here, then the ring's
  // first chunks issued); else the ring's first chunks were issued by
  // prologue() and the first window is copied.
  template <bool kNorm>
  __device__ __forceinline__ void run(float* r1s) const {
    const int G = gridDim.x, bid = blockIdx.x;
    int loaded = -1;  // row group * windows + window of the operand held
    if (total > 0) {
      const int s = (bid / ncg) % slices, rg = bid / (ncg * slices);
      const int win = s * slice_rows / win_rows;
      if (kNorm) {
        norm_window(rg, win, r1s);
      } else {
        window(rg, win);
      }
      loaded = rg * nwin + win;
    }
    if (kNorm) {
      prologue();
    } else {
      ptt::cp_async_commit();
      ptt::cp_async_wait<0>();
      __syncthreads();
    }
    Acc<T> acc;
    for (int j = 0; j < total; ++j) {
      ptt::cp_async_wait<kRing - 2>();
      __syncthreads();
      issue(j + kRing - 1);
      const int t = bid + (j / nkc) * G, kc = j % nkc;
      const int cg = t % ncg, s = (t / ncg) % slices;
      const int rg = t / (ncg * slices);
      const int win = s * slice_rows / win_rows;
      if (kc == 0) {
        if (rg * nwin + win != loaded) {
          if (kNorm) {
            norm_window(rg, win, r1s);
          } else {
            window(rg, win);
            ptt::cp_async_commit();
            ptt::cp_async_wait<0>();
            __syncthreads();
          }
          loaded = rg * nwin + win;
        }
#pragma unroll
        for (int i = 0; i < static_cast<int>(sizeof(acc.c) / 4); ++i) {
          acc.c[i] = 0.f;
        }
      }
      chunk_mma(acc, ring + (j % kRing) * kChunkBytes, op,
                s * slice_rows - win * win_rows + kc * KC);
      if (kc == nkc - 1) {
        const T* w;
        int c0, cols, out_off;
        seg(cg, w, c0, cols, out_off);
        tile_out(acc, red,
                 part + (static_cast<long long>(s) * nb + rg * kRows)
                     * out_cols + out_off + c0,
                 min(kCols, cols - c0), min(kRows, nb - rg * kRows),
                 out_cols);
      }
    }
    ptt::cp_async_wait<0>();
    __syncthreads();
  }
};

// ---- stage B: attention items --------------------------------------------

struct Item {
  int b, ts, g, hc, h0, count, t0, t1, len;
};

// Row b's visible positions and split count, from its pre-append depth.
template <typename T>
__device__ __forceinline__ int ntok_of(const Args<T>& a, int len) {
  return min(len + 1, a.walk_cols * a.page);
}
template <typename T>
__device__ __forceinline__ int nsplit_of(const Args<T>& a, int len) {
  return max(1, (ntok_of(a, len) + a.ts - 1) / a.ts);
}

// Item i from the rows' depths len_s and split prefix pre_s (shared
// memory: row b's splits are pre_s[b] .. pre_s[b + 1] - 1).
template <typename T>
__device__ __forceinline__ Item item_of(const Args<T>& a, int i,
                                        const int* len_s, const int* pre_s) {
  Item it;
  it.hc = i % a.nchunks;
  const int r = i / a.nchunks;
  it.g = r % a.kvh;
  const int p = r / a.kvh;
  int lo = 0, hi = a.b;  // the last row whose first split is <= p
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (pre_s[mid] <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  it.b = lo;
  it.ts = p - pre_s[lo];
  it.len = len_s[lo];
  it.t0 = it.ts * a.ts;
  it.t1 = min(ntok_of(a, it.len), it.t0 + a.ts);
  const int group = a.heads / a.kvh;
  it.h0 = it.g * group + it.hc * a.per;
  it.count = min(a.per, group - it.hc * a.per);
  return it;
}

// An item's slot: q of its heads (f32, roped), the new k and v rows (f32,
// roped k), then its K rows and V rows in T at a stride of a.kst bytes.
__device__ __forceinline__ float* slot_q(char* s) {
  return reinterpret_cast<float*>(s);
}
__device__ __forceinline__ float* slot_knew(char* s) {
  return reinterpret_cast<float*>(s) + kChunkHeads * kMaxD;
}
__device__ __forceinline__ float* slot_vnew(char* s) {
  return reinterpret_cast<float*>(s) + (kChunkHeads + 1) * kMaxD;
}
__device__ __forceinline__ char* slot_k(char* s) { return s + kItemHead; }

// n f32 values global -> shared, 16 bytes a copy where vec
__device__ __forceinline__ void copy_f32(float* dst, const float* src, int n,
                                         bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      ptt::cp_async_16(dst + 4 * i, src + 4 * i, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      ptt::cp_async_4(dst + i, src + i, 4);
    }
  }
}

// The item's q, new k/v and K/V rows into its slot by cp.async (16 bytes
// a copy where the rows are 16-byte aligned, else 4): kThreads / ts
// threads a K/V row. pg_s: the rows' page ids for their visible columns (b
// * walk_cols + column), or null to read the table.
template <typename T>
__device__ __forceinline__ void issue_item(const Args<T>& a, const Item& it,
                                           char* slot, const int* pg_s) {
  const int d = a.d, na = (a.heads + 2 * a.kvh) * d;
  const float* row = a.qkv + static_cast<long long>(it.b) * na;
  const bool vec = a.vec_kv;
  copy_f32(slot_q(slot), row + it.h0 * d, it.count * d, vec);
  if (it.len >= it.t0 && it.len < it.t1) {
    copy_f32(slot_knew(slot), row + (a.heads + it.g) * d, d, vec);
    copy_f32(slot_vnew(slot), row + (a.heads + a.kvh + it.g) * d, d, vec);
  }
  constexpr int kTpr = kThreads / kMaxItemTokens;  // threads a row
  const int rr = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int t = it.t0 + rr;
  if (rr < it.t1 - it.t0 && t != it.len) {  // the appended row is in f32
    const int pg =
        pg_s ? pg_s[it.b * a.walk_cols + t / a.page]
             : min(max(__ldg(a.tables + static_cast<long long>(it.b)
                                        * a.table_cols + t / a.page), 0),
                   a.n_pages - 1);
    const long long off =
        ((static_cast<long long>(pg) * a.page + t % a.page) * a.kvh + it.g)
        * d;
    const char* ksrc = reinterpret_cast<const char*>(a.k_pages + off);
    const char* vsrc = reinterpret_cast<const char*>(a.v_pages + off);
    char* kdst = slot_k(slot) + rr * a.kst;
    char* vdst = slot_k(slot) + (a.ts + rr) * a.kst;
    const int bytes = d * static_cast<int>(sizeof(T));
    if (vec) {
      for (int c = part * 16; c < bytes; c += kTpr * 16) {
        ptt::cp_async_16(kdst + c, ksrc + c, 16);
        ptt::cp_async_16(vdst + c, vsrc + c, 16);
      }
    } else {
      for (int c = part * 4; c < bytes; c += kTpr * 4) {
        ptt::cp_async_4(kdst + c, ksrc + c, 4);
        ptt::cp_async_4(vdst + c, vsrc + c, 4);
      }
    }
  }
}

// Two values of T at p (4-byte aligned pairs) as floats
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One item's attention, exact softmax over its positions: (1) four lanes a
// (head, position) score, each a quarter of the dot product's 16-byte
// units, summed by two shuffles; (2) a warp a head: max, exponentials,
// sum; (3) four lanes two columns of a head, each a quarter of the
// positions, summed by two shuffles. Every sum is taken in a fixed order.
// The appended row is read in f32 from the slot. A row's only split stores
// T(att); otherwise (m, l, acc) of the split. [Changed from the lane
// layout of paged_decode_any_kernel (DPL = ceil(D / 32) columns a lane, a
// warp's shuffle sum a score): its five dependent shuffles a score took
// 4-22 us an item at 1-8 heads of 64 positions on the H100, the kernel's
// largest stage.]
template <typename T>
__device__ __forceinline__ void attend_item(const Args<T>& a, const Item& it,
                                            char* slot, float* sc,
                                            float* ml) {
  constexpr int kParts = 4, CW = 16 / static_cast<int>(sizeof(T));
  const int d = a.d, kst = a.kst, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, part = tid % kParts;
  const float scale = a.scale;
  const bool vec = a.vec_kv;
  const float* qs = slot_q(slot);
  const float* knew = slot_knew(slot);
  const float* vnew = slot_vnew(slot);
  const char* kb = slot_k(slot);
  const char* vb = kb + a.ts * kst;
  const int nr = it.t1 - it.t0, lrow = it.len - it.t0, cnt = it.count;
  // (1) scores: pair tid / kParts + k (kThreads / kParts)
  for (int base = 0; base < cnt * nr; base += kThreads / kParts) {
    const int pr = base + tid / kParts;
    float dot = 0.f;
    if (pr < cnt * nr) {
      const int h = pr / nr, r = pr % nr;
      const float* q = qs + h * d;
      const bool fresh = r == lrow;  // its smem row holds no copy
      const T* kr = reinterpret_cast<const T*>(kb + r * kst);
      if (vec) {
#pragma unroll 4
        for (int c = part * CW; c < d; c += kParts * CW) {
          float kv[CW];
          smem_vec(kr + c, kv);
          if (fresh) {
#pragma unroll
            for (int j = 0; j < CW; ++j) kv[j] = knew[c + j];
          }
#pragma unroll
          for (int j = 0; j < CW; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(q + c + j);
            dot += qv.x * kv[j] + qv.y * kv[j + 1] + qv.z * kv[j + 2]
                   + qv.w * kv[j + 3];
          }
        }
      } else {
#pragma unroll 4
        for (int c = part * 2; c < d; c += kParts * 2) {
          float2 kv = load2(kr + c);
          if (fresh) kv = make_float2(knew[c], knew[c + 1]);
          dot += q[c] * kv.x + q[c + 1] * kv.y;
        }
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (pr < cnt * nr && part == 0) {
      sc[(pr / nr) * kMaxItemTokens + pr % nr] = dot * scale;
    }
  }
  __syncthreads();
  // (2) softmax statistics, a warp a head
  if (warp < cnt) {
    float* sw = sc + warp * kMaxItemTokens;
    float m = ptt::kNegInf;
    for (int r = lane; r < nr; r += 32) m = fmaxf(m, sw[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    float l = 0.f;
    for (int r = lane; r < nr; r += 32) {
      const float p = expf(sw[r] - m);
      sw[r] = p;
      l += p;
    }
    l = ptt::warp_sum(l);
    if (lane == 0) {
      ml[2 * warp] = m;
      ml[2 * warp + 1] = l;
    }
  }
  __syncthreads();
  // (3) P V: output pair tid / kParts + k (kThreads / kParts), positions
  // part, part + kParts, ...
  const int hd = a.heads * d, half = d / 2;
  const bool split = nsplit_of(a, it.len) > 1;
  const long long chunk = (static_cast<long long>(it.b) * a.kvh + it.g)
                              * a.nchunks + it.hc;
  float* sp = a.spart + ((chunk * a.maxsplit + it.ts) * a.per) * (d + 2);
  T* att = a.att + static_cast<long long>(it.b) * hd + it.h0 * d;
  for (int base = 0; base < cnt * half; base += kThreads / kParts) {
    const int o = base + tid / kParts;
    float a0 = 0.f, a1 = 0.f;
    int h = 0, c = 0;
    if (o < cnt * half) {
      h = o / half;
      c = (o % half) * 2;
      const float* p = sc + h * kMaxItemTokens;
#pragma unroll 4
      for (int r = part; r < nr; r += kParts) {
        float2 v = load2(reinterpret_cast<const T*>(vb + r * kst) + c);
        if (r == lrow) v = make_float2(vnew[c], vnew[c + 1]);
        a0 += p[r] * v.x;
        a1 += p[r] * v.y;
      }
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
    a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
    if (o < cnt * half && part == 0) {
      if (!split) {
        const float inv = 1.f / fmaxf(ml[2 * h + 1], 1e-30f);
        att[h * d + c] = ptt::from_float<T>(a0 * inv);
        att[h * d + c + 1] = ptt::from_float<T>(a1 * inv);
      } else {
        float* dst = sp + h * (d + 2);
        dst[2 + c] = a0;
        dst[3 + c] = a1;
        if (c == 0) {
          dst[0] = ml[2 * h];
          dst[1] = ml[2 * h + 1];
        }
      }
    }
  }
  __syncthreads();
}

// ---- the kernel -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decode_layer_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float r1s[kRows], sum_buf[kWarps];
  __shared__ int warp_tot[kWarps];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = gridDim.x, bid = blockIdx.x;
  const int d = a.d, nb = a.b, hidden = a.hidden;
  const int units = a.heads + 2 * a.kvh, na = units * d;
  const long long gtid = static_cast<long long>(bid) * kThreads + tid;
  const long long gthreads = static_cast<long long>(G) * kThreads;
  const Gemm& ga = a.ga;

  // A. q | k | v partials
  const Walk<T> wa(ga, a.x, hidden, a.vec_ln, nb, smem, a.ln1, a.eps1);
  wa.template run<true>(r1s);
  grid_sync(a.bar);

  // A2. per (row, head, 4 column pairs (j, j + D / 2), or one where
  // D % 8 != 0): the slices' sum in slice order, RoPE on q and k, the
  // append of k and v
  {
    const int half = d / 2, pw = half % 4 == 0 ? 4 : 1;
    const int gph = half / pw;  // pair groups a head
    const long long sstride = static_cast<long long>(nb) * na;
    for (long long w = gtid; w < static_cast<long long>(nb) * units * gph;
         w += gthreads) {
      const int b = static_cast<int>(w / (units * gph));
      const int rem = static_cast<int>(w % (units * gph));
      const int u = rem / gph, j = (rem % gph) * pw;
      const int sgi = u < a.heads ? 0 : (u < a.heads + a.kvh ? 1 : 2);
      const float* p = ga.part + static_cast<long long>(b) * na + u * d + j;
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
      if (pw == 4) {
#pragma unroll 4
        for (int sl = 0; sl < ga.slices; ++sl) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(
              p + sl * sstride));
          const float4 y = __ldcg(reinterpret_cast<const float4*>(
              p + sl * sstride + half));
          lo[0] += x.x;
          lo[1] += x.y;
          lo[2] += x.z;
          lo[3] += x.w;
          hi[0] += y.x;
          hi[1] += y.y;
          hi[2] += y.z;
          hi[3] += y.w;
        }
      } else {
#pragma unroll 4
        for (int sl = 0; sl < ga.slices; ++sl) {
          lo[0] += __ldcg(p + sl * sstride);
          hi[0] += __ldcg(p + sl * sstride + half);
        }
      }
      const int len = max(__ldg(a.lengths + b), 0);
      if (sgi < 2) {  // neox RoPE of q and k
        const long long pos = min(len, a.rope_rows - 1);
        const float* cs = a.rope_cos + pos * d + j;
        const float* sn = a.rope_sin + pos * d + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < pw) {
            const float x = lo[e], y = hi[e];
            lo[e] = x * __ldg(cs + e) - y * __ldg(sn + e);
            hi[e] = y * __ldg(cs + half + e) + x * __ldg(sn + half + e);
          }
        }
      }
      float* q = a.qkv + static_cast<long long>(b) * na + u * d + j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < pw) {
          q[e] = lo[e];
          q[half + e] = hi[e];
        }
      }
      const int col = len / a.page;
      if (sgi > 0 && col < a.table_cols) {  // the append
        const int pg = min(max(__ldg(a.tables + static_cast<long long>(b)
                                            * a.table_cols + col), 0),
                           a.n_pages - 1);
        const int g = u - (sgi == 1 ? a.heads : a.heads + a.kvh);
        T* dst = (sgi == 1 ? a.k_pages : a.v_pages)
                 + ((static_cast<long long>(pg) * a.page + len % a.page)
                    * a.kvh + g) * d + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < pw) {
            dst[e] = ptt::from_float<T>(lo[e]);
            dst[half + e] = ptt::from_float<T>(hi[e]);
          }
        }
      }
    }
  }
  grid_sync(a.bar);

  // B. attention, two items in flight
  {
    char* slots[2] = {smem, smem + kItemBytes};
    float* sc = reinterpret_cast<float*>(smem + 2 * kItemBytes);
    float* ml = sc + kChunkHeads * kMaxItemTokens;
    int* len_s = reinterpret_cast<int*>(ml + 2 * kChunkHeads);
    int* pre_s = len_s + nb;
    int* pg_s = pre_s + nb + 1;
    if (nb * a.walk_cols <= kPageTable) {
      for (int i = tid; i < nb * a.walk_cols; i += kThreads) {
        const int b = i / a.walk_cols, c = i % a.walk_cols;
        pg_s[i] = min(max(__ldg(a.tables + static_cast<long long>(b)
                                           * a.table_cols + c), 0),
                      a.n_pages - 1);
      }
    } else {
      pg_s = nullptr;
    }
    // the rows' depths, then the exclusive prefix of their split counts:
    // thread t sums rows [t seg, (t + 1) seg), the block scans the sums
    const int seg = (nb + kThreads - 1) / kThreads;
    int mine_sum = 0;
    for (int b = tid * seg; b < min(nb, (tid + 1) * seg); ++b) {
      len_s[b] = max(__ldg(a.lengths + b), 0);
      mine_sum += nsplit_of(a, len_s[b]);
    }
    int incl = mine_sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    int run = before + incl - mine_sum;
    for (int b = tid * seg; b < min(nb, (tid + 1) * seg); ++b) {
      pre_s[b] = run;
      run += nsplit_of(a, len_s[b]);
    }
    if (tid == kThreads - 1) pre_s[nb] = run;
    __syncthreads();
    const int items = pre_s[nb] * a.kvh * a.nchunks;
    const int mine = bid < items ? (items - bid + G - 1) / G : 0;
    if (mine > 0) {
      issue_item(a, item_of(a, bid, len_s, pre_s), slots[0], pg_s);
    }
    ptt::cp_async_commit();
    for (int k = 0; k < mine; ++k) {
      if (k + 1 < mine) {
        issue_item(a, item_of(a, bid + (k + 1) * G, len_s, pre_s),
                   slots[(k + 1) & 1], pg_s);
      }
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
      __syncthreads();
      attend_item<T>(a, item_of(a, bid + k * G, len_s, pre_s), slots[k & 1],
                     sc, ml);
    }
    ptt::cp_async_wait<0>();
    __syncthreads();
  }
  grid_sync(a.bar);

  // B2. rows of several splits: per (row, head, 4 columns) the splits
  // merged in split order, sum_s acc_s e^(m_s - max) / sum_s l_s e^(..)
  {
    const int hd = a.heads * d, group = a.heads / a.kvh;
    const int cw = d % 4 == 0 ? 4 : 1, gpd = d / cw;
    const long long stride = static_cast<long long>(a.per) * (d + 2);
    for (long long w = gtid; w < static_cast<long long>(nb) * a.heads * gpd;
         w += gthreads) {
      const int b = static_cast<int>(w / (a.heads * gpd));
      const int h = static_cast<int>((w / gpd) % a.heads);
      const int j = static_cast<int>(w % gpd) * cw;
      const int ns = nsplit_of(a, max(__ldg(a.lengths + b), 0));
      if (ns == 1) continue;
      const int g = h / group, hl = h % group;
      const int hc = hl / a.per, hh = hl % a.per;
      const long long cnt = (static_cast<long long>(b) * a.kvh + g)
                            * a.nchunks + hc;
      const float* sp = a.spart + cnt * a.maxsplit * stride + hh * (d + 2);
      float mmax = ptt::kNegInf;
#pragma unroll 4
      for (int sl = 0; sl < ns; ++sl) {
        mmax = fmaxf(mmax, __ldcg(sp + sl * stride));
      }
      float lsum = 0.f, val[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int sl = 0; sl < ns; ++sl) {
        const float* q = sp + sl * stride;
        const float f = expf(__ldcg(q) - mmax);
        lsum += __ldcg(q + 1) * f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < cw) val[e] += __ldcg(q + 2 + j + e) * f;
        }
      }
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      T* o = a.att + static_cast<long long>(b) * hd + h * d + j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < cw) o[e] = ptt::from_float<T>(val[e] * inv);
      }
    }
  }
  // stage C's first weight chunks stream in over a barrier
  const Walk<T> wc(a.gc, a.att, static_cast<long long>(a.heads) * d,
                   a.vec_att, nb, smem);
  wc.prologue();
  grid_sync(a.bar);

  // C. o partials
  wc.template run<false>(r1s);
  grid_sync(a.bar);

  // D. a block a row: o summed over the slices in slice order, 4 columns
  // a thread (every slice's loads of a thread issued together), h_mid =
  // T(x + T(o)), the row's sum of squares, y2
  {
    constexpr int kPer = kMaxHidden / 4 / kThreads;
    const long long cstride = static_cast<long long>(nb) * hidden;
    const int slices_c = a.gc.slices;
    for (int b = bid; b < nb; b += G) {
      const long long base = static_cast<long long>(b) * hidden;
      float4 o[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int sl = 0; sl < slices_c; ++sl) {
        const float4* p =
            reinterpret_cast<const float4*>(a.part_c + base + sl * cstride);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int i4 = tid + k * kThreads;
          if (4 * i4 < hidden) {
            const float4 t = __ldcg(p + i4);
            o[k].x += t.x;
            o[k].y += t.y;
            o[k].z += t.z;
            o[k].w += t.w;
          }
        }
      }
      float h[kPer][4];
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = 4 * (tid + k * kThreads);
        const float ov[4] = {o[k].x, o[k].y, o[k].z, o[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[k][j] = 0.f;
          if (i < hidden) {
            h[k][j] = round_to<T>(ptt::to_float(a.x[base + i + j])
                                  + round_to<T>(ov[j]));
            a.h_mid[base + i + j] = ptt::from_float<T>(h[k][j]);
            ss += h[k][j] * h[k][j];
          }
        }
      }
      const float r2 = rsqrtf(block_sum(ss, sum_buf) / hidden + a.eps2);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = 4 * (tid + k * kThreads);
        if (i < hidden) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a.y2[base + i + j] = ptt::from_float<T>(
                round_to<T>(h[k][j] * r2) * ptt::to_float(a.ln2[i + j]));
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t st) {
  auto* fn = decode_layer_kernel<T>;
  static int grid[kMaxDevices];  // occupancy x SMs, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    int occ = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads,
                                                      kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid[dev] = occ * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid[dev]);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

inline bool takes(int b, int hidden, int heads, int kv_heads, int d) {
  return b >= 0 && b <= kMaxBatch && kv_heads > 0 && heads > 0
         && heads % kv_heads == 0 && d >= 2 && d % 2 == 0 && d <= kMaxD
         && hidden > 0 && hidden % 8 == 0 && hidden <= kMaxHidden;
}

template <typename T>
int launch_layer(const void* x, const void* ln1, const void* ln2,
                 const void* wq, const void* wk, const void* wv,
                 const void* wo, const void* rope_cos, const void* rope_sin,
                 void* k_pages, void* v_pages, const void* tables,
                 const void* lengths, void* h_mid, void* y2, void* work,
                 void* state, int b, int hidden, int heads, int kv_heads,
                 int d, int rope_rows, int page_size, int n_pages,
                 int table_cols, int walk_cols, float eps1, float eps2,
                 float scale, void* stream) {
  if (!takes(b, hidden, heads, kv_heads, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return static_cast<int>(cudaSuccess);
  Args<T> a{};
  const Layout l = layout<T>(b, hidden, heads, kv_heads, d, page_size,
                             walk_cols, &a.ga, &a.gc);
  char* wb = static_cast<char*>(work);
  a.ga.seg[0].w = wq;
  a.ga.seg[1].w = wk;
  a.ga.seg[2].w = wv;
  a.gc.seg[0].w = wo;
  a.ga.part = reinterpret_cast<float*>(wb + l.part_a);
  a.gc.part = reinterpret_cast<float*>(wb + l.part_c);
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const size_t es = sizeof(T);
  a.ga.vec = (addr(wq) | addr(wk) | addr(wv)) % 16 == 0
             && (static_cast<size_t>(d) * es) % 16 == 0;
  a.gc.vec = addr(wo) % 16 == 0 && (static_cast<size_t>(hidden) * es) % 16 == 0;
  a.vec_kv = (addr(k_pages) | addr(v_pages)) % 16 == 0
             && (static_cast<size_t>(d) * es) % 16 == 0 && d % 4 == 0;
  a.vec_ln = addr(ln1) % 16 == 0;
  a.vec_att = (static_cast<size_t>(heads) * d * es) % 16 == 0;
  a.x = static_cast<const T*>(x);
  a.ln1 = static_cast<const T*>(ln1);
  a.ln2 = static_cast<const T*>(ln2);
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  a.k_pages = static_cast<T*>(k_pages);
  a.v_pages = static_cast<T*>(v_pages);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.h_mid = static_cast<T*>(h_mid);
  a.y2 = static_cast<T*>(y2);
  a.qkv = reinterpret_cast<float*>(wb + l.qkv);
  a.spart = reinterpret_cast<float*>(wb + l.spart);
  a.att = reinterpret_cast<T*>(wb + l.att);
  a.part_c = a.gc.part;
  a.bar = static_cast<unsigned*>(state);
  a.b = b;
  a.hidden = hidden;
  a.heads = heads;
  a.kvh = kv_heads;
  a.d = d;
  a.rope_rows = rope_rows;
  a.page = page_size;
  a.n_pages = n_pages;
  a.table_cols = table_cols;
  a.walk_cols = walk_cols;
  a.nchunks = l.nchunks;
  a.per = l.per;
  a.ts = l.ts;
  a.maxsplit = l.maxsplit;
  a.kst = l.kst;
  a.eps1 = eps1;
  a.eps2 = eps2;
  a.scale = scale;
  return launch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace
