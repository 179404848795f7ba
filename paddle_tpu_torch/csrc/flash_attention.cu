// Flash-attention forward: O = softmax(Q K^T * scale [+ causal mask]) V
// and the per-row log-sum-exp, online softmax in f32, never forming the
// (Sq, Sk) score matrix in memory.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/flash_attention.py:86
// (_fwd_kernel, called from _fwd at :137). Same function: causal rows see
// keys c <= r + (sk - sq) (:102-107), GQA reads kv head h / (H / KVH) by
// index and never repeats K/V, lse = m + log(max(l, 1e-30)) in f32, masked
// scores are -1e30. The Pallas grid steps over (b, h, q-block) in order
// and carries nothing between steps; here one block of 4 warps owns a
// tile of kBQ = 64 query rows of one (b, h), each warp 16 of them, and
// walks 64-key tiles up to the tile's causal limit (tiles past it are
// skipped, not masked). Rows past sq are zero-filled and never stored, so
// any length rides the kernel: the serving bucket 32 and ragged lengths.
//
// Segment masking (the Pallas kernel's masked=True, :87-122) is the
// kSegments instantiation: an entry counts only where the query's int32 id
// equals the key's. Each block stages its 64 query ids in shared memory
// beside its Q rows, and each key tile's 64 ids with the tile, in the same
// cp.async ring. In the m16n8k16 accumulator layout lane l holds rows l/4
// and l/4 + 8 and columns 2(l%4) + {0, 1} of each n-block; those ids are
// compared on every tile the block visits, and a masked S entry becomes
// -1e30 before the row max, as the causal mask does. A key tile whose id
// range does not meet the query tile's is skipped: no key of it can match
// (ptt::SegWalk over a host-built table of (min, max) per 32 positions;
// the ring prefetches the next tile that is not skipped). For packed
// documents with monotone ids that leaves the tiles on the documents'
// diagonal blocks. The unmasked instantiation's code path is unchanged.
//
// A query row with no visible key (causal with sq > sk, or a segment that
// is missing from the keys) gets out = 0 and lse = -1e30, whether its
// tiles are visited or skipped: while a row's max is -1e30 its P is 0
// (mb = 0 below), so l = 0 and O = 0. The plain version in
// ops/cuda/flash_attention.py defines such rows the same way; the Pallas
// kernel leaves them "finite garbage" that depends on its tiles.
//
// Bound on the H100: operations at the training shape (4, 1536, 12, 128)
// causal (28.99 GFLOP, 29.3 us at the bf16 tensor-core peak), bytes at the
// serving prefill (8, 128, 12, 128) (12.6 MB, 3.8 us at 3.35 TB/s) and at
// BERT's (32, 128, 12, 64). With segments the bound is the visible,
// same-segment (query, key) pairs x 4 D flops over 989 TFLOP/s, or the
// bytes (q, k, v, the ids in; out, lse out) over 3.35 TB/s if larger; the
// pairs are counted from the ids (chip_smoke.py). Design, for the tensor
// cores:
// - Every product is a bf16 mma.sync.m16n8k16 with f32 accumulators. A
//   warp holds its 16 rows of Q as A fragments in registers (loaded once
//   with ldmatrix); S = Q K^T lands in registers, row max and row sum
//   reduce over the 4 lanes of a quad, and P, rounded to bf16, is the A
//   operand of P V as it stands (the m16n8k16 accumulator layout is the
//   A-fragment layout). O, m and l stay in f32 registers until the end.
// - P enters P V as two bf16 operands, its rounding and the rounding of
//   the rest (ptt::split_bf16), so it keeps ~16 bits where the Pallas
//   kernel keeps P in f32 (l sums P in f32). One rounding, as FA2 does,
//   errs by 2^-9 of each term, which in early causal rows (few keys) and
//   in outputs that cancel to near zero exceeds the port's gate of 1e-3
//   + 2^-7 relative; tests/test_torch_flash_rounding.py shows both. The
//   second operand makes the tensor-core work 3 products instead of 2.
// - K and V tiles are staged with 16-byte cp.async in a ring of two: the
//   next tile's copies are in flight while the current one is multiplied.
//   Shared rows are padded by 8 bf16, so ldmatrix (V through .trans) is
//   free of bank conflicts. K and V are read once per block of 64 rows.
// - Causal tiles run heaviest first (the last query tiles are launched
//   first), so the long rows do not finish last. The mask is applied only
//   on tiles that cross the diagonal or the end of the keys.
// - 87 KB of shared memory at D = 128 (46 KB at 64): two blocks per SM.
//   The output tile is written through the block's Q rows in shared
//   memory, 16 bytes per lane.
//
// Head dims. The kernel is instantiated at D = 32, 64, 96, 128 and 256
// (ptt_flash_attention_fwd); the wrapper in ops/cuda/flash_attention.py
// zero-pads any other D <= 256 to the next of these and passes the scale
// of the true D, as the Pallas kernel takes any d <= 256
// (flash_attention_supported, :67-82). Every loop over D runs in k-steps
// of 16 and n-blocks of 8 (ldmatrix.x4 covers 16 columns), so D = 96 is 6
// k-steps and 12 n-blocks, and a K/V row is D / 8 16-byte chunks. At
// D = 256 the f32 O accumulator alone is 128 registers a thread, so the
// block walks 32-key tiles (the scores take 16 registers, not 32) and
// reads Q's fragments from shared memory at each k-step rather than
// holding all 64 of them in registers; its shared memory is then 101 KB,
// and two blocks still fit an SM. D <= 128 keeps 64-key tiles and Q in
// registers, its code unchanged.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block: 4 warps x 16
constexpr int kThreads = kBQ / 16 * 32;
constexpr float kLog2e = 1.4426950408889634f;

// keys per tile, and whether a warp holds its Q fragments in registers
template <int D>
constexpr int kKeyTile = D <= 128 ? 64 : 32;
template <int D>
constexpr bool kQInRegisters = D <= 128;

template <int D, bool kSegments>
constexpr int smem_bytes() {
  // Q, and two stages of K and V; with segments the Q tile's ids and two
  // stages of key ids
  constexpr int kBK = kKeyTile<D>;
  return (kBQ + 4 * kBK) * (D + 8) * 2 + (kSegments ? (kBQ + 2 * kBK) * 4 : 0);
}

template <int D, bool kSegments>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 const ptt::SegIds seg, int sq, int sk, int heads,
                 int kv_heads, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= 256, "head dims of whole k-steps");
  constexpr int kBK = kKeyTile<D>;
  constexpr bool kQRegs = kQInRegisters<D>;
  constexpr int S = D + 8;      // shared row stride, bf16
  constexpr int kKd = D / 16;   // k-steps of Q K^T
  constexpr int kNs = kBK / 8;  // score n-blocks of a key tile
  constexpr int kNo = D / 8;    // output n-blocks
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  __nv_bfloat16* ks = qs + kBQ * S;      // [2][kBK][S]
  __nv_bfloat16* vs = ks + 2 * kBK * S;  // [2][kBK][S]
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
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * sq * heads + h) * D;
  const long long kv_base = (static_cast<long long>(b) * sk * kv_heads + kh) * D;
  const __nv_bfloat16* kb = k + kv_base;
  const __nv_bfloat16* vb = v + kv_base;

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
    ptt::cp_async_rows<kBK, D, kThreads>(ks + at, kb, kv_row, k0, sk);
    ptt::cp_async_rows<kBK, D, kThreads>(vs + at, vb, kv_row, k0, sk);
    if (kSegments && threadIdx.x < kBK) {
      const int c = k0 + threadIdx.x;
      const int* kid = seg.k + static_cast<long long>(b) * sk;
      ptt::cp_async_4(kid_s + stage * kBK + threadIdx.x, kid + (c < sk ? c : 0),
                      c < sk ? 4 : 0);
    }
  };

  ptt::cp_async_rows<kBQ, D, kThreads>(qs, qb, q_row, q0, sq);
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
  uint32_t qa[kQRegs ? kKd : 1][4];  // Q's A fragments, held when kQRegs
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
        ptt::ldmatrix_x4<false>(
            qa[kk], qs + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
      }
    }
    const __nv_bfloat16* kst = ks + stage * kBK * S;
    const __nv_bfloat16* vst = vs + stage * kBK * S;
    const int quad = lane >> 3;  // which of ldmatrix's four matrices

    // S = Q K^T over this warp's 16 rows and the tile's 64 keys
    float s[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      if (!kQRegs) {  // this k-step's Q fragment, from the Q rows
        ptt::ldmatrix_x4<false>(
            qa[0], qs + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
      }
      const uint32_t(&qf)[4] = qa[kQRegs ? kk : 0];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t bk[4];
        ptt::ldmatrix_x4<false>(
            bk, kst + (j * 16 + (quad >> 1) * 8 + (lane & 7)) * S + kk * 16 +
                    (quad & 1) * 8);
        ptt::mma_bf16(s[2 * j], qf, bk[0], bk[1]);
        ptt::mma_bf16(s[2 * j + 1], qf, bk[2], bk[3]);
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
      int2 cid = make_int2(0, 0);  // the ids of columns 2t, 2t + 1
      if (kSegments) {
        cid = *reinterpret_cast<const int2*>(kid_s + stage * kBK + n * 8 +
                                             2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (need_mask) {
          const int c = k0 + n * 8 + 2 * t + (e & 1);
          const int r = row + (e >> 1) * 8;
          if (c >= sk || (causal && c > r + off) ||
              (kSegments && (e & 1 ? cid.y : cid.x) != rid[e >> 1])) {
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

    // O += P V, P split in registers into two bf16 A operands
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // rows g, g + 8 by a & 1; keys by a >> 1
        const float* p = s[2 * kk + (a >> 1)] + 2 * (a & 1);
        ptt::split_bf16(p[0], p[1], hi[a], lo[a]);
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bv[4];
        ptt::ldmatrix_x4<true>(
            bv, vst + (kk * 16 + (quad & 1) * 8 + (lane & 7)) * S + j * 16 +
                    (quad >> 1) * 8);
        ptt::mma_bf16(acc[2 * j], hi, bv[0], bv[1]);
        ptt::mma_bf16(acc[2 * j], lo, bv[0], bv[1]);
        ptt::mma_bf16(acc[2 * j + 1], hi, bv[2], bv[3]);
        ptt::mma_bf16(acc[2 * j + 1], lo, bv[2], bv[3]);
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
  __nv_bfloat16* os = qs + warp * 16 * S;  // this warp's own Q rows
#pragma unroll
  for (int n = 0; n < kNo; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * S + n * 8 + 2 * t) =
        ptt::pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * S + n * 8 + 2 * t) =
        ptt::pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __nv_bfloat16* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
#pragma unroll
  for (int j = 0; j < 16 * kChunks / 32; ++j) {
    const int i = j * 32 + lane;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int qr = q0 + warp * 16 + r;
    if (qr < sq) {
      *reinterpret_cast<uint4*>(ob + qr * q_row + c) =
          *reinterpret_cast<const uint4*>(os + r * S + c);
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
int launch_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
               const ptt::SegIds& seg, int b, int sq, int sk, int heads,
               int kv_heads, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kSegments>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kSegments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (sq + kBQ - 1) / kBQ * heads * b;
  flash_fwd_kernel<D, kSegments><<<blocks, kThreads, smem, stream>>>(
      q, k, v, o, lse, seg, sq, sk, heads, kv_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
               const ptt::SegIds& seg, int b, int sq, int sk, int heads,
               int kv_heads, float scale, int causal, cudaStream_t stream) {
  if (seg.q != nullptr) {
    return launch_fwd<D, true>(q, k, v, o, lse, seg, b, sq, sk, heads,
                               kv_heads, scale, causal, stream);
  }
  return launch_fwd<D, false>(q, k, v, o, lse, seg, b, sq, sk, heads,
                              kv_heads, scale, causal, stream);
}

}  // namespace

// q, o: (b, sq, heads, d); k, v: (b, sk, kv_heads, d), all bf16
// row-major, 16-byte aligned; lse: (b, heads, sq) f32. d is 32, 64, 96,
// 128 or 256; scale is the caller's (1 / sqrt of the unpadded head dim).
// q_seg (b, sq) and k_seg (b, sk) int32 ids with their range tables
// (min, max per 32 positions: q_lo, q_hi (b, ceil(sq / 32)); k_lo, k_hi
// (b, ceil(sk / 32))), 4-byte aligned; q_seg null: no segment mask.
PTT_EXPORT int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const int* q_seg, const int* k_seg,
                                       const int* q_lo, const int* q_hi,
                                       const int* k_lo, const int* k_hi,
                                       int b, int sq, int sk, int heads,
                                       int kv_heads, int d, float scale,
                                       int causal, void* stream) {
  const ptt::SegIds seg{q_seg, k_seg, q_lo, q_hi, k_lo, k_hi};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_fwd<32>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                            kv_heads, scale, causal, st);
    case 64:
      return launch_fwd<64>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                            kv_heads, scale, causal, st);
    case 96:
      return launch_fwd<96>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                            kv_heads, scale, causal, st);
    case 128:
      return launch_fwd<128>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                             kv_heads, scale, causal, st);
    case 256:
      return launch_fwd<256>(qp, kp, vp, op, lp, seg, b, sq, sk, heads,
                             kv_heads, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
