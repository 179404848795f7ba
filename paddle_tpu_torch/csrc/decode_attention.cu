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
// One block per (kv head, sequence) processes that kv head's whole GQA
// group, so each K/V row is read once for all of its query heads. The
// block's kNumWarps warps split the sequence's tokens (flash-decoding
// inside the block): warp w takes tokens w*kUnroll + i*kNumWarps*kUnroll,
// keeps its own (m, l, acc) per query head, and the warps merge through
// shared memory at the end. The reduction order therefore differs from
// the Pallas kernel's page-by-page order; in f32 the two agree to ~1e-6
// relative.
//
// Bound on the H100 at the serving path's decode (B = 8, H = KVH = 12,
// D = 128, page 128, lengths up to 183): bytes, the K/V rows the lengths
// reach, about 7 MB at the longest, ~2 us at 3.35 TB/s; flops are 4 per
// K/V element. With 96 blocks on 132 SMs the kernel is latency bound: the
// lanes of a warp split D so each K/V row is one coalesced 256-byte read,
// and every warp keeps kUnroll rows of K and of V in flight.
//
// Head dims: D = 64 and 128 take paged_decode_kernel, whose lanes hold
// D / 32 neighbouring values loaded as bf16 pairs. Every other D up to 256
// (the Pallas kernel takes any, paged_attention_supported :49-55) takes
// paged_decode_any_kernel<DPL> with DPL = ceil(D / 32): lane l holds
// columns l, l + 32, ..., so each load of a warp reads 32 neighbouring
// bf16 of the row, and the columns at or past D are masked; the pools are
// read at their own width, never padded. Its warps merge one query head
// at a time through a [warps][DPL * 32] buffer (8 KB at D = 256, where the
// whole group's would pass the 48 KB of static shared memory), and past
// DPL = 4 a warp keeps 2 rows in flight rather than 4, so the K/V rows,
// the group's q and its accumulators stay in registers.
#include "common.cuh"

namespace {

constexpr int kNumWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxGroup = 8;  // query heads per kv head

template <int DPL>  // head_dim / 32 values per lane
__global__ void __launch_bounds__(kNumWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ o, int heads, int kv_heads,
                    int page_size, int n_pages, int table_cols,
                    int max_tokens, float scale) {
  constexpr int D = DPL * 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = heads / kv_heads;
  const int len = max(min(lengths[b], max_tokens), 0);
  const int* trow = tables + static_cast<long long>(b) * table_cols;

  float qf[kMaxGroup][DPL], acc[kMaxGroup][DPL], m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = ptt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) qf[g][i] = acc[g][i] = 0.f;
    if (g < group) {
      ptt::load_bf16<DPL>(
          q + (static_cast<long long>(b) * heads + kh * group + g) * D +
              lane * DPL,
          qf[g]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) qf[g][i] *= scale;
    }
  }

  for (int t0 = warp * kUnroll; t0 < len; t0 += kNumWarps * kUnroll) {
    float kf[kUnroll][DPL], vf[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < len) {
        int page = trow[t / page_size];
        page = min(max(page, 0), n_pages - 1);
        const long long off =
            ((static_cast<long long>(page) * page_size + t % page_size) *
                 kv_heads + kh) * D + lane * DPL;
        ptt::load_bf16<DPL>(k_pages + off, kf[u]);
        ptt::load_bf16<DPL>(v_pages + off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;  // uniform across the warp
      float s[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qf[g][i] * kf[u][i];
        s[u] = ptt::warp_sum(part);
        if (t0 + u < len) mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = (t0 + u < len) ? expf(s[u] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += p * vf[u][i];
      }
      m[g] = mx;
    }
  }

  __shared__ float m_s[kNumWarps][kMaxGroup];
  __shared__ float l_s[kNumWarps][kMaxGroup];
  __shared__ float acc_s[kNumWarps][kMaxGroup][D];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][g][lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * D; idx += kNumWarps * 32) {
    const int g = idx / D, dd = idx % D;
    float mmax = ptt::kNegInf;
#pragma unroll
    for (int w = 0; w < kNumWarps; ++w) mmax = fmaxf(mmax, m_s[w][g]);
    float lsum = 0.f, val = 0.f;
#pragma unroll
    for (int w = 0; w < kNumWarps; ++w) {
      const float f = expf(m_s[w][g] - mmax);
      lsum += l_s[w][g] * f;
      val += acc_s[w][g][dd] * f;
    }
    o[(static_cast<long long>(b) * heads + kh * group + g) * D + dd] =
        __float2bfloat16(val / fmaxf(lsum, 1e-30f));
  }
}

template <int DPL>  // ceil(head_dim / 32) columns per lane, the last masked
__global__ void __launch_bounds__(kNumWarps * 32)
paged_decode_any_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ o, int heads,
                        int kv_heads, int d, int page_size, int n_pages,
                        int table_cols, int max_tokens, float scale) {
  constexpr int kU = DPL > 4 ? 2 : kUnroll;  // K/V rows in flight per warp
  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = heads / kv_heads;
  const int len = max(min(lengths[b], max_tokens), 0);
  const int* trow = tables + static_cast<long long>(b) * table_cols;

  float qf[kMaxGroup][DPL], acc[kMaxGroup][DPL], m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = ptt::kNegInf;
    l[g] = 0.f;
    const __nv_bfloat16* qr =
        q + (static_cast<long long>(b) * heads + kh * group + g) * d;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      qf[g][i] = g < group && c < d ? __bfloat162float(qr[c]) * scale : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int t0 = warp * kU; t0 < len; t0 += kNumWarps * kU) {
    float kf[kU][DPL], vf[kU][DPL];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      long long off = 0;
      if (t < len) {
        int page = trow[t / page_size];
        page = min(max(page, 0), n_pages - 1);
        off = ((static_cast<long long>(page) * page_size + t % page_size) *
                   kv_heads + kh) * d;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        const bool ok = t < len && c < d;
        kf[u][i] = ok ? __bfloat162float(k_pages[off + c]) : 0.f;
        vf[u][i] = ok ? __bfloat162float(v_pages[off + c]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;  // uniform across the warp
      float s[kU];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qf[g][i] * kf[u][i];
        s[u] = ptt::warp_sum(part);
        if (t0 + u < len) mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = (t0 + u < len) ? expf(s[u] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += p * vf[u][i];
      }
      m[g] = mx;
    }
  }

  __shared__ float m_s[kNumWarps][kMaxGroup];
  __shared__ float l_s[kNumWarps][kMaxGroup];
  __shared__ float acc_s[kNumWarps][DPL * 32];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;  // uniform across the block
    __syncthreads();  // the previous head's reads of acc_s are done
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][lane + 32 * i] = acc[g][i];
    __syncthreads();
    const int c = threadIdx.x;  // one output column a thread: d <= 256
    if (c < d) {
      float mmax = ptt::kNegInf;
#pragma unroll
      for (int w = 0; w < kNumWarps; ++w) mmax = fmaxf(mmax, m_s[w][g]);
      float lsum = 0.f, val = 0.f;
#pragma unroll
      for (int w = 0; w < kNumWarps; ++w) {
        const float f = expf(m_s[w][g] - mmax);
        lsum += l_s[w][g] * f;
        val += acc_s[w][c] * f;
      }
      o[(static_cast<long long>(b) * heads + kh * group + g) * d + c] =
          __float2bfloat16(val / fmaxf(lsum, 1e-30f));
    }
  }
}

template <int DPL>
void launch_any(dim3 grid, dim3 block, cudaStream_t st,
                const __nv_bfloat16* q, const __nv_bfloat16* kp,
                const __nv_bfloat16* vp, const int* tp, const int* lp,
                __nv_bfloat16* op, int heads, int kv_heads, int d,
                int page_size, int n_pages, int table_cols, int max_tokens,
                float scale) {
  paged_decode_any_kernel<DPL><<<grid, block, 0, st>>>(
      q, kp, vp, tp, lp, op, heads, kv_heads, d, page_size, n_pages,
      table_cols, max_tokens, scale);
}

}  // namespace

// q, o: (b, heads, d) bf16; k_pages, v_pages: (n_pages, page_size,
// kv_heads, d) bf16; tables: (b, table_cols) int32; lengths: (b,) int32.
// max_tokens = pages_per_seq * page_size caps the walk. d is 1 to 256,
// heads / kv_heads at most 8.
PTT_EXPORT int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* o, int b,
                                   int heads, int kv_heads, int d,
                                   int page_size, int n_pages, int table_cols,
                                   int max_tokens, float scale, void* stream) {
  if (heads / kv_heads > kMaxGroup || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(kv_heads, b);
  const dim3 block(kNumWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (d == 128) {
    paged_decode_kernel<4><<<grid, block, 0, st>>>(
        qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, n_pages,
        table_cols, max_tokens, scale);
  } else if (d == 64) {
    paged_decode_kernel<2><<<grid, block, 0, st>>>(
        qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, n_pages,
        table_cols, max_tokens, scale);
  } else {
    auto* launch = launch_any<8>;
    switch ((d + 31) / 32) {
      case 1: launch = launch_any<1>; break;
      case 2: launch = launch_any<2>; break;
      case 3: launch = launch_any<3>; break;
      case 4: launch = launch_any<4>; break;
      case 5: launch = launch_any<5>; break;
      case 6: launch = launch_any<6>; break;
      case 7: launch = launch_any<7>; break;
      default: break;
    }
    launch(grid, block, st, qp, kp, vp, tp, lp, op, heads, kv_heads, d,
           page_size, n_pages, table_cols, max_tokens, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
