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
//
// GQA groups (the Pallas kernel takes any h % kvh == 0,
// paged_attention_supported :49-55): a block holds at most kMaxGroup = 8
// query heads' q and (m, l, acc) in registers. A larger group (Mistral-
// Large-2's 12, Llama-3.1-405B's 16, multi-query attention's all) is cut
// into ceil(group / 8) chunks of near-equal size, and paged_decode_group_
// kernel gives each chunk its own block: a grid of (kv head x chunk,
// sequence). Each chunk reads its kv head's K/V rows again, the later
// reads mostly from L2, and the extra blocks fill more SMs where there are
// few kv heads. It shares paged_decode_any_kernel's body and lane layout
// at every D; groups up to 8 keep their kernels.
//
// float32 (the Pallas kernel is generic in its dtype, :112, :179, and the
// JAX engine's pool takes the parameters' dtype, f32 by default): both
// kernels are templates on the element type T of q, the pools and o, and
// compute in f32 either way. In f32 paged_decode_kernel's lanes load their
// D / 32 neighbouring values as float4 (D = 128) or float2 (D = 64), which
// needs the pointers 16-byte aligned (else the f32 call takes the other
// kernel); the lanes of paged_decode_any_kernel read 32 neighbouring f32,
// 128 bytes a warp load, at any D. Registers do not grow (K/V rows are
// floats in both), and the bytes double: the bound at e2's lengths is
// ~2.4 us rather than 1.2.
#include "common.cuh"

namespace {

constexpr int kNumWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxGroup = 8;  // query heads per kv head

template <typename T, int DPL>  // head_dim / 32 values per lane
__global__ void __launch_bounds__(kNumWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    T* __restrict__ o, int heads, int kv_heads,
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
      ptt::load_vals<DPL>(
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
        ptt::load_vals<DPL>(k_pages + off, kf[u]);
        ptt::load_vals<DPL>(v_pages + off, vf[u]);
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
        ptt::from_float<T>(val / fmaxf(lsum, 1e-30f));
  }
}

// Query heads h0 .. h0 + count - 1 (count <= kMaxGroup) of kv head kh
// over row b's pages, ceil(head_dim / 32) columns per lane, the last
// masked: the body of paged_decode_any_kernel (h0 = kh * group, count =
// group) and of paged_decode_group_kernel (a chunk of the group).
template <typename T, int DPL>
__device__ __forceinline__ void paged_decode_heads(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ o, int heads,
    int kv_heads, int d, int page_size, int n_pages, int table_cols,
    int max_tokens, float scale, int kh, int b, int h0, int count) {
  constexpr int kU = DPL > 4 ? 2 : kUnroll;  // K/V rows in flight per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(min(lengths[b], max_tokens), 0);
  const int* trow = tables + static_cast<long long>(b) * table_cols;

  float qf[kMaxGroup][DPL], acc[kMaxGroup][DPL], m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = ptt::kNegInf;
    l[g] = 0.f;
    const T* qr = q + (static_cast<long long>(b) * heads + h0 + g) * d;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      qf[g][i] = g < count && c < d ? ptt::to_float(qr[c]) * scale : 0.f;
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
        kf[u][i] = ok ? ptt::to_float(k_pages[off + c]) : 0.f;
        vf[u][i] = ok ? ptt::to_float(v_pages[off + c]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= count) break;  // uniform across the warp
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
    if (g >= count) break;  // uniform across the block
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
      o[(static_cast<long long>(b) * heads + h0 + g) * d + c] =
          ptt::from_float<T>(val / fmaxf(lsum, 1e-30f));
    }
  }
}

// ceil(head_dim / 32) columns per lane, the last masked; the whole GQA
// group (at most kMaxGroup query heads) of kv head blockIdx.x
template <typename T, int DPL>
__global__ void __launch_bounds__(kNumWarps * 32)
paged_decode_any_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        T* __restrict__ o, int heads,
                        int kv_heads, int d, int page_size, int n_pages,
                        int table_cols, int max_tokens, float scale) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int group = heads / kv_heads;
  paged_decode_heads<T, DPL>(q, k_pages, v_pages, tables, lengths, o, heads,
                             kv_heads, d, page_size, n_pages, table_cols,
                             max_tokens, scale, kh, b, kh * group, group);
}

// A group past kMaxGroup query heads, cut into `chunks` chunks of at most
// kMaxGroup (sizes differ by at most one): block x = kh * chunks + chunk
// takes one chunk, so the chunks of a kv head read its K/V rows each,
// the later reads mostly from L2.
template <typename T, int DPL>
__global__ void __launch_bounds__(kNumWarps * 32)
paged_decode_group_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          T* __restrict__ o, int heads, int kv_heads, int d,
                          int page_size, int n_pages, int table_cols,
                          int max_tokens, float scale, int chunks) {
  const int kh = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int b = blockIdx.y;
  const int group = heads / kv_heads;
  const int per = (group + chunks - 1) / chunks;
  const int first = chunk * per, count = min(per, group - first);
  if (count <= 0) return;  // uniform across the block
  paged_decode_heads<T, DPL>(q, k_pages, v_pages, tables, lengths, o, heads,
                             kv_heads, d, page_size, n_pages, table_cols,
                             max_tokens, scale, kh, b, kh * group + first,
                             count);
}

// chunks > 1: the group kernel, kv_heads * chunks blocks a row
template <typename T, int DPL>
void launch_any(dim3 grid, dim3 block, cudaStream_t st, const T* q,
                const T* kp, const T* vp, const int* tp, const int* lp, T* op,
                int heads, int kv_heads, int d, int page_size, int n_pages,
                int table_cols, int max_tokens, float scale, int chunks) {
  if (chunks > 1) {
    paged_decode_group_kernel<T, DPL>
        <<<dim3(grid.x * chunks, grid.y), block, 0, st>>>(
            q, kp, vp, tp, lp, op, heads, kv_heads, d, page_size, n_pages,
            table_cols, max_tokens, scale, chunks);
  } else {
    paged_decode_any_kernel<T, DPL><<<grid, block, 0, st>>>(
        q, kp, vp, tp, lp, op, heads, kv_heads, d, page_size, n_pages,
        table_cols, max_tokens, scale);
  }
}

template <typename T>
int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* tables, const void* lengths, void* o, int b,
                 int heads, int kv_heads, int d, int page_size, int n_pages,
                 int table_cols, int max_tokens, float scale, void* stream) {
  if (kv_heads < 1 || heads % kv_heads || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (heads / kv_heads + kMaxGroup - 1) / kMaxGroup;
  const dim3 grid(kv_heads, b);
  const dim3 block(kNumWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k_pages);
  const auto* vp = static_cast<const T*>(v_pages);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<T*>(o);
  // f32 lanes load their neighbouring values as float4 / float2
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages);
  const bool vec = sizeof(T) == 2 || addr % 16 == 0;
  if (d == 128 && vec && chunks == 1) {
    paged_decode_kernel<T, 4><<<grid, block, 0, st>>>(
        qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, n_pages,
        table_cols, max_tokens, scale);
  } else if (d == 64 && vec && chunks == 1) {
    paged_decode_kernel<T, 2><<<grid, block, 0, st>>>(
        qp, kp, vp, tp, lp, op, heads, kv_heads, page_size, n_pages,
        table_cols, max_tokens, scale);
  } else {
    auto* launch = launch_any<T, 8>;
    switch ((d + 31) / 32) {
      case 1: launch = launch_any<T, 1>; break;
      case 2: launch = launch_any<T, 2>; break;
      case 3: launch = launch_any<T, 3>; break;
      case 4: launch = launch_any<T, 4>; break;
      case 5: launch = launch_any<T, 5>; break;
      case 6: launch = launch_any<T, 6>; break;
      case 7: launch = launch_any<T, 7>; break;
      default: break;
    }
    launch(grid, block, st, qp, kp, vp, tp, lp, op, heads, kv_heads, d,
           page_size, n_pages, table_cols, max_tokens, scale, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (b, heads, d) bf16; k_pages, v_pages: (n_pages, page_size,
// kv_heads, d) bf16; tables: (b, table_cols) int32; lengths: (b,) int32.
// max_tokens = pages_per_seq * page_size caps the walk. d is 1 to 256,
// heads a multiple of kv_heads.
PTT_EXPORT int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* o, int b,
                                   int heads, int kv_heads, int d,
                                   int page_size, int n_pages, int table_cols,
                                   int max_tokens, float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, o,
                                     b, heads, kv_heads, d, page_size,
                                     n_pages, table_cols, max_tokens, scale,
                                     stream);
}

// The same with q, the pools and o f32.
PTT_EXPORT int ptt_paged_attention_f32(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* tables,
                                       const void* lengths, void* o, int b,
                                       int heads, int kv_heads, int d,
                                       int page_size, int n_pages,
                                       int table_cols, int max_tokens,
                                       float scale, void* stream) {
  return launch_paged<float>(q, k_pages, v_pages, tables, lengths, o, b,
                             heads, kv_heads, d, page_size, n_pages,
                             table_cols, max_tokens, scale, stream);
}
