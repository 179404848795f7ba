// The decode megakernel: the attention half of one decoder layer's decode
// step, for every sequence of the batch, in one launch.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/decode_megakernel.py:189
// (_megakernel, called from fused_decode_layer at :322). For each row b
// (one new token per sequence, pre-append depth len = lengths[b]):
//   xn = bf16(x * rsqrt(mean x^2 + eps1)) * ln1        (rounded to bf16)
//   q, k, v = xn @ wq, wk, wv                          (f32)
//   neox RoPE of q and k at position clip(len, 0, rope_rows - 1)
//   store bf16 k, v at (tables[b, len / page], len % page)
//   online-softmax attention of the query heads over positions [0, len] of
//   the first walk_cols table columns, the new row taken in f32
//   o = bf16(att) @ wo summed in f32; h_mid = bf16(x + bf16(o))
//   y2 = bf16(bf16(h_mid * rsqrt(mean h_mid^2 + eps2)) * ln2)
// The rounding points are the Pallas kernel's (:211-319).
//
// The Pallas kernel runs a sequential grid (B, pages) with every weight
// matrix staged whole in VMEM. Here one block owns (kv head g, row b):
// grid KVH x B, 96 blocks for the 438M model at 8 slots.
//   1. It recomputes ln1 of its row into shared memory.
//   2. It computes its group * D query columns and its D key and value
//      columns as GEMVs. Each thread takes 8 adjacent output columns (one
//      16-byte load per weight row, neighbouring threads on neighbouring
//      addresses) over a slice of the rows; the slices are summed in fixed
//      order through shared memory. kGemvUnroll rows of loads are in flight
//      per thread.
//   3. RoPE in shared memory (the block owns whole heads, so both rotation
//      halves are local); the new k/v row is stored to the pool.
//   4. Its 8 warps split the positions (the pattern of decode_attention.cu:
//      lanes split D, each warp keeps (m, l, acc) per query head) and
//      merge through shared memory, one query head at a time.
//   5. It writes an f32 partial o_proj of its query heads,
//      bf16(att) @ wo[rows of those heads, :], to a (B, KVH, hidden)
//      scratch.
//   6. The last block of row b to finish (a __threadfence, then an atomic
//      counter per row) sums the KVH partials in fixed g order, so the
//      result does not depend on which block finished last, then writes
//      h_mid and y2 and zeroes the row's counter.
// No cooperative launch, no float atomics: the kernel can be captured in a
// CUDA graph and gives the same bits on every run.
//
// Only the appended row is stored, so the Pallas kernel's two flush modes
// (write-back, dump page) end in the same pools here. Rows that share a
// page (the serving engine's idle rows, all on its dump page) store into
// the same cell in no fixed order; their outputs are never used, and every
// value stored is finite.
//
// Bound on the H100 at the 438M serving decode (B = 8, hidden 1536, 12
// heads of 128, page 128): bytes. The layer's four weight matrices,
// 4 x 1536^2 x 2 B = 18.9 MB, plus the K/V rows the lengths reach (~5 MB at
// depth ~100), over 3.35 TB/s: ~7 us. Flops are ~2 per weight element per
// row (~0.3 GFLOP). This design reads each weight once per row: 8 reads of
// 18.9 MB, the first from device memory and the rest mostly from the 50 MB
// L2, so per-SM L2 bandwidth (one block per SM, ~1.6 MB each) sets its pace.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNumWarps = kThreads / 32;
constexpr int kUnroll = 4;       // K/V rows in flight per warp
constexpr int kGemvUnroll = 16;  // weight rows in flight per thread
constexpr int kMaxGroup = 8;     // query heads per kv head
constexpr int kMaxHidden = 4096;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Sum over the block; buf holds kNumWarps floats. Every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  v = ptt::warp_sum(v);
  if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kNumWarps; ++w) t += buf[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ void fma8(float* acc, const uint4& w, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    acc[2 * j] += a * f.x;
    acc[2 * j + 1] += a * f.y;
  }
}

// out[8c + j] = sum_{r < nrows} vec[r] * W_c[r * ld_c + j] for every chunk
// c < nchunks, where chunk(c, &ld) gives W_c and its row stride. The rows
// are cut into S slices so that nchunks * S threads work; slice sums are
// added in slice order through red (kThreads * 8 floats). store(o, value)
// receives each output once. Ends with the block synchronised.
template <class Chunk, class Store>
__device__ __forceinline__ void gemv(const float* vec, int nrows, int nchunks,
                                     Chunk chunk, Store store, float* red) {
  const int slices = max(1, kThreads / nchunks);
  const int rows = (nrows + slices - 1) / slices;
  for (int item = threadIdx.x; item < nchunks * slices; item += kThreads) {
    const int c = item % nchunks, s = item / nchunks;
    long long ld;
    const __nv_bfloat16* w = chunk(c, &ld);
    const int lo = s * rows, hi = min(nrows, lo + rows);
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    int r = lo;
    for (; r + kGemvUnroll <= hi; r += kGemvUnroll) {
      uint4 wr[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        wr[u] = __ldg(reinterpret_cast<const uint4*>(w + (r + u) * ld));
      }
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) fma8(acc, wr[u], vec[r + u]);
    }
    for (; r < hi; ++r) {
      fma8(acc, __ldg(reinterpret_cast<const uint4*>(w + r * ld)), vec[r]);
    }
    if (slices == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) store(c * 8 + j, acc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(s * nchunks + c) * 8 + j] = acc[j];
    }
  }
  __syncthreads();
  if (slices > 1) {
    for (int o = threadIdx.x; o < nchunks * 8; o += kThreads) {
      float t = 0.f;
      for (int s = 0; s < slices; ++s) t += red[s * nchunks * 8 + o];
      store(o, t);
    }
    __syncthreads();
  }
}

template <int DPL>  // head_dim / 32 values per lane
__global__ void __launch_bounds__(kThreads)
decode_layer_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ ln1,
                    const __nv_bfloat16* __restrict__ ln2,
                    const __nv_bfloat16* __restrict__ wq,
                    const __nv_bfloat16* __restrict__ wk,
                    const __nv_bfloat16* __restrict__ wv,
                    const __nv_bfloat16* __restrict__ wo,
                    const float* __restrict__ rope_cos,
                    const float* __restrict__ rope_sin,
                    __nv_bfloat16* __restrict__ k_pages,
                    __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ h_mid,
                    __nv_bfloat16* __restrict__ y2, float* partial,
                    unsigned int* counters, int hidden, int heads,
                    int kv_heads, int rope_rows, int page_size, int n_pages,
                    int table_cols, int walk_cols, float eps1, float eps2,
                    float scale) {
  constexpr int D = DPL * 32;
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = heads / kv_heads;
  const int len = max(lengths[b], 0);
  const int* trow = tables + static_cast<long long>(b) * table_cols;

  __shared__ float xs[kMaxHidden];               // xn, later h_mid
  __shared__ float qkv[(kMaxGroup + 2) * D];     // roped q heads, k, v
  __shared__ float att[kMaxGroup * D];           // bf16-rounded att
  __shared__ float red[kThreads * 8];            // GEMV slices, warp merge
  __shared__ float wm[kNumWarps], wl[kNumWarps], sum_buf[kNumWarps];
  __shared__ int is_last;

  // 1. ln1 of row b
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * hidden;
  float ss = 0.f;
  for (int i = tid * 8; i < hidden; i += kThreads * 8) {
    float f[8];
    ptt::load_bf16<8>(xb + i, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
  }
  const float r1 = rsqrtf(block_sum(ss, sum_buf) / hidden + eps1);
  for (int i = tid; i < hidden; i += kThreads) {
    xs[i] = bf16_round(bf16_round(__bfloat162float(xb[i]) * r1) *
                       __bfloat162float(ln1[i]));
  }
  __syncthreads();

  // 2. q columns of this kv head's query heads, then its k and v columns
  const int qchunks = group * D / 8, kchunks = D / 8;
  gemv(
      xs, hidden, qchunks + 2 * kchunks,
      [&](int c, long long* ld) -> const __nv_bfloat16* {
        if (c < qchunks) {
          *ld = static_cast<long long>(heads) * D;
          return wq + g * group * D + c * 8;
        }
        *ld = static_cast<long long>(kv_heads) * D;
        const __nv_bfloat16* w = c < qchunks + kchunks ? wk : wv;
        return w + g * D + ((c - qchunks) % kchunks) * 8;
      },
      [&](int o, float v) { qkv[o] = v; }, red);

  // 3. RoPE of the query heads and k, at the clipped position
  const int pos = min(len, rope_rows - 1);
  const float* cs = rope_cos + static_cast<long long>(pos) * D;
  const float* sn = rope_sin + static_cast<long long>(pos) * D;
  for (int i = tid; i < (group + 1) * D; i += kThreads) {
    const int j = i % D, base = i - j;
    const float other = j < D / 2 ? -qkv[base + j + D / 2]
                                  : qkv[base + j - D / 2];
    red[i] = qkv[i] * cs[j] + other * sn[j];
  }
  __syncthreads();
  for (int i = tid; i < (group + 1) * D; i += kThreads) qkv[i] = red[i];
  __syncthreads();
  const float* knew = qkv + group * D;
  const float* vnew = qkv + (group + 1) * D;
  const int col = len / page_size;
  if (col < table_cols) {
    const int page = min(max(trow[col], 0), n_pages - 1);
    const long long off =
        ((static_cast<long long>(page) * page_size + len % page_size) *
             kv_heads + g) * D;
    for (int j = tid; j < D; j += kThreads) {
      k_pages[off + j] = __float2bfloat16(knew[j]);
      v_pages[off + j] = __float2bfloat16(vnew[j]);
    }
  }

  // 4. attention over positions [0, len] of the visible columns
  const int ntok = min(len + 1, walk_cols * page_size);
  float qf[kMaxGroup][DPL], acc[kMaxGroup][DPL], m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    m[h] = ptt::kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qf[h][i] = h < group ? qkv[h * D + lane * DPL + i] * scale : 0.f;
      acc[h][i] = 0.f;
    }
  }
  for (int t0 = warp * kUnroll; t0 < ntok; t0 += kNumWarps * kUnroll) {
    float kf[kUnroll][DPL], vf[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t == len) {  // the appended row, unrounded
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kf[u][i] = knew[lane * DPL + i];
          vf[u][i] = vnew[lane * DPL + i];
        }
      } else if (t < ntok) {
        const int page = min(max(trow[t / page_size], 0), n_pages - 1);
        const long long off =
            ((static_cast<long long>(page) * page_size + t % page_size) *
                 kv_heads + g) * D + lane * DPL;
        ptt::load_bf16<DPL>(k_pages + off, kf[u]);
        ptt::load_bf16<DPL>(v_pages + off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h >= group) break;  // uniform across the block
      float s[kUnroll];
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qf[h][i] * kf[u][i];
        s[u] = ptt::warp_sum(part);
        if (t0 + u < ntok) mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[h] - mx);
      l[h] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[h][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = (t0 + u < ntok) ? expf(s[u] - mx) : 0.f;
        l[h] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] += p * vf[u][i];
      }
      m[h] = mx;
    }
  }
  // merge the warps, one query head at a time; att is rounded to bf16
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h >= group) break;
    if (lane == 0) {
      wm[warp] = m[h];
      wl[warp] = l[h];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[warp * D + lane * DPL + i] = acc[h][i];
    __syncthreads();
    if (tid < D) {
      float mmax = ptt::kNegInf;
#pragma unroll
      for (int w = 0; w < kNumWarps; ++w) mmax = fmaxf(mmax, wm[w]);
      float lsum = 0.f, val = 0.f;
#pragma unroll
      for (int w = 0; w < kNumWarps; ++w) {
        const float f = expf(wm[w] - mmax);
        lsum += wl[w] * f;
        val += red[w * D + tid] * f;
      }
      att[h * D + tid] = bf16_round(val / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();
  }

  // 5. partial o_proj of this kv head's query heads
  float* part = partial + (static_cast<long long>(b) * kv_heads + g) * hidden;
  const __nv_bfloat16* wo_g = wo + static_cast<long long>(g) * group * D * hidden;
  gemv(
      att, group * D, hidden / 8,
      [&](int c, long long* ld) -> const __nv_bfloat16* {
        *ld = hidden;
        return wo_g + c * 8;
      },
      [&](int o, float v) { part[o] = v; }, red);

  // 6. the last block of row b sums the partials in g order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = static_cast<int>(atomicAdd(counters + b, 1u)) == kv_heads - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* prow = partial + static_cast<long long>(b) * kv_heads * hidden;
  __nv_bfloat16* hb = h_mid + static_cast<long long>(b) * hidden;
  float ss2 = 0.f;
  for (int i = tid; i < hidden; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < kv_heads; ++gg) {
      o += __ldcg(prow + static_cast<long long>(gg) * hidden + i);
    }
    const float h = bf16_round(__bfloat162float(xb[i]) + bf16_round(o));
    xs[i] = h;
    hb[i] = __float2bfloat16(h);
    ss2 += h * h;
  }
  const float r2 = rsqrtf(block_sum(ss2, sum_buf) / hidden + eps2);
  __nv_bfloat16* yb = y2 + static_cast<long long>(b) * hidden;
  for (int i = tid; i < hidden; i += kThreads) {
    yb[i] = __float2bfloat16(bf16_round(xs[i] * r2) *
                             __bfloat162float(ln2[i]));
  }
  if (tid == 0) counters[b] = 0u;
}

}  // namespace

// x, h_mid, y2: (b, hidden) bf16; ln1, ln2: (hidden,) bf16; wq: (hidden,
// heads * d), wk and wv: (hidden, kv_heads * d), wo: (heads * d, hidden),
// all bf16; rope_cos, rope_sin: (rope_rows, d) f32; k_pages, v_pages:
// (n_pages, page_size, kv_heads, d) bf16, updated in place; tables: (b,
// table_cols) int32; lengths: (b,) int32 pre-append depths; partial: (b,
// kv_heads, hidden) f32 scratch; counters: (b,) int32, zero on entry and
// on exit. Attention reads the first walk_cols table columns. d is 64 or
// 128, heads / kv_heads at most 8, hidden a multiple of 8 up to 4096.
PTT_EXPORT int ptt_fused_decode_layer(
    const void* x, const void* ln1, const void* ln2, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* rope_cos,
    const void* rope_sin, void* k_pages, void* v_pages, const void* tables,
    const void* lengths, void* h_mid, void* y2, void* partial, void* counters,
    int b, int hidden, int heads, int kv_heads, int d, int rope_rows,
    int page_size, int n_pages, int table_cols, int walk_cols, float eps1,
    float eps2, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || heads / kv_heads > kMaxGroup ||
      hidden % 8 || hidden > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(kv_heads, b);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_DECODE_LAYER_ARGS                                                \
  static_cast<const __nv_bfloat16*>(x),                                      \
      static_cast<const __nv_bfloat16*>(ln1),                                \
      static_cast<const __nv_bfloat16*>(ln2),                                \
      static_cast<const __nv_bfloat16*>(wq),                                 \
      static_cast<const __nv_bfloat16*>(wk),                                 \
      static_cast<const __nv_bfloat16*>(wv),                                 \
      static_cast<const __nv_bfloat16*>(wo),                                 \
      static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), \
      static_cast<__nv_bfloat16*>(k_pages),                                  \
      static_cast<__nv_bfloat16*>(v_pages), static_cast<const int*>(tables), \
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(h_mid),  \
      static_cast<__nv_bfloat16*>(y2), static_cast<float*>(partial),         \
      static_cast<unsigned int*>(counters), hidden, heads, kv_heads,         \
      rope_rows, page_size, n_pages, table_cols, walk_cols, eps1, eps2, scale
  if (d == 128) {
    decode_layer_kernel<4><<<grid, block, 0, st>>>(PTT_DECODE_LAYER_ARGS);
  } else if (d == 64) {
    decode_layer_kernel<2><<<grid, block, 0, st>>>(PTT_DECODE_LAYER_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_DECODE_LAYER_ARGS
  return static_cast<int>(cudaGetLastError());
}
