// The decode megakernel at every even head dim up to 256, every GQA group
// and both float types: the attention half of one decoder layer's decode
// step, for every sequence of the batch, in one launch.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/decode_megakernel.py:189
// (_megakernel, called from fused_decode_layer at :322) where
// decode_megakernel.cu's kernel does not reach: that kernel is built for
// bf16, D = 64 and 128 and at most 8 query heads per kv head, and keeps
// those cases. The JAX probe (:126-159) takes any even D, any dtype and
// any group whose q/k/v/o weights fit its VMEM budget; this kernel takes
// every even D up to 256, bf16 or f32 throughout (x, norm scales, weights,
// pools and outputs of one type; RoPE tables f32), any group, and hidden a
// multiple of 8 up to kMaxHidden. It computes what decode_megakernel.cu's
// kernel computes (see there), rounded where the Pallas kernel rounds
// (:211-319): to bf16 in bf16, and in f32 not at all, where the layer is
// the unfused composition (reference_decode_layer :439-485).
//
// One block owns (kv head g, row b), 256 threads:
//   1. ln1 of its row into shared memory.
//   2. Its D key and D value columns as one GEMV (the pattern of
//      decode_megakernel.cu: a thread takes 16 bytes of adjacent columns,
//      8 bf16 or 4 f32, over a slice of the rows, and the slices are summed
//      in fixed order through shared memory); RoPE of k; the new k/v row
//      stored to the pool in the pool's type.
//   3. Its group of query heads in chunks of at most kChunk = 8 heads
//      (ceil(group / 8) chunks of near-equal size), so that the chunk's q
//      and its (m, l, acc) stay in registers at any group. For each chunk:
//      the chunk's q columns (a GEMV), RoPE; attention of its heads over
//      positions [0, len] with the lane layout of decode_attention.cu's
//      paged_decode_any_kernel (DPL >= ceil(D / 32) columns a lane, lane l
//      holding columns l, l + 32, ..., those at or past D masked; built
//      for DPL = 1, 2, 3, 4, 6 and 8, the two types in two sources, to
//      keep the build short; the appended row taken from shared memory in
//      f32); the warps merged one
//      head at a time; the chunk's o_proj rows into an f32 partial of the
//      row in (B, KVH, hidden) scratch, added to the earlier chunks' sum
//      in chunk order by the thread that owns the column.
//   4. The last block of row b to finish sums the KVH partials in g order
//      and writes h_mid and y2, as decode_megakernel.cu's kernel does.
// No cooperative launch and no float atomics: the kernel can be captured
// in a CUDA graph and gives the same bits on every run.
//
// RoPE rotates each (j, j + D / 2) pair in place in shared memory; the
// block owns whole heads, so both halves are local.
//
// Weights are read as 16-byte vectors when D is a multiple of 16 bytes of
// the type (8 in bf16, 4 in f32) and the weights are 16-byte aligned, so
// that every column chunk starts on a vector; otherwise value by value
// (no public model's D is off that grid).
//
// Bound on the H100: bytes. The layer's four weight matrices, plus the K/V
// rows the lengths reach: at the 438M widths in f32 (hidden 1536, 12
// heads of 128) 37.7 MB of weights, ~11 us at 3.35 TB/s. Each block reads
// its kv head's q, k, v and o columns once a row, so across the batch the
// weights are read B times, mostly from the 50 MB L2, as in
// decode_megakernel.cu.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNumWarps = kThreads / 32;
constexpr int kGemvUnroll = 16;  // weight rows in flight per thread
constexpr int kChunk = 8;        // query heads a block attends at once
constexpr int kMaxHidden = 4096;

// v rounded to T and back: bf16 rounding, or nothing in f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ptt::to_float(ptt::from_float<T>(v));
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

// The values of T in one 16-byte load, and acc[j] += a * w[j] over them.
template <typename T>
struct Vec16;
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void fma(float* acc, const uint4& w,
                                             float a) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += a * f.x;
      acc[2 * j + 1] += a * f.y;
    }
  }
};
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void fma(float* acc, const uint4& w,
                                             float a) {
    const float4 f = *reinterpret_cast<const float4*>(&w);
    acc[0] += a * f.x;
    acc[1] += a * f.y;
    acc[2] += a * f.z;
    acc[3] += a * f.w;
  }
};

// Column chunk c of a GEMV: &W[0][first column], the row stride, and its
// column count (at most Vec16<T>::N).
template <typename T>
struct Cols {
  const T* w;
  long long ld;
  int n;
};

// out(c, j) = sum_{r < nrows} vec[r] * W_c[r * ld_c + j] for j < n_c and
// every chunk c < nchunks, where chunk(c) gives Cols<T> {W_c, ld_c, n_c}.
// With vec16 a full chunk is read as one 16-byte load a row (W_c 16-byte
// aligned, ld_c a multiple of N), else value by value. The rows are cut
// into S slices so that nchunks * S threads work; slice sums are added in
// slice order through red (kThreads * 8 floats). store(c, j, value)
// receives each output once, from a thread fixed by (c, j, nchunks). Ends
// with the block synchronised.
template <typename T, class Chunk, class Store>
__device__ __forceinline__ void gemv(const float* vec, int nrows, int nchunks,
                                     bool vec16, Chunk chunk, Store store,
                                     float* red) {
  constexpr int N = Vec16<T>::N;
  const int slices = max(1, kThreads / nchunks);
  const int rows = (nrows + slices - 1) / slices;
  for (int item = threadIdx.x; item < nchunks * slices; item += kThreads) {
    const int c = item % nchunks, s = item / nchunks;
    const Cols<T> col = chunk(c);
    const int lo = s * rows, hi = min(nrows, lo + rows);
    float acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.f;
    if (vec16 && col.n == N) {
      int r = lo;
      for (; r + kGemvUnroll <= hi; r += kGemvUnroll) {
        uint4 wr[kGemvUnroll];
#pragma unroll
        for (int u = 0; u < kGemvUnroll; ++u) {
          wr[u] = __ldg(reinterpret_cast<const uint4*>(col.w
                                                       + (r + u) * col.ld));
        }
#pragma unroll
        for (int u = 0; u < kGemvUnroll; ++u) {
          Vec16<T>::fma(acc, wr[u], vec[r + u]);
        }
      }
      for (; r < hi; ++r) {
        Vec16<T>::fma(acc, __ldg(reinterpret_cast<const uint4*>(
                               col.w + r * col.ld)), vec[r]);
      }
    } else {
      for (int r = lo; r < hi; ++r) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < col.n) {
            acc[j] += vec[r] * ptt::to_float(col.w[r * col.ld + j]);
          }
        }
      }
    }
    if (slices == 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < col.n) store(c, j, acc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) red[(s * nchunks + c) * N + j] = acc[j];
    }
  }
  __syncthreads();
  if (slices > 1) {
    for (int o = threadIdx.x; o < nchunks * N; o += kThreads) {
      const int c = o / N, j = o % N;
      if (j < chunk(c).n) {
        float t = 0.f;
        for (int s = 0; s < slices; ++s) t += red[s * nchunks * N + o];
        store(c, j, t);
      }
    }
    __syncthreads();
  }
}

// Neox RoPE of n heads of d values at stride d in s, in place: pair
// (j, j + d / 2) of a head becomes (x_j cos_j - x_{j+h} sin_j,
// x_{j+h} cos_{j+h} + x_j sin_{j+h}). Ends with the block synchronised.
__device__ __forceinline__ void rope(float* s, int n, int d, const float* cs,
                                     const float* sn) {
  const int half = d / 2;
  for (int i = threadIdx.x; i < n * half; i += kThreads) {
    const int j = i % half, base = (i / half) * d;
    const float a = s[base + j], b = s[base + j + half];
    s[base + j] = a * cs[j] - b * sn[j];
    s[base + j + half] = b * cs[j + half] + a * sn[j + half];
  }
  __syncthreads();
}

template <typename T, int DPL>  // ceil(head_dim / 32) columns per lane
__global__ void __launch_bounds__(kThreads, 1)
decode_layer_any_kernel(const T* __restrict__ x, const T* __restrict__ ln1,
                        const T* __restrict__ ln2, const T* __restrict__ wq,
                        const T* __restrict__ wk, const T* __restrict__ wv,
                        const T* __restrict__ wo,
                        const float* __restrict__ rope_cos,
                        const float* __restrict__ rope_sin,
                        T* __restrict__ k_pages, T* __restrict__ v_pages,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        T* __restrict__ h_mid, T* __restrict__ y2,
                        float* partial, unsigned int* counters, int hidden,
                        int heads, int kv_heads, int d, int rope_rows,
                        int page_size, int n_pages, int table_cols,
                        int walk_cols, float eps1, float eps2, float scale,
                        bool vec16) {
  constexpr int kD = DPL * 32;             // d <= kD
  constexpr int kU = DPL > 4 ? 2 : 4;      // K/V rows in flight per warp
  constexpr int N = Vec16<T>::N;           // columns of a GEMV chunk
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = heads / kv_heads;
  const int chunks = (group + kChunk - 1) / kChunk;
  const int per = (group + chunks - 1) / chunks;
  const int len = max(lengths[b], 0);
  const int* trow = tables + static_cast<long long>(b) * table_cols;

  __shared__ float xs[kMaxHidden];      // xn, later h_mid
  __shared__ float qs[kChunk * kD];     // the chunk's roped q heads
  __shared__ float kvs[2 * kD];         // the roped new k row, then v
  __shared__ float att[kChunk * kD];    // the chunk's attention, rounded
  __shared__ float red[kThreads * 8];   // GEMV slices, warp merge
  __shared__ float wm[kNumWarps], wl[kNumWarps], sum_buf[kNumWarps];
  __shared__ int is_last;

  // 1. ln1 of row b
  const T* xb = x + static_cast<long long>(b) * hidden;
  float ss = 0.f;
  for (int i = tid; i < hidden; i += kThreads) {
    const float f = ptt::to_float(xb[i]);
    ss += f * f;
  }
  const float r1 = rsqrtf(block_sum(ss, sum_buf) / hidden + eps1);
  for (int i = tid; i < hidden; i += kThreads) {
    xs[i] = round_to<T>(round_to<T>(ptt::to_float(xb[i]) * r1)
                        * ptt::to_float(ln1[i]));
  }
  __syncthreads();

  // 2. the k and v columns of kv head g; RoPE of k; the append
  const int kvc = (d + N - 1) / N;  // column chunks of each
  gemv<T>(
      xs, hidden, 2 * kvc, vec16,
      [&](int c) {
        const int j = (c % kvc) * N;
        return Cols<T>{(c < kvc ? wk : wv) + g * d + j,
                       static_cast<long long>(kv_heads) * d, min(N, d - j)};
      },
      [&](int c, int j, float v) {
        kvs[(c / kvc) * kD + (c % kvc) * N + j] = v;
      },
      red);
  const int pos = min(len, rope_rows - 1);
  const float* cs = rope_cos + static_cast<long long>(pos) * d;
  const float* sn = rope_sin + static_cast<long long>(pos) * d;
  rope(kvs, 1, d, cs, sn);
  const float* knew = kvs;
  const float* vnew = kvs + kD;
  const int col = len / page_size;
  if (col < table_cols) {
    const int page = min(max(trow[col], 0), n_pages - 1);
    const long long off =
        ((static_cast<long long>(page) * page_size + len % page_size) *
             kv_heads + g) * d;
    for (int j = tid; j < d; j += kThreads) {
      k_pages[off + j] = ptt::from_float<T>(knew[j]);
      v_pages[off + j] = ptt::from_float<T>(vnew[j]);
    }
  }

  // 3. the query heads, a chunk at a time
  const int ntok = min(len + 1, walk_cols * page_size);
  float* part = partial + (static_cast<long long>(b) * kv_heads + g) * hidden;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int first = chunk * per, count = min(per, group - first);
    if (count <= 0) break;  // uniform across the block
    const int h0 = g * group + first;  // the chunk's first query head
    gemv<T>(
        xs, hidden, (count * d + N - 1) / N, vec16,
        [&](int c) {
          return Cols<T>{wq + static_cast<long long>(h0) * d + c * N,
                         static_cast<long long>(heads) * d,
                         min(N, count * d - c * N)};
        },
        [&](int c, int j, float v) { qs[c * N + j] = v; }, red);
    rope(qs, count, d, cs, sn);

    // attention over positions [0, len] of the visible columns
    float qf[kChunk][DPL], acc[kChunk][DPL], m[kChunk], l[kChunk];
#pragma unroll
    for (int h = 0; h < kChunk; ++h) {
      m[h] = ptt::kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        qf[h][i] = h < count && c < d ? qs[h * d + c] * scale : 0.f;
        acc[h][i] = 0.f;
      }
    }
    for (int t0 = warp * kU; t0 < ntok; t0 += kNumWarps * kU) {
      float kf[kU][DPL], vf[kU][DPL];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u;
        long long off = 0;
        if (t < ntok && t != len) {
          const int page = min(max(trow[t / page_size], 0), n_pages - 1);
          off = ((static_cast<long long>(page) * page_size + t % page_size) *
                     kv_heads + g) * d;
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int c = lane + 32 * i;
          if (t == len) {  // the appended row, unrounded
            kf[u][i] = c < d ? knew[c] : 0.f;
            vf[u][i] = c < d ? vnew[c] : 0.f;
          } else {
            const bool ok = t < ntok && c < d;
            kf[u][i] = ok ? ptt::to_float(k_pages[off + c]) : 0.f;
            vf[u][i] = ok ? ptt::to_float(v_pages[off + c]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kChunk; ++h) {
        if (h >= count) break;  // uniform across the block
        float s[kU];
        float mx = m[h];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float p = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) p += qf[h][i] * kf[u][i];
          s[u] = ptt::warp_sum(p);
          if (t0 + u < ntok) mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[h] - mx);
        l[h] *= alpha;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] *= alpha;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float p = (t0 + u < ntok) ? expf(s[u] - mx) : 0.f;
          l[h] += p;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[h][i] += p * vf[u][i];
        }
        m[h] = mx;
      }
    }
    // merge the warps, one query head at a time; att rounded to T
#pragma unroll
    for (int h = 0; h < kChunk; ++h) {
      if (h >= count) break;
      if (lane == 0) {
        wm[warp] = m[h];
        wl[warp] = l[h];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) red[warp * kD + lane + 32 * i] = acc[h][i];
      __syncthreads();
      if (tid < d) {
        float mmax = ptt::kNegInf;
#pragma unroll
        for (int w = 0; w < kNumWarps; ++w) mmax = fmaxf(mmax, wm[w]);
        float lsum = 0.f, val = 0.f;
#pragma unroll
        for (int w = 0; w < kNumWarps; ++w) {
          const float f = expf(wm[w] - mmax);
          lsum += wl[w] * f;
          val += red[w * kD + tid] * f;
        }
        att[h * d + tid] = round_to<T>(val / fmaxf(lsum, 1e-30f));
      }
      __syncthreads();
    }

    // the chunk's o_proj rows, added to the earlier chunks' partial
    const T* wo_c = wo + static_cast<long long>(h0) * d * hidden;
    gemv<T>(
        att, count * d, hidden / N, vec16,
        [&](int c) { return Cols<T>{wo_c + c * N, hidden, N}; },
        [&](int c, int j, float v) {
          const int o = c * N + j;
          part[o] = chunk ? part[o] + v : v;
        },
        red);
  }

  // 4. the last block of row b sums the partials in g order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = static_cast<int>(atomicAdd(counters + b, 1u)) == kv_heads - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* prow = partial + static_cast<long long>(b) * kv_heads * hidden;
  T* hb = h_mid + static_cast<long long>(b) * hidden;
  float ss2 = 0.f;
  for (int i = tid; i < hidden; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < kv_heads; ++gg) {
      o += __ldcg(prow + static_cast<long long>(gg) * hidden + i);
    }
    const float h = round_to<T>(ptt::to_float(xb[i]) + round_to<T>(o));
    xs[i] = h;
    hb[i] = ptt::from_float<T>(h);
    ss2 += h * h;
  }
  const float r2 = rsqrtf(block_sum(ss2, sum_buf) / hidden + eps2);
  T* yb = y2 + static_cast<long long>(b) * hidden;
  for (int i = tid; i < hidden; i += kThreads) {
    yb[i] = ptt::from_float<T>(round_to<T>(xs[i] * r2)
                               * ptt::to_float(ln2[i]));
  }
  if (tid == 0) counters[b] = 0u;
}

template <typename T, int DPL>
void launch(dim3 grid, cudaStream_t st, const void* x, const void* ln1,
            const void* ln2, const void* wq, const void* wk, const void* wv,
            const void* wo, const void* rope_cos, const void* rope_sin,
            void* k_pages, void* v_pages, const void* tables,
            const void* lengths, void* h_mid, void* y2, void* partial,
            void* counters, int hidden, int heads, int kv_heads, int d,
            int rope_rows, int page_size, int n_pages, int table_cols,
            int walk_cols, float eps1, float eps2, float scale, bool vec16) {
  decode_layer_any_kernel<T, DPL><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln1),
      static_cast<const T*>(ln2), static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<const T*>(wo), static_cast<const float*>(rope_cos),
      static_cast<const float*>(rope_sin), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(h_mid),
      static_cast<T*>(y2), static_cast<float*>(partial),
      static_cast<unsigned int*>(counters), hidden, heads, kv_heads, d,
      rope_rows, page_size, n_pages, table_cols, walk_cols, eps1, eps2, scale,
      vec16);
}

template <typename T>
int launch_layer(const void* x, const void* ln1, const void* ln2,
                 const void* wq, const void* wk, const void* wv,
                 const void* wo, const void* rope_cos, const void* rope_sin,
                 void* k_pages, void* v_pages, const void* tables,
                 const void* lengths, void* h_mid, void* y2, void* partial,
                 void* counters, int b, int hidden, int heads, int kv_heads,
                 int d, int rope_rows, int page_size, int n_pages,
                 int table_cols, int walk_cols, float eps1, float eps2,
                 float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || d < 2 || d % 2 || d > 256 ||
      hidden % 8 || hidden > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(wq) | reinterpret_cast<uintptr_t>(wk) |
      reinterpret_cast<uintptr_t>(wv) | reinterpret_cast<uintptr_t>(wo);
  const bool vec16 = d % Vec16<T>::N == 0 && addr % 16 == 0;
  // built for 1, 2, 3, 4, 6 and 8 columns a lane: 5 takes 6 and 7 takes 8
  auto* fn = launch<T, 8>;
  switch ((d + 31) / 32) {
    case 1: fn = launch<T, 1>; break;
    case 2: fn = launch<T, 2>; break;
    case 3: fn = launch<T, 3>; break;
    case 4: fn = launch<T, 4>; break;
    case 5: case 6: fn = launch<T, 6>; break;
    default: break;
  }
  fn(dim3(kv_heads, b), static_cast<cudaStream_t>(stream), x, ln1, ln2, wq,
     wk, wv, wo, rope_cos, rope_sin, k_pages, v_pages, tables, lengths, h_mid,
     y2, partial, counters, hidden, heads, kv_heads, d, rope_rows, page_size,
     n_pages, table_cols, walk_cols, eps1, eps2, scale, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
