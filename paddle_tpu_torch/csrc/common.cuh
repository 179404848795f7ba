// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel file exposes plain C entry points (no PyTorch headers, so
// nvcc builds each file in seconds). An entry takes raw device pointers,
// sizes and the caller's cudaStream_t, launches, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ptt {

// The Pallas kernels mask with -1e30 rather than -inf, so fully masked
// rows stay finite; the port keeps the same constant.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads N (even) consecutive bf16 values as floats; p must be 4-byte aligned.
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    out[i] = f.x;
    out[i + 1] = f.y;
  }
}

// Loads N (even) consecutive f32 values, as float4 when N % 4 == 0 (p
// 16-byte aligned), else as float2 (p 8-byte aligned).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  static_assert(N % 2 == 0, "pairs of values");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      out[i] = f.x;
      out[i + 1] = f.y;
      out[i + 2] = f.z;
      out[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + i);
      out[i] = f.x;
      out[i + 1] = f.y;
    }
  }
}

// 8 bf16 held as the 16 bytes of u, as floats: a bf16 is the top half of
// its f32, so each is a shift or a mask, and u stays in registers (taking
// its address to reinterpret it would put it on the stack)
__device__ __forceinline__ void unpack_bf16x8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Kernels that are templates on the element type T (bf16 or f32) compute
// in f32 and convert at each load and store through these.
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// N consecutive values of either type as floats (load_bf16 or load_f32).
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* out) {
  load_bf16<N>(p, out);
}
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  load_f32<N>(p, out);
}

// ---- tensor-core building blocks (sm_80+): cp.async staging, ldmatrix
// fragment loads and the bf16 m16n8k16 MMA with f32 accumulators. In a
// fragment, lane = 4 * g + t: an accumulator holds (row g, cols 2t, 2t + 1)
// in c[0..1] and (row g + 8, the same cols) in c[2..3]; an A operand
// (16 x 16, row-major) holds (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..) in a[0..3]; a B operand (16 x 8, k x n) holds
// (k 2t..2t+1, n g) in b0 and (k 2t + 8.., n g) in b1, the lower k in the
// low half of each register.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
// (the source address must still be valid).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives (row g, cols 2t, 2t + 1) of it (with
// kTrans, (rows 2t, 2t + 1, col g): the matrix transposed).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
  }
}

// Two 8 x 8 b16 matrices, as ldmatrix_x4: lanes 8i..8i+7 (i < 2) give
// the row addresses of matrix i.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
  }
}

// c += a b over one 16 x 8 x 16 step, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as two bf16 pairs, hi their rounding and lo the rounding of what
// hi leaves over: hi + lo carries ~16 bits of each, so a product that
// takes both as operands loses 2^-17 relative, where one bf16 rounding
// loses 2^-9.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// ---- 3xTF32: an f32 product on the tensor cores. Each f32 operand is
// split into hi, its TF32 rounding (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), and lo = the rest, exact in f32, which the
// tensor core reads as TF32 by dropping its low 13 bits; a b is then
// hi_a hi_b + hi_a lo_b + lo_a hi_b, which errs by about 2^-21 relative
// where one TF32 product (1xTF32) errs by 2^-11. hi is formed with two
// integer operations, the value cvt.rna.tf32.f32 gives a finite x: the
// instruction compiles to a longer sequence (it checks for NaN and
// infinity), on the hot path of every product. The m16n8k8 TF32
// fragments, lane = 4 g + t: A (16 x 8,
// row-major) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) in
// a[0..3]; B (8 x 8, k x n) holds (k t, n g) in b0 and (k t + 4, n g) in
// b1; the accumulator as bf16's m16n8k16.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b over one 16 x 8 x 8 step, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, a and b given split: the two small products first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// Rows [row0, row0 + kRows) of a bf16 matrix with D columns whose row i
// starts at src + i * row_stride, into dst[kRows][D + 8] (each row padded
// by 8 bf16, so that the 8 row addresses of an ldmatrix fall in distinct
// banks) with 16-byte cp.async; rows at or past nrows are zeros. src and
// row_stride must keep every row 16-byte aligned.
template <int kRows, int D, int kThreads>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              long long row_stride, int row0,
                                              int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kTotal = kRows * kChunks;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < nrows;
    cp_async_16(dst + r * (D + 8) + c,
                ok ? src + (row0 + r) * row_stride + c : src, ok ? 16 : 0);
  }
}

// Rows [row0, row0 + kRows) of an f32 matrix with D columns whose row i
// starts at src + i * row_stride, into dst[kRows][D + 4] (rows padded by 4
// floats, so that 16 rows read as float4 at one column fall in distinct
// bank groups) with 16-byte cp.async; rows at or past nrows are zeros.
// src and row_stride must keep every row 16-byte aligned.
template <int kRows, int D, int kThreads>
__device__ __forceinline__ void cp_async_rows_f32(float* dst, const float* src,
                                                  long long row_stride,
                                                  int row0, int nrows) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  constexpr int kTotal = kRows * kChunks;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = row0 + r < nrows;
    cp_async_16(dst + r * (D + 4) + c,
                ok ? src + (row0 + r) * row_stride + c : src, ok ? 16 : 0);
  }
}

// ---- segment masking of the flash kernels. Ids are int32 per (batch row,
// position); an entry counts only where the query's id equals the key's. A
// tile pair is skipped when the id ranges of its two sides do not meet: no
// id of one side can then equal an id of the other. The ranges come from a
// table of (min, max) per kSegChunk positions, built with plain torch ops
// before the launch (segment_ranges in ops/cuda/flash_attention.py).
constexpr int kSegChunk = 32;

struct SegIds {  // q == nullptr: no segment mask
  const int *q, *k;              // (b, sq), (b, sk) ids
  const int *q_lo, *q_hi;        // (b, ceil(sq / 32)) range table
  const int *k_lo, *k_hi;        // (b, ceil(sk / 32))
};

// [min, max] of the ids at positions [row0, row0 + T) of one batch row,
// from its n-entry range table; row0 is a multiple of T and entries past
// the table (positions past the end) add nothing. A tile within one chunk
// (T < kSegChunk) takes its chunk's range, which holds the tile's.
template <int T>
__device__ __forceinline__ int2 seg_range(const int* lo, const int* hi, int n,
                                          int row0) {
  static_assert(T % kSegChunk == 0 || kSegChunk % T == 0,
                "tiles of whole chunks, or within one");
  int mn = 0x7fffffff, mx = -0x7fffffff - 1;
#pragma unroll
  for (int i = 0; i < (T + kSegChunk - 1) / kSegChunk; ++i) {
    const int c = row0 / kSegChunk + i;
    if (c < n) {
      mn = min(mn, __ldg(lo + c));
      mx = max(mx, __ldg(hi + c));
    }
  }
  return make_int2(mn, mx);
}

// Bit j: tile base + j of a side of T-row tiles (tiles below `end`) has an
// id range that meets `want`. Every warp computes the same mask with one
// ballot, so the threads of a block walk the same tiles.
template <int T>
__device__ __forceinline__ unsigned seg_window(const int* lo, const int* hi,
                                               int n, int base, int end,
                                               int2 want) {
  const int j = base + static_cast<int>(threadIdx.x % 32);
  bool meet = false;
  if (j < end) {
    const int2 r = seg_range<T>(lo, hi, n, j * T);
    meet = r.x <= want.y && r.y >= want.x;
  }
  return __ballot_sync(0xffffffffu, meet);
}

// The tiles to visit in order, 32 at a time: `todo` holds the bits of the
// current window [base, base + 32) not yet taken.
struct SegWalk {
  int base;
  unsigned todo;
  template <class Window>
  __device__ __forceinline__ void start(int from, Window window) {
    base = from;
    todo = window(base);
  }
  // the next tile to visit, or end
  template <class Window>
  __device__ __forceinline__ int next(int end, Window window) {
    while (todo == 0) {
      base += 32;
      if (base >= end) return end;
      todo = window(base);
    }
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    return base + j;
  }
};

}  // namespace ptt

PTT_EXPORT const char* ptt_error_string(int code);
