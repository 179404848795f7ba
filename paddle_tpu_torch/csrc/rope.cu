// Neox rotate-half rotary embedding of q and k in one launch:
//   out = x * cos[pos] + rot(x) * sin[pos],  rot(x) = [-x2, x1],
// with the math in f32; with kInverse the adjoint rotation
// rot(x) = [x2, -x1], which carries the output gradients (dq, dk) back.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/fused_ops.py:47
// (_rope_kernel, called from _rope_apply at :60), both directions: the
// forward (inverse=False) and the adjoint that _rope_one_bwd (:91) runs
// (inverse=True). The kernel reads c[i] and c[i + D / 2] (and s the same)
// for the pair (i, i + D / 2), as the Pallas kernel and the plain version
// do, and assumes nothing of the two halves.
// The Pallas kernel takes the (S, D) tables cropped to the sequence, so
// it serves only position_ids=None; decode's per-slot positions take the
// jnp gather in paddle_tpu/ops/nn_kernels.py:828-846. This kernel reads
// a (B, S) int32 position per token and gathers its cos/sin rows itself,
// so prefill (arange) and per-slot decode both run through it; positions
// outside the table are clamped, as the jnp gather clamps them. Any even
// D (JAX's probe fused_rope_supported :41 asks only for that).
//
// Bound on the H100: bytes. Each rotated pair reads two values of x and
// writes two, plus the gathered f32 table entries (L1/L2 hits: every
// head of a token reads the same row), for 6 flops per pair. At the
// training shape, q and k of (4, 1536, 12, 128) bf16, either direction
// moves 75.5 MB (22.5 us at 3.35 TB/s).
//
// One kernel, rope_kernel<T, kInverse>, T bf16 or f32 (the Pallas kernel
// is generic in its dtype, :47-57, and the JAX model's default is f32).
// Lanes split a row's pairs into runs of V neighbouring pairs, V = 8 in
// bf16 and 4 in f32, so that x1 and x2 of a run are one 16-byte vector
// each; L = min(D / 2 / V, 32) lanes cover a row, and a warp's 32 / L
// groups of L lanes take the token's q rows, then its k rows, a group a
// row, 3 rows in flight a lane in bf16, 4 in f32. With enough tokens to
// fill the card a warp takes a token, 8 warps a block; with fewer (a
// decode step's 8) a warp takes one row a group, 4 warps a block, so
// that the rows spread over the SMs (12 blocks at the 438M's 24 rows of
// 128, 26 at Phi-3's 64 rows of 96). A lane loads its run's cos/sin
// entries (both halves, as float4s) once and keeps them across its rows.
// The position and the rows' offsets come from the token (a 64-bit base
// after one 32-bit division a warp) and the row (32-bit offsets): no
// division a pair. A D whose half is not a multiple of V, or pointers off
// 16-byte alignment, take the same code with runs of one pair (element
// loads) inside the same kernel.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;        // warps a block on a wide call
constexpr int kNarrowWarps = 4;  // and on a narrow one
constexpr int kMaxDevices = 64;

// rows a lane loads at once: 3 in bf16, whose 8-pair runs hold 32 table
// entries a lane, so that 2 blocks of 8 warps fit an SM without spilling
template <typename T>
constexpr int kRowsInFlight = sizeof(T) == 2 ? 3 : 4;

// V values of T as raw bits: one 16-byte vector, or one element at V = 1
template <typename T, int V>
struct Run {
  using Raw = typename std::conditional<V == 1, T, uint4>::type;
  static_assert(V == 1 || V * sizeof(T) == 16, "a 16-byte run");

  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  static __device__ __forceinline__ void store(T* p, Raw r) {
    *reinterpret_cast<Raw*>(p) = r;
  }
  static __device__ __forceinline__ void unpack(const Raw& r,
                                                float (&f)[V]) {
    if constexpr (V == 1) {
      f[0] = ptt::to_float(r);
    } else if constexpr (sizeof(T) == 2) {
      ptt::unpack_bf16x8(r, f);
    } else {
      f[0] = __uint_as_float(r.x);
      f[1] = __uint_as_float(r.y);
      f[2] = __uint_as_float(r.z);
      f[3] = __uint_as_float(r.w);
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[V]) {
    Raw r;
    if constexpr (V == 1) {
      r = ptt::from_float<T>(f[0]);
    } else if constexpr (sizeof(T) == 2) {
      r = make_uint4(ptt::pack_bf16(f[0], f[1]), ptt::pack_bf16(f[2], f[3]),
                     ptt::pack_bf16(f[4], f[5]), ptt::pack_bf16(f[6], f[7]));
    } else {
      r = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                     __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
    return r;
  }
};

// V table entries from p as floats (float4s at V > 1, 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_table(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      f[i] = v.x;
      f[i + 1] = v.y;
      f[i + 2] = v.z;
      f[i + 3] = v.w;
    }
  }
}

struct RopeArgs {
  const void* q;
  const void* k;
  void* q_out;
  void* k_out;
  const int* positions;
  const float* cos_table;
  const float* sin_table;
  long long tokens;
  int q_heads, k_heads, d, table_rows;
};

// Rows [r_begin, r_end) of the token's q then k rows, in runs of V
// pairs: lane group `grp` of `groups` takes rows r_begin + grp, + groups,
// ..., kRowsInFlight of them loaded at once; lane vl of a group runs vl,
// vl + L, ... of a row's half / V.
template <typename T, bool kInverse, int V>
__device__ __forceinline__ void rope_rows(const RopeArgs& a, long long tok,
                                          int r_begin, int r_end, int lane) {
  using R = Run<T, V>;
  const int d = a.d, half = d / 2, runs = half / V;
  const int lanes = min(runs, 32), groups = 32 / lanes;
  const int grp = lane / lanes, vl = lane - grp * lanes;
  if (grp >= groups) return;
  const T* qt = static_cast<const T*>(a.q) + tok * a.q_heads * d;
  const T* kt = static_cast<const T*>(a.k) + tok * a.k_heads * d;
  T* qo = static_cast<T*>(a.q_out) + tok * a.q_heads * d;
  T* ko = static_cast<T*>(a.k_out) + tok * a.k_heads * d;
  const int pos = min(max(__ldg(a.positions + tok), 0), a.table_rows - 1);
  const float* crow = a.cos_table + static_cast<long long>(pos) * d;
  const float* srow = a.sin_table + static_cast<long long>(pos) * d;
  for (int v = vl; v < runs; v += lanes) {
    const int i = v * V;
    typename R::Raw x1[kRowsInFlight<T>], x2[kRowsInFlight<T>];
    int row = r_begin + grp;
    // the first rows' loads before the table's, which wait on pos
#pragma unroll
    for (int u = 0; u < kRowsInFlight<T>; ++u) {
      const int r = row + u * groups;
      if (r < r_end) {
        const T* x = r < a.q_heads ? qt + r * d : kt + (r - a.q_heads) * d;
        x1[u] = R::load(x + i);
        x2[u] = R::load(x + i + half);
      }
    }
    float c1[V], c2[V], s1[V], s2[V];
    load_table<V>(crow + i, c1);
    load_table<V>(crow + i + half, c2);
    load_table<V>(srow + i, s1);
    load_table<V>(srow + i + half, s2);
    while (true) {
#pragma unroll
      for (int u = 0; u < kRowsInFlight<T>; ++u) {
        const int r = row + u * groups;
        if (r >= r_end) break;
        float f1[V], f2[V], o1[V], o2[V];
        R::unpack(x1[u], f1);
        R::unpack(x2[u], f2);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (kInverse) {
            o1[j] = f1[j] * c1[j] + f2[j] * s1[j];
            o2[j] = f2[j] * c2[j] - f1[j] * s2[j];
          } else {
            o1[j] = f1[j] * c1[j] - f2[j] * s1[j];
            o2[j] = f2[j] * c2[j] + f1[j] * s2[j];
          }
        }
        T* o = r < a.q_heads ? qo + r * d : ko + (r - a.q_heads) * d;
        R::store(o + i, R::pack(o1));
        R::store(o + i + half, R::pack(o2));
      }
      row += kRowsInFlight<T> * groups;
      if (row >= r_end) break;
#pragma unroll
      for (int u = 0; u < kRowsInFlight<T>; ++u) {
        const int r = row + u * groups;
        if (r < r_end) {
          const T* x = r < a.q_heads ? qt + r * d : kt + (r - a.q_heads) * d;
          x1[u] = R::load(x + i);
          x2[u] = R::load(x + i + half);
        }
      }
    }
  }
}

// A warp a (token, part): `wpt` parts a token of `rpp` rows each.
template <typename T, bool kInverse>
__global__ void __launch_bounds__(kWarps * 32)
rope_kernel(const __grid_constant__ RopeArgs a, bool vec, int rpp, int wpt) {
  // 32-bit: the launch has fewer than 2^31 warps
  const unsigned w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const unsigned tok = w / static_cast<unsigned>(wpt);
  if (tok >= a.tokens) return;
  const int r_begin = static_cast<int>(w - tok * wpt) * rpp;
  const int r_end = min(r_begin + rpp, a.q_heads + a.k_heads);
  if (vec) {
    rope_rows<T, kInverse, 16 / sizeof(T)>(a, tok, r_begin, r_end,
                                           threadIdx.x % 32);
  } else {
    rope_rows<T, kInverse, 1>(a, tok, r_begin, r_end, threadIdx.x % 32);
  }
}

template <typename T, bool kInverse>
int launch_rope(const void* q, const void* k, void* q_out, void* k_out,
                const void* positions, const void* cos_table,
                const void* sin_table, long long tokens, int q_heads,
                int k_heads, int d, int table_rows, void* stream) {
  if (d < 2 || d % 2 || q_heads < 1 || k_heads < 0 || table_rows < 1 ||
      tokens < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tokens == 0) return static_cast<int>(cudaSuccess);
  RopeArgs a{q, k, q_out, k_out, static_cast<const int*>(positions),
             static_cast<const float*>(cos_table),
             static_cast<const float*>(sin_table), tokens, q_heads, k_heads,
             d, table_rows};
  constexpr int kV = 16 / sizeof(T);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(q_out) | reinterpret_cast<uintptr_t>(k_out) |
      reinterpret_cast<uintptr_t>(cos_table) |
      reinterpret_cast<uintptr_t>(sin_table);
  const bool vec = (d / 2) % kV == 0 && addr % 16 == 0;
  // Enough tokens to fill the card: a warp a token, 8 a block. Fewer (a
  // decode step's): a warp one row a lane group, kNarrowWarps a block, so
  // that the rows spread over as many SMs as they can.
  static int sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  const int sm_count = dev < kMaxDevices && sms[dev] > 0 ? sms[dev] : 132;
  const int rows = q_heads + k_heads;
  const int runs = d / 2 / (vec ? kV : 1);
  const int groups = 32 / (runs < 32 ? runs : 32);
  const bool wide = tokens >= 4LL * sm_count;
  const int rpp = wide ? rows : groups, wpt = (rows + rpp - 1) / rpp;
  const int wpb = wide ? kWarps : kNarrowWarps;
  if (tokens * wpt >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (tokens * wpt + wpb - 1) / wpb;
  rope_kernel<T, kInverse><<<static_cast<unsigned>(blocks), wpb * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(a, vec, rpp,
                                                                  wpt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (tokens, q_heads, d), k: (tokens, k_heads, d) bf16; positions:
// (tokens,) int32; tables: (table_rows, d) f32. Outputs like q and k.
// k_heads = 0 rotates q alone: k and k_out are
// then never read or written and may be null.
PTT_EXPORT int ptt_rope_fwd(const void* q, const void* k, void* q_out,
                            void* k_out, const void* positions,
                            const void* cos_table, const void* sin_table,
                            long long tokens, int q_heads, int k_heads,
                            int d, int table_rows, void* stream) {
  return launch_rope<__nv_bfloat16, false>(q, k, q_out, k_out, positions,
                                           cos_table, sin_table, tokens,
                                           q_heads, k_heads, d, table_rows,
                                           stream);
}

// The adjoint rotation of (dq, dk), with the forward's arguments.
PTT_EXPORT int ptt_rope_bwd(const void* dq, const void* dk, void* dq_out,
                            void* dk_out, const void* positions,
                            const void* cos_table, const void* sin_table,
                            long long tokens, int q_heads, int k_heads,
                            int d, int table_rows, void* stream) {
  return launch_rope<__nv_bfloat16, true>(dq, dk, dq_out, dk_out, positions,
                                          cos_table, sin_table, tokens,
                                          q_heads, k_heads, d, table_rows,
                                          stream);
}

// The same two with q, k and the outputs f32.
PTT_EXPORT int ptt_rope_fwd_f32(const void* q, const void* k, void* q_out,
                                void* k_out, const void* positions,
                                const void* cos_table, const void* sin_table,
                                long long tokens, int q_heads, int k_heads,
                                int d, int table_rows, void* stream) {
  return launch_rope<float, false>(q, k, q_out, k_out, positions, cos_table,
                                   sin_table, tokens, q_heads, k_heads, d,
                                   table_rows, stream);
}

PTT_EXPORT int ptt_rope_bwd_f32(const void* dq, const void* dk, void* dq_out,
                                void* dk_out, const void* positions,
                                const void* cos_table, const void* sin_table,
                                long long tokens, int q_heads, int k_heads,
                                int d, int table_rows, void* stream) {
  return launch_rope<float, true>(dq, dk, dq_out, dk_out, positions,
                                  cos_table, sin_table, tokens, q_heads,
                                  k_heads, d, table_rows, stream);
}
