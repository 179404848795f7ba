// Neox rotate-half rotary embedding of q and k in one launch:
//   out = x * cos[pos] + rot(x) * sin[pos],  rot(x) = [-x2, x1],
// with the math in f32; with kInverse the adjoint rotation
// rot(x) = [x2, -x1], which carries the output gradients (dq, dk) back.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas/fused_ops.py:47
// (_rope_kernel, called from _rope_apply at :60), both directions: the
// forward (inverse=False) and the adjoint that _rope_one_bwd (:91) runs
// (inverse=True). The tables hold the same angle in both halves, so the
// inverse rotation is the exact transpose of the forward's.
// The Pallas kernel takes the (S, D) tables cropped to the sequence, so
// it serves only position_ids=None; decode's per-slot positions take the
// jnp gather in paddle_tpu/ops/nn_kernels.py:828-846. This kernel reads
// a (B, S) int32 position per token and gathers its cos/sin rows itself,
// so prefill (arange) and per-slot decode both run through it; positions
// outside the table are clamped, as the jnp gather clamps them.
//
// Bound on the H100: bytes. Each rotated pair reads two bf16 values and
// writes two, plus the gathered f32 table entries (cached in L1/L2, as
// every head of a token reads the same row), for 6 flops per pair. One
// thread per pair keeps neighbouring threads on neighbouring addresses,
// so every load and store is coalesced. At the training shape, q and k
// of (4, 1536, 12, 128), either direction moves 75.5 MB (22.5 us).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            __nv_bfloat16* __restrict__ q_out,
            __nv_bfloat16* __restrict__ k_out,
            const int* __restrict__ positions,
            const float* __restrict__ cos_table,
            const float* __restrict__ sin_table, long long q_pairs,
            long long total_pairs, int q_heads, int k_heads, int half,
            int table_rows) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total_pairs) return;
  const bool is_q = idx < q_pairs;
  const long long t = is_q ? idx : idx - q_pairs;
  const int heads = is_q ? q_heads : k_heads;
  const __nv_bfloat16* x = is_q ? q : k;
  __nv_bfloat16* out = is_q ? q_out : k_out;
  const int i = static_cast<int>(t % half);
  const long long row = t / half;  // (token, head)
  const long long token = row / heads;
  int p = positions[token];
  p = min(max(p, 0), table_rows - 1);
  const int d = 2 * half;
  const float* c = cos_table + static_cast<long long>(p) * d;
  const float* s = sin_table + static_cast<long long>(p) * d;
  const __nv_bfloat16* xr = x + row * d;
  __nv_bfloat16* orow = out + row * d;
  const float x1 = __bfloat162float(xr[i]);
  const float x2 = __bfloat162float(xr[i + half]);
  if (kInverse) {
    orow[i] = __float2bfloat16(x1 * c[i] + x2 * s[i]);
    orow[i + half] = __float2bfloat16(x2 * c[i + half] - x1 * s[i + half]);
  } else {
    orow[i] = __float2bfloat16(x1 * c[i] - x2 * s[i]);
    orow[i + half] = __float2bfloat16(x2 * c[i + half] + x1 * s[i + half]);
  }
}

template <bool kInverse>
int launch_rope(const void* q, const void* k, void* q_out, void* k_out,
                const void* positions, const void* cos_table,
                const void* sin_table, long long tokens, int q_heads,
                int k_heads, int d, int table_rows, void* stream) {
  const int half = d / 2;
  const long long q_pairs = tokens * q_heads * half;
  const long long total = q_pairs + tokens * k_heads * half;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rope_kernel<kInverse><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(k_out),
      static_cast<const int*>(positions),
      static_cast<const float*>(cos_table),
      static_cast<const float*>(sin_table), q_pairs, total, q_heads, k_heads,
      half, table_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (tokens, q_heads, d), k: (tokens, k_heads, d) bf16; positions:
// (tokens,) int32; tables: (table_rows, d) f32. Outputs like q and k.
// k_heads = 0 rotates q alone (total pairs = q pairs): k and k_out are
// then never read or written and may be null.
PTT_EXPORT int ptt_rope_fwd(const void* q, const void* k, void* q_out,
                            void* k_out, const void* positions,
                            const void* cos_table, const void* sin_table,
                            long long tokens, int q_heads, int k_heads,
                            int d, int table_rows, void* stream) {
  return launch_rope<false>(q, k, q_out, k_out, positions, cos_table,
                            sin_table, tokens, q_heads, k_heads, d,
                            table_rows, stream);
}

// The adjoint rotation of (dq, dk), with the forward's arguments.
PTT_EXPORT int ptt_rope_bwd(const void* dq, const void* dk, void* dq_out,
                            void* dk_out, const void* positions,
                            const void* cos_table, const void* sin_table,
                            long long tokens, int q_heads, int k_heads,
                            int d, int table_rows, void* stream) {
  return launch_rope<true>(dq, dk, dq_out, dk_out, positions, cos_table,
                           sin_table, tokens, q_heads, k_heads, d,
                           table_rows, stream);
}
