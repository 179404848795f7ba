// The decode megakernel's f32 entry (the kernel: decode_megakernel.cuh).
// Its bf16 entry is decode_megakernel_bf16.cu.
#include "decode_megakernel.cuh"

// The arguments of ptt_fused_decode_layer (decode_megakernel_bf16.cu)
// with x, the norm scales, the weights, the pools, h_mid and y2 f32.
PTT_EXPORT int ptt_fused_decode_layer_f32(
    const void* x, const void* ln1, const void* ln2, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* rope_cos,
    const void* rope_sin, void* k_pages, void* v_pages, const void* tables,
    const void* lengths, void* h_mid, void* y2, void* work, void* state,
    int b, int hidden, int heads, int kv_heads, int d, int rope_rows,
    int page_size, int n_pages, int table_cols, int walk_cols, float eps1,
    float eps2, float scale, void* stream) {
  return launch_layer<float>(
      x, ln1, ln2, wq, wk, wv, wo, rope_cos, rope_sin, k_pages, v_pages,
      tables, lengths, h_mid, y2, work, state, b, hidden, heads, kv_heads, d,
      rope_rows, page_size, n_pages, table_cols, walk_cols, eps1, eps2, scale,
      stream);
}
