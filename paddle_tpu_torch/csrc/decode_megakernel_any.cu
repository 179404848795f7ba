// The second decode megakernel's bf16 entry (the kernel:
// decode_megakernel_any.cuh). Its f32 entry is decode_megakernel_f32.cu,
// a source of its own so that nvcc builds the two in parallel.
#include "decode_megakernel_any.cuh"

// The arguments of ptt_fused_decode_layer (decode_megakernel.cu), all bf16
// but the f32 RoPE tables and scratch; d any even value up to 256, heads a
// multiple of kv_heads, hidden a multiple of 8 up to 4096.
PTT_EXPORT int ptt_fused_decode_layer_any(
    const void* x, const void* ln1, const void* ln2, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* rope_cos,
    const void* rope_sin, void* k_pages, void* v_pages, const void* tables,
    const void* lengths, void* h_mid, void* y2, void* partial, void* counters,
    int b, int hidden, int heads, int kv_heads, int d, int rope_rows,
    int page_size, int n_pages, int table_cols, int walk_cols, float eps1,
    float eps2, float scale, void* stream) {
  return launch_layer<__nv_bfloat16>(
      x, ln1, ln2, wq, wk, wv, wo, rope_cos, rope_sin, k_pages, v_pages,
      tables, lengths, h_mid, y2, partial, counters, b, hidden, heads,
      kv_heads, d, rope_rows, page_size, n_pages, table_cols, walk_cols, eps1,
      eps2, scale, stream);
}
