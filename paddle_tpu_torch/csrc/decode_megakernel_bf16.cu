// The decode megakernel's bf16 entry and the scratch query (the kernel:
// decode_megakernel.cuh). Its f32 entry is decode_megakernel_f32.cu, a
// source of its own so that nvcc builds the two in parallel.
#include "decode_megakernel.cuh"

// x, h_mid, y2: (b, hidden); ln1, ln2: (hidden,); wq: (hidden, heads * d),
// wk and wv: (hidden, kv_heads * d), wo: (heads * d, hidden), all bf16;
// rope_cos, rope_sin: (rope_rows, d) f32; k_pages, v_pages: (n_pages,
// page_size, kv_heads, d) bf16, the new rows appended in place; tables:
// (b, table_cols) int32; lengths: (b,) int32 pre-append depths. work and
// state: the scratch of ptt_fused_decode_layer_scratch's sizes, kept
// across launches on one stream (state zeroed before its first launch; the
// kernel leaves it ready for the next). Attention reads the first
// walk_cols table columns. d any even value up to 256, heads a multiple of
// kv_heads, hidden a multiple of 8 up to 4096, any b. A cooperative launch
// on every SM; a refused launch returns its error.
PTT_EXPORT int ptt_fused_decode_layer(
    const void* x, const void* ln1, const void* ln2, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* rope_cos,
    const void* rope_sin, void* k_pages, void* v_pages, const void* tables,
    const void* lengths, void* h_mid, void* y2, void* work, void* state,
    int b, int hidden, int heads, int kv_heads, int d, int rope_rows,
    int page_size, int n_pages, int table_cols, int walk_cols, float eps1,
    float eps2, float scale, void* stream) {
  return launch_layer<__nv_bfloat16>(
      x, ln1, ln2, wq, wk, wv, wo, rope_cos, rope_sin, k_pages, v_pages,
      tables, lengths, h_mid, y2, work, state, b, hidden, heads, kv_heads, d,
      rope_rows, page_size, n_pages, table_cols, walk_cols, eps1, eps2, scale,
      stream);
}

// sizes[0] = the work buffer's bytes, sizes[1] = the state's int32 count
// for a launch of these shapes in elements of elem_bytes (2: bf16, 4:
// f32). Returns cudaErrorInvalidValue for shapes the kernel does not take.
PTT_EXPORT int ptt_fused_decode_layer_scratch(int elem_bytes, int b,
                                              int hidden, int heads,
                                              int kv_heads, int d,
                                              int page_size, int walk_cols,
                                              long long* sizes) {
  if (!takes(b, hidden, heads, kv_heads, d)
      || (elem_bytes != 2 && elem_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Gemm ga, gc;
  const Layout l =
      elem_bytes == 2
          ? layout<__nv_bfloat16>(b, hidden, heads, kv_heads, d, page_size,
                                  walk_cols, &ga, &gc)
          : layout<float>(b, hidden, heads, kv_heads, d, page_size, walk_cols,
                          &ga, &gc);
  sizes[0] = l.work_bytes;
  sizes[1] = l.state_ints;
  return static_cast<int>(cudaSuccess);
}
