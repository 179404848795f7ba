// The rate at which one H100 streams a weight matrix through per-block
// cp.async rings of 16 KB chunks, the way the decode megakernel's GEMV
// stages read their weights (csrc/decode_megakernel.cuh, Walk), with no
// compute: the stream's own ceiling for those stages.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o cp_async_stream tools/cp_async_stream.cu && ./cp_async_stream
//
// A matrix of Phi-3-mini's [wq | wk | wv] (3072 rows of 9216 bf16) is cut
// into tiles of 128 rows x (16384 / 128) bytes ... 16 rows x 1 KB; one
// block an SM walks tiles bid, bid + G, ... through a ring of DEPTH chunks
// (DEPTH - 2 in flight while one is consumed), touching one float of each
// chunk. Prints the time a pass and the rate, for each chunk shape and
// ring depth, averaged over 20 launches after one of warm-up.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int DEPTH>
__global__ void __launch_bounds__(256, 1)
stream(const char* w, long long rowbytes, int rows, int rows_a_chunk,
       float* out) {
  extern __shared__ __align__(128) char smem[];
  const int cb = 16384 / rows_a_chunk;  // bytes a chunk row
  const int ncg = static_cast<int>(rowbytes / cb);
  const int tiles = ncg * (rows / rows_a_chunk);
  const int G = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
  const int mine = bid < tiles ? (tiles - bid + G - 1) / G : 0;
  auto issue = [&](int j) {
    if (j < mine) {
      const int t = bid + j * G, cg = t % ncg, rs = t / ncg;
      const char* src = w + static_cast<long long>(rs) * rows_a_chunk
                                * rowbytes + static_cast<long long>(cg) * cb;
      char* dst = smem + (j % DEPTH) * 16384;
      for (int i = tid; i < 1024; i += 256) {
        const int rr = i / (cb / 16), cc = i % (cb / 16);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(dst + i * 16)),
                        "l"(src + rr * rowbytes + cc * 16) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int j = 0; j < DEPTH - 1; ++j) issue(j);
  float acc = 0.f;
  for (int j = 0; j < mine; ++j) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(DEPTH - 2) : "memory");
    __syncthreads();
    issue(j + DEPTH - 1);
    acc += reinterpret_cast<const float*>(smem + (j % DEPTH) * 16384)[tid];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (acc == 12345.f) out[0] = acc;  // keeps the loads
}

template <int DEPTH>
float pass_ms(const char* w, long long rowbytes, int rows, int r,
              float* out, int sms) {
  cudaFuncSetAttribute(stream<DEPTH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DEPTH * 16384);
  stream<DEPTH><<<sms, 256, DEPTH * 16384>>>(w, rowbytes, rows, r, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) {
    stream<DEPTH><<<sms, 256, DEPTH * 16384>>>(w, rowbytes, rows, r, out);
  }
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 20;
}

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int rows = 3072;
  const long long rowbytes = 9216 * 2;
  const double bytes = static_cast<double>(rows) * rowbytes;
  char* w = nullptr;
  float* out = nullptr;
  cudaMalloc(&w, static_cast<size_t>(bytes));
  cudaMemset(w, 0, static_cast<size_t>(bytes));
  cudaMalloc(&out, 4);
  std::printf("%s, %d SMs, %.1f MB a pass\n", prop.name, sms, bytes / 1e6);
  for (int r : {128, 64, 32, 16}) {
    const float t4 = pass_ms<4>(w, rowbytes, rows, r, out, sms);
    const float t8 = pass_ms<8>(w, rowbytes, rows, r, out, sms);
    const float t12 = pass_ms<12>(w, rowbytes, rows, r, out, sms);
    std::printf("%3d rows x %4d B a chunk: depth 4 %.1f us %.2f TB/s, "
                "depth 8 %.1f us %.2f TB/s, depth 12 %.1f us %.2f TB/s\n",
                r, 16384 / r, t4 * 1e3, bytes / t4 / 1e9, t8 * 1e3,
                bytes / t8 / 1e9, t12 * 1e3, bytes / t12 / 1e9);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    std::printf("CUDA error: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}
