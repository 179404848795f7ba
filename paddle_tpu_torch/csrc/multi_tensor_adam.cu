// The whole Adam / AdamW update of a group of tensors as one launch.
//
// Replaces no Pallas kernel: it is the port's counterpart of the one XLA
// program into which the JAX package jits the whole update
// (paddle_tpu/optimizer/optimizer.py `_build_update` :251, `Adam._rule`
// :682, `AdamW._rule` :745). It computes JAX's update, element by element
// and in JAX's order: the clip scale on g, rounded to g's dtype; coupled
// L2 (Adam: g + c * w) or decoupled decay (AdamW: w * (1 - lr_i * c)); the
// moments; bias correction by t, epsilon outside the square root; the
// master written back and the bf16 parameter as its cast. The arithmetic
// is f32, each operation the IEEE one (__fmul_rn and friends, so that nvcc
// contracts nothing into an FMA), as JAX computes with f32 work values.
// Where JAX's work values are bf16 (bf16 parameters without masters) the
// port still computes in f32 and only stores in bf16: JAX's bf16 rule
// rounds beta2 = 0.999 to 1, and its first step divides 0 by 0. Moment1 is
// stored in its own dtype (bf16 under acc_dtype), moment2 in the work
// values' dtype, each with round-to-nearest-even.
//
// Bound: bytes. Per element, a bf16 parameter with an f32 master and f32
// moments reads g (2), master, m, v (12) and writes master, m, v (12) and
// p (2): 28 bytes, 24 with a bf16 moment1, against 3.35 TB/s. Design: a
// block takes a chunk of kChunk elements of one tensor (a table maps each
// block to its tensor) and walks it with 256 threads, 8 elements a thread
// a step in 16-byte vectors (two for f32) when every pointer of the tensor
// is 16-byte aligned, else one element at a time; the chunk's last
// elements short of 8 go one at a time. The learning rate, the step t and
// the clip scales come from a device buffer (state = [lr, t, scale...]),
// the gradients' pointers from a device column that the wrapper refreshes
// when they change: nothing the launch reads depends on the host, so the
// launch can be captured in a CUDA graph as it is.
#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace {

// One tensor of the group: 56 bytes, as the wrapper's numpy dtype lays
// them out. slot < 0 means no clip scale.
struct AdamTensor {
  int64_t p, master, m, v, numel;
  float lr_mult, coeff;
  int slot, first_block;
};

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int64_t kChunk = 16384;  // elements a block: 8 vector steps

// What every element of a block shares.
struct Consts {
  float b1, b2, omb1, omb2, eps, bc1, bc2, lr, coeff, scale;
  bool decay, coupled, clip;
};

// One element's update in f32, each operation the IEEE one (no FMA).
__device__ __forceinline__ void adam_elem(const Consts& c, float& w, float g,
                                          float& m, float& v) {
  if (c.decay) {
    if (c.coupled) {
      g = __fadd_rn(g, __fmul_rn(c.coeff, w));
    } else {
      w = __fmul_rn(w, __fsub_rn(1.f, __fmul_rn(c.lr, c.coeff)));
    }
  }
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float mhat = __fdiv_rn(m, c.bc1);
  const float vhat = __fdiv_rn(v, c.bc2);
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(c.lr, mhat),
                             __fadd_rn(__fsqrt_rn(vhat), c.eps)));
}

// 8 consecutive values as floats, and back (16-byte accesses; f32 as two)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  unpack_bf16x8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                 pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// g after the clip scale, rounded to g's own type P (exact when there is
// no clip: the scale is not applied)
template <typename P>
__device__ __forceinline__ float clipped(const Consts& c, float g) {
  return c.clip ? to_float(from_float<P>(__fmul_rn(g, c.scale))) : g;
}

// P: the parameter (and gradient) type; M: moment1's; kMaster: an f32
// master holds the work values, else the parameter does. Moment2 is
// stored in the work values' type W (f32 with a master, else P).
template <typename P, typename M, bool kMaster>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_adam_kernel(const AdamTensor* __restrict__ tensors,
                             const int64_t* __restrict__ grads,
                             const int* __restrict__ block_tensor,
                             const float* __restrict__ state, float b1,
                             float b2, float eps, int coupled) {
  using W = std::conditional_t<kMaster, float, P>;
  const int ti = block_tensor[blockIdx.x];
  const AdamTensor t = tensors[ti];
  Consts c;
  c.b1 = b1;
  c.b2 = b2;
  c.omb1 = __fsub_rn(1.f, b1);
  c.omb2 = __fsub_rn(1.f, b2);
  c.eps = eps;
  c.bc1 = __fsub_rn(1.f, powf(b1, state[1]));
  c.bc2 = __fsub_rn(1.f, powf(b2, state[1]));
  c.lr = __fmul_rn(state[0], t.lr_mult);
  c.coeff = t.coeff;
  c.decay = t.coeff != 0.f;
  c.coupled = coupled != 0;
  c.clip = t.slot >= 0;
  c.scale = c.clip ? state[2 + t.slot] : 1.f;

  P* p = reinterpret_cast<P*>(t.p);
  const P* g = reinterpret_cast<const P*>(grads[ti]);
  float* master = reinterpret_cast<float*>(t.master);
  M* m1 = reinterpret_cast<M*>(t.m);
  W* m2 = reinterpret_cast<W*>(t.v);
  const int64_t start =
      static_cast<int64_t>(blockIdx.x - t.first_block) * kChunk;
  const int64_t end =
      t.numel < start + kChunk ? t.numel : start + kChunk;

  const bool aligned =
      ((t.p | grads[ti] | t.m | t.v | (kMaster ? t.master : 0)) & 15) == 0;
  int64_t i0 = start;
  if (aligned) {
    const int64_t vec_end = start + (end - start) / kVec * kVec;
    for (int64_t i = start + threadIdx.x * kVec; i < vec_end;
         i += kThreads * kVec) {
      float w[kVec], gv[kVec], m[kVec], v[kVec];
      if constexpr (kMaster) {
        load8(master + i, w);
      } else {
        load8(p + i, w);
      }
      load8(g + i, gv);
      load8(m1 + i, m);
      load8(m2 + i, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        adam_elem(c, w[k], clipped<P>(c, gv[k]), m[k], v[k]);
      }
      if constexpr (kMaster) store8(master + i, w);
      store8(p + i, w);
      store8(m1 + i, m);
      store8(m2 + i, v);
    }
    i0 = vec_end;
  }
  for (int64_t i = i0 + threadIdx.x; i < end; i += kThreads) {
    float w = kMaster ? master[i] : to_float(p[i]);
    float m = to_float(m1[i]), v = to_float(m2[i]);
    adam_elem(c, w, clipped<P>(c, to_float(g[i])), m, v);
    if constexpr (kMaster) master[i] = w;
    p[i] = from_float<P>(w);
    m1[i] = from_float<M>(m);
    m2[i] = from_float<W>(v);
  }
}

template <typename P, typename M, bool kMaster>
cudaError_t launch(const void* tensors, const int64_t* grads,
                   const int* block_tensor, int blocks, const float* state,
                   float b1, float b2, float eps, int coupled,
                   cudaStream_t stream) {
  multi_tensor_adam_kernel<P, M, kMaster><<<blocks, kThreads, 0, stream>>>(
      static_cast<const AdamTensor*>(tensors), grads, block_tensor, state, b1,
      b2, eps, coupled);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt

// One launch over a group: p_f32 picks the parameter type (bf16 or f32),
// m_f32 moment1's, master whether f32 masters hold the work values (bf16
// parameters only); coupled selects Adam's L2 (1) or AdamW's decoupled
// decay (0) for the tensors whose coeff is not 0.
PTT_EXPORT int ptt_multi_tensor_adam(int p_f32, int m_f32, int master,
                                     const void* tensors, const int64_t* grads,
                                     const int* block_tensor, int blocks,
                                     const float* state, float b1, float b2,
                                     float eps, int coupled, void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks <= 0) return cudaSuccess;
  if (p_f32) {
    if (master) return cudaErrorInvalidValue;
    return m_f32 ? ptt::launch<float, float, false>(tensors, grads, block_tensor,
                                                     blocks, state, b1, b2, eps,
                                                     coupled, s)
                 : ptt::launch<float, bf16, false>(tensors, grads, block_tensor,
                                                    blocks, state, b1, b2, eps,
                                                    coupled, s);
  }
  if (master) {
    return m_f32 ? ptt::launch<bf16, float, true>(tensors, grads, block_tensor,
                                                   blocks, state, b1, b2, eps,
                                                   coupled, s)
                 : ptt::launch<bf16, bf16, true>(tensors, grads, block_tensor,
                                                  blocks, state, b1, b2, eps,
                                                  coupled, s);
  }
  return m_f32 ? ptt::launch<bf16, float, false>(tensors, grads, block_tensor,
                                                  blocks, state, b1, b2, eps,
                                                  coupled, s)
               : ptt::launch<bf16, bf16, false>(tensors, grads, block_tensor,
                                                 blocks, state, b1, b2, eps,
                                                 coupled, s);
}
