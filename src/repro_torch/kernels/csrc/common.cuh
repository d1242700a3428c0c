// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Every kernel reads its inputs as bf16 or f32, computes in f32 and writes
// its output in the input's type.  The dtype codes match ops._DTYPES.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -2.0e30f;  // the Pallas kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// 16-byte vectors: kVec<T> elements of T per load or store (8 bf16, 4 f32).
// The pointer must be 16-byte aligned.
template <typename T> constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) out[i] = to_f32(v[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Reductions over `width` neighbouring lanes (width a power of two <= 32).
template <int width = 32>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int width = 32>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace rt
