// Helpers shared by the port's kernels: fp32 <-> storage-type conversion,
// 16-byte vector packs and the reference's LeakyReLU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace calipsync {

// Storage types the wrappers pass; the C entry points take one of these
// codes and instantiate the matching template.
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T's precision and back: the cast points of the JAX
// kernels (``.astype(dtype)`` between stages) kept in fp32 registers.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// N contiguous elements moved as one load/store (16 bytes when
// N * sizeof(T) == 16).
template <typename T, int N> struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace calipsync
