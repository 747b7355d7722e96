// Helpers shared by every kernel library of the package: f32 <-> T
// conversion for T in {float, __nv_bfloat16}, exact GELU, the device-count
// limit, the dtype codes of the C entry points, and the error-string entry
// point each library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nodems {

// devices a library keeps per-device state for (shared-memory opt-ins)
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

}  // namespace nodems

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
#define NODEMS_F32 0
#define NODEMS_BF16 1

extern "C" const char* nodems_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
