// Shared helpers for the port's kernels: element-type conversion and the
// C-interface conventions (dtype codes, error return).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python: 0 = float32, 1 = bfloat16.
enum NplDtype { NPL_F32 = 0, NPL_BF16 = 1 };

__device__ __forceinline__ float npl_to_float(float v) { return v; }
__device__ __forceinline__ float npl_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float npl_to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T npl_from_float(float v);
template <>
__device__ __forceinline__ float npl_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 npl_from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
