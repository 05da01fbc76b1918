// fp32 <-> storage-type conversions shared by the port's CUDA kernels: they
// load float32 or bfloat16, compute in fp32, and store with round-to-nearest-even.
#pragma once

#include <cuda_bf16.h>

namespace mt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

}  // namespace mt
