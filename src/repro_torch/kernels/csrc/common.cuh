// Shared helpers for the port's kernels: dtype codes and conversions.
//
// Every kernel library exports plain C functions (no PyTorch headers), which
// take device pointers and the stream as `void*`, a dtype code, and return the
// `cudaError_t` of the launch as an int (0 is success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Dtype codes shared with the Python wrappers (kernels/_build.py DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;  // the bucket codec's int8 wire only

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(signed char v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// Round to nearest even, as torch's and jnp's casts to bf16 do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// max over the block of each thread's m (m >= 0), valid in thread 0. Call it
// once per kernel: it uses a static shared array.
template <int kThreads>
__device__ __forceinline__ float block_max(float m) {
    __shared__ float warp_max[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0.f;
    if (threadIdx.x < 32) {
        m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    return m;
}

}  // namespace repro_torch

extern "C" const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
