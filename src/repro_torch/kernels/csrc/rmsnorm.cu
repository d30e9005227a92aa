// Row-wise RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py (reached through `rmsnorm_fwd`), which normalised
// one (block_rows, D) VMEM tile per sequential grid step.
//
// Bound: bytes. Each element is read once and written once with a handful of
// flops, so the least time is (2 * R * D + D) * sizeof(T) / 3.35 TB/s.
// Design: one warp per row, 8 rows per 256-thread block, so rows run in
// parallel across the SMs instead of one tile at a time. Lanes walk the row
// with a stride of 32 (neighbouring lanes on neighbouring addresses); the loop
// bound `i < d` masks the ragged last tile, so any D works (smollm's D = 576 is
// not a power of two). The sum of squares accumulates in fp32 and is reduced
// with warp shuffles, no shared memory and no block barrier. The second pass
// re-reads the row, which the first pass left in L1.
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::to_float;

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
               int rows, int d, float eps) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + warp;
    if (row >= rows) return;  // whole warp leaves together; no barrier follows
    const T* xr = x + static_cast<size_t>(row) * d;
    T* orow = out + static_cast<size_t>(row) * d;

    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
        const float v = to_float(xr[i]);
        ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

    for (int i = lane; i < d; i += 32) {
        orow[i] = from_float<T>(to_float(xr[i]) * inv * to_float(scale[i]));
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
    const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    rmsnorm_kernel<T><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), rows, d,
        eps);
    return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous; scale: (d,), all of one dtype.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                           float eps, int dtype, void* stream) {
    if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case repro_torch::kFloat32:
            return static_cast<int>(launch<float>(x, scale, out, rows, d, eps, s));
        case repro_torch::kBFloat16:
            return static_cast<int>(launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
