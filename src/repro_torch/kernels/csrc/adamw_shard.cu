// Fused sharded AdamW for Hopper (sm_90a): one device's (n_buckets,
// shard_elems) carrier shards of the reduced gradient g, the params p and the
// moments m and v, plus the scalars clip, lr, bc1 and bc2, give the updated
// params in the all-gather's wire dtype (fp32, bf16, or int8 with one
// symmetric scale per row) and the new fp32 moments: the ZeRO update between
// the reduce-scatter and the all-gather.
//
// Replaces the Pallas TPU kernel `_adamw_shard_kernel` in
// src/repro/kernels/bucket_codec.py (reached through `_adamw_shard_pallas` and
// `adamw_update_shard`). That kernel ran one grid step per bucket row, in
// order, with the whole row in VMEM, so its int8 row maximum was one
// in-register reduction. Here blocks of a 2-D grid (row, chunk of 4096
// columns) run in parallel and cannot share a row maximum:
//   * fp32 / bf16 wire: one pass; every element is independent.
//   * int8 wire: two passes, as the int8 pack (bucket_pack.cu) does. Pass 1
//     updates m and v, writes p_new into an fp32 scratch and one partial
//     max|p_new| per block; pass 2 reduces its row's partials, forms
//     s = max(max|p_new|, 1e-12) / 127 and writes q = clip(rint(p_new / s),
//     -127, 127). A maximum is exact in any order, so the split does not change
//     the result. One block per row (129 rows on 132 SMs) would keep one pass
//     but still could not hold a 1M-element row's p_new in registers or shared
//     memory, so it would reread or recompute it all the same.
//
// Bound: bytes. g, p, m and v are read once (16 B an element); the fp32 wire
// writes p, m and v (12 B), the int8 wire q, m and v (9 B) plus one scale a
// row. smollm-135m at world size 1, (129, 1,048,576): 3.79 GB, 1.13 ms at
// 3.35 TB/s on the fp32 wire, 3.38 GB, 1.01 ms on the int8 wire. The int8
// design adds the scratch's write and reread (8 B an element). Accesses are
// 16 bytes a thread (float4) when the rows are a multiple of 4 elements and
// every pointer is 16-byte aligned, else 4 bytes.
//
// Bits as the JAX package's `_adamw_shard_xla` (run op by op): every
// product, sum, quotient and square root is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nvcc would otherwise contract
// a*b+c into one FMA), p_new / s is a true division, and rintf rounds half to
// even as jnp.round does. 1 - b1 and 1 - b2 arrive rounded once from double,
// as JAX's weak-typed Python floats are. Zero pads (g = p = m = v = 0) stay
// zero: delta = 0 / (0 + eps) + wd * 0.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using repro_torch::block_max;

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // row elements per block: 16 a thread
constexpr int kWireFp32 = repro_torch::kFloat32;
constexpr int kWireBf16 = repro_torch::kBFloat16;
constexpr int kWireInt8 = repro_torch::kInt8;

// What the update pass writes p_new as: the bf16 wire's dtype, else fp32 (the
// fp32 wire, and the int8 wire's scratch).
template <int kWire>
using WireOut = typename std::conditional<kWire == kWireBf16, __nv_bfloat16, float>::type;

struct Consts {
    float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded once from double
};

struct Scalars {
    float clip, lr, bc1, bc2;
};

// The step's traced scalars, read from device memory (no host read, so a
// launch can be captured in a CUDA graph).
__device__ __forceinline__ Scalars load_scalars(const float* __restrict__ s) {
    return Scalars{s[0], s[1], s[2], s[3]};
}

// One element in the JAX op order; updates m and v, returns p_new.
__device__ __forceinline__ float adamw_elem(float g, float p, float& m, float& v,
                                            const Scalars& s, const Consts& c) {
    g = __fmul_rn(g, s.clip);
    m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
    v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
    const float mhat = __fdiv_rn(m, s.bc1);
    const float vhat = __fdiv_rn(v, s.bc2);
    const float delta = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), c.eps)),
                                  __fmul_rn(c.wd, p));
    return __fsub_rn(p, __fmul_rn(s.lr, delta));
}

__device__ __forceinline__ void store4(float* out, long long e, float4 x) {
    *reinterpret_cast<float4*>(out + e) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long e, float4 x) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + e);
    o[0] = __floats2bfloat162_rn(x.x, x.y);  // round to nearest even, as torch's cast
    o[1] = __floats2bfloat162_rn(x.z, x.w);
}

// The update. grid (n_buckets, chunks per row). fp32/bf16 wire: p_new cast
// into `out`. int8 wire (pass 1): p_new into the fp32 scratch `out` and one
// max|p_new| per block into `partial`.
template <int kWire, bool kVec>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const float* __restrict__ g, const float* __restrict__ p,
                    const float* __restrict__ m, const float* __restrict__ v,
                    const float* __restrict__ scalars,
                    WireOut<kWire>* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ v_out,
                    float* __restrict__ partial, long long sh, Consts c) {
    const Scalars s = load_scalars(scalars);
    const long long row = blockIdx.x;
    const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
    const long long c1 = min(c0 + kChunk, sh);
    const long long base = row * sh;
    float mx = 0.f;
    if (kVec) {  // sh % 4 == 0 and 16-byte aligned pointers
        for (long long col = c0 + 4 * threadIdx.x; col < c1; col += 4 * kThreads) {
            const long long e = base + col;
            const float4 g4 = *reinterpret_cast<const float4*>(g + e);
            const float4 p4 = *reinterpret_cast<const float4*>(p + e);
            float4 m4 = *reinterpret_cast<const float4*>(m + e);
            float4 v4 = *reinterpret_cast<const float4*>(v + e);
            float4 r;
            r.x = adamw_elem(g4.x, p4.x, m4.x, v4.x, s, c);
            r.y = adamw_elem(g4.y, p4.y, m4.y, v4.y, s, c);
            r.z = adamw_elem(g4.z, p4.z, m4.z, v4.z, s, c);
            r.w = adamw_elem(g4.w, p4.w, m4.w, v4.w, s, c);
            store4(out, e, r);
            *reinterpret_cast<float4*>(m_out + e) = m4;
            *reinterpret_cast<float4*>(v_out + e) = v4;
            if (kWire == kWireInt8) {
                mx = fmaxf(mx, fmaxf(fmaxf(fabsf(r.x), fabsf(r.y)), fmaxf(fabsf(r.z), fabsf(r.w))));
            }
        }
    } else {
        for (long long col = c0 + threadIdx.x; col < c1; col += kThreads) {
            const long long e = base + col;
            float mm = m[e], vv = v[e];
            const float r = adamw_elem(g[e], p[e], mm, vv, s, c);
            out[e] = repro_torch::from_float<WireOut<kWire>>(r);
            m_out[e] = mm;
            v_out[e] = vv;
            if (kWire == kWireInt8) mx = fmaxf(mx, fabsf(r));
        }
    }
    if (kWire == kWireInt8) {
        mx = block_max<kThreads>(mx);
        if (threadIdx.x == 0) partial[row * gridDim.y + blockIdx.y] = mx;
    }
}

// int8 pass 2: the row's scale from its partial maxima, then q from the scratch.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adamw_quantize_kernel(const float* __restrict__ partial, const float* __restrict__ p_new,
                      int8_t* __restrict__ q, float* __restrict__ scales, long long sh) {
    __shared__ float s_row;
    const long long row = blockIdx.x;
    const int chunks = gridDim.y;
    float mx = 0.f;
    for (int i = threadIdx.x; i < chunks; i += kThreads) mx = fmaxf(mx, partial[row * chunks + i]);
    mx = block_max<kThreads>(mx);
    if (threadIdx.x == 0) {
        s_row = __fdiv_rn(fmaxf(mx, 1e-12f), 127.0f);
        if (blockIdx.y == 0) scales[row] = s_row;
    }
    __syncthreads();
    const float s = s_row;
    const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
    const long long c1 = min(c0 + kChunk, sh);
    const long long base = row * sh;
    auto quant = [s](float x) {
        return static_cast<signed char>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
    };
    if (kVec) {
        for (long long col = c0 + 4 * threadIdx.x; col < c1; col += 4 * kThreads) {
            const float4 x = *reinterpret_cast<const float4*>(p_new + base + col);
            *reinterpret_cast<char4*>(q + base + col) =
                make_char4(quant(x.x), quant(x.y), quant(x.z), quant(x.w));
        }
    } else {
        for (long long col = c0 + threadIdx.x; col < c1; col += kThreads) {
            q[base + col] = quant(p_new[base + col]);
        }
    }
}

template <bool kVec>
cudaError_t launch(int wire, const float* g, const float* p, const float* m, const float* v,
                   const float* scalars, void* p_out, float* m_out, float* v_out, float* scratch,
                   float* partial, float* scales, long long nb, long long sh, const Consts& c,
                   cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>((sh + kChunk - 1) / kChunk));
    switch (wire) {
        case kWireFp32:
            adamw_update_kernel<kWireFp32, kVec><<<grid, kThreads, 0, stream>>>(
                g, p, m, v, scalars, static_cast<float*>(p_out), m_out, v_out, nullptr, sh, c);
            break;
        case kWireBf16:
            adamw_update_kernel<kWireBf16, kVec><<<grid, kThreads, 0, stream>>>(
                g, p, m, v, scalars, static_cast<__nv_bfloat16*>(p_out), m_out, v_out, nullptr,
                sh, c);
            break;
        case kWireInt8: {
            adamw_update_kernel<kWireInt8, kVec><<<grid, kThreads, 0, stream>>>(
                g, p, m, v, scalars, scratch, m_out, v_out, partial, sh, c);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return e;
            adamw_quantize_kernel<kVec><<<grid, kThreads, 0, stream>>>(
                partial, scratch, static_cast<int8_t*>(p_out), scales, sh);
            break;
        }
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

bool aligned16(const void* ptr) {
    return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// Chunks per row: the wrapper sizes the int8 `partial` scratch with it.
extern "C" long long adamw_shard_chunks(long long sh) { return (sh + kChunk - 1) / kChunk; }

// g, p, m, v, m_out, v_out: (nb, sh) contiguous fp32. scalars: 4 fp32 on the
// device, [clip, lr, bc1, bc2]. p_out: (nb, sh) of the wire dtype (0 fp32,
// 1 bf16, 2 int8). int8 only: scratch (nb, sh) fp32, partial
// (nb, adamw_shard_chunks(sh)) fp32, scales (nb,) fp32.
extern "C" int adamw_shard(const void* g, const void* p, const void* m, const void* v,
                           const void* scalars, int wire, void* p_out, void* m_out, void* v_out,
                           void* scratch, void* partial, void* scales, long long nb,
                           long long sh, float b1, float omb1, float b2, float omb2, float eps,
                           float wd, void* stream) {
    if (nb <= 0 || nb > 2147483647LL || sh <= 0 || (sh + kChunk - 1) / kChunk > 65535 ||
        g == nullptr || p == nullptr || m == nullptr || v == nullptr || scalars == nullptr ||
        p_out == nullptr || m_out == nullptr || v_out == nullptr ||
        (wire == kWireInt8 && (scratch == nullptr || partial == nullptr || scales == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Consts c{b1, omb1, b2, omb2, eps, wd};
    const float* gf = static_cast<const float*>(g);
    const float* pf = static_cast<const float*>(p);
    const float* mf = static_cast<const float*>(m);
    const float* vf = static_cast<const float*>(v);
    const float* sc = static_cast<const float*>(scalars);
    float* mo = static_cast<float*>(m_out);
    float* vo = static_cast<float*>(v_out);
    float* sr = static_cast<float*>(scratch);
    float* pa = static_cast<float*>(partial);
    float* ss = static_cast<float*>(scales);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = sh % 4 == 0 && aligned16(g) && aligned16(p) && aligned16(m) &&
                     aligned16(v) && aligned16(p_out) && aligned16(m_out) && aligned16(v_out) &&
                     aligned16(scratch);
    return static_cast<int>(
        vec ? launch<true>(wire, gf, pf, mf, vf, sc, p_out, mo, vo, sr, pa, ss, nb, sh, c, st)
            : launch<false>(wire, gf, pf, mf, vf, sc, p_out, mo, vo, sr, pa, ss, nb, sh, c, st));
}
