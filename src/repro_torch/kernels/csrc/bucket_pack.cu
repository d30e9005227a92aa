// Bucket codec pack for Hopper (sm_90a): gathers the gradient leaves into the
// (n_buckets, bucket_elems) carrier, multiplies by `scale` (the 1/n of a mean
// reduce), zero-pads the last bucket and writes the wire dtype: fp32, bf16, or
// int8 with one symmetric scale per bucket and error feedback.
//
// Replaces the Pallas TPU kernel `_pack_kernel` in
// src/repro/kernels/bucket_codec.py (reached through `_pack_pallas` and
// `pack`). That kernel ran one grid step per bucket, in order, with one
// unrolled `pl.when` branch per bucket over a static span table. Here every
// block finds its own addresses: the codec table makes each live leaf one
// contiguous range [start[j], start[j+1]) of the flattened carrier, and the
// ranges tile [0, total) in order. A block whose elements all lie in one leaf
// (nearly every block) looks that leaf up once; elsewhere a thread finds each
// element's leaf by binary search over `start`, and past `total` it writes
// the pad's zero. The table and the leaves' pointers travel by value in the
// kernel's parameters (LeafTable, staged into shared memory by each block),
// so a launch needs no host-to-device copy and can be captured in a CUDA
// graph.
//
// Bound: bytes. fp32/bf16 wire: each leaf element is read once and each carrier
// element written once. smollm-135m (bf16 leaves, 4 MiB buckets): 269 MB read,
// 541 MB written, 0.24 ms at 3.35 TB/s. int8 wire: leaves and err read, q,
// scales and new_err written, about 1.49 GB, 0.44 ms.
//
// int8 takes two passes, since blocks on a GPU cannot carry a row maximum
// between them: pass 1 writes r = leaf * scale + err into new_err (used as
// scratch) and one partial max|r| per (bucket, chunk); pass 2 reduces its
// row's partials, forms s = max(max|r|, 1e-12) / 127, and writes
// q = clip(rint(r / s), -127, 127) and new_err = r - q * s. A maximum is exact
// in any order, so the result does not depend on the split.
//
// Bits as the JAX package's `_pack_xla` and `_quantize_rows` (run op by op):
// every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: nvcc would otherwise contract a*b+c into one FMA),
// r / s is a true division (__fdiv_rn, not a multiply by 1/s), and rintf rounds
// half to even as jnp.round does.
#include <cstdint>

#include "codec.cuh"

namespace {

using repro_torch::LeafTable;
using repro_torch::TableView;
using repro_torch::find_leaf;
using repro_torch::kMaxLeaves;
using repro_torch::single_leaf;
using repro_torch::stage_table;
using repro_torch::from_float;
using repro_torch::to_float;

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // carrier elements per block: 16 a thread

// The scaled leaf value at flat carrier position e (0 past the last leaf).
template <typename TIn>
__device__ __forceinline__ float leaf_value(const TableView& t, long long e, float scale) {
    float v = 0.f;
    if (e < t.start[t.n]) {
        const int j = find_leaf(t, e);
        v = to_float(static_cast<const TIn*>(t.ptr[j])[e - t.start[j]]);
    }
    return __fmul_rn(v, scale);
}

// fp32 / bf16 wire. grid (n_buckets, chunks per row).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
pack_cast_kernel(LeafTable table, TOut* __restrict__ out, long long cap, float scale) {
    __shared__ long long s_start[kMaxLeaves + 1];
    __shared__ void* s_ptr[kMaxLeaves];
    const TableView t = stage_table(table, s_start, s_ptr);
    const long long base = static_cast<long long>(blockIdx.x) * cap;
    const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
    const long long c1 = min(c0 + kChunk, cap);
    const int j = single_leaf(t, base + c0, base + c1);
    if (j >= 0) {
        const TIn* src = static_cast<const TIn*>(t.ptr[j]);
        const long long off = base - t.start[j];
        for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
            out[base + c] = from_float<TOut>(__fmul_rn(to_float(src[off + c]), scale));
        }
        return;
    }
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
        out[base + c] = from_float<TOut>(leaf_value<TIn>(t, base + c, scale));
    }
}

// int8 pass 1: r = leaf * scale (+ err) into r_out; one max|r| per block.
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
pack_int8_pass1(LeafTable table, const float* __restrict__ err, float* __restrict__ r_out,
                float* __restrict__ partial, long long cap, float scale) {
    __shared__ long long s_start[kMaxLeaves + 1];
    __shared__ void* s_ptr[kMaxLeaves];
    const TableView t = stage_table(table, s_start, s_ptr);
    const long long row = blockIdx.x;
    const long long base = row * cap;
    const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
    const long long c1 = min(c0 + kChunk, cap);
    const int j = single_leaf(t, base + c0, base + c1);
    const TIn* src = j >= 0 ? static_cast<const TIn*>(t.ptr[j]) : nullptr;
    const long long off = j >= 0 ? base - t.start[j] : 0;
    float m = 0.f;
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
        const long long e = base + c;
        float r = src != nullptr ? __fmul_rn(to_float(src[off + c]), scale)
                                 : leaf_value<TIn>(t, e, scale);
        if (err != nullptr) r = __fadd_rn(r, err[e]);
        r_out[e] = r;
        m = fmaxf(m, fabsf(r));
    }
    m = repro_torch::block_max<kThreads>(m);
    if (threadIdx.x == 0) partial[row * gridDim.y + blockIdx.y] = m;
}

// int8 pass 2: the row's scale, then q and the new error, in place over r.
__global__ void __launch_bounds__(kThreads)
pack_int8_pass2(const float* __restrict__ partial, float* __restrict__ r_err,
                int8_t* __restrict__ q, float* __restrict__ scales, long long cap) {
    __shared__ float s_row;
    const long long row = blockIdx.x;
    const int chunks = gridDim.y;
    float m = 0.f;
    for (int i = threadIdx.x; i < chunks; i += kThreads) m = fmaxf(m, partial[row * chunks + i]);
    m = repro_torch::block_max<kThreads>(m);
    if (threadIdx.x == 0) {
        s_row = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
        if (blockIdx.y == 0) scales[row] = s_row;
    }
    __syncthreads();
    const float s = s_row;
    const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
    const long long c1 = min(c0 + kChunk, cap);
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
        const long long e = row * cap + c;
        const float r = r_err[e];
        const float qf = fminf(fmaxf(rintf(__fdiv_rn(r, s)), -127.f), 127.f);
        q[e] = static_cast<int8_t>(qf);
        r_err[e] = __fsub_rn(r, __fmul_rn(qf, s));
    }
}

template <typename TIn>
cudaError_t launch(const LeafTable& t, int wire, void* out, const float* err, float* new_err,
                   float* scales, float* partial, long long n_buckets, long long cap,
                   float scale, cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(n_buckets),
                    static_cast<unsigned>((cap + kChunk - 1) / kChunk));
    switch (wire) {
        case repro_torch::kFloat32:
            pack_cast_kernel<TIn, float><<<grid, kThreads, 0, stream>>>(
                t, static_cast<float*>(out), cap, scale);
            break;
        case repro_torch::kBFloat16:
            pack_cast_kernel<TIn, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
                t, static_cast<__nv_bfloat16*>(out), cap, scale);
            break;
        case repro_torch::kInt8:
            pack_int8_pass1<TIn><<<grid, kThreads, 0, stream>>>(t, err, new_err, partial, cap,
                                                                scale);
            {
                const cudaError_t e = cudaGetLastError();
                if (e != cudaSuccess) return e;
            }
            pack_int8_pass2<<<grid, kThreads, 0, stream>>>(partial, new_err,
                                                           static_cast<int8_t*>(out), scales, cap);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// Chunks per carrier row: the wrapper sizes the int8 `partial` scratch with it.
extern "C" long long bucket_pack_chunks(long long cap) { return (cap + kChunk - 1) / kChunk; }

// leaf_ptrs, starts: host arrays of n_leaves pointers and n_leaves + 1 offsets
// (starts[n_leaves] = total live elements), leaves in carrier order, all of
// dtype `leaf_dtype`. out: (n_buckets, cap) of the wire dtype. int8 only: err
// (nullable), new_err (n_buckets, cap) fp32, scales (n_buckets,) fp32,
// partial (n_buckets, bucket_pack_chunks(cap)) fp32 scratch.
extern "C" int bucket_pack(const unsigned long long* leaf_ptrs, const long long* starts,
                           int n_leaves, int leaf_dtype, int wire, void* out, const void* err,
                           void* new_err, void* scales, void* partial, long long n_buckets,
                           long long cap, float scale, void* stream) {
    LeafTable t;
    if (!repro_torch::fill_table(&t, leaf_ptrs, starts, n_leaves)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n_buckets <= 0 || n_buckets > 2147483647LL || cap <= 0 ||
        (cap + kChunk - 1) / kChunk > 65535 || t.start[t.n] > n_buckets * cap) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* e = static_cast<const float*>(err);
    float* ne = static_cast<float*>(new_err);
    float* sc = static_cast<float*>(scales);
    float* pa = static_cast<float*>(partial);
    switch (leaf_dtype) {
        case repro_torch::kFloat32:
            return static_cast<int>(
                launch<float>(t, wire, out, e, ne, sc, pa, n_buckets, cap, scale, s));
        case repro_torch::kBFloat16:
            return static_cast<int>(
                launch<__nv_bfloat16>(t, wire, out, e, ne, sc, pa, n_buckets, cap, scale, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
