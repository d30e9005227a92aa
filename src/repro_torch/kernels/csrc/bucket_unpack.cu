// Bucket codec unpack for Hopper (sm_90a): the reduced carrier (wire dtype)
// back to one fp32 tensor per gradient leaf, times the bucket's scale when the
// wire is int8.
//
// Replaces the Pallas TPU kernel `_unpack_kernel` in
// src/repro/kernels/bucket_codec.py (reached through `_unpack_pallas` and
// `unpack`), which ran one grid step per bucket and scattered its row through
// unrolled `pl.when` branches over a static span table. Here the grid walks
// the live part of the flattened carrier, [0, start[n)), in chunks; each
// thread finds its element's leaf by binary search over the table
// (codec.cuh; once per block when the block lies in one leaf) and writes out_j[e - start[j]] = float(carrier[e]) (x the scale
// of row e / cap when scales are given, as for int8). The pad past the last leaf is never read.
// Zero-size leaves own no range and come back as zeros from the wrapper.
//
// Bound: bytes. The carrier's live elements are read once and the fp32 leaves
// written once: smollm-135m on the fp32 wire, 538 MB + 538 MB, 0.32 ms at
// 3.35 TB/s. With scales the product is rounded on its own (__fmul_rn), as the
// JAX package's `_unpack_xla` multiplies after the cast.
#include <cstdint>

#include "codec.cuh"

namespace {

using repro_torch::LeafTable;
using repro_torch::TableView;
using repro_torch::find_leaf;
using repro_torch::kMaxLeaves;
using repro_torch::single_leaf;
using repro_torch::stage_table;
using repro_torch::to_float;

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // carrier elements per block: 16 a thread

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(LeafTable table, const TIn* __restrict__ carrier, const float* __restrict__ scales,
              long long cap) {
    __shared__ long long s_start[kMaxLeaves + 1];
    __shared__ void* s_ptr[kMaxLeaves];
    const TableView t = stage_table(table, s_start, s_ptr);
    const long long total = t.start[t.n];
    const long long e0 = static_cast<long long>(blockIdx.x) * kChunk;
    const long long e1 = min(e0 + kChunk, total);
    const int one = single_leaf(t, e0, e1);
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
        float v = to_float(carrier[e]);
        if (scales != nullptr) v = __fmul_rn(v, scales[e / cap]);
        const int j = one >= 0 ? one : find_leaf(t, e);
        static_cast<float*>(t.ptr[j])[e - t.start[j]] = v;
    }
}

template <typename TIn>
cudaError_t launch(const LeafTable& t, const void* carrier, const float* scales, long long cap,
                   cudaStream_t stream) {
    const long long blocks = (t.start[t.n] + kChunk - 1) / kChunk;
    unpack_kernel<TIn><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        t, static_cast<const TIn*>(carrier), scales, cap);
    return cudaGetLastError();
}

}  // namespace

// out_ptrs, starts: host arrays of n_leaves fp32 output pointers and
// n_leaves + 1 offsets (starts[n_leaves] = live elements), in carrier order.
// carrier: (n_buckets, cap) contiguous of `wire` dtype; scales: (n_buckets,)
// fp32 or null (null: no scaling, as for the fp32 and bf16 wires).
extern "C" int bucket_unpack(const unsigned long long* out_ptrs, const long long* starts,
                             int n_leaves, int wire, const void* carrier, const void* scales,
                             long long n_buckets, long long cap, void* stream) {
    LeafTable t;
    if (!repro_torch::fill_table(&t, out_ptrs, starts, n_leaves)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n_buckets <= 0 || cap <= 0 || t.start[t.n] > n_buckets * cap ||
        (t.start[t.n] + kChunk - 1) / kChunk > 2147483647LL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sc = static_cast<const float*>(scales);
    switch (wire) {
        case repro_torch::kFloat32:
            return static_cast<int>(launch<float>(t, carrier, sc, cap, s));
        case repro_torch::kBFloat16:
            return static_cast<int>(launch<__nv_bfloat16>(t, carrier, sc, cap, s));
        case repro_torch::kInt8:
            return static_cast<int>(launch<int8_t>(t, carrier, sc, cap, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
