// The bucket codec's leaf table, shared by bucket_pack.cu and bucket_unpack.cu.
//
// Every live gradient leaf is one contiguous range [start[j], start[j+1]) of
// the flattened (n_buckets, bucket_elems) carrier, and the ranges tile
// [0, start[n]) in order (kernels/bucket_codec.py builds them from the codec
// table's leaf offsets). The table travels by value as a kernel parameter:
// 2 KB for 128 leaves, well inside the 4 KB parameter space.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kMaxLeaves = 128;

struct LeafTable {
    void* ptr[kMaxLeaves];             // leaf j's data (const for pack, written by unpack)
    long long start[kMaxLeaves + 1];   // carrier offset of leaf j; start[n] = live elements
    int n;
};

// A block's copy of the table in shared memory: the parameters are read once
// per block, and the per-element binary search reads shared memory (every
// thread of a warp walks nearly the same path, so the reads broadcast).
struct TableView {
    const long long* start;
    void* const* ptr;
    int n;
};

__device__ __forceinline__ TableView stage_table(const LeafTable& t, long long* s_start,
                                                 void** s_ptr) {
    for (int i = threadIdx.x; i <= t.n; i += blockDim.x) s_start[i] = t.start[i];
    for (int i = threadIdx.x; i < t.n; i += blockDim.x) s_ptr[i] = t.ptr[i];
    __syncthreads();
    return TableView{s_start, s_ptr, t.n};
}

// The leaf that holds flat carrier position e, for 0 <= e < start[n]: the last
// j with start[j] <= e.
__device__ __forceinline__ int find_leaf(const TableView& t, long long e) {
    int lo = 0, hi = t.n - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.start[mid] <= e) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// The leaf that holds all of the non-empty range [e0, e1), or -1 when the
// range crosses a leaf boundary or the end of the live data. A block whose
// range lies in one leaf (nearly all of them: leaves are large and a block
// covers a few thousand elements) skips the per-element search.
__device__ __forceinline__ int single_leaf(const TableView& t, long long e0, long long e1) {
    if (e1 > t.start[t.n]) return -1;
    const int j = find_leaf(t, e0);
    return t.start[j + 1] >= e1 ? j : -1;
}

// Copy host arrays into a table; false if they do not describe ordered,
// non-empty ranges.
inline bool fill_table(LeafTable* t, const unsigned long long* ptrs, const long long* starts,
                       int n) {
    if (n <= 0 || n > kMaxLeaves || starts[0] != 0) return false;
    t->n = n;
    for (int j = 0; j < n; ++j) {
        if (starts[j + 1] <= starts[j] || ptrs[j] == 0) return false;
        t->ptr[j] = reinterpret_cast<void*>(ptrs[j]);
        t->start[j] = starts[j];
    }
    t->start[n] = starts[n];
    for (int j = n + 1; j <= kMaxLeaves; ++j) t->start[j] = starts[n];
    for (int j = n; j < kMaxLeaves; ++j) t->ptr[j] = nullptr;
    return true;
}

}  // namespace repro_torch
