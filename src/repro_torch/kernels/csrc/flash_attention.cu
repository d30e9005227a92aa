// Flash attention forward for Hopper (sm_90a): blocked causal or non-causal
// attention with an online softmax, over (BH, S, hd) with kv already repeated
// to the query heads.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (reached through `flash_attention_fwd`).
// On the TPU the kv blocks were the grid's sequential ("arbitrary") dimension
// and the running max, normaliser and accumulator lived in VMEM scratch across
// grid steps. Blocks on a GPU run in no order, so here one block owns one query
// tile and walks the kv tiles in a loop of its own.
//
// Bound: operations once S is in the thousands (4 * hd flops per query-key
// pair, S*(S+1)/2 pairs per head when causal), bytes at the serving prefill's
// S = 128. This first version computes in fp32 on the CUDA cores, exactly the
// TPU kernel's arithmetic (it casts q, k, v to fp32): 67 TFLOP/s is its
// ceiling, not the tensor cores' 989. wgmma and TMA are for a later version.
//
// Design: a block of kBlockQ threads, one query row per thread, holding its q
// row and its fp32 accumulator in registers. K and V tiles of kBlockK rows are
// staged in shared memory as fp32; every thread reads the same key row, so the
// reads broadcast without bank conflicts. Keys are consumed in chunks of
// kChunk: their scores, one rescale of the accumulator by exp(m_old - m_new),
// then the P.V update. Causal blocks stop at the last kv tile that touches the
// diagonal, and a thread skips the chunks wholly above its own row. Keys past
// S are masked to -1e30 and rows past S are not stored, so any S works.
// out = acc / max(l, 1e-30), as on the TPU. The head width is a template
// argument, instantiated for 64 (smollm-135m and the other configs) and 32
// (the reduced configs of the CPU tests and the launcher's --reduced).
#include "common.cuh"

namespace {

using repro_torch::from_float;
using repro_torch::to_float;

constexpr int kBlockQ = 64;   // query rows per block = threads per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax update
constexpr float kNegInf = -1e30f;

template <typename T, int kHeadDim>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int seq, int causal, float scale) {
    __shared__ __align__(16) float ks[kBlockK][kHeadDim];
    __shared__ __align__(16) float vs[kBlockK][kHeadDim];

    const int q0 = blockIdx.y * kBlockQ;
    const int row = q0 + threadIdx.x;
    const bool valid = row < seq;
    const size_t base = static_cast<size_t>(blockIdx.x) * seq * kHeadDim;

    float qr[kHeadDim];
    float acc[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
        qr[d] = valid ? to_float(q[base + static_cast<size_t>(row) * kHeadDim + d]) : 0.f;
        acc[d] = 0.f;
    }
    float m = kNegInf;
    float l = 0.f;

    // Causal: kv tiles strictly above this query tile's last row are skipped.
    const int kv_end = causal ? min(seq, q0 + kBlockQ) : seq;
    for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
        __syncthreads();  // the previous tile has been consumed by every thread
        for (int e = threadIdx.x; e < kBlockK * kHeadDim; e += kBlockQ) {
            const int r = e / kHeadDim;
            const int c = e % kHeadDim;
            const int key = k0 + r;
            float kval = 0.f, vval = 0.f;
            if (key < seq) {
                const size_t off = base + static_cast<size_t>(key) * kHeadDim + c;
                kval = to_float(k[off]);
                vval = to_float(v[off]);
            }
            ks[r][c] = kval;
            vs[r][c] = vval;
        }
        __syncthreads();

        for (int j0 = 0; j0 < kBlockK; j0 += kChunk) {
            const int first = k0 + j0;
            // Every later chunk of the tile lies further right: stop. This also
            // guarantees each chunk that runs holds at least one unmasked key.
            if (first >= seq || (causal && first > row)) break;
            // The chunk's kChunk dot products advance together, one head-dim
            // slice at a time: independent fma chains instead of one long one.
            float s[kChunk];
#pragma unroll
            for (int c = 0; c < kChunk; ++c) s[c] = 0.f;
#pragma unroll
            for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    const float4 kk = reinterpret_cast<const float4*>(ks[j0 + c])[d4];
                    s[c] = fmaf(qr[4 * d4 + 0], kk.x, s[c]);
                    s[c] = fmaf(qr[4 * d4 + 1], kk.y, s[c]);
                    s[c] = fmaf(qr[4 * d4 + 2], kk.z, s[c]);
                    s[c] = fmaf(qr[4 * d4 + 3], kk.w, s[c]);
                }
            }
            float m_chunk = kNegInf;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                const int key = first + c;
                const bool masked = key >= seq || (causal && key > row);
                s[c] = masked ? kNegInf : s[c] * scale;
                m_chunk = fmaxf(m_chunk, s[c]);
            }
            const float m_new = fmaxf(m, m_chunk);
            const float alpha = expf(m - m_new);
            l *= alpha;
#pragma unroll
            for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                const float p = expf(s[c] - m_new);
                l += p;
                const float4* vr = reinterpret_cast<const float4*>(vs[j0 + c]);
#pragma unroll
                for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
                    const float4 vv = vr[d4];
                    acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
                    acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
                    acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
                    acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
                }
            }
            m = m_new;
        }
    }

    if (valid) {
        const float denom = fmaxf(l, 1e-30f);
        T* orow = o + base + static_cast<size_t>(row) * kHeadDim;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) orow[d] = from_float<T>(acc[d] / denom);
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int seq,
                   int head_dim, int causal, float scale, cudaStream_t stream) {
    const dim3 grid(bh, (seq + kBlockQ - 1) / kBlockQ);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    T* ot = static_cast<T*>(o);
    if (head_dim == 64)
        flash_fwd_kernel<T, 64><<<grid, kBlockQ, 0, stream>>>(qt, kt, vt, ot, seq, causal, scale);
    else
        flash_fwd_kernel<T, 32><<<grid, kBlockQ, 0, stream>>>(qt, kt, vt, ot, seq, causal, scale);
    return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, seq, head_dim) contiguous, all of one dtype; head_dim 32 or 64.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                   int seq, int head_dim, int causal, float scale, int dtype,
                                   void* stream) {
    if ((head_dim != 32 && head_dim != 64) || bh <= 0 || seq <= 0 ||
        (seq + kBlockQ - 1) / kBlockQ > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case repro_torch::kFloat32:
            return static_cast<int>(
                launch<float>(q, k, v, o, bh, seq, head_dim, causal, scale, s));
        case repro_torch::kBFloat16:
            return static_cast<int>(launch<__nv_bfloat16>(q, k, v, o, bh, seq, head_dim,
                                                                   causal, scale, s));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
