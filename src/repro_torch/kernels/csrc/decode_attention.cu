// Decode attention: one query position per GQA group against a KV cache.
//
// Replaces the TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py, body `_decode_kernel`). Same
// function: q (B, KV, G, hd), caches (B, KV, T, hd), float32 or bfloat16,
// lengths (B,) int32; cache positions t >= lengths[b] are masked; scores are
// scaled by hd^-0.5; output (B, KV, G, hd) typed as q. Numerics follow the
// TPU kernel: fp32 scores and softmax statistics, p = 0 where masked, p
// rounded to v's type before the PV product, rescale factors clamped at
// exp(-80), output = acc / max(l, 1e-30), so lengths[b] = 0 gives 0. Unlike
// the TPU kernel, T need not be a multiple of a block.
//
// Bound on the card: bytes. The cache rows below lengths[b] are read once:
// at B=8, KV=2, hd=64 and lengths ~512..575 that is ~2.4 MB of bf16 K and V
// per layer, ~0.7 us at 3.35 TB/s, while the products are ~2 MFLOP. With so
// little work per launch, launch latency dominates. Design (split-K, "flash
// decoding"): pass 1 runs one block of 128 threads per (b*KV + kv, chunk of
// CHUNK cache positions); it stages q and the chunk's K and V rows in shared
// memory as fp32, computes all G x CHUNK scores, the chunk's max and sum per
// query row (one warp per row, shuffle reductions) and the chunk's PV
// partial (one thread per (row, d)), and writes (m, l, acc) to scratch.
// Chunks past lengths[b] write an empty partial without touching the cache.
// Pass 2 runs one block per (b*KV + kv) that merges the partials with
// weights exp(max(m_chunk - m, -80)). hd is fixed at 64; the wrapper refuses
// other head dims and groups above MAX_GROUP.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#define HEAD_DIM 64
#define CHUNK 64
#define THREADS 128
#define MAX_GROUP 16

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}
// p is rounded to v's type before the PV product
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ lengths,
                      float* __restrict__ part_acc, float* __restrict__ part_m,
                      float* __restrict__ part_l, int KV, int G, int T_len,
                      int n_chunks, float scale) {
    __shared__ float qs[MAX_GROUP][HEAD_DIM];
    __shared__ float ks[CHUNK][HEAD_DIM + 1];  // padded: rows on distinct banks
    __shared__ float vs[CHUNK][HEAD_DIM];
    __shared__ float ps[MAX_GROUP][CHUNK];

    const int chunk = blockIdx.x;
    const int bh = blockIdx.y;
    const int tid = threadIdx.x;
    const int t0 = chunk * CHUNK;
    const int len = min(max(lengths[bh / KV], 0), T_len);
    const size_t part = (size_t)bh * n_chunks + chunk;

    if (t0 >= len) {  // nothing visible in this chunk: an empty partial
        for (int i = tid; i < G * HEAD_DIM; i += THREADS) {
            part_acc[part * G * HEAD_DIM + i] = 0.f;
        }
        for (int g = tid; g < G; g += THREADS) {
            part_m[part * G + g] = kNegInf;
            part_l[part * G + g] = 0.f;
        }
        return;
    }
    const int n = min(CHUNK, len - t0);  // visible positions of this chunk

    for (int i = tid; i < G * HEAD_DIM; i += THREADS) {
        qs[i / HEAD_DIM][i % HEAD_DIM] = load_f(q + (size_t)bh * G * HEAD_DIM + i);
    }
    const size_t base = ((size_t)bh * T_len + t0) * HEAD_DIM;
    for (int i = tid; i < n * HEAD_DIM; i += THREADS) {
        const int r = i / HEAD_DIM;
        const int c = i - r * HEAD_DIM;
        ks[r][c] = load_f(kc + base + i);
        vs[r][c] = load_f(vc + base + i);
    }
    __syncthreads();

    // scores, one (row, position) pair per thread step
    for (int i = tid; i < G * CHUNK; i += THREADS) {
        const int g = i / CHUNK;
        const int j = i - g * CHUNK;
        float s = kNegInf;
        if (j < n) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < HEAD_DIM; ++d) dot = fmaf(qs[g][d], ks[j][d], dot);
            s = dot * scale;
        }
        ps[g][j] = s;
    }
    __syncthreads();

    // the chunk's max and sum per row; ps becomes p rounded to v's type
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int g = warp; g < G; g += THREADS / 32) {
        float mx = kNegInf;
        for (int j = lane; j < CHUNK; j += 32) mx = fmaxf(mx, ps[g][j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int j = lane; j < CHUNK; j += 32) {
            const float s = ps[g][j];
            const float p = s > 0.5f * kNegInf ? expf(s - mx) : 0.f;
            sum += p;
            ps[g][j] = round_as(p, vc);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
            part_m[part * G + g] = mx;
            part_l[part * G + g] = sum;
        }
    }
    __syncthreads();

    // the chunk's PV partial, one thread per (row, d)
    const int d = tid % HEAD_DIM;
    for (int g = tid / HEAD_DIM; g < G; g += THREADS / HEAD_DIM) {
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(ps[g][j], vs[j][d], acc);
        part_acc[(part * G + g) * HEAD_DIM + d] = acc;
    }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ out, int G, int n_chunks) {
    const int bh = blockIdx.x;
    const int i = threadIdx.x;
    if (i >= G * HEAD_DIM) return;
    const int g = i / HEAD_DIM;
    const size_t first = (size_t)bh * n_chunks;
    float m = kNegInf;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, part_m[(first + c) * G + g]);
    float acc = 0.f;
    float l = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
        const size_t p = (first + c) * G + g;
        const float w = expf(fmaxf(part_m[p] - m, -80.f));
        acc = fmaf(w, part_acc[p * HEAD_DIM + i % HEAD_DIM], acc);
        l = fmaf(w, part_l[p], l);
    }
    store_f(out + (size_t)bh * G * HEAD_DIM + i, acc / fmaxf(l, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* part_acc, void* part_m, void* part_l, void* out, int BH,
           int KV, int G, int T_len, cudaStream_t st) {
    const int n_chunks = (T_len + CHUNK - 1) / CHUNK;
    const float scale = 1.0f / sqrtf((float)HEAD_DIM);
    if (n_chunks > 0) {
        decode_partial_kernel<T><<<dim3(n_chunks, BH), THREADS, 0, st>>>(
            (const T*)q, (const T*)kc, (const T*)vc, (const int*)lengths,
            (float*)part_acc, (float*)part_m, (float*)part_l, KV, G, T_len,
            n_chunks, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    decode_combine_kernel<T><<<BH, G * HEAD_DIM, 0, st>>>(
        (const float*)part_acc, (const float*)part_m, (const float*)part_l,
        (T*)out, G, n_chunks);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_head_dim() { return HEAD_DIM; }
extern "C" int decode_attention_max_group() { return MAX_GROUP; }
extern "C" int decode_attention_chunk() { return CHUNK; }

// q (B, KV, G, 64), caches (B, KV, T, 64), lengths (B,) int32, out like q;
// scratch: part_acc (B*KV*n_chunks*G*64), part_m and part_l
// (B*KV*n_chunks*G) float32 with n_chunks = ceil(T / CHUNK). bf16 != 0
// selects bfloat16, else float32. Launches both passes on `stream`; returns
// the first cudaGetLastError() that is not 0, else 0.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* lengths,
                                       void* part_acc, void* part_m,
                                       void* part_l, void* out, int B, int KV,
                                       int G, int T_len, int bf16,
                                       void* stream) {
    const int BH = B * KV;
    if (G < 1 || G > MAX_GROUP || BH > 65535) return (int)cudaErrorInvalidValue;
    if (BH == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        return launch<__nv_bfloat16>(q, kc, vc, lengths, part_acc, part_m,
                                     part_l, out, BH, KV, G, T_len, st);
    }
    return launch<float>(q, kc, vc, lengths, part_acc, part_m, part_l, out,
                         BH, KV, G, T_len, st);
}
