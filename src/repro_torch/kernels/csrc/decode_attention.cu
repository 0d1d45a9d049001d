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
// the TPU kernel, T need not be a multiple of a block. A ring (windowed)
// cache is the same call: the caller passes lengths = min(pos + 1, T), and
// softmax does not care in which slot a position lies.
//
// Bound on the card: bytes. The cache rows below lengths[b] are read once:
// at B=8, KV=2, hd=64 and lengths ~512..575 that is ~2.4 MB of bf16 K and V
// per layer (~0.7 us at 3.35 TB/s); at recurrentgemma's B=8, KV=1, hd=256
// and a full 2048-slot ring, ~16.8 MB (~5.0 us). The products are ~4 FLOP
// per byte, far below the card's ratio. With so little work per launch at
// hd 64, launch latency dominates. Design (split-K, "flash decoding"): pass
// 1 runs one block per (b*KV + kv, chunk of CHUNK cache positions); it
// stages q and the chunk's K and V rows in shared memory as fp32 (16-byte
// loads, eight bf16 values a thread), computes
// all G x CHUNK scores (thread per cache position, each thread holding the
// dot products of several query heads so that one read of a K value serves
// them all), the chunk's max and sum per query row (one warp per row,
// shuffle reductions) and the chunk's PV partial (one thread per (row, four
// dims)), and writes (m, l, acc) to scratch. Chunks past lengths[b] write
// an empty partial without touching the cache. Pass 2 runs one block of hd
// threads per (b*KV + kv, query row) that merges the partials with weights
// exp(max(m_chunk - m, -80)). Two instantiations, by head dim: hd 64 (CHUNK
// 64, 128 threads, 42 KB of shared memory) and hd 256 (CHUNK 32, 256
// threads, 84 KB, above the 48 KB static limit, so dynamic shared memory
// with the attribute raised).
// The wrapper refuses other head dims and groups above MAX_GROUP.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#define MAX_GROUP 16

namespace {

constexpr float kNegInf = -1e30f;

// (chunk of cache positions, threads of pass 1) by head dim
template <int HD> struct Shape;
template <> struct Shape<64> { static constexpr int CHUNK = 64, THREADS = 128; };
template <> struct Shape<256> { static constexpr int CHUNK = 32, THREADS = 256; };

// pass 1's shared memory in floats: q rows, K rows padded by 4 (a warp's
// float4 reads of 32 rows fall on distinct banks), V rows, p rows
template <int HD>
constexpr int smem_floats() {
    return MAX_GROUP * HD + Shape<HD>::CHUNK * (HD + 4) + Shape<HD>::CHUNK * HD +
           MAX_GROUP * Shape<HD>::CHUNK;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}
// eight consecutive elements (16-byte aligned for floats, 16 bytes of
// bf16) to fp32, as two float4s
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
}
// a bf16 is the high half of the fp32 with the same bits: the element at
// the lower address of each 32-bit word is its low half
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a, float4& b) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    a = make_float4(lo_bf16(raw.x), hi_bf16(raw.x), lo_bf16(raw.y), hi_bf16(raw.y));
    b = make_float4(lo_bf16(raw.z), hi_bf16(raw.z), lo_bf16(raw.w), hi_bf16(raw.w));
}
__device__ __forceinline__ void store8(float* p, const float4& a, const float4& b) {
    *reinterpret_cast<float4*>(p) = a;
    *reinterpret_cast<float4*>(p + 4) = b;
}
// p is rounded to v's type before the PV product
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ lengths,
                      float* __restrict__ part_acc, float* __restrict__ part_m,
                      float* __restrict__ part_l, int KV, int G, int T_len,
                      int n_chunks, float scale) {
    constexpr int CHUNK = Shape<HD>::CHUNK;
    constexpr int THREADS = Shape<HD>::THREADS;
    constexpr int KSTRIDE = HD + 4;
    constexpr int GSTEP = THREADS / CHUNK;              // query rows in parallel
    constexpr int GPT = (MAX_GROUP + GSTEP - 1) / GSTEP;  // rows per thread
    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                       // [MAX_GROUP][HD]
    float* ks = qs + MAX_GROUP * HD;        // [CHUNK][KSTRIDE]
    float* vs = ks + CHUNK * KSTRIDE;       // [CHUNK][HD]
    float* ps = vs + CHUNK * HD;            // [MAX_GROUP][CHUNK]

    const int chunk = blockIdx.x;
    const int bh = blockIdx.y;
    const int tid = threadIdx.x;
    const int t0 = chunk * CHUNK;
    const int len = min(max(lengths[bh / KV], 0), T_len);
    const size_t part = (size_t)bh * n_chunks + chunk;

    if (t0 >= len) {  // nothing visible in this chunk: an empty partial
        for (int i = tid; i < G * HD; i += THREADS) {
            part_acc[part * G * HD + i] = 0.f;
        }
        for (int g = tid; g < G; g += THREADS) {
            part_m[part * G + g] = kNegInf;
            part_l[part * G + g] = 0.f;
        }
        return;
    }
    const int n = min(CHUNK, len - t0);  // visible positions of this chunk

    // staged eight elements a thread at a time (16-byte loads of bf16)
    float4 a, b;
    for (int i = tid * 8; i < G * HD; i += THREADS * 8) {
        load8(q + (size_t)bh * G * HD + i, a, b);
        store8(qs + i, a, b);
    }
    const size_t base = ((size_t)bh * T_len + t0) * HD;
    for (int i = tid * 8; i < n * HD; i += THREADS * 8) {
        const int r = i / HD;
        const int c = i - r * HD;
        load8(kc + base + i, a, b);
        store8(ks + r * KSTRIDE + c, a, b);
        load8(vc + base + i, a, b);
        store8(vs + r * HD + c, a, b);
    }
    __syncthreads();

    // scores: thread (g0, j) takes position j for rows g0, g0 + GSTEP, ...
    {
        const int j = tid % CHUNK;
        const int g0 = tid / CHUNK;
        float dot[GPT];
#pragma unroll
        for (int u = 0; u < GPT; ++u) dot[u] = 0.f;
        for (int d = 0; d < HD; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&ks[j * KSTRIDE + d]);
#pragma unroll
            for (int u = 0; u < GPT; ++u) {
                const int g = g0 + u * GSTEP;
                if (g < G) {
                    const float4 qq = *reinterpret_cast<const float4*>(&qs[g * HD + d]);
                    dot[u] = fmaf(qq.x, kk.x, dot[u]);
                    dot[u] = fmaf(qq.y, kk.y, dot[u]);
                    dot[u] = fmaf(qq.z, kk.z, dot[u]);
                    dot[u] = fmaf(qq.w, kk.w, dot[u]);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < GPT; ++u) {
            const int g = g0 + u * GSTEP;
            if (g < G) ps[g * CHUNK + j] = j < n ? dot[u] * scale : kNegInf;
        }
    }
    __syncthreads();

    // the chunk's max and sum per row; ps becomes p rounded to v's type
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int g = warp; g < G; g += THREADS / 32) {
        float mx = kNegInf;
        for (int j = lane; j < CHUNK; j += 32) mx = fmaxf(mx, ps[g * CHUNK + j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int j = lane; j < CHUNK; j += 32) {
            const float s = ps[g * CHUNK + j];
            const float p = s > 0.5f * kNegInf ? expf(s - mx) : 0.f;
            sum += p;
            ps[g * CHUNK + j] = round_as(p, vc);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
            part_m[part * G + g] = mx;
            part_l[part * G + g] = sum;
        }
    }
    __syncthreads();

    // the chunk's PV partial, one thread per (row, four dims)
    for (int i = tid; i < G * (HD / 4); i += THREADS) {
        const int g = i / (HD / 4);
        const int d = (i - g * (HD / 4)) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < n; ++j) {
            const float p = ps[g * CHUNK + j];
            const float4 vv = *reinterpret_cast<const float4*>(&vs[j * HD + d]);
            acc.x = fmaf(p, vv.x, acc.x);
            acc.y = fmaf(p, vv.y, acc.y);
            acc.z = fmaf(p, vv.z, acc.z);
            acc.w = fmaf(p, vv.w, acc.w);
        }
        *reinterpret_cast<float4*>(&part_acc[(part * G + g) * HD + d]) = acc;
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l, T* __restrict__ out,
                      int G, int n_chunks) {
    const int g = blockIdx.x;
    const int bh = blockIdx.y;
    const int d = threadIdx.x;
    const size_t first = (size_t)bh * n_chunks;
    float m = kNegInf;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, part_m[(first + c) * G + g]);
    float acc = 0.f;
    float l = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
        const size_t p = (first + c) * G + g;
        const float w = expf(fmaxf(part_m[p] - m, -80.f));
        acc = fmaf(w, part_acc[p * HD + d], acc);
        l = fmaf(w, part_l[p], l);
    }
    store_f(out + ((size_t)bh * G + g) * HD + d, acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* part_acc, void* part_m, void* part_l, void* out, int BH,
           int KV, int G, int T_len, cudaStream_t st) {
    constexpr int CHUNK = Shape<HD>::CHUNK;
    constexpr size_t smem = smem_floats<HD>() * sizeof(float);
    static bool smem_raised = false;  // once per instantiation
    if (smem > 48 * 1024 && !smem_raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            decode_partial_kernel<T, HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_raised = true;
    }
    const int n_chunks = (T_len + CHUNK - 1) / CHUNK;
    const float scale = 1.0f / sqrtf((float)HD);
    if (n_chunks > 0) {
        decode_partial_kernel<T, HD><<<dim3(n_chunks, BH), Shape<HD>::THREADS, smem, st>>>(
            (const T*)q, (const T*)kc, (const T*)vc, (const int*)lengths,
            (float*)part_acc, (float*)part_m, (float*)part_l, KV, G, T_len,
            n_chunks, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    decode_combine_kernel<T, HD><<<dim3(G, BH), HD, 0, st>>>(
        (const float*)part_acc, (const float*)part_m, (const float*)part_l,
        (T*)out, G, n_chunks);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kc, const void* vc,
              const void* lengths, void* part_acc, void* part_m, void* part_l,
              void* out, int BH, int KV, int G, int T_len, cudaStream_t st) {
    if (hd == 64) {
        return launch<T, 64>(q, kc, vc, lengths, part_acc, part_m, part_l, out,
                             BH, KV, G, T_len, st);
    }
    return launch<T, 256>(q, kc, vc, lengths, part_acc, part_m, part_l, out, BH,
                          KV, G, T_len, st);
}

}  // namespace

// The largest group (query heads per KV head) the kernel takes at head dim
// `hd`; 0 if it was not built for that head dim.
extern "C" int decode_attention_max_group(int hd) {
    return hd == 64 || hd == 256 ? MAX_GROUP : 0;
}
// cache positions per chunk of pass 1 at head dim `hd` (0 if not built)
extern "C" int decode_attention_chunk(int hd) {
    return hd == 64 ? Shape<64>::CHUNK : hd == 256 ? Shape<256>::CHUNK : 0;
}

// q (B, KV, G, hd), caches (B, KV, T, hd), lengths (B,) int32, out like q,
// hd 64 or 256; scratch: part_acc (B*KV*n_chunks*G*hd), part_m and part_l
// (B*KV*n_chunks*G) float32 with n_chunks = ceil(T / decode_attention_chunk(hd)).
// bf16 != 0 selects bfloat16, else float32. Launches both passes on
// `stream`; returns the first CUDA error that is not 0, else 0.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* lengths,
                                       void* part_acc, void* part_m,
                                       void* part_l, void* out, int B, int KV,
                                       int G, int T_len, int hd, int bf16,
                                       void* stream) {
    const int BH = B * KV;
    if (G < 1 || G > decode_attention_max_group(hd) || BH > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    if (BH == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        return launch_hd<__nv_bfloat16>(hd, q, kc, vc, lengths, part_acc, part_m,
                                        part_l, out, BH, KV, G, T_len, st);
    }
    return launch_hd<float>(hd, q, kc, vc, lengths, part_acc, part_m, part_l,
                            out, BH, KV, G, T_len, st);
}
