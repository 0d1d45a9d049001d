// Causal or windowed grouped-query attention, forward pass, online softmax.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py,
// body `_flash_kernel`). Same function: q (B, KV, G, Sq, hd), k and v
// (B, KV, Sk, hd), float32 or bfloat16, output shaped and typed as q. Query
// and key positions both start at 0; a key is visible to a query iff
// (not causal or q_pos >= k_pos) and (window == 0 or q_pos - k_pos < window).
// Scores are scaled by hd^-0.5. Numerics follow the TPU kernel: scores and
// the running max and sum in fp32; p = 0 where a score is masked; the
// rescale factor alpha = exp(max(m_prev - m_new, -80)); p rounded to v's type
// before the PV product; output = acc / max(l, 1e-30), so a row that sees no
// key gives 0.
//
// Bound on the card: bytes at qwen2 serving's prefill shape, operations
// at longer sequences and wider heads. At B=8, Sq=Sk=512, 14 heads, hd=64,
// causal it must move ~17 MB of q, k, v and output (~5.0 us at 3.35 TB/s) and do ~3.8
// GFLOP of QK and PV products (~3.8 us at the bf16 tensor-core rate); at
// B=1, S=2048 the products (~7.5 GFLOP) dominate; at recurrentgemma's
// prefill (B=8, KV=1, G=16, hd=256, S=2560, window 2048) the products are
// ~413 GFLOP (~0.42 ms) against ~357 MB (~0.11 ms). This first version does
// its products in fp32 on the CUDA cores (67 TFLOP/s peak), so it stays
// well above either bound. Design (simple first; wgmma and TMA come later): one
// thread block per (b*KV + kv, tile of BLOCK_Q query positions) holding the
// whole group of G query heads of that KV head, one thread per (head,
// position) row, so each K/V tile is read once for all G heads, as the TPU
// kernel's block does. K and V tiles of BLOCK_K positions go through shared
// memory as fp32; each thread keeps its q row, its accumulator and its
// tile's scores in registers and runs the online softmax with fp32 FMAs
// (CUDA cores, not tensor cores). Tiles wholly outside the causal or
// window band are skipped (exact: such a tile changes neither m, l nor acc).
// Ragged Sq and Sk are masked in the tail tiles.
//
// Two instantiations, by head dim. hd 64 (qwen2) keeps the design above,
// with groups up to MAX_GROUP = 8. At hd 256 (recurrentgemma: MQA, 16 query
// heads over one KV head, a 2048-token window) a thread cannot hold a
// 256-wide q row and accumulator (512 floats), so the wide kernel splits
// each row over WIDE_LANES = 8 neighbouring threads of a warp: thread `lane`
// holds dims lane*4 + 32*c (c < 8) of q and of the accumulator, so the eight
// float4 reads of a K or V row by one row's threads fall on distinct banks;
// the QK dot product is summed over the 8 threads by three xor shuffles,
// which leave the same sum in each. Each thread holds two rows (the K and V
// values it reads serve both), a block of 256 threads holds 64 rows: the G
// query heads of one KV head times 64 / G query positions (4 at G = 16), so
// each K/V tile is read once for all G heads. K and V tiles of
// WIDE_BLOCK_K = 16 keys go through 32 KB of static shared memory as fp32.
// With a window, only the key tiles that intersect the band of the block's
// queries are visited (at S = 2560 and window 2048 the last 512 queries
// skip their first tiles). The wrapper refuses other head dims and groups
// above the instantiation's maximum (`flash_attention_max_group`).
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#define HEAD_DIM 64
#define BLOCK_Q 32
#define BLOCK_K 32
#define MAX_GROUP 8  // G * BLOCK_Q threads per block, at most 256
#define WIDE_HEAD_DIM 256
#define WIDE_LANES 8       // threads per row
#define WIDE_THREADS 256
#define WIDE_ROWS 64       // (head, query) rows per block: 2 per thread
#define WIDE_BLOCK_K 16
#define WIDE_MAX_GROUP 16  // at least 4 query positions per block

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
__global__ void __launch_bounds__(MAX_GROUP * BLOCK_Q)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int G,
                       int Sq, int Sk, int causal, int window, float scale) {
    __shared__ __align__(16) float ks[BLOCK_K][HEAD_DIM];
    __shared__ __align__(16) float vs[BLOCK_K][HEAD_DIM];

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BLOCK_Q;
    const int tid = threadIdx.x;
    const int g = tid / BLOCK_Q;
    const int qpos = q0 + tid % BLOCK_Q;
    const bool row_ok = qpos < Sq;
    const size_t row = ((size_t)bh * G + g) * Sq + (row_ok ? qpos : 0);

    float qr[HEAD_DIM];
    float acc[HEAD_DIM];
#pragma unroll
    for (int d = 0; d < HEAD_DIM; ++d) {
        qr[d] = load_f(q + row * HEAD_DIM + d);
        acc[d] = 0.f;
    }
    float m = kNegInf;
    float l = 0.f;

    // the keys this query tile can see at all
    const int q_last = min(q0 + BLOCK_Q, Sq) - 1;
    const int k_end = causal ? min(Sk, q_last + 1) : Sk;
    const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
    const int k_begin = (k_first / BLOCK_K) * BLOCK_K;
    const T* kb = k + (size_t)bh * Sk * HEAD_DIM;
    const T* vb = v + (size_t)bh * Sk * HEAD_DIM;

    for (int kt = k_begin; kt < k_end; kt += BLOCK_K) {
        __syncthreads();  // the previous tile is consumed
        for (int i = tid; i < BLOCK_K * HEAD_DIM; i += blockDim.x) {
            const int r = i / HEAD_DIM;
            const int c = i - r * HEAD_DIM;
            const int key = kt + r;
            const bool in = key < Sk;
            ks[r][c] = in ? load_f(kb + (size_t)key * HEAD_DIM + c) : 0.f;
            vs[r][c] = in ? load_f(vb + (size_t)key * HEAD_DIM + c) : 0.f;
        }
        __syncthreads();

        float s[BLOCK_K];
        float m_new = m;
#pragma unroll
        for (int j = 0; j < BLOCK_K; ++j) {
            const int key = kt + j;
            bool ok = row_ok && key < Sk;
            if (causal) ok = ok && key <= qpos;
            if (window > 0) ok = ok && qpos - key < window;
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < HEAD_DIM; d += 4) {
                const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
                dot = fmaf(qr[d], kk.x, dot);
                dot = fmaf(qr[d + 1], kk.y, dot);
                dot = fmaf(qr[d + 2], kk.z, dot);
                dot = fmaf(qr[d + 3], kk.w, dot);
            }
            s[j] = ok ? dot * scale : kNegInf;
            m_new = fmaxf(m_new, s[j]);
        }
        const float alpha = expf(fmaxf(m - m_new, -80.f));
#pragma unroll
        for (int d = 0; d < HEAD_DIM; ++d) acc[d] *= alpha;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BLOCK_K; ++j) {
            const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
            psum += p;
            const float pv = round_as(p, v);
#pragma unroll
            for (int d = 0; d < HEAD_DIM; d += 4) {
                const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
                acc[d] = fmaf(pv, vv.x, acc[d]);
                acc[d + 1] = fmaf(pv, vv.y, acc[d + 1]);
                acc[d + 2] = fmaf(pv, vv.z, acc[d + 2]);
                acc[d + 3] = fmaf(pv, vv.w, acc[d + 3]);
            }
        }
        l = l * alpha + psum;
        m = m_new;
    }

    if (row_ok) {
        const float denom = fmaxf(l, 1e-30f);
#pragma unroll
        for (int d = 0; d < HEAD_DIM; ++d) {
            store_f(out + row * HEAD_DIM + d, acc[d] / denom);
        }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(WIDE_THREADS)
flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int G, int Sq, int Sk, int causal, int window,
                            float scale) {
    constexpr int NC = HD / (WIDE_LANES * 4);             // float4s per row slice
    constexpr int DPT = NC * 4;                           // dims per thread
    constexpr int RPT = WIDE_ROWS * WIDE_LANES / WIDE_THREADS;  // rows per thread
    constexpr int ROW_STEP = WIDE_THREADS / WIDE_LANES;
    __shared__ __align__(16) float ks[WIDE_BLOCK_K][HD];
    __shared__ __align__(16) float vs[WIDE_BLOCK_K][HD];

    const int bh = blockIdx.y;
    const int BQ = WIDE_ROWS / G;  // query positions per block
    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const int lane = tid % WIDE_LANES;
    const int rg = tid / WIDE_LANES;

    float qr[RPT][DPT];
    float acc[RPT][DPT];
    float m[RPT];
    float l[RPT];
    int qpos[RPT];
    bool row_ok[RPT];
    size_t row_off[RPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
        const int row = rg + rr * ROW_STEP;
        const int g = row / BQ;
        qpos[rr] = q0 + row % BQ;
        row_ok[rr] = g < G && qpos[rr] < Sq;
        row_off[rr] = (((size_t)bh * G + (row_ok[rr] ? g : 0)) * Sq +
                       (row_ok[rr] ? qpos[rr] : 0)) * HD;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = c * WIDE_LANES * 4 + lane * 4 + e;
                qr[rr][c * 4 + e] = row_ok[rr] ? load_f(q + row_off[rr] + d) : 0.f;
                acc[rr][c * 4 + e] = 0.f;
            }
        }
        m[rr] = kNegInf;
        l[rr] = 0.f;
    }

    // the keys this block's queries can see at all
    const int q_last = min(q0 + BQ, Sq) - 1;
    const int k_end = causal ? min(Sk, q_last + 1) : Sk;
    const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
    const int k_begin = (k_first / WIDE_BLOCK_K) * WIDE_BLOCK_K;
    const T* kb = k + (size_t)bh * Sk * HD;
    const T* vb = v + (size_t)bh * Sk * HD;

    for (int kt = k_begin; kt < k_end; kt += WIDE_BLOCK_K) {
        __syncthreads();  // the previous tile is consumed
        for (int i = tid; i < WIDE_BLOCK_K * HD; i += WIDE_THREADS) {
            const int r = i / HD;
            const int c = i - r * HD;
            const int key = kt + r;
            const bool in = key < Sk;
            ks[r][c] = in ? load_f(kb + (size_t)key * HD + c) : 0.f;
            vs[r][c] = in ? load_f(vb + (size_t)key * HD + c) : 0.f;
        }
        __syncthreads();

        float s[RPT][WIDE_BLOCK_K];
#pragma unroll
        for (int j = 0; j < WIDE_BLOCK_K; ++j) {
            float d0[RPT], d1[RPT];
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) d0[rr] = d1[rr] = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 kk = *reinterpret_cast<const float4*>(
                    &ks[j][c * WIDE_LANES * 4 + lane * 4]);
#pragma unroll
                for (int rr = 0; rr < RPT; ++rr) {
                    d0[rr] = fmaf(qr[rr][c * 4], kk.x, d0[rr]);
                    d1[rr] = fmaf(qr[rr][c * 4 + 1], kk.y, d1[rr]);
                    d0[rr] = fmaf(qr[rr][c * 4 + 2], kk.z, d0[rr]);
                    d1[rr] = fmaf(qr[rr][c * 4 + 3], kk.w, d1[rr]);
                }
            }
            const int key = kt + j;
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) {
                float dot = d0[rr] + d1[rr];
#pragma unroll
                for (int o = 1; o < WIDE_LANES; o <<= 1) {
                    dot += __shfl_xor_sync(0xffffffffu, dot, o);
                }
                bool ok = row_ok[rr] && key < Sk;
                if (causal) ok = ok && key <= qpos[rr];
                if (window > 0) ok = ok && qpos[rr] - key < window;
                s[rr][j] = ok ? dot * scale : kNegInf;
            }
        }
        // online softmax per row; s becomes p rounded to v's type
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
            float m_new = m[rr];
#pragma unroll
            for (int j = 0; j < WIDE_BLOCK_K; ++j) m_new = fmaxf(m_new, s[rr][j]);
            const float alpha = expf(fmaxf(m[rr] - m_new, -80.f));
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[rr][d] *= alpha;
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < WIDE_BLOCK_K; ++j) {
                const float p = s[rr][j] > 0.5f * kNegInf ? expf(s[rr][j] - m_new) : 0.f;
                psum += p;
                s[rr][j] = round_as(p, v);
            }
            l[rr] = l[rr] * alpha + psum;
            m[rr] = m_new;
        }
#pragma unroll
        for (int j = 0; j < WIDE_BLOCK_K; ++j) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 vv = *reinterpret_cast<const float4*>(
                    &vs[j][c * WIDE_LANES * 4 + lane * 4]);
#pragma unroll
                for (int rr = 0; rr < RPT; ++rr) {
                    acc[rr][c * 4] = fmaf(s[rr][j], vv.x, acc[rr][c * 4]);
                    acc[rr][c * 4 + 1] = fmaf(s[rr][j], vv.y, acc[rr][c * 4 + 1]);
                    acc[rr][c * 4 + 2] = fmaf(s[rr][j], vv.z, acc[rr][c * 4 + 2]);
                    acc[rr][c * 4 + 3] = fmaf(s[rr][j], vv.w, acc[rr][c * 4 + 3]);
                }
            }
        }
    }

#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
        if (!row_ok[rr]) continue;
        const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = c * WIDE_LANES * 4 + lane * 4 + e;
                store_f(out + row_off[rr] + d, acc[rr][c * 4 + e] / denom);
            }
        }
    }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* out, int BH,
            int G, int Sq, int Sk, int causal, int window, int hd,
            cudaStream_t st) {
    const float scale = 1.0f / sqrtf((float)hd);
    if (hd == HEAD_DIM) {
        const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, BH);
        flash_attention_kernel<T><<<grid, G * BLOCK_Q, 0, st>>>(
            (const T*)q, (const T*)k, (const T*)v, (T*)out, G, Sq, Sk, causal,
            window, scale);
    } else {
        const int bq = WIDE_ROWS / G;
        const dim3 grid((Sq + bq - 1) / bq, BH);
        flash_attention_wide_kernel<T, WIDE_HEAD_DIM><<<grid, WIDE_THREADS, 0, st>>>(
            (const T*)q, (const T*)k, (const T*)v, (T*)out, G, Sq, Sk, causal,
            window, scale);
    }
}

}  // namespace

// The largest group (query heads per KV head) the kernel takes at head dim
// `hd`; 0 if it was not built for that head dim.
extern "C" int flash_attention_max_group(int hd) {
    return hd == HEAD_DIM ? MAX_GROUP : hd == WIDE_HEAD_DIM ? WIDE_MAX_GROUP : 0;
}

// q (BH, G, Sq, hd), k and v (BH, Sk, hd), out like q, hd 64 or 256; bf16
// != 0 selects bfloat16, else float32. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int G,
                                      int Sq, int Sk, int causal, int window,
                                      int hd, int bf16, void* stream) {
    const int max_g = flash_attention_max_group(hd);
    if (G < 1 || G > max_g || BH > 65535) return (int)cudaErrorInvalidValue;
    if (BH > 0 && Sq > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        if (bf16) {
            launch<__nv_bfloat16>(q, k, v, out, BH, G, Sq, Sk, causal, window, hd, st);
        } else {
            launch<float>(q, k, v, out, BH, G, Sq, Sk, causal, window, hd, st);
        }
    }
    return (int)cudaGetLastError();
}
