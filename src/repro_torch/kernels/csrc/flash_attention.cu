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
// Bound on the card: bytes at the serving path's prefill shape, operations
// at longer sequences. At B=8, Sq=Sk=512, 14 heads, hd=64, causal it must
// move ~17 MB of q, k, v and output (~5.0 us at 3.35 TB/s) and do ~3.8
// GFLOP of QK and PV products (~3.8 us at the bf16 tensor-core rate); at
// B=1, S=2048 the products (~7.5 GFLOP) dominate. This first version does
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
// Ragged Sq and Sk are masked in the tail tiles. hd is fixed at 64; the
// wrapper refuses other head dims and groups above MAX_GROUP.
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

}  // namespace

extern "C" int flash_attention_head_dim() { return HEAD_DIM; }
extern "C" int flash_attention_max_group() { return MAX_GROUP; }

// q (BH, G, Sq, 64), k and v (BH, Sk, 64), out like q; bf16 != 0 selects
// bfloat16, else float32. Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int G,
                                      int Sq, int Sk, int causal, int window,
                                      int bf16, void* stream) {
    if (G < 1 || G > MAX_GROUP || BH > 65535) return (int)cudaErrorInvalidValue;
    if (BH > 0 && Sq > 0) {
        const float scale = 1.0f / sqrtf((float)HEAD_DIM);
        const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, BH);
        const dim3 block(G * BLOCK_Q);
        cudaStream_t st = (cudaStream_t)stream;
        if (bf16) {
            flash_attention_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
                (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                (const __nv_bfloat16*)v, (__nv_bfloat16*)out, G, Sq, Sk,
                causal, window, scale);
        } else {
            flash_attention_kernel<float><<<grid, block, 0, st>>>(
                (const float*)q, (const float*)k, (const float*)v, (float*)out,
                G, Sq, Sk, causal, window, scale);
        }
    }
    return (int)cudaGetLastError();
}
