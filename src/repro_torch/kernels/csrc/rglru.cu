// RG-LRU: the real-gated linear recurrence of the Griffin / RecurrentGemma
// recurrent block, one thread per (batch, channel).
//
// Replaces the TPU kernel `rglru` (src/repro/kernels/rglru_scan.py, body
// `_rglru_kernel`). Same recurrence, elementwise across the width W and
// sequential across S:
//     log a_t = -8 softplus(lam) r_t,   a_t = exp(log a_t)
//     h_t     = a_t h_{t-1} + sqrt(max(1 - exp(2 log a_t), 1e-12)) (i_t x_t)
// x, r, i (B, S, W) float32 or bfloat16, lam (W,) float32, output h (B, S,
// W) float32. Unlike the TPU kernel, the initial state may be given (decode
// carries it from step to step; a null pointer means zeros, the TPU
// kernel's only case), the final state is written out, and any S >= 1 works
// (the TPU kernel needed S to divide into chunks).
//
// Numerics. softplus is max(lam, 0) + log1p(exp(-|lam|)), which is
// jax.nn.softplus's logaddexp(lam, 0) at every lam. The TPU kernel casts x
// and i to fp32 before it multiplies them; the reference's model and its
// oracle (`ref.rglru_ref`) multiply i * x in the inputs' type, round, and
// then go to fp32. In bf16 the two differ by one rounding. This kernel
// follows the model and the oracle: the product of two bf16 values is exact
// in fp32, and rounding it to bf16 is the product rounded once. The update
// a_t h + g_t is a product and a sum, each rounded (no fused multiply-add),
// as the plain version computes it.
//
// Bound on the card: bytes. Each step of each channel reads x, r and i once
// and writes h once, at about 0.1 FLOP per byte: at serving's prefill shape
// (B=8, S=2560, W=4096, bf16 inputs) that is 503 MB read and 336 MB written,
// ~250 us at 3.35 TB/s. At decode (S=1) it is 0.6 MB, so a launch costs its
// latency.
//
// Design (simple first): one thread per (b, w) holds h in a register for the
// whole sequence; B*W threads (32,768 at serving's shape) run independently.
// Neighbouring threads take neighbouring channels, so every load and store
// of a step is coalesced along W. The loop over S is the only sequential
// part: the loads of UNROLL steps (independent of h) are issued before their
// updates, so each thread keeps that many loads in flight; a ragged tail of
// fewer steps runs one step at a time. A chunk-parallel scan over S is later
// work.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#define THREADS 128
#define UNROLL 16

namespace {

constexpr float kRglruC = 8.0f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
// i * x in the inputs' type, then to fp32
__device__ __forceinline__ float mul_in_type(const float* a, const float* b) {
    return __fmul_rn(*a, *b);
}
__device__ __forceinline__ float mul_in_type(const __nv_bfloat16* a,
                                             const __nv_bfloat16* b) {
    const float p = __fmul_rn(__bfloat162float(*a), __bfloat162float(*b));
    return __bfloat162float(__float2bfloat16_rn(p));
}

// one step's decay a and gated input g from r, x and i at `at`
template <typename T>
__device__ __forceinline__ void gate(const T* __restrict__ x, const T* __restrict__ r,
                                     const T* __restrict__ ig, size_t at, float c,
                                     float& a, float& g) {
    const float log_a = __fmul_rn(c, load_f(r + at));
    a = expf(log_a);
    const float one_minus = __fsub_rn(1.f, expf(__fmul_rn(2.f, log_a)));
    g = __fmul_rn(mul_in_type(ig + at, x + at), __fsqrt_rn(fmaxf(one_minus, 1e-12f)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ r,
             const T* __restrict__ ig, const float* __restrict__ lam,
             const float* __restrict__ h0, float* __restrict__ out,
             float* __restrict__ h_out, int S_len, int W) {
    const int w = blockIdx.x * THREADS + threadIdx.x;
    const int b = blockIdx.y;
    if (w >= W) return;
    const float lm = lam[w];
    const float c = -kRglruC * (fmaxf(lm, 0.f) + log1pf(expf(-fabsf(lm))));
    float h = h0 ? h0[(size_t)b * W + w] : 0.f;
    const size_t base = (size_t)b * S_len * W + w;

    // whole blocks of UNROLL steps: every load issued before the updates
    int t0 = 0;
    for (; t0 + UNROLL <= S_len; t0 += UNROLL) {
        float a[UNROLL];
        float g[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            gate(x, r, ig, base + (size_t)(t0 + u) * W, c, a[u], g[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            h = __fadd_rn(__fmul_rn(a[u], h), g[u]);
            out[base + (size_t)(t0 + u) * W] = h;
        }
    }
    for (; t0 < S_len; ++t0) {  // the ragged tail, one step at a time
        float a, g;
        const size_t at = base + (size_t)t0 * W;
        gate(x, r, ig, at, c, a, g);
        h = __fadd_rn(__fmul_rn(a, h), g);
        out[at] = h;
    }
    h_out[(size_t)b * W + w] = h;
}

}  // namespace

// x, r, i (B, S, W) of one type, bf16 != 0 selecting bfloat16, else
// float32; lam (W,) float32; h0 (B, W) float32 or null for zeros; out (B,
// S, W) and h_out (B, W) float32, apart from every input. Launches one
// kernel on `stream`; returns cudaGetLastError().
extern "C" int rglru_launch(const void* x, const void* r, const void* i,
                            const void* lam, const void* h0, void* out,
                            void* h_out, int B, int S_len, int W, int bf16,
                            void* stream) {
    if (B < 0 || S_len < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const dim3 grid((W + THREADS - 1) / THREADS, B);
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        rglru_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)r,
            (const __nv_bfloat16*)i, (const float*)lam, (const float*)h0,
            (float*)out, (float*)h_out, S_len, W);
    } else {
        rglru_kernel<float><<<grid, THREADS, 0, st>>>(
            (const float*)x, (const float*)r, (const float*)i,
            (const float*)lam, (const float*)h0, (float*)out, (float*)h_out,
            S_len, W);
    }
    return (int)cudaGetLastError();
}
