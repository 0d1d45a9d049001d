// WKV6: the RWKV-6 "Finch" time-mix recurrence, one (batch, head) per block.
//
// Replaces the TPU kernel `wkv6` (src/repro/kernels/rwkv6_scan.py, body
// `_wkv_kernel`). Same function, per (b, h) with a (hd_k x hd_v) state S:
//     o_t = r_t . (S + diag(u) k_t^T v_t)
//     S  <- diag(w_t) S + k_t^T v_t
// r, k, v, w (B, S, H, hd) float32, u (H, hd) float32, output (B, S, H, hd)
// float32. Unlike the TPU kernel, the initial state may be given (decode
// carries it from step to step; a null pointer means zeros, the TPU kernel's
// only case), the final state is written out, and any S >= 1 works (the TPU
// kernel needed S to divide into chunks).
//
// Bound on the card: bytes. Each step of each (b, h) reads four hd-rows and
// writes one, 20 bytes per channel, and does ~5 hd^2 FLOPs (the r.S product
// and the rank-1 update): at B=8, S=512, H=32, hd=64 that is 168 MB (50 us at
// 3.35 TB/s) against 2.7 GFLOP (40 us of fp32 CUDA-core FMAs). The recurrence
// is sequential in t, so the parallelism is B*H blocks (256 at the serving
// shape, two per SM) and the columns of the state.
//
// Design: one block of HEAD_DIM threads per (b, h); thread j keeps column j of
// the fp32 state, S[:, j], in registers for the whole sequence, so the state
// never touches memory between steps. Rows r_t, k_t, w_t, v_t are staged
// through shared memory TILE timesteps at a time (coalesced 256-byte rows at
// timestep stride H*hd, read from the (B, S, H, hd) layout as it stands); in
// the step loop every thread reads the same r, k, w, u entries (shared-memory
// broadcasts) and v_t[j], updates its column and writes o_t[j]. The r.(...)
// sum is split over four accumulators to shorten its dependency chain.
// A chunk-parallel or tensor-core form is later work.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_runtime.h>

#include <cstddef>

#define HEAD_DIM 64
#define TILE 32

namespace {

__global__ void __launch_bounds__(HEAD_DIM)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state_in,
            float* __restrict__ out, float* __restrict__ state_out, int S_len,
            int H) {
    __shared__ __align__(16) float rs[TILE][HEAD_DIM];
    __shared__ __align__(16) float ks[TILE][HEAD_DIM];
    __shared__ __align__(16) float ws[TILE][HEAD_DIM];
    __shared__ __align__(16) float vs[TILE][HEAD_DIM];
    __shared__ __align__(16) float us[HEAD_DIM];

    const int bh = blockIdx.x;  // b * H + h
    const int h = bh % H;
    const int b = bh / H;
    const int j = threadIdx.x;
    const size_t state_base = (size_t)bh * HEAD_DIM * HEAD_DIM;

    // column j of the state: S[i][j], i = 0..HEAD_DIM-1
    float st[HEAD_DIM];
#pragma unroll
    for (int i = 0; i < HEAD_DIM; ++i) {
        st[i] = state_in ? state_in[state_base + (size_t)i * HEAD_DIM + j] : 0.f;
    }
    us[j] = u[(size_t)h * HEAD_DIM + j];

    const size_t row_stride = (size_t)H * HEAD_DIM;  // one timestep
    const size_t base = ((size_t)b * S_len * H + h) * HEAD_DIM + j;

    for (int t0 = 0; t0 < S_len; t0 += TILE) {
        const int n = min(TILE, S_len - t0);
        __syncthreads();  // the previous tile is consumed
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
            const size_t at = base + (size_t)(t0 + t) * row_stride;
            rs[t][j] = r[at];
            ks[t][j] = k[at];
            ws[t][j] = w[at];
            vs[t][j] = v[at];
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            const float vj = vs[t][j];
            float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
            for (int i = 0; i < HEAD_DIM; i += 4) {
                const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][i]);
                const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][i]);
                const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][i]);
                const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
                float kv;
                kv = k4.x * vj;
                o0 = fmaf(r4.x, fmaf(u4.x, kv, st[i + 0]), o0);
                st[i + 0] = fmaf(w4.x, st[i + 0], kv);
                kv = k4.y * vj;
                o1 = fmaf(r4.y, fmaf(u4.y, kv, st[i + 1]), o1);
                st[i + 1] = fmaf(w4.y, st[i + 1], kv);
                kv = k4.z * vj;
                o2 = fmaf(r4.z, fmaf(u4.z, kv, st[i + 2]), o2);
                st[i + 2] = fmaf(w4.z, st[i + 2], kv);
                kv = k4.w * vj;
                o3 = fmaf(r4.w, fmaf(u4.w, kv, st[i + 3]), o3);
                st[i + 3] = fmaf(w4.w, st[i + 3], kv);
            }
            out[base + (size_t)(t0 + t) * row_stride] = (o0 + o1) + (o2 + o3);
        }
    }

#pragma unroll
    for (int i = 0; i < HEAD_DIM; ++i) {
        state_out[state_base + (size_t)i * HEAD_DIM + j] = st[i];
    }
}

}  // namespace

extern "C" int wkv6_head_dim() { return HEAD_DIM; }

// r, k, v, w, out (B, S, H, 64) float32; u (H, 64); state_in (B, H, 64, 64)
// float32 or null for a zero state; state_out (B, H, 64, 64) float32, apart
// from every input. Launches one kernel on `stream`; returns
// cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* state_in,
                           void* out, void* state_out, int B, int S_len, int H,
                           void* stream) {
    if (B < 0 || S_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)B * H;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return (int)cudaGetLastError();
    wkv6_kernel<<<(unsigned)blocks, HEAD_DIM, 0, (cudaStream_t)stream>>>(
        (const float*)r, (const float*)k, (const float*)v, (const float*)w,
        (const float*)u, (const float*)state_in, (float*)out,
        (float*)state_out, S_len, H);
    return (int)cudaGetLastError();
}
