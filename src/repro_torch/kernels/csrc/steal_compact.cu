// Grant export of a steal round: each victim hands its granted bottom
// records to a dense staging block and advances its ring-buffer bottom.
//
// Replaces the TPU kernel `steal_compact` (src/repro/kernels/steal_compact.py,
// body `_steal_kernel`). Same function, per worker w:
//   g = min(grants[w], size[w]);
//   stolen[w, r] = buf[w, (bot[w] + r) mod C] for r < g, zeros for g <= r < GRANT_WIDTH;
//   new_bot[w] = (bot[w] + g) mod C;  new_size[w] = size[w] - g.
//
// Bound on the card: bytes. It moves at most 16 bytes in and 16 bytes out per
// (worker, rank) plus five int32 cursors per worker, about 1 MB at W=4096 —
// a fraction of a microsecond at 3.35 TB/s, so one launch is dominated by
// launch latency. Design: one thread per (worker, rank < GRANT_WIDTH), each
// reading and writing one 16-byte record with a single int4 access; the
// rank-0 thread of each worker writes the cursors. The Pallas version kept a
// block of whole rings in VMEM; here only the granted records are touched.
// Grants arrive already clamped to GRANT_WIDTH by the caller.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_runtime.h>
#include <cstddef>

#ifndef GRANT_WIDTH
#define GRANT_WIDTH 8
#endif

__device__ __forceinline__ int floor_mod(int a, int m) {
    int r = a % m;
    return r < 0 ? r + m : r;
}

__global__ void steal_compact_kernel(const int4* __restrict__ buf,
                                     const int* __restrict__ bot,
                                     const int* __restrict__ size,
                                     const int* __restrict__ grants,
                                     int4* __restrict__ stolen,
                                     int* __restrict__ new_bot,
                                     int* __restrict__ new_size,
                                     int W, int C) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= W * GRANT_WIDTH) return;
    const int w = i / GRANT_WIDTH;
    const int r = i - w * GRANT_WIDTH;
    const int b = bot[w];
    const int s = size[w];
    const int g = min(grants[w], s);
    int4 out = make_int4(0, 0, 0, 0);
    if (r < g) out = buf[(size_t)w * C + floor_mod(b + r, C)];
    stolen[i] = out;
    if (r == 0) {
        new_bot[w] = floor_mod(b + g, C);
        new_size[w] = s - g;
    }
}

extern "C" int steal_compact_grant_width() { return GRANT_WIDTH; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int steal_compact_launch(const void* buf, const void* bot,
                                    const void* size, const void* grants,
                                    void* stolen, void* new_bot,
                                    void* new_size, int W, int C,
                                    void* stream) {
    const int n = W * GRANT_WIDTH;
    if (n > 0) {
        const int threads = 256;
        const int blocks = (n + threads - 1) / threads;
        steal_compact_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int4*)buf, (const int*)bot, (const int*)size,
            (const int*)grants, (int4*)stolen, (int*)new_bot, (int*)new_size,
            W, C);
    }
    return (int)cudaGetLastError();
}
