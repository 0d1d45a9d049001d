// Grant export of a steal round: each victim hands its granted bottom
// records to a dense staging block and advances its ring-buffer bottom —
// the whole victim side of the export in one launch.
//
// Replaces the TPU kernel `steal_compact` (src/repro/kernels/steal_compact.py,
// body `_steal_kernel`) together with the grant clamp of its caller
// (src/repro/core/deque.py, `export_bottom`). Per worker w, for an export
// `width` <= GRANT_WIDTH:
//   g = min(grants[w], width, size[w]);
//   stolen[w, r] = buf[w, (bot[w] + r) mod C] for r < g, zeros for g <= r < width;
//   new_bot[w] = (bot[w] + g) mod C;  new_size[w] = size[w] - g.
//
// Bound on the card: bytes. It reads three int32 cursors and the granted
// records, and writes the staging block (width x 16 bytes) and two cursors a
// worker: about 0.8 MB at W=4096, a quarter of a microsecond at 3.35 TB/s,
// so at that size the launch floor (~1.4 us) is the bound; at 73,728 rows
// (an 18-point grid) the ~9 MB staging block makes the bytes the bound.
//
// Design: an 8-thread group a worker (one thread a rank of GRANT_WIDTH).
// The group's first thread loads the worker's cursors and grant once and
// clamps the grant; __shfl_sync hands them to the other seven. Each thread
// then moves one 16-byte record (or zeros) with one int4 load and one int4
// store, so a warp writes four workers' staging rows as 512 contiguous
// bytes; the first thread writes the new cursors. (A block's first warp
// loading 32 workers' cursors coalesced into shared memory instead was
// faster at 73,728 rows but slower at 4,096, the main path's rows, where
// nearly all the launches are.) The Pallas version kept a block of whole
// rings in VMEM; here only the granted records are read.
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
                                     int W, int C, int width) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int w = (int)(i / GRANT_WIDTH);
    const int r = (int)(i % GRANT_WIDTH);
    const bool mine = w < W;
    int b = 0, s = 0, g = 0;
    if (mine && r == 0) {
        b = __ldg(bot + w);
        s = __ldg(size + w);
        g = min(min(__ldg(grants + w), width), s);
    }
    // every thread of the warp takes part (blocks are whole warps and no
    // thread has returned yet); lane 0 of each 8-lane group is its source
    b = __shfl_sync(0xffffffffu, b, 0, GRANT_WIDTH);
    s = __shfl_sync(0xffffffffu, s, 0, GRANT_WIDTH);
    g = __shfl_sync(0xffffffffu, g, 0, GRANT_WIDTH);
    if (!mine || r >= width) return;
    int4 out = make_int4(0, 0, 0, 0);
    if (r < g) out = __ldg(buf + (size_t)w * C + floor_mod(b + r, C));
    stolen[(size_t)w * width + r] = out;
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
                                    void* new_size, int W, int C, int width,
                                    void* stream) {
    const long long n = (long long)W * GRANT_WIDTH;
    if (n > 0) {
        const int threads = 256;  // whole warps: the shuffles need them
        const long long blocks = (n + threads - 1) / threads;
        steal_compact_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
            (const int4*)buf, (const int*)bot, (const int*)size,
            (const int*)grants, (int4*)stolen, (int*)new_bot, (int*)new_size,
            W, C, width);
    }
    return (int)cudaGetLastError();
}
