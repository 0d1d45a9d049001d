// One-pass commit of a tick's staged deque pushes.
//
// Replaces the TPU kernel `deque_apply` (src/repro/kernels/deque_apply.py,
// body `_apply_kernel`). Same function, out of place: the result is the ring
// buffer `buf` (W, C, 4) with, for every worker w and lane l < n[w] taken in
// ascending order, record rec[w, l] written at ring slot slot[w, l] — so the
// last lane staged for a slot wins.
//
// Bound on the card: bytes. Out of place it reads and writes the whole ring
// buffer (2 x W*C*16 bytes, about 8 MB at W=4096, C=64) plus the live lanes
// of the push log — about 2.5 microseconds at 3.35 TB/s; integer work is a
// few compares per slot. Design: one thread per (worker, ring slot). The
// thread scans its worker's L lane slots (L = 9 on the simulator's common
// path; they sit in L1 for the 64 threads of a worker) for the LAST live
// lane naming its slot, then writes that lane's record, or copies the old
// record, with one 16-byte load and one 16-byte store. Every output slot has
// exactly one writer, so last-write-wins needs no atomics and no ordering
// between threads. The Pallas version replayed the lanes over a VMEM block
// of whole rings; writing only the touched slots in place is a later change.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_runtime.h>
#include <cstddef>

__global__ void deque_apply_kernel(const int4* __restrict__ buf,
                                   const int* __restrict__ slot,
                                   const int4* __restrict__ rec,
                                   const int* __restrict__ n,
                                   int4* __restrict__ out,
                                   int W, int C, int L) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)W * C) return;
    const int w = (int)(i / C);
    const int c = (int)(i - (long long)w * C);
    const int live = min(n[w], L);
    const int* s = slot + (size_t)w * L;
    int last = -1;
    for (int l = 0; l < live; ++l) {
        if (s[l] == c) last = l;
    }
    out[i] = last >= 0 ? rec[(size_t)w * L + last] : buf[i];
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int deque_apply_launch(const void* buf, const void* slot,
                                  const void* rec, const void* n, void* out,
                                  int W, int C, int L, void* stream) {
    const long long total = (long long)W * C;
    if (total > 0) {
        const int threads = 256;
        const long long blocks = (total + threads - 1) / threads;
        deque_apply_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            (const int4*)buf, (const int*)slot, (const int4*)rec,
            (const int*)n, (int4*)out, W, C, L);
    }
    return (int)cudaGetLastError();
}
