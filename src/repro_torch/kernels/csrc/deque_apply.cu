// One-pass commit of a tick's staged deque pushes, in place.
//
// Replaces the TPU kernel `deque_apply` (src/repro/kernels/deque_apply.py,
// body `_apply_kernel`). Same function: for every worker w and live lane
// l < n[w] taken in ascending order, record rec[w, l] lands in the ring
// buffer `buf` (W, C, 4) at slot slot[w, l], so the last lane staged for a
// slot wins; a slot outside [0, C) writes nothing (the Pallas kernel's
// `cols == slot` never hits it). Unlike the Pallas kernel, which returns a
// new buffer, this one writes into `buf`: the port's staged backend commits
// into its live ring, which saves copying the whole ring every tick.
//
// Bound on the card: bytes, counted from what the inputs need — n (W x 4
// bytes), the live lanes' slots (4 bytes each), the winning lanes' records
// read and written (2 x 16 bytes each). A tick's push log touches at most L
// slots a worker (L = 9 on the simulator's common path), so at W=4096 the
// bound is well under a microsecond and the launch floor (~1.4 us) is the
// real limit; the out-of-place first port moved the whole ring (2 x W*C*16
// bytes) instead. The integer work, a scan of at most L slots a live lane,
// is far below the card's rate.
//
// Design: one thread per (worker, lane), a worker's lanes adjacent, so the
// slot and record rows load coalesced. Lane l writes its record with one
// 16-byte store if and only if l < min(n[w], L), its slot is in range, and
// no later live lane of its worker names the same slot: the thread scans
// slot[w, l+1 .. live) — neighbouring threads read neighbouring words, from
// L1 after the first — and stops at the first match. Each slot then has at
// most one writer, so the kernel needs no atomics and no ordering between
// threads. A row with n = 0 is not written. The kernel is latency-bound: a
// thread's chain is its lane's slot and its worker's count (loaded
// together, not one after the other: a dead lane's slot shares its cache
// line with its worker's live ones), the scan, then the winner's record,
// read only once it has won, so dead and overridden lanes cost no record
// bytes. Blocks of 128 threads. TMA and the tensor cores have nothing to
// offer a scatter of 16-byte records: there is no tile to stage and no
// product to take.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda_runtime.h>
#include <cstddef>

__global__ void deque_apply_kernel(int4* __restrict__ buf,
                                   const int* __restrict__ slot,
                                   const int4* __restrict__ rec,
                                   const int* __restrict__ n,
                                   int W, int C, int L) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)W * L) return;
    const int w = (int)(i / L);
    const int l = (int)(i - (long long)w * L);
    const int c = __ldg(slot + i);
    const int live = min(__ldg(n + w), L);
    if (l >= live || c < 0 || c >= C) return;
    const int* s = slot + (size_t)w * L;
    for (int k = l + 1; k < live; ++k) {
        if (__ldg(s + k) == c) return;  // a later lane wins this slot
    }
    buf[(size_t)w * C + c] = __ldg(rec + i);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int deque_apply_launch(void* buf, const void* slot, const void* rec,
                                  const void* n, int W, int C, int L,
                                  void* stream) {
    const long long total = (long long)W * L;
    if (total > 0) {
        const int threads = 128;
        const long long blocks = (total + threads - 1) / threads;
        deque_apply_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            (int4*)buf, (const int*)slot, (const int4*)rec, (const int*)n,
            W, C, L);
    }
    return (int)cudaGetLastError();
}
