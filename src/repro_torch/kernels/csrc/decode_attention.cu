// Decode attention: one query position per GQA group against a KV cache.
//
// Replaces the TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py, body `_decode_kernel`). Same
// function: q (B, KV, G, hd), caches (B, KV, T, hd), float32 or bfloat16,
// lengths (B,) int32; cache positions t >= lengths[b] are masked; scores are
// scaled by hd^-0.5; output (B, KV, G, hd) typed as q. Numerics follow the
// TPU kernel: fp32 scores and softmax statistics, p = 0 where masked, p
// rounded to v's type before the PV product against the running max, l the
// sum of the unrounded p, rescale factors clamped at exp(-80), output =
// acc / max(l, 1e-30), so lengths[b] = 0 gives 0. Unlike the TPU kernel, T
// need not be a multiple of a block. A ring (windowed) cache is the same
// call: the caller passes lengths = min(pos + 1, T), and softmax does not
// care in which slot a position lies.
//
// Bound on the card: bytes. The cache rows below lengths[b] are read once:
// at B=8, KV=2, hd=64 and lengths ~512..575 that is ~2.2 MB of bf16 K and V
// per layer (~0.7 us at 3.35 TB/s); at qwen2-moe's B=8, KV=16, hd=128, the
// same lengths, ~36 MB (~10.6 us); at recurrentgemma's B=8, KV=1, hd=256
// and a full 2048-slot ring, ~16.8 MB (~5.0 us). The products are ~4 FLOP
// per byte, far below the card's ratio, so the design aims at keeping enough
// bytes in flight on every SM and at a short tail after the last byte.
//
// bf16 design (tensor cores, one launch, `decode_attention_mma_kernel`):
// - Split over T. One block of 4 warps per (b*KV + kv, chunk of CHUNK
//   positions): CHUNK 128 at hd 64 (5 chunks of qwen2's 584-slot cache, 80
//   blocks) and at hd 128 (5 chunks of qwen2-moe's, 640 blocks of 16 KV
//   heads x 8 rows), 256 at hd 256 (8 chunks of recurrentgemma's 2048-slot
//   ring, 64 blocks of 256 KB of cache each). Chunks at or past lengths[b]
//   read no cache.
// - Each warp owns tiles of 16 positions (position t0 + (i*WARPS + w)*16 for
//   its tile i: 2 tiles at hd 64 and 128, 4 at hd 256) and keeps its own online
//   softmax over them. K and V stay bf16 in shared memory: the warp's tiles
//   stream through its own 2-slot ring by cp.async (16 bytes a lane, rows
//   past lengths[b] zero-filled), one commit group a tile, a slot refilled
//   as soon as its tile is done, so the math of tile i overlaps the loads
//   of tile i+1. Rows are padded by 16 bytes, so ldmatrix's eight 16-byte
//   rows fall on distinct banks.
// - QK^T and PV on mma.sync.m16n8k16 (bf16 in, fp32 accumulate). The G <= 16
//   query rows fill one m16 tile; rows past G are zero in shared memory and
//   their outputs are never written. K laid out [t][d] is the column-major B
//   operand of QK^T (ldmatrix), summed over hd in two independent chains;
//   V needs ldmatrix.trans for PV. The S accumulator fragments of the
//   tile's two n8 halves are, after the softmax, exactly PV's A fragment: p
//   goes to bf16 in registers and never to shared memory. The softmax's
//   exponentials are ex2.approx: an accurate expf sits on each tile's
//   serial path (max, exp, PV) and made the whole kernel measurably slower.
//   Why not wgmma: it takes 64 rows, so with G <= 16 it would waste three
//   quarters of every product.
// - The warps' partials (m, l, acc) merge in shared memory with weights
//   exp(max(m_w - m, -80)). The blocks of a (b, kv) pair then merge inside
//   a thread-block cluster of up to 16 (hd 64) or 8 (hd 128, 256) consecutive
//   chunks, one cluster a pair at the serving shapes: each block pushes its
//   partial's m and l to every block of the cluster and the acc of each
//   (row, 4 dims) element to the block whose slice holds it, by stores to
//   distributed shared memory (st.shared::cluster), into a receive area
//   outside its ring; after one cluster barrier each block merges its slice
//   with weights exp(max(m_b - m, -80)) from its own shared memory and
//   writes the output. Blocks of an active cluster past lengths[b] push an
//   empty partial. Why this and not a merge through global memory: a last
//   block (found by an atomic ticket) that reads every partial back pulls
//   them all through one SM after every other block is done, and that tail
//   outweighed the cache's whole read time at hd 256; a second launch costs
//   a launch. Why chunks of 256 and clusters of 8 at hd 256: a block holds
//   its 4 x 2 x 2 K/V tiles in 161 KB of shared memory, one block an SM,
//   and a card's GPCs cannot hold the 16 clusters of 8 such blocks that
//   chunks of 128 would need at once; the 8 clusters of chunks of 256 they
//   can. At hd 128 a block holds 84.5 KB, two an SM, and clusters of 8 stay
//   within the portable size.
// - A cache longer than a cluster (more than 2048 positions) has several
//   clusters a pair: each writes its slices to scratch (G x hd fp32 plus m
//   and l a cluster) and takes a ticket per (b, kv, slice) (atomicAdd after
//   a fence); the last cluster of a slice to arrive merges the clusters'
//   slices in cluster order (the result does not depend on which finished
//   last), writes them out and sets its ticket back to 0. The tickets
//   therefore stay zero between launches, and a captured CUDA graph may
//   replay the launch.
//
// fp32 design (CUDA cores, two passes, no serving path uses it): pass 1 runs
// one block per (b*KV + kv, chunk of 64 (hd 64) or 32 (hd 128, 256) positions),
// stages q, K and V in shared memory as fp32, computes scores, the chunk's
// max and sum and its PV partial, and writes (m, l, acc) to scratch; pass 2
// runs one block of hd threads per (b*KV + kv, query row) that merges the
// partials with weights exp(max(m_chunk - m, -80)).
//
// The wrapper refuses other head dims and groups above MAX_GROUP. Built with
// nvcc into a shared library with a plain C interface (see kernels/build.py)
// and called through ctypes from kernels/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#define MAX_GROUP 16

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------------------
// fp32: CUDA cores, two passes
// ------------------------------------------------------------------------

// (chunk of cache positions, threads of pass 1) by head dim
template <int HD> struct Shape;
template <> struct Shape<64> { static constexpr int CHUNK = 64, THREADS = 128; };
template <> struct Shape<128> { static constexpr int CHUNK = 32, THREADS = 128; };
template <> struct Shape<256> { static constexpr int CHUNK = 32, THREADS = 256; };

// pass 1's shared memory in floats: q rows, K rows padded by 4 (a warp's
// float4 reads of 32 rows fall on distinct banks), V rows, p rows
template <int HD>
constexpr int smem_floats() {
    return MAX_GROUP * HD + Shape<HD>::CHUNK * (HD + 4) + Shape<HD>::CHUNK * HD +
           MAX_GROUP * Shape<HD>::CHUNK;
}

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
decode_partial_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                      const float* __restrict__ vc, const int* __restrict__ lengths,
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

    for (int i = tid * 4; i < G * HD; i += THREADS * 4) {
        *reinterpret_cast<float4*>(qs + i) =
            *reinterpret_cast<const float4*>(q + (size_t)bh * G * HD + i);
    }
    const size_t base = ((size_t)bh * T_len + t0) * HD;
    for (int i = tid * 4; i < n * HD; i += THREADS * 4) {
        const int r = i / HD;
        const int c = i - r * HD;
        *reinterpret_cast<float4*>(ks + r * KSTRIDE + c) =
            *reinterpret_cast<const float4*>(kc + base + i);
        *reinterpret_cast<float4*>(vs + r * HD + c) =
            *reinterpret_cast<const float4*>(vc + base + i);
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

    // the chunk's max and sum per row; ps becomes p
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
            ps[g * CHUNK + j] = p;
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

template <int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l, float* __restrict__ out,
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
    out[((size_t)bh * G + g) * HD + d] = acc / fmaxf(l, 1e-30f);
}

template <int HD>
int launch_fp32(const void* q, const void* kc, const void* vc, const void* lengths,
                float* scratch, void* out, int BH, int KV, int G, int T_len,
                cudaStream_t st) {
    constexpr int CHUNK = Shape<HD>::CHUNK;
    constexpr size_t smem = smem_floats<HD>() * sizeof(float);
    static bool smem_raised = false;  // once per instantiation
    if (smem > 48 * 1024 && !smem_raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            decode_partial_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_raised = true;
    }
    const int n_chunks = (T_len + CHUNK - 1) / CHUNK;
    float* part_acc = scratch;
    float* part_m = part_acc + (size_t)BH * n_chunks * G * HD;
    float* part_l = part_m + (size_t)BH * n_chunks * G;
    if (n_chunks > 0) {
        decode_partial_kernel<HD><<<dim3(n_chunks, BH), Shape<HD>::THREADS, smem, st>>>(
            (const float*)q, (const float*)kc, (const float*)vc, (const int*)lengths,
            part_acc, part_m, part_l, KV, G, T_len, n_chunks, 1.0f / sqrtf((float)HD));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    decode_combine_kernel<HD><<<dim3(G, BH), HD, 0, st>>>(part_acc, part_m, part_l,
                                                          (float*)out, G, n_chunks);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), one launch
// ------------------------------------------------------------------------

// warps of a block, 16-position tiles of each warp, slots of each warp's
// ring, and the largest cluster (blocks whose partials merge in distributed
// shared memory), by head dim
template <int HD> struct Mma;
template <> struct Mma<64> {
    static constexpr int WARPS = 4, TILES = 2, STAGES = 2, MAX_CLUSTER = 16;
};
template <> struct Mma<128> {
    static constexpr int WARPS = 4, TILES = 2, STAGES = 2, MAX_CLUSTER = 8;
};
template <> struct Mma<256> {
    static constexpr int WARPS = 4, TILES = 4, STAGES = 2, MAX_CLUSTER = 8;
};
constexpr int kTile = 16;  // positions of a warp's tile: the k of PV's m16n8k16
constexpr int kMaxCluster = 16;  // tickets per (b, kv): one per cluster rank

template <int HD>
struct MmaLayout {
    static constexpr int WARPS = Mma<HD>::WARPS, TILES = Mma<HD>::TILES;
    static constexpr int STAGES = Mma<HD>::STAGES;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int CHUNK = WARPS * TILES * kTile;
    static constexpr int ROW = HD + 8;                  // bf16 a shared row (16 B of pad)
    static constexpr int TILE_BYTES = kTile * ROW * 2;  // one K or one V tile
    static constexpr int RING_OFF = MAX_GROUP * ROW * 2;  // after the q rows
    static constexpr int RING_END = RING_OFF + WARPS * STAGES * 2 * TILE_BYTES;
    // the warps' partials, reusing the same memory once the tiles are done:
    // acc [WARPS][16][ACC_ROW] floats (8 floats of pad: the float2 writes of
    // a half-warp fall on distinct banks), then m, l and the merge weights
    // [WARPS][16]
    static constexpr int ACC_ROW = HD + 8;
    static constexpr int MERGE_BYTES = WARPS * MAX_GROUP * (ACC_ROW + 3) * 4;
    // what the cluster's blocks push here, outside the ring (a block may
    // push before this one is done with its tiles): from each rank r, its
    // partial's m and l [MC][16] and its acc for this block's slice of the
    // (row, 4 dims) elements, [MC][per] float4s (per = ceil(G hd/4 / CL))
    static constexpr int MC = Mma<HD>::MAX_CLUSTER;
    static constexpr int RECV_OFF = RING_END;
    static constexpr int RECV_BYTES = (MAX_GROUP * HD / 4 + MC) * 16 + 2 * MC * MAX_GROUP * 4;
    static constexpr int BYTES = RECV_OFF + RECV_BYTES;
};
template <int HD>
constexpr bool layout_fits() {
    return MmaLayout<HD>::MERGE_BYTES <= MmaLayout<HD>::RING_END &&    // merge area
           Mma<HD>::STAGES <= Mma<HD>::TILES && Mma<HD>::STAGES <= 4 &&  // ring slots
           Mma<HD>::MAX_CLUSTER <= kMaxCluster;                           // tickets
}
static_assert(layout_fits<64>() && layout_fits<128>() && layout_fits<256>(),
              "decode_attention_mma_kernel layout");

// blocks of a cluster at head dim HD with n_chunks chunks of the cache
template <int HD>
int cluster_size(int n_chunks) {
    return n_chunks < Mma<HD>::MAX_CLUSTER ? (n_chunks > 0 ? n_chunks : 1)
                                           : Mma<HD>::MAX_CLUSTER;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of this block's shared `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}
// the cluster barrier, split: every thread arrives, then waits for all
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_blocks() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return (int)r;
}

// 16 bytes from global to shared; bytes past `src_bytes` (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row-major) B (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^x for x <= 0 (down to -1e30, which gives 0) as one ex2.approx on x
// log2(e): relative error ~2^-22, far below the bf16 rounding of p
__device__ __forceinline__ float exp_neg(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// four outputs of one row, rounded to bf16, as one 8-byte store
__device__ __forceinline__ void store_out4(__nv_bfloat16* dst, float4 a, float inv) {
    uint2 w;
    w.x = pack_bf16(a.x * inv, a.y * inv);
    w.y = pack_bf16(a.z * inv, a.w * inv);
    *reinterpret_cast<uint2*>(dst) = w;
}

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 acc) {
    return make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y), fmaf(w, x.z, acc.z),
                       fmaf(w, x.w, acc.w));
}

template <int HD>
__global__ void __launch_bounds__(MmaLayout<HD>::THREADS, 1)
decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ kc,
                            const __nv_bfloat16* __restrict__ vc,
                            const int* __restrict__ lengths, float* __restrict__ scratch,
                            unsigned* __restrict__ tickets, __nv_bfloat16* __restrict__ out,
                            int KV, int G, int T_len, float scale) {
    using L = MmaLayout<HD>;
    constexpr int SEGS = HD / 8;  // 16-byte segments of a row
    constexpr int Q4 = HD / 4;    // float4s of an output row
    extern __shared__ __align__(16) unsigned char smem_mma[];
    __shared__ float row_m[MAX_GROUP], row_l[MAX_GROUP], row_scale[MAX_GROUP];
    __shared__ float blk_m[MAX_GROUP], blk_l[MAX_GROUP];
    __shared__ int last;

    const int chunk = blockIdx.x;
    const int bh = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int CL = cluster_blocks();  // the cluster runs along the chunks
    const int rank = cluster_rank();
    const int n_clusters = gridDim.x / CL;
    const int per = (G * Q4 + CL - 1) / CL;  // (row, 4 dims) elements a rank merges
    const uint32_t sbase = smem_u32(smem_mma);
    float4* recv_acc = reinterpret_cast<float4*>(smem_mma + L::RECV_OFF);
    float* recv_m = reinterpret_cast<float*>(recv_acc + MAX_GROUP * Q4 + L::MC);
    float* recv_l = recv_m + L::MC * MAX_GROUP;
    // this block has started: once every block of the cluster has, they may
    // write into each other's shared memory
    cluster_arrive_relaxed();

    // q rows first (rows G..15 zero-filled): they need no length
    const __nv_bfloat16* qg = q + (size_t)bh * G * HD;
    for (int i = tid; i < MAX_GROUP * SEGS; i += L::THREADS) {
        const int r = i / SEGS, c = (i % SEGS) * 8;
        cp_async16(sbase + (r * L::ROW + c) * 2, qg + (size_t)min(r, G - 1) * HD + c,
                   r < G ? 16 : 0);
    }
    cp_async_commit();
    const int len = min(max(lengths[bh / KV], 0), T_len);
    const int n_active = (len + L::CHUNK - 1) / L::CHUNK;
    const int n_cl_active = (n_active + CL - 1) / CL;
    __nv_bfloat16* o = out + (size_t)bh * G * HD;
    if (chunk / CL >= n_cl_active) {  // the whole cluster is past lengths[b]
        if (len == 0 && chunk == 0) {  // nothing visible: the output is 0
            for (int i = tid; i < G * HD / 2; i += L::THREADS) {
                reinterpret_cast<uint32_t*>(o)[i] = 0u;
            }
        }
        cp_async_wait<0>();
        return;
    }

    // pushes this block's partial to the cluster: m and l of every row to
    // every rank, the acc of element j to the rank whose slice holds it
    auto push_rows = [&]() {
        for (int i = tid; i < CL * G; i += L::THREADS) {
            const int r = i / G, g = i % G;
            st_cluster(map_rank(smem_u32(recv_m + rank * MAX_GROUP + g), r), blk_m[g]);
            st_cluster(map_rank(smem_u32(recv_l + rank * MAX_GROUP + g), r), blk_l[g]);
        }
    };
    auto push_acc = [&](int j, float4 a) {
        const int owner = j / per;
        st_cluster4(map_rank(smem_u32(recv_acc + rank * per + (j - owner * per)), owner), a);
    };
    if (chunk >= n_active) {  // past lengths[b] in an active cluster: an empty partial
        cp_async_wait<0>();
        if (tid < G) {
            blk_m[tid] = kNegInf;
            blk_l[tid] = 0.f;
        }
        __syncthreads();
        cluster_wait();
        push_rows();
        for (int j = tid; j < G * Q4; j += L::THREADS) {
            push_acc(j, make_float4(0.f, 0.f, 0.f, 0.f));
        }
    } else {
        const int t0 = chunk * L::CHUNK;
        // this warp's tiles stream through its ring of STAGES slots, one
        // commit group a tile (an empty group past lengths[b]), rows past
        // lengths[b] zero-filled; a slot is refilled once its tile is done
        const size_t cache_base = (size_t)bh * T_len * HD;
        const uint32_t ring = sbase + L::RING_OFF + warp * L::STAGES * 2 * L::TILE_BYTES;
        auto load_tile = [&](int i) {
            const int tp = t0 + (i * L::WARPS + warp) * kTile;
            if (i < L::TILES && tp < len) {
                const uint32_t kdst = ring + (i % L::STAGES) * 2 * L::TILE_BYTES;
                for (int j = lane; j < kTile * SEGS; j += 32) {
                    const int r = j / SEGS, c = (j % SEGS) * 8;
                    const bool ok = tp + r < len;
                    const size_t src = cache_base + (size_t)(ok ? tp + r : tp) * HD + c;
                    const uint32_t off = (r * L::ROW + c) * 2;
                    cp_async16(kdst + off, kc + src, ok ? 16 : 0);
                    cp_async16(kdst + L::TILE_BYTES + off, vc + src, ok ? 16 : 0);
                }
            }
            cp_async_commit();
        };
#pragma unroll
        for (int i = 0; i < L::STAGES; ++i) load_tile(i);
        cp_async_wait<L::STAGES>();  // this thread's q rows
        __syncthreads();             // everyone's

        // per warp: online softmax over its tiles. A thread holds rows r0
        // and r0 + 8 at positions cq, cq + 1 (first n8 half) and 8 + cq,
        // 9 + cq
        const int r0 = lane / 4, cq = (lane % 4) * 2;
        const uint32_t q_addr = sbase + ((lane % 16) * L::ROW + (lane / 16) * 8) * 2;
        const uint32_t k_off =
            (((lane / 16) * 8 + lane % 8) * L::ROW + ((lane / 8) % 2) * 8) * 2;
        const uint32_t v_off =
            ((((lane / 8) % 2) * 8 + lane % 8) * L::ROW + (lane / 16) * 8) * 2;
        float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
        float acc[HD / 8][4];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        for (int i = 0; i < L::TILES; ++i) {
            cp_async_wait<L::STAGES - 1>();  // tile i has landed
            __syncwarp();
            const int tp = t0 + (i * L::WARPS + warp) * kTile;
            if (tp >= len) break;  // this and later tiles of the warp are past lengths[b]
            const uint32_t kt = ring + (i % L::STAGES) * 2 * L::TILE_BYTES;
            const uint32_t vt = kt + L::TILE_BYTES;

            // S = Q K^T over the tile's 16 positions: two n8 halves, each
            // summed over hd in two chains (even and odd k steps)
            float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
            float t0v[4] = {0.f, 0.f, 0.f, 0.f}, t1v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < HD / 16; kk += 2) {
                uint32_t a[4], b[4], a2[4], b2[4];
                ldmatrix_x4(a, q_addr + kk * 32);
                ldmatrix_x4(b, kt + k_off + kk * 32);
                ldmatrix_x4(a2, q_addr + (kk + 1) * 32);
                ldmatrix_x4(b2, kt + k_off + (kk + 1) * 32);
                mma_bf16(s0, a, b[0], b[1]);
                mma_bf16(s1, a, b[2], b[3]);
                mma_bf16(t0v, a2, b2[0], b2[1]);
                mma_bf16(t1v, a2, b2[2], b2[3]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                s0[u] += t0v[u];
                s1[u] += t1v[u];
            }
            // rows r0 (x[0..3]) and r0 + 8 (x[4..7]); masked scores are NEG_INF
            const int pos[4] = {tp + cq, tp + cq + 1, tp + 8 + cq, tp + 9 + cq};
            float x[8] = {s0[0], s0[1], s1[0], s1[1], s0[2], s0[3], s1[2], s1[3]};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                x[u] = pos[u] < len ? x[u] * scale : kNegInf;
                x[u + 4] = pos[u] < len ? x[u + 4] * scale : kNegInf;
            }
            float mx0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
            float mx1 = fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7]));
#pragma unroll
            for (int o2 = 1; o2 <= 2; o2 <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
            }
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float al0 = exp_neg(fmaxf(m0 - mn0, -80.f));
            const float al1 = exp_neg(fmaxf(m1 - mn1, -80.f));
            float p[8];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                p[u] = x[u] > 0.5f * kNegInf ? exp_neg(x[u] - mn0) : 0.f;
                p[u + 4] = x[u + 4] > 0.5f * kNegInf ? exp_neg(x[u + 4] - mn1) : 0.f;
            }
            // this thread's share of l: the unrounded p
            l0 = l0 * al0 + ((p[0] + p[1]) + (p[2] + p[3]));
            l1 = l1 * al1 + ((p[4] + p[5]) + (p[6] + p[7]));
            m0 = mn0;
            m1 = mn1;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                acc[j][0] *= al0;
                acc[j][1] *= al0;
                acc[j][2] *= al1;
                acc[j][3] *= al1;
            }
            // the S fragments are PV's A fragment: p rounded to bf16 in registers
            const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[4], p[5]),
                                    pack_bf16(p[2], p[3]), pack_bf16(p[6], p[7])};
#pragma unroll
            for (int dn = 0; dn < HD / 16; ++dn) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, vt + v_off + dn * 32);
                mma_bf16(acc[2 * dn], pa, b[0], b[1]);
                mma_bf16(acc[2 * dn + 1], pa, b[2], b[3]);
            }
            __syncwarp();  // every lane is done with the slot
            load_tile(i + L::STAGES);
        }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
            l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
        }

        // the warps' partials meet in shared memory (the tiles are done)
        __syncthreads();
        float* wacc = reinterpret_cast<float*>(smem_mma);
        float* wm = wacc + L::WARPS * MAX_GROUP * L::ACC_ROW;
        float* wl = wm + L::WARPS * MAX_GROUP;
        float* mine = wacc + warp * MAX_GROUP * L::ACC_ROW;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            const int col = j * 8 + cq;
            *reinterpret_cast<float2*>(mine + r0 * L::ACC_ROW + col) =
                make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(mine + (r0 + 8) * L::ACC_ROW + col) =
                make_float2(acc[j][2], acc[j][3]);
        }
        if (lane % 4 == 0) {
            wm[warp * MAX_GROUP + r0] = m0;
            wm[warp * MAX_GROUP + r0 + 8] = m1;
            wl[warp * MAX_GROUP + r0] = l0;
            wl[warp * MAX_GROUP + r0 + 8] = l1;
        }
        __syncthreads();

        // the block's partial: the warps merged with weights exp(max(m_w -
        // m, -80)), first per row, then one thread per (row, 4 dims)
        float* we = wl + L::WARPS * MAX_GROUP;
        if (tid < G) {
            const int g = tid;
            float m = kNegInf;
#pragma unroll
            for (int w = 0; w < L::WARPS; ++w) m = fmaxf(m, wm[w * MAX_GROUP + g]);
            float l = 0.f;
#pragma unroll
            for (int w = 0; w < L::WARPS; ++w) {
                const float e = expf(fmaxf(wm[w * MAX_GROUP + g] - m, -80.f));
                l = fmaf(e, wl[w * MAX_GROUP + g], l);
                we[w * MAX_GROUP + g] = e;
            }
            blk_m[g] = m;
            blk_l[g] = l;
        }
        __syncthreads();
        cluster_wait();
        push_rows();
        for (int j = tid; j < G * Q4; j += L::THREADS) {
            const int g = j / Q4, d = (j % Q4) * 4;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int w = 0; w < L::WARPS; ++w) {
                a = fma4(we[w * MAX_GROUP + g],
                         *reinterpret_cast<const float4*>(
                             wacc + (w * MAX_GROUP + g) * L::ACC_ROW + d), a);
            }
            push_acc(j, a);
        }
    }

    // the cluster's partial: once every block has pushed, block `rank`
    // merges its slice of the (row, 4 dims) elements from its own shared
    // memory (no block reads another's, so none waits for the others to
    // leave)
    cluster_arrive();
    cluster_wait();
    const int j0 = rank * per;
    const int j_end = min(j0 + per, G * Q4);
    const int cl = chunk / CL;
    float* part_acc = scratch + ((size_t)bh * n_clusters + cl) * G * HD;
    float* part_m = scratch + (size_t)gridDim.y * n_clusters * G * HD +
                    ((size_t)bh * n_clusters + cl) * G;
    float* part_l = part_m + (size_t)gridDim.y * n_clusters * G;
    for (int j = j0 + tid; j < j_end; j += L::THREADS) {
        const int g = j / Q4;
        float m = kNegInf;
        for (int r = 0; r < CL; ++r) m = fmaxf(m, recv_m[r * MAX_GROUP + g]);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float l = 0.f;
        for (int r = 0; r < CL; ++r) {
            const float e = expf(fmaxf(recv_m[r * MAX_GROUP + g] - m, -80.f));
            l = fmaf(e, recv_l[r * MAX_GROUP + g], l);
            a = fma4(e, recv_acc[r * per + (j - j0)], a);
        }
        if (n_cl_active == 1) {
            store_out4(o + j * 4, a, 1.f / fmaxf(l, 1e-30f));
        } else {
            reinterpret_cast<float4*>(part_acc)[j] = a;
            part_m[g] = m;  // every element of row g writes the same m and l
            part_l[g] = l;
        }
    }
    if (n_cl_active == 1) return;

    // the clusters' partials, slice by slice: a ticket per (b, kv, rank), in
    // CUTLASS's release pattern (the block's stores, a barrier, then one
    // thread's gpu-scope fence and atomic). The last block of the slice to
    // arrive merges it and sets its ticket back to 0. Here CL is L::MC (the
    // cache holds more chunks than a cluster).
    unsigned* ticket = tickets + (size_t)bh * kMaxCluster + rank;
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(ticket, 1u) == (unsigned)(n_cl_active - 1);
        if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
    const int n_el = j_end - j0;  // float4 elements of this slice
    if (n_el > 0) {
        // the slice of every cluster's partial, a group of clusters at a time
        // (what shared memory holds), with each row's max, sum and acc
        // carried over the groups online (one group at the serving shapes)
        const float* pacc0 = scratch + (size_t)bh * n_clusters * G * HD;
        const float* pm0 = scratch + (size_t)gridDim.y * n_clusters * G * HD +
                           (size_t)bh * n_clusters * G;
        const float* pl0 = pm0 + (size_t)gridDim.y * n_clusters * G;
        constexpr int ELEMS = (MAX_GROUP * Q4 / L::MC + L::THREADS - 1) / L::THREADS;
        const int group = L::BYTES / (n_el * 16 + 3 * G * 4);
        const float4* stage = reinterpret_cast<const float4*>(smem_mma);
        if (tid < G) {
            row_m[tid] = kNegInf;
            row_l[tid] = 0.f;
        }
        float4 sum[ELEMS];
#pragma unroll
        for (int u = 0; u < ELEMS; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c0 = 0; c0 < n_cl_active; c0 += group) {
            const int nc = min(group, n_cl_active - c0);
            __syncthreads();  // the previous group is consumed
            for (int i = tid; i < nc * n_el; i += L::THREADS) {
                const int c = i / n_el, e = i % n_el;
                cp_async16(sbase + i * 16, pacc0 + (size_t)(c0 + c) * G * HD + (j0 + e) * 4, 16);
            }
            cp_async_commit();
            float* sm = reinterpret_cast<float*>(smem_mma + nc * n_el * 16);
            float* sl = sm + nc * G;
            float* wt = sl + nc * G;
            for (int i = tid; i < nc * G; i += L::THREADS) {
                sm[i] = __ldcg(pm0 + c0 * G + i);
                sl[i] = __ldcg(pl0 + c0 * G + i);
            }
            cp_async_wait<0>();
            __syncthreads();
            if (tid < G) {  // row g: its new max, the rescale of what came before, the weights
                const int g = tid;
                const float m_old = row_m[g];
                float m = m_old;
                for (int c = 0; c < nc; ++c) m = fmaxf(m, sm[c * G + g]);
                const float sc = expf(fmaxf(m_old - m, -80.f));
                float l = row_l[g] * sc;
                for (int c = 0; c < nc; ++c) {
                    const float w = expf(fmaxf(sm[c * G + g] - m, -80.f));
                    wt[c * G + g] = w;
                    l = fmaf(w, sl[c * G + g], l);
                }
                row_scale[g] = sc;
                row_m[g] = m;
                row_l[g] = l;
            }
            __syncthreads();
#pragma unroll
            for (int u = 0; u < ELEMS; ++u) {
                const int e = tid + u * L::THREADS;
                if (e < n_el) {
                    const int g = (j0 + e) / Q4;
                    const float sc = row_scale[g];
                    float4 a = make_float4(sum[u].x * sc, sum[u].y * sc, sum[u].z * sc,
                                           sum[u].w * sc);
                    for (int c = 0; c < nc; ++c) a = fma4(wt[c * G + g], stage[c * n_el + e], a);
                    sum[u] = a;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < ELEMS; ++u) {
            const int e = tid + u * L::THREADS;
            if (e < n_el) {
                store_out4(o + (j0 + e) * 4, sum[u], 1.f / fmaxf(row_l[(j0 + e) / Q4], 1e-30f));
            }
        }
    }
    if (tid == 0) *ticket = 0u;  // ready for the next launch
}

template <int HD>
int launch_mma(const void* q, const void* kc, const void* vc, const void* lengths,
               float* scratch, unsigned* tickets, void* out, int BH, int KV, int G,
               int T_len, cudaStream_t st) {
    using L = MmaLayout<HD>;
    // once per device: allow more than 48 KB of dynamic shared memory and
    // clusters of more than 8 blocks
    static uint32_t ready = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 32) return (int)cudaErrorInvalidDevice;
    if (!(ready >> dev & 1u)) {
        err = cudaFuncSetAttribute(decode_attention_mma_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
        if (err != cudaSuccess) return (int)err;
        if (Mma<HD>::MAX_CLUSTER > 8) {
            err = cudaFuncSetAttribute(decode_attention_mma_kernel<HD>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return (int)err;
        }
        ready |= 1u << dev;
    }
    const int n_chunks = (T_len + L::CHUNK - 1) / L::CHUNK;
    const int CL = cluster_size<HD>(n_chunks);
    const int n_clusters = n_chunks > 0 ? (n_chunks + CL - 1) / CL : 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_clusters * CL, BH);
    cfg.blockDim = dim3(L::THREADS);
    cfg.dynamicSmemBytes = L::BYTES;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, decode_attention_mma_kernel<HD>,
                             (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc,
                             (const __nv_bfloat16*)vc, (const int*)lengths, scratch,
                             tickets, (__nv_bfloat16*)out, KV, G, T_len,
                             1.0f / sqrtf((float)HD));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// floats of scratch the bf16 kernel needs: the clusters' partials
template <int HD>
long long scratch_mma(int BH, int G, int T_len) {
    const int n_chunks = (T_len + MmaLayout<HD>::CHUNK - 1) / MmaLayout<HD>::CHUNK;
    const int CL = cluster_size<HD>(n_chunks);
    const long long n_clusters = n_chunks > 0 ? (n_chunks + CL - 1) / CL : 1;
    return (long long)BH * n_clusters * G * (HD + 2);
}

}  // namespace

// The largest group (query heads per KV head) the kernel takes at head dim
// `hd`; 0 if it was not built for that head dim.
extern "C" int decode_attention_max_group(int hd) {
    return hd == 64 || hd == 128 || hd == 256 ? MAX_GROUP : 0;
}
// cache positions per bf16 block at head dim `hd`; 0 if not built for it
extern "C" int decode_attention_chunk(int hd) {
    return hd == 64    ? MmaLayout<64>::CHUNK
           : hd == 128 ? MmaLayout<128>::CHUNK
           : hd == 256 ? MmaLayout<256>::CHUNK
                       : 0;
}
// warps of a bf16 block at head dim `hd` (each keeps its own online softmax
// over tiles of decode_attention_tile() positions); 0 if not built
extern "C" int decode_attention_warps(int hd) {
    return hd == 64 ? Mma<64>::WARPS : hd == 128 ? Mma<128>::WARPS
                                     : hd == 256 ? Mma<256>::WARPS : 0;
}
extern "C" int decode_attention_tile() { return kTile; }
// blocks of a bf16 cluster at head dim `hd` for a cache of T positions
extern "C" int decode_attention_cluster(int hd, int T_len) {
    const int chunk = decode_attention_chunk(hd);
    if (chunk == 0) return 0;
    const int n_chunks = (T_len + chunk - 1) / chunk;
    return hd == 64 ? cluster_size<64>(n_chunks) : hd == 128 ? cluster_size<128>(n_chunks)
                                                             : cluster_size<256>(n_chunks);
}
// floats of scratch a launch needs; -1 if more than an int counts
extern "C" int decode_attention_scratch_floats(int B, int KV, int G, int T_len, int hd,
                                               int bf16) {
    const int BH = B * KV;
    long long n = 0;
    if (bf16) {
        n = hd == 64    ? scratch_mma<64>(BH, G, T_len)
            : hd == 128 ? scratch_mma<128>(BH, G, T_len)
                        : scratch_mma<256>(BH, G, T_len);
    } else {
        const int chunk = hd == 64 ? Shape<64>::CHUNK : hd == 128 ? Shape<128>::CHUNK
                                                                  : Shape<256>::CHUNK;
        n = (long long)BH * ((T_len + chunk - 1) / chunk) * G * (hd + 2);
    }
    return n <= 0x7fffffffLL ? (int)n : -1;
}
// tickets a launch may use: B*KV*decode_attention_tickets_per_pair()
extern "C" int decode_attention_tickets_per_pair() { return kMaxCluster; }

// q (B, KV, G, hd), caches (B, KV, T, hd), lengths (B,) int32, out like q,
// hd 64, 128 or 256; bf16 != 0 selects bfloat16 (tensor cores, one launch),
// else float32 (CUDA cores, two launches). scratch:
// decode_attention_scratch_floats floats; tickets:
// B*KV*decode_attention_tickets_per_pair() unsigned ints, zero before the
// first launch (each bf16 launch leaves them zero). Launches on `stream`;
// returns the first CUDA error that is not 0, else 0.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* lengths,
                                       void* scratch, void* tickets, void* out,
                                       int B, int KV, int G, int T_len, int hd,
                                       int bf16, void* stream) {
    const int BH = B * KV;
    if (G < 1 || G > decode_attention_max_group(hd) || BH > 65535 || T_len < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (BH == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    float* s = (float*)scratch;
    unsigned* tk = (unsigned*)tickets;
    if (bf16) {
        return hd == 64    ? launch_mma<64>(q, kc, vc, lengths, s, tk, out, BH, KV, G, T_len, st)
               : hd == 128 ? launch_mma<128>(q, kc, vc, lengths, s, tk, out, BH, KV, G, T_len,
                                             st)
                           : launch_mma<256>(q, kc, vc, lengths, s, tk, out, BH, KV, G, T_len,
                                             st);
    }
    return hd == 64    ? launch_fp32<64>(q, kc, vc, lengths, s, out, BH, KV, G, T_len, st)
           : hd == 128 ? launch_fp32<128>(q, kc, vc, lengths, s, out, BH, KV, G, T_len, st)
                       : launch_fp32<256>(q, kc, vc, lengths, s, out, BH, KV, G, T_len, st);
}
