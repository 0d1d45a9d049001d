// WKV6: the RWKV-6 "Finch" time-mix recurrence.
//
// Replaces the TPU kernel `wkv6` (src/repro/kernels/rwkv6_scan.py, body
// `_wkv_kernel`). Same function, per (b, h) with a (hd_k x hd_v) state S:
//     o_t = r_t . (S + diag(u) k_t^T v_t)
//     S  <- diag(w_t) S + k_t^T v_t
// r, k, v (B, S, H, hd) float32 or bfloat16 (one type; the TPU kernel too
// takes them as they come and casts them to fp32 inside, which is exact),
// w (B, S, H, hd) float32, u (H, hd) float32, output (B, S, H, hd) float32.
// Unlike the TPU kernel, the initial state may be given (decode carries it
// from step to step; a null pointer means zeros, the TPU kernel's only case),
// the final state is written out, and any S >= 1 works (the TPU kernel
// needed S to divide into chunks).
//
// Numerics (fp32 throughout; tests/test_torch_wkv6_tiling.py emulates both
// kernels' order on the CPU). Both take o_t as (r_t . S) + c_t v_t, with
// the bonus c_t = sum_i r_t[i] u[i] k_t[i] summed once a step over lanes.
// The sequence kernel walks each 16-step tile in quads t .. t + 3 and, with
// W_j = w_{t+j}, prefix products P_j = W_0 .. W_{j-1} (P_0 = 1), suffix
// products Q_s = W_{s+1} .. W_3 and d_{j,s} = sum_i r_{t+j} k_{t+s}
// W_{s+1} .. W_{j-1}, takes from the S before t
//     o_{t+j} = (r_{t+j} P_j) . S + sum_{s<j} d_{j,s} v_{t+s} + c_{t+j} v_{t+j}
//     S      <- P_4 S + sum_s (k_{t+s} Q_s) v_{t+s}^T
// the same function by the distributive law: nine fp32 instructions an
// element for four steps instead of twelve. No decay is ever divided by.
// The last one to three steps of a tile that ends inside a quad are taken
// one at a time, S <- fmaf(w, S, k v).
//
// Bound on the card. At B=8, S=512, H=32, hd=64 the recurrence moves 126 MB
// with bf16 r, k, v (37.6 us at 3.35 TB/s; 176 MB, 52.6 us with fp32 ones)
// and, in the quad form below, does ~2.43 GFLOP (17 FLOP a state element
// and quad plus the O(hd) terms: 36.3 us at 67 TFLOP/s): bytes bound it,
// with operations close behind. What the card actually runs is fp32 FMA-pipe instructions and
// 16-byte shared-memory loads, and on this card the two add up rather than
// overlap (the step time tracked their sum in every layout tried). So the
// design spends as few of both per state element as it can (quads: 2.25
// FP32 instructions an element-step and 9 16-byte row loads a lane-step,
// against 3 and 12 one step at a time), and keeps two warps on each
// scheduler (one warp alone issues FP32 well below one instruction a
// cycle). The recurrence is sequential in t; the parallelism is B*H (256 at
// the serving shape) times the 64 x 64 state elements.
//
// Design of the sequence kernel (`wkv6_seq_kernel`, S > 1): one block of
// five warps per (b, h), two blocks on an SM (all 256 at once on 132 SMs),
// so each scheduler holds two state warps:
// - warp 0, the producer: one lane streams r, k, v and w tiles by TMA (3-D
//   tensor maps over (H*hd, S, B), so a ragged S is zero-filled per batch
//   row) into a 3-stage ring guarded by mbarriers (full, ready, empty);
// - warps 1-4, the state: warp sw holds key rows 16 sw .. 16 sw + 15 of
//   the state, lane l value columns 2l and 2l + 1 of them: 32 fp32 values
//   a lane, in registers for the whole sequence, and no shuffles on the
//   step path (each lane's 16 rows are summed in order). A quad reads nine
//   16-row vectors as warp-uniform 16-byte shared loads and v as 8-byte
//   loads, does 288 FP32 instructions, and stores the four steps' partial
//   sums of r.S to a per-tile buffer;
// - each state warp also prepares a quad of the next tile once it has
//   finished this tile's quads (while the other warps finish theirs): it
//   reads the quad's r, k (bf16 ones converted on the way, exactly) and w,
//   sums c and d over its lanes (a butterfly whose lanes keep half their
//   values at each level, so no select is needed) and writes the rows
//   `quad_step` reads to the fp32 work tiles, each once;
// - at the end of a tile the four state warps meet at a named barrier, and
//   each adds the four warps' partial sums (in warp order), the d v terms
//   and c v for its quad of the tile's steps and sends them out by a TMA
//   store (clipped at S) while the next tile runs.
// At S = 1 (decode) there is nothing to pipeline and the bound is the state
// itself (4 MB read and 4 MB written at B=8, H=32): `wkv6_step_kernel` runs
// one block of 256 threads per (b, h), each thread 4 rows x 4 columns of the
// state in coalesced 16-byte loads and streaming 16-byte stores, the partial
// sums combined by one shuffle and then across warps (in order) through
// shared memory. The launch picks the kernel by S alone: the sequence
// kernel takes S = 1 too (its tail step covers it), but spends ~1.8 us more
// there on its set-up (mbarriers, a TMA box, the prep, two barriers). The
// macro WKV6_STEP_KERNEL=0 builds the library without the step kernel, so
// that chip_smoke.py can time the sequence kernel at S = 1 beside it.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py. The
// tensor maps are encoded through libcuda's cuTensorMapEncodeTiled, reached
// by cudaGetDriverEntryPointByVersion, so no libcuda link is needed.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#define HEAD_DIM 64
#ifndef WKV6_STEP_KERNEL
#define WKV6_STEP_KERNEL 1
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSteps = 16;       // steps of a tile (4 quads)
constexpr int kStages = 3;       // input ring stages
constexpr int kOutStages = 2;    // output tiles of each state warp
constexpr int kStateWarps = 4;   // a head's: one on each scheduler, 16 key rows each
constexpr int kWarpRows = HEAD_DIM / kStateWarps;
constexpr int kSeqThreads = 32 * (1 + kStateWarps);   // producer, state warps
constexpr int kTile = kSteps * HEAD_DIM;              // elements of one row tile
constexpr int kShare = kSteps / kStateWarps;          // steps a state warp prepares
constexpr int kStepThreads = 256;

static_assert(HEAD_DIM == 64 && kShare == 4, "lanes own 2 columns; a warp preps a quad");

template <typename T>
struct Layout {
    static constexpr uint32_t F32_TILE = kTile * 4;
    // r, k, v, w as fp32 tiles, then c (kSteps floats) and d (8 floats a
    // quad), rounded up to 128 B
    static constexpr uint32_t WORK = (4 * F32_TILE + kSteps * 12 + 127) / 128 * 128;
    // bf16 r, k, v as TMA lands them (none for fp32: TMA writes the work tiles)
    static constexpr uint32_t STAGING = sizeof(T) == 2 ? 3 * kTile * 2 : 0;
    static constexpr uint32_t SLOT = WORK + STAGING;  // one stage
    static constexpr uint32_t TX = 3 * kTile * sizeof(T) + F32_TILE;  // bytes a tile
    // each state warp's partial sums of r.S for a tile, double-buffered
    static constexpr uint32_t PART = kStateWarps * kTile * 4;
    static constexpr uint32_t PART_OFF = kStages * SLOT;
    static constexpr uint32_t OUT_TILE = kShare * HEAD_DIM * 4;  // kShare steps a warp
    static constexpr uint32_t OUT_OFF = PART_OFF + 2 * PART;
    static constexpr uint32_t BAR_OFF = OUT_OFF + kStateWarps * kOutStages * OUT_TILE;
    // full, ready and empty per stage
    static constexpr uint32_t BYTES = BAR_OFF + 8 * 3 * kStages;
    static constexpr uint32_t DYN_BYTES = BYTES + 128;  // room to align the base
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}
// returns once the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    while (!mbar_try_wait(bar, parity)) {
    }
}

// TMA: the box at (c0, c1, c2) of `map` into shared memory at `dst`; its
// bytes count against the transaction count of barrier `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
           "r"(bar)
        : "memory");
}
// TMA: shared memory at `src` into the box at (c0, c1, c2) of `map`; the
// parts of the box outside the tensor are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// makes this thread's writes to shared memory visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// two bf16 in one word (element 0 in the low half) as fp32, exactly
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t x) {
    return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

__device__ __forceinline__ float comp(const float4& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// the bonus lane l contributes for rows 2l and 2l + 1: (r u) k, then
// fmaf(r u, k, .) for the second row; summed over the warp by a butterfly
__device__ __forceinline__ float bonus_part(float2 r2, float2 k2, float u0, float u1) {
    return fmaf(__fmul_rn(r2.y, u1), k2.y, __fmul_rn(__fmul_rn(r2.x, u0), k2.x));
}
__device__ __forceinline__ float butterfly_sum(float p) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) p = __fadd_rn(p, __shfl_xor_sync(kFull, p, m));
    return p;
}
// the sums over the warp's lanes of N values a lane, in the order of a
// butterfly over lane masks 16, 8, 4, 2, 1 (each level adds the pairs of
// lanes that differ in that bit), each lane keeping half of the values it
// holds at each level while it holds more than one. The caller puts the
// value of index i ^ (l >> (5 - log2 N)) in slot i of lane l, so a lane
// always keeps its lower slots (no select); lane l ends with the sum of
// index l >> (5 - log2 N) in slot 0.
template <int N>
__device__ __forceinline__ void lane_sums(float (&v)[N]) {
#pragma unroll
    for (int l = 0; l < 5; ++l) {
        const int m = 16 >> l;
        const int n = N >> l;  // values held
        if (n > 1) {
#pragma unroll
            for (int c = 0; c < n / 2; ++c) {
                v[c] = __fadd_rn(v[c], __shfl_xor_sync(kFull, v[c + n / 2], m));
            }
        } else {
            v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], m));
        }
    }
}

// v[i] <- v[i ^ x] for i < N (x < N), by a conditional swap for each bit
template <int N>
__device__ __forceinline__ void permute_slots(float (&v)[N], int x) {
#pragma unroll
    for (int b = 1; b < N; b <<= 1) {
        const bool swap = x & b;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if (!(i & b)) {
                const float lo = v[i], hi = v[i | b];
                v[i] = swap ? hi : lo;
                v[i | b] = swap ? lo : hi;
            }
        }
    }
}

// a lane's two values (rows or columns 2l, 2l + 1) of a row vector in
// shared memory, as fp32: fp32 rows as they are, bf16 ones converted
__device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}

// a state warp's share of preparing a tile of its head: the quad of steps
// t0 .. t0 + 3, lane l taking rows 2l and 2l + 1 of each row vector. The
// bonus c_t of each step and, if the whole quad lies below `steps`, its
// cross terms d_{j,s} (s < j) are summed over the lanes, and the quad's rows
// go to the fp32 work tiles for `quad_step`: with W_j = w_{t0+j}, prefix
// products P_j = W_0 .. W_{j-1} and suffix products Q_s = W_{s+1} .. W_3,
// r_{t0+j} <- r_{t0+j} P_j (j = 1..3), k_{t0+s} <- k_{t0+s} Q_s (s = 0..2),
// w_{t0} <- P_4, and r_{t0}, k_{t0+3} and v as they are (w_{t0+1..3} are no
// longer read). A quad that reaches past `steps` goes to the work tiles as
// it is (for `one_step`). bf16 r, k, v are read from the staging tiles and
// converted on the way (exactly), so every fp32 row is written once.
template <typename T>
__device__ __forceinline__ void prep_share(unsigned char* slot, int t0, int steps, int lane,
                                           float u0, float u1) {
    constexpr bool kBf16 = sizeof(T) == 2;
    float* work = reinterpret_cast<float*>(slot);
    const T* in = reinterpret_cast<const T*>(kBf16 ? slot + Layout<T>::WORK : slot);
    const int at = t0 * HEAD_DIM + 2 * lane;  // + j * HEAD_DIM: step t0 + j
    float2* r = reinterpret_cast<float2*>(work + at);
    float2* k = reinterpret_cast<float2*>(work + kTile + at);
    float2* v = reinterpret_cast<float2*>(work + 2 * kTile + at);
    float2* w = reinterpret_cast<float2*>(work + 3 * kTile + at);
    float* cs = work + 4 * kTile;
    float* ds = cs + kSteps + t0 * 2;  // 8 floats a quad
    float2 rr[4], kk[4], ww[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        rr[j] = ld2(in + at + j * HEAD_DIM);
        kk[j] = ld2(in + kTile + at + j * HEAD_DIM);
        ww[j] = w[j * 32];
    }
    float c[kShare], d[8];
#pragma unroll
    for (int j = 0; j < kShare; ++j) c[j] = bonus_part(rr[j], kk[j], u0, u1);
    // the terms of d_{j,s} = sum r_j k_s W_{s+1} .. W_{j-1}, in the order
    // (1,0), (2,0), (2,1), (3,0), (3,1), (3,2), then two zeros
    {
        const float2 as[6] = {rr[1], mul2(rr[2], ww[1]), rr[2],
                              mul2(rr[3], mul2(ww[1], ww[2])), mul2(rr[3], ww[2]), rr[3]};
        const float2 bs[6] = {kk[0], kk[0], kk[1], kk[0], kk[1], kk[2]};
#pragma unroll
        for (int i = 0; i < 6; ++i) d[i] = fmaf(as[i].y, bs[i].y, __fmul_rn(as[i].x, bs[i].x));
        d[6] = d[7] = 0.f;
    }
    // index i of lane l into slot i ^ (l >> (5 - log2 N)), for `lane_sums`
    permute_slots(c, lane >> 3);
    permute_slots(d, lane >> 2);
    lane_sums(c);
    lane_sums(d);
    if ((lane & 7) == 0) cs[t0 + (lane >> 3)] = c[0];
    if ((lane & 3) == 0) ds[lane >> 2] = d[0];
    if (t0 + 3 < steps) {
        const float2 p2 = mul2(ww[0], ww[1]), p3 = mul2(p2, ww[2]);
        const float2 q1 = mul2(ww[2], ww[3]);
        r[32] = mul2(rr[1], ww[0]);
        r[64] = mul2(rr[2], p2);
        r[96] = mul2(rr[3], p3);
        k[0] = mul2(kk[0], mul2(ww[1], q1));
        k[32] = mul2(kk[1], q1);
        k[64] = mul2(kk[2], ww[3]);
        w[0] = mul2(p3, ww[3]);
        if constexpr (kBf16) {
            r[0] = rr[0];
            k[96] = kk[3];
        }
    } else if constexpr (kBf16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j * 32] = rr[j], k[j * 32] = kk[j];
    }
    if constexpr (kBf16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j * 32] = ld2(in + 2 * kTile + at + j * HEAD_DIM);
    }
}

// one step of a state lane (rows 16 sw + 4m + e, columns 2l and 2l + 1 of
// the head): p = r.S over its rows, then S <- w S + k v
__device__ __forceinline__ void one_step(const float* __restrict__ rt,
                                         const float* __restrict__ kt,
                                         const float* __restrict__ wt, float2 v,
                                         float (&st)[kWarpRows][2], float2& p) {
    p = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kWarpRows / 4; ++m) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + 4 * m);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + 4 * m);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = 4 * m + e;
            const float r = comp(r4, e), k = comp(k4, e), w = comp(w4, e);
            p.x = fmaf(r, st[i][0], p.x);
            p.y = fmaf(r, st[i][1], p.y);
            st[i][0] = fmaf(w, st[i][0], __fmul_rn(k, v.x));
            st[i][1] = fmaf(w, st[i][1], __fmul_rn(k, v.y));
        }
    }
}

// a quad of steps t .. t + 3 of a state lane from the rows `prep_share`
// made (r'_j = r_{t+j} P_j, k'_s = k_{t+s} Q_s, P_4): p_j = r'_j . S over its
// rows, then S <- P_4 S + (k'_0 v_0 + k'_1 v_1 + k'_2 v_2 + k_3 v_3), the
// sum taken in that order
__device__ __forceinline__ void quad_step(const float* __restrict__ rq,
                                          const float* __restrict__ kq,
                                          const float* __restrict__ p4, const float2 (&v)[4],
                                          float (&st)[kWarpRows][2], float2 (&p)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kWarpRows / 4; ++m) {
        float4 r4[4], k4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            r4[j] = *reinterpret_cast<const float4*>(rq + j * HEAD_DIM + 4 * m);
            k4[j] = *reinterpret_cast<const float4*>(kq + j * HEAD_DIM + 4 * m);
        }
        const float4 pp = *reinterpret_cast<const float4*>(p4 + 4 * m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = 4 * m + e;
            const float pe = comp(pp, e);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float x = comp(r4[j], e);
                p[j].x = fmaf(x, st[i][0], p[j].x);
                p[j].y = fmaf(x, st[i][1], p[j].y);
            }
            float x0 = __fmul_rn(comp(k4[0], e), v[0].x);
            float x1 = __fmul_rn(comp(k4[0], e), v[0].y);
#pragma unroll
            for (int j = 1; j < 4; ++j) {
                x0 = fmaf(comp(k4[j], e), v[j].x, x0);
                x1 = fmaf(comp(k4[j], e), v[j].y, x1);
            }
            st[i][0] = fmaf(pe, st[i][0], x0);
            st[i][1] = fmaf(pe, st[i][1], x1);
        }
    }
}

// two blocks resident on an SM: all of B*H = 256 at once on 132 SMs
template <typename T>
__global__ void __launch_bounds__(kSeqThreads, 2)
wkv6_seq_kernel(const __grid_constant__ CUtensorMap tr,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap to, const float* __restrict__ u,
                const float* __restrict__ state_in, float* __restrict__ state_out,
                int S_len, int H) {
    using L = Layout<T>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t base = (raw + 127u) & ~127u;
    unsigned char* smem = smem_raw + (base - raw);
    const uint32_t full = base + L::BAR_OFF;
    const uint32_t ready = full + 8 * kStages;
    const uint32_t empty = ready + 8 * kStages;

    const int bh = blockIdx.x;  // b * H + h
    const int b = bh / H;
    const int c0 = bh % H * HEAD_DIM;  // the head's first column in (H * hd)
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n_tiles = (S_len + kSteps - 1) / kSteps;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(ready + 8 * s, 32 * kStateWarps);
            mbar_init(empty + 8 * s, 32 * kStateWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {  // the producer
        if (lane == 0) {
            for (int n = 0; n < n_tiles; ++n) {
                const int s = n % kStages;
                mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);  // free
                const uint32_t slot = base + s * L::SLOT;
                // fp32 r, k, v land in the work tiles, bf16 ones in staging
                const uint32_t rkv = sizeof(T) == 2 ? slot + L::WORK : slot;
                const uint32_t step = sizeof(T) == 2 ? kTile * 2 : L::F32_TILE;
                mbar_expect_tx(full + 8 * s, L::TX);
                tma_load_3d(rkv, &tr, full + 8 * s, c0, n * kSteps, b);
                tma_load_3d(rkv + step, &tk, full + 8 * s, c0, n * kSteps, b);
                tma_load_3d(rkv + 2 * step, &tv, full + 8 * s, c0, n * kSteps, b);
                tma_load_3d(slot + 3 * L::F32_TILE, &tw, full + 8 * s, c0, n * kSteps, b);
            }
        }
        return;
    }

    // the state warps: warp sw holds rows 16 sw .. 16 sw + 15 of the state,
    // lane l columns 2l and 2l + 1 of them, 32 fp32 values a lane
    const int sw = warp - 1;
    const int row0 = sw * kWarpRows;
    const size_t sbase = (size_t)bh * HEAD_DIM * HEAD_DIM;
    float st[kWarpRows][2];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
        float2 x = make_float2(0.f, 0.f);
        if (state_in != nullptr) {
            x = *reinterpret_cast<const float2*>(state_in + sbase +
                                                 (size_t)(row0 + i) * HEAD_DIM + 2 * lane);
        }
        st[i][0] = x.x;
        st[i][1] = x.y;
    }
    const float u0 = u[c0 + 2 * lane], u1 = u[c0 + 2 * lane + 1];
    // this warp's share of each tile's preparation, one tile ahead
    auto prep = [&](int n) {
        const int s = n % kStages;
        mbar_wait(full + 8 * s, (n / kStages) & 1);
        prep_share<T>(smem + s * L::SLOT, sw * kShare, min(kSteps, S_len - n * kSteps), lane,
                      u0, u1);
        fence_proxy_async();  // before TMA writes this slot again
        mbar_arrive(ready + 8 * s);
    };
    const uint32_t out_smem = L::OUT_OFF + sw * kOutStages * L::OUT_TILE;
    prep(0);
    for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        mbar_wait(ready + 8 * s, (n / kStages) & 1);
        const int so = n % kOutStages;
        if (n >= kOutStages) {  // the store that last read this out tile is done
            if (lane == 0) bulk_wait_read<kOutStages - 1>();
            __syncwarp();
        }
        const float* work = reinterpret_cast<const float*>(smem + s * L::SLOT);
        const float* rs = work + row0;  // + t * HEAD_DIM: this warp's rows of step t
        const float* ks = work + kTile + row0;
        const float* vs = work + 2 * kTile;
        const float* ws = work + 3 * kTile + row0;
        const float* cs = work + 4 * kTile;
        const float* ds = cs + kSteps;
        float* part = reinterpret_cast<float*>(smem + L::PART_OFF + (n & 1) * L::PART);
        float2* mine = reinterpret_cast<float2*>(part + sw * kTile) + lane;  // + t * 32
        const int steps = min(kSteps, S_len - n * kSteps);
        int t = 0;
#pragma unroll 2
        for (; t + 3 < steps; t += 4) {
            const int at = t * HEAD_DIM;
            float2 v[4], p[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = reinterpret_cast<const float2*>(vs + at + j * HEAD_DIM)[lane];
            }
            quad_step(rs + at, ks + at, ws + at, v, st, p);
#pragma unroll
            for (int j = 0; j < 4; ++j) mine[(t + j) * 32] = p[j];
        }
        for (; t < steps; ++t) {  // the last steps of a tile that ends inside a quad
            const int at = t * HEAD_DIM;
            float2 p;
            one_step(rs + at, ks + at, ws + at, reinterpret_cast<const float2*>(vs + at)[lane],
                     st, p);
            mine[t * 32] = p;
        }
        // the next tile's share of preparation, while the other state warps
        // finish this one's steps
        if (n + 1 < n_tiles) prep(n + 1);
        // the state warps' sums added in warp order, then the quad's d v terms
        // and the bonus c v: warp sw takes the quad of steps 4 sw .. 4 sw + 3,
        // lane l columns 2l and 2l + 1
        asm volatile("bar.sync 1, %0;\n" :: "r"(32 * kStateWarps) : "memory");
        float2* os = reinterpret_cast<float2*>(smem + out_smem + so * L::OUT_TILE) + lane;
#pragma unroll
        for (int j = 0; j < kShare; ++j) {
            const int t = sw * kShare + j;
            const float2* pt = reinterpret_cast<const float2*>(part + t * HEAD_DIM) + lane;
            float2 o = pt[0];
#pragma unroll
            for (int w = 1; w < kStateWarps; ++w) {
                const float2 y = pt[w * kTile / 2];
                o.x = __fadd_rn(o.x, y.x);
                o.y = __fadd_rn(o.y, y.y);
            }
            if (sw * kShare + 3 < steps) {  // a whole quad: d_{j,i} v_i for i < j
                const float* dq = ds + sw * 8 + j * (j - 1) / 2;
#pragma unroll
                for (int i = 0; i < j; ++i) {
                    const float2 vp =
                        reinterpret_cast<const float2*>(vs + (sw * kShare + i) * HEAD_DIM)[lane];
                    o = make_float2(fmaf(dq[i], vp.x, o.x), fmaf(dq[i], vp.y, o.y));
                }
            }
            const float2 vv = reinterpret_cast<const float2*>(vs + t * HEAD_DIM)[lane];
            os[j * 32] = make_float2(fmaf(cs[t], vv.x, o.x), fmaf(cs[t], vv.y, o.y));
        }
        mbar_arrive(empty + 8 * s);
        fence_proxy_async();
        __syncwarp();
        const int t0 = n * kSteps + sw * kShare;
        if (lane == 0 && t0 < S_len) {
            tma_store_3d(&to, base + out_smem + so * L::OUT_TILE, c0, t0, b);
            bulk_commit();
        }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
        *reinterpret_cast<float2*>(state_out + sbase + (size_t)(row0 + i) * HEAD_DIM +
                                   2 * lane) = make_float2(st[i][0], st[i][1]);
    }
}

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf16x2_to_float2(x.x), b = bf16x2_to_float2(x.y);
    return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// one step (S = 1) from a carried state: thread (g, jq) holds rows 4g..4g+3
// of columns 4jq..4jq+3; partial sums over its 4 rows, then the two row
// groups of a warp by one shuffle, then the 8 warps in order
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ state_in, float* __restrict__ out,
                 float* __restrict__ state_out, int H) {
    __shared__ __align__(16) float part[kStepThreads / 32][HEAD_DIM];
    __shared__ float bonus;
    const int bh = blockIdx.x;  // b * H + h; with S = 1 also the row of r, k, v, w
    const int h = bh % H;
    const int tid = threadIdx.x;
    const int jq = tid % 16, g = tid / 16;
    const int warp = tid / 32, lane = tid % 32;
    const size_t sbase = (size_t)bh * HEAD_DIM * HEAD_DIM;
    const size_t rbase = (size_t)bh * HEAD_DIM;

    float4 st[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        st[e] = state_in != nullptr
                    ? load4(state_in + sbase + (size_t)(4 * g + e) * HEAD_DIM + 4 * jq)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float4 r4 = load4(r + rbase + 4 * g), k4 = load4(k + rbase + 4 * g);
    const float4 w4 = load4(w + rbase + 4 * g), v4 = load4(v + rbase + 4 * jq);
    const float vo = tid < HEAD_DIM ? load1(v + rbase + tid) : 0.f;  // for the output
    if (warp == 0) {
        const float2 uu = load2(u + (size_t)h * HEAD_DIM + 2 * lane);
        const float c = butterfly_sum(bonus_part(load2(r + rbase + 2 * lane),
                                                 load2(k + rbase + 2 * lane), uu.x, uu.y));
        if (lane == 0) bonus = c;
    }
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float re = comp(r4, e), ke = comp(k4, e), we = comp(w4, e);
        const float4 s = st[e];
        p[0] = fmaf(re, s.x, p[0]);
        p[1] = fmaf(re, s.y, p[1]);
        p[2] = fmaf(re, s.z, p[2]);
        p[3] = fmaf(re, s.w, p[3]);
        const float4 n = make_float4(fmaf(we, s.x, __fmul_rn(ke, v4.x)),
                                     fmaf(we, s.y, __fmul_rn(ke, v4.y)),
                                     fmaf(we, s.z, __fmul_rn(ke, v4.z)),
                                     fmaf(we, s.w, __fmul_rn(ke, v4.w)));
        __stcs(reinterpret_cast<float4*>(state_out + sbase + (size_t)(4 * g + e) * HEAD_DIM +
                                         4 * jq), n);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) p[c] = __fadd_rn(p[c], __shfl_xor_sync(kFull, p[c], 16));
    if (lane < 16) {
        *reinterpret_cast<float4*>(&part[warp][4 * jq]) = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    if (tid < HEAD_DIM) {
        float o = part[0][tid];
#pragma unroll
        for (int i = 1; i < kStepThreads / 32; ++i) o = __fadd_rn(o, part[i][tid]);
        out[rbase + tid] = fmaf(bonus, vo, o);
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null
EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiledFn>(p);
        }
    }
    return fn;
}

// a 3-D map over a contiguous (B, S, H * hd) tensor of `elt`-byte elements,
// boxes of one head's hd columns x `steps` steps x 1 row, zero-filled outside
bool encode_map(EncodeTiledFn encode, CUtensorMap* map, CUtensorMapDataType type,
                int elt, const void* ptr, int B, int S_len, int H, int steps) {
    const cuuint64_t dims[3] = {(cuuint64_t)H * HEAD_DIM, (cuuint64_t)S_len, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)H * HEAD_DIM * elt,
                                   (cuuint64_t)S_len * H * HEAD_DIM * elt};
    const cuuint32_t box[3] = {HEAD_DIM, (cuuint32_t)steps, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_seq(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* state_in, void* out, void* state_out, int B, int S_len, int H,
               cudaStream_t st) {
    using L = Layout<T>;
    static uint32_t ready = 0;  // devices whose shared-memory limit is raised
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 32) return (int)cudaErrorInvalidDevice;
    if (!(ready >> dev & 1u)) {
        err = cudaFuncSetAttribute(wkv6_seq_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L::DYN_BYTES);
        if (err != cudaSuccess) return (int)err;
        ready |= 1u << dev;
    }
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const CUtensorMapDataType type = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap tr, tk, tv, tw, to;
    if (!encode_map(encode, &tr, type, sizeof(T), r, B, S_len, H, kSteps) ||
        !encode_map(encode, &tk, type, sizeof(T), k, B, S_len, H, kSteps) ||
        !encode_map(encode, &tv, type, sizeof(T), v, B, S_len, H, kSteps) ||
        !encode_map(encode, &tw, f32, 4, w, B, S_len, H, kSteps) ||
        !encode_map(encode, &to, f32, 4, out, B, S_len, H, kShare)) {
        return (int)cudaErrorInvalidValue;
    }
    wkv6_seq_kernel<T><<<(unsigned)(B * H), kSeqThreads, L::DYN_BYTES, st>>>(
        tr, tk, tv, tw, to, (const float*)u, (const float*)state_in, (float*)state_out, S_len,
        H);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_step(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* state_in, void* out, void* state_out, int B, int H,
                cudaStream_t st) {
    wkv6_step_kernel<T><<<(unsigned)(B * H), kStepThreads, 0, st>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)u,
        (const float*)state_in, (float*)out, (float*)state_out, H);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_head_dim() { return HEAD_DIM; }

// steps of the sequence kernel's tile (its ring's unit)
extern "C" int wkv6_tile() { return kSteps; }

// r, k, v (B, S, H, 64) of one type, bf16 != 0 selecting bfloat16, else
// float32; w, out (B, S, H, 64) float32; u (H, 64) float32; state_in (B, H,
// 64, 64) float32 or null for a zero state; state_out (B, H, 64, 64) float32,
// apart from every input; all 16-byte aligned. Launches one kernel on
// `stream`: the step kernel at S = 1 (unless built with WKV6_STEP_KERNEL=0),
// the sequence kernel above. Returns the first CUDA error that is not 0,
// else 0.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* state_in,
                           void* out, void* state_out, int B, int S_len, int H,
                           int bf16, void* stream) {
    if (B < 0 || S_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)B * H;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (WKV6_STEP_KERNEL && S_len == 1) {
        return bf16 ? launch_step<__nv_bfloat16>(r, k, v, w, u, state_in, out, state_out, B,
                                                 H, st)
                    : launch_step<float>(r, k, v, w, u, state_in, out, state_out, B, H, st);
    }
    return bf16 ? launch_seq<__nv_bfloat16>(r, k, v, w, u, state_in, out, state_out, B, S_len,
                                            H, st)
                : launch_seq<float>(r, k, v, w, u, state_in, out, state_out, B, S_len, H, st);
}
