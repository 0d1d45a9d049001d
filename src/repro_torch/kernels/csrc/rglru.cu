// RG-LRU: the real-gated linear recurrence of the Griffin / RecurrentGemma
// recurrent block.
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
// in the sequential order of t, as the plain version computes it. Both
// kernels below run the same gate code and the same update, so each equals
// the plain version bit for bit wherever torch's expf and log1pf agree with
// the card's (they do at the serving shapes, chip_smoke.py checks it).
//
// Bound on the card: bytes. Each step of each channel reads x, r and i once
// and writes h once, at about 0.1 FLOP per byte: at serving's prefill shape
// (B=8, S=2560, W=4096, bf16 inputs) that is 503 MB read and 336 MB written,
// ~250 us at 3.35 TB/s. The gates (two expf and a square root an element)
// are the most instructions, so they must run on many threads and overlap
// the memory traffic; the serial chain h = a h + g is two dependent
// operations a step and is short if nothing else sits on it. At decode
// (S=1) it is 0.6 MB, so a launch costs its latency.
//
// Design of the sequence kernel (`rglru_tma_kernel`, S > 1): one block per
// (b, 32 channels), 1,024 blocks at the prefill shape, eight resident on an
// SM. Its warps have one role each and hand tiles of 16 steps x 32 channels
// on through shared-memory rings guarded by mbarriers:
// - warp 0, the producer: one lane streams the tiles of x, r and i by TMA
//   (3-D tensor maps over (W, S, B), channels innermost, so the ragged edges
//   of W and S are zero-filled per batch row) into a 3-stage input ring;
// - warps 2-5, the gates: every lane computes (a_t, g_t) for its channel at
//   a quarter of the tile's steps, elementwise, into a 2-stage fp32 ring;
// - warp 1, the scan: lane c runs only h = a h + g for channel c over the
//   tile's steps, in order, writes h into a 2-stage fp32 tile ring, and one
//   lane sends each tile out by a TMA store (clipped at the S and W edges).
// So loads, gates and the serial chain of different tiles overlap, and only
// the chain itself is serial. TMA needs rows of 16-byte multiples: where W
// times the element size is not one, and at S = 1 (decode, where there is
// nothing to pipeline), `rglru_launch` runs the per-channel kernel
// (`rglru_kernel`): one thread per (b, w) holds h in a register for the whole
// sequence, loads of UNROLL steps issued before their updates. The choice is
// by shape only (`rglru_uses_tma`).
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py. The
// tensor maps are encoded through libcuda's cuTensorMapEncodeTiled, reached
// by cudaGetDriverEntryPointByVersion, so no libcuda link is needed.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

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

// the per-channel constant -8 softplus(lam)
__device__ __forceinline__ float decay_scale(float lm) {
    return -kRglruC * (fmaxf(lm, 0.f) + log1pf(expf(-fabsf(lm))));
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
    const float c = decay_scale(lam[w]);
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

// ------------------------------------------------------------------------
// The sequence kernel: TMA ring, gate warps, scan warp
// ------------------------------------------------------------------------

constexpr int kChannels = 32;  // channels of a block: the scan warp's lanes
constexpr int kSteps = 16;     // steps of a tile
constexpr int kGateWarps = 4;
constexpr int kTmaThreads = 32 * (2 + kGateWarps);  // producer, scan, gates
constexpr int kInStages = 3, kAgStages = 2, kHStages = 2;
constexpr int kTileElems = kSteps * kChannels;

template <typename T>
struct TmaLayout {
    static constexpr uint32_t IN_TILE = kTileElems * sizeof(T);  // one of x, r, i
    static constexpr uint32_t IN_SLOT = 3 * IN_TILE;
    static constexpr uint32_t AG_SLOT = 2 * kTileElems * 4;       // a, then g
    static constexpr uint32_t H_SLOT = kTileElems * 4;
    static constexpr uint32_t AG_OFF = kInStages * IN_SLOT;
    static constexpr uint32_t H_OFF = AG_OFF + kAgStages * AG_SLOT;
    static constexpr uint32_t C_OFF = H_OFF + kHStages * H_SLOT;  // -8 softplus(lam)
    static constexpr uint32_t BAR_OFF = C_OFF + kChannels * 4;
    // in full and in empty per input stage, ag full and ag empty per gate stage
    static constexpr uint32_t BYTES = BAR_OFF + 8 * (2 * kInStages + 2 * kAgStages);
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

template <typename T>
__global__ void __launch_bounds__(kTmaThreads, 8)
rglru_tma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tr,
                 const __grid_constant__ CUtensorMap ti,
                 const __grid_constant__ CUtensorMap th,
                 const float* __restrict__ lam, const float* __restrict__ h0,
                 float* __restrict__ h_out, int S_len, int W) {
    using L = TmaLayout<T>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 127u) & ~127u) - raw);
    const uint32_t base = (raw + 127u) & ~127u;
    const uint32_t in_full = base + L::BAR_OFF;
    const uint32_t in_empty = in_full + 8 * kInStages;
    const uint32_t ag_full = in_empty + 8 * kInStages;
    const uint32_t ag_empty = ag_full + 8 * kAgStages;
    float* cs = reinterpret_cast<float*>(smem + L::C_OFF);

    const int w0 = blockIdx.x * kChannels;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n_tiles = (S_len + kSteps - 1) / kSteps;

    if (warp == 0) {
        const int w = w0 + lane;
        cs[lane] = decay_scale(w < W ? lam[w] : 0.f);
    }
    if (threadIdx.x == 0) {
        for (int s = 0; s < kInStages; ++s) {
            mbar_init(in_full + 8 * s, 1);
            mbar_init(in_empty + 8 * s, 32 * kGateWarps);
        }
        for (int s = 0; s < kAgStages; ++s) {
            mbar_init(ag_full + 8 * s, 32 * kGateWarps);
            mbar_init(ag_empty + 8 * s, 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {  // the producer
        if (lane == 0) {
            for (int k = 0; k < n_tiles; ++k) {
                const int s = k % kInStages;
                const uint32_t ph = (k / kInStages) & 1;
                mbar_wait(in_empty + 8 * s, ph ^ 1);  // free (immediate on the first pass)
                const uint32_t dst = base + s * L::IN_SLOT;
                mbar_expect_tx(in_full + 8 * s, L::IN_SLOT);
                tma_load_3d(dst, &tx, in_full + 8 * s, w0, k * kSteps, b);
                tma_load_3d(dst + L::IN_TILE, &tr, in_full + 8 * s, w0, k * kSteps, b);
                tma_load_3d(dst + 2 * L::IN_TILE, &ti, in_full + 8 * s, w0, k * kSteps, b);
            }
        }
        return;
    }

    if (warp == 1) {  // the scan: lane c carries channel w0 + c
        const int w = w0 + lane;
        float h = (h0 != nullptr && w < W) ? h0[(size_t)b * W + w] : 0.f;
        for (int k = 0; k < n_tiles; ++k) {
            const int sa = k % kAgStages;
            const int sh = k % kHStages;
            mbar_wait(ag_full + 8 * sa, (k / kAgStages) & 1);
            if (k >= kHStages) {  // the store that last read this h slot is done
                if (lane == 0) bulk_wait_read<kHStages - 1>();
                __syncwarp();
            }
            const float* as = reinterpret_cast<const float*>(smem + L::AG_OFF + sa * L::AG_SLOT);
            const float* gs = as + kTileElems;
            float* hs = reinterpret_cast<float*>(smem + L::H_OFF + sh * L::H_SLOT);
            const int n = min(kSteps, S_len - k * kSteps);
            if (n == kSteps) {
#pragma unroll
                for (int t0 = 0; t0 < kSteps; t0 += 8) {
                    float a[8], g[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        a[u] = as[(t0 + u) * kChannels + lane];
                        g[u] = gs[(t0 + u) * kChannels + lane];
                    }
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        h = __fadd_rn(__fmul_rn(a[u], h), g[u]);
                        hs[(t0 + u) * kChannels + lane] = h;
                    }
                }
            } else {
                for (int t = 0; t < n; ++t) {
                    h = __fadd_rn(__fmul_rn(as[t * kChannels + lane], h),
                                  gs[t * kChannels + lane]);
                    hs[t * kChannels + lane] = h;
                }
            }
            mbar_arrive(ag_empty + 8 * sa);
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) {
                tma_store_3d(&th, base + L::H_OFF + sh * L::H_SLOT, w0, k * kSteps, b);
                bulk_commit();
            }
        }
        if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        if (w < W) h_out[(size_t)b * W + w] = h;
        return;
    }

    // the gates: warp gw takes steps gw, gw + kGateWarps, ... of each tile
    const int gw = warp - 2;
    const float c = cs[lane];
    for (int k = 0; k < n_tiles; ++k) {
        const int s = k % kInStages;
        const int sa = k % kAgStages;
        mbar_wait(ag_empty + 8 * sa, ((k / kAgStages) & 1) ^ 1);
        mbar_wait(in_full + 8 * s, (k / kInStages) & 1);
        const T* xs = reinterpret_cast<const T*>(smem + s * L::IN_SLOT);
        const T* rs = xs + kTileElems;
        const T* is = rs + kTileElems;
        float* as = reinterpret_cast<float*>(smem + L::AG_OFF + sa * L::AG_SLOT);
        float* gs = as + kTileElems;
#pragma unroll
        for (int t = gw; t < kSteps; t += kGateWarps) {
            const int at = t * kChannels + lane;
            float a, g;
            gate(xs, rs, is, at, c, a, g);
            as[at] = a;
            gs[at] = g;
        }
        mbar_arrive(in_empty + 8 * s);
        mbar_arrive(ag_full + 8 * sa);
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

// a 3-D map over a contiguous (B, S, W) tensor of `elt`-byte elements,
// boxes of 32 channels x kSteps steps x 1 row, zero-filled outside
bool encode_map(EncodeTiledFn encode, CUtensorMap* map, CUtensorMapDataType type,
                int elt, const void* ptr, int B, int S_len, int W) {
    const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S_len, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)W * elt, (cuuint64_t)S_len * W * elt};
    const cuuint32_t box[3] = {kChannels, kSteps, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_tma(const void* x, const void* r, const void* i, const void* lam,
               const void* h0, void* out, void* h_out, int B, int S_len, int W,
               cudaStream_t st) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const CUtensorMapDataType type = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap tx, tr, ti, th;
    if (!encode_map(encode, &tx, type, sizeof(T), x, B, S_len, W) ||
        !encode_map(encode, &tr, type, sizeof(T), r, B, S_len, W) ||
        !encode_map(encode, &ti, type, sizeof(T), i, B, S_len, W) ||
        !encode_map(encode, &th, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, B, S_len, W)) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((W + kChannels - 1) / kChannels, B);
    rglru_tma_kernel<T><<<grid, kTmaThreads, TmaLayout<T>::DYN_BYTES, st>>>(
        tx, tr, ti, th, (const float*)lam, (const float*)h0, (float*)h_out, S_len, W);
    return (int)cudaGetLastError();
}

}  // namespace

// 1 if rglru_launch runs the TMA-fed sequence kernel at this shape, 0 if the
// per-channel kernel: S > 1 and rows of whole 16-byte units (W times the
// element size), as TMA needs
extern "C" int rglru_uses_tma(int S_len, int W, int bf16) {
    return S_len > 1 && ((long long)W * (bf16 ? 2 : 4)) % 16 == 0 ? 1 : 0;
}

// x, r, i (B, S, W) of one type, bf16 != 0 selecting bfloat16, else
// float32; lam (W,) float32; h0 (B, W) float32 or null for zeros; out (B,
// S, W) and h_out (B, W) float32, apart from every input; all 16-byte
// aligned. Launches one kernel on `stream`, the one rglru_uses_tma names;
// returns the first CUDA error that is not 0, else 0.
extern "C" int rglru_launch(const void* x, const void* r, const void* i,
                            const void* lam, const void* h0, void* out,
                            void* h_out, int B, int S_len, int W, int bf16,
                            void* stream) {
    if (B < 0 || S_len < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (rglru_uses_tma(S_len, W, bf16)) {
        return bf16 ? launch_tma<__nv_bfloat16>(x, r, i, lam, h0, out, h_out, B, S_len, W, st)
                    : launch_tma<float>(x, r, i, lam, h0, out, h_out, B, S_len, W, st);
    }
    const dim3 grid((W + THREADS - 1) / THREADS, B);
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
