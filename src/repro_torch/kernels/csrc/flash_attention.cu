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
// key gives 0. The bf16 kernel computes those exponentials as 2^x with
// ex2.approx (relative error ~2^-22), the scale folded into the argument
// (x = s scale log2(e) - m scale log2(e), one FMA), and the division as a
// product with 1 / max(l, 1e-30): each within an fp32 ulp or two of the
// formula, far below the bf16 rounding of p and of the output.
//
// Bound on the card: bytes at qwen2 serving's prefill shape, operations
// at longer sequences and wider heads. At B=8, Sq=Sk=512, 14 heads, hd=64,
// causal it must move ~17 MB of q, k, v and output (~5.0 us at 3.35 TB/s) and
// do ~3.8 GFLOP of QK and PV products (~3.8 us at the bf16 tensor-core
// rate); at qwen2-moe's (B=8, KV=16, G=1, hd=128, S=512) ~67 MB (~20.0 us)
// against ~8.6 GFLOP (~8.7 us); at recurrentgemma's prefill (B=8, KV=1,
// G=16, hd=256, S=2560, window 2048) the products are ~413 GFLOP (~0.42 ms)
// against ~357 MB (~0.11 ms).
//
// bfloat16: tensor cores (`flash_attention_wgmma_kernel`, sm_90a). A work
// item is (query head, tile of 128 consecutive query positions); the grid
// holds one block of 384 threads per SM (fewer if there are fewer items),
// and each block walks its share of the items, those with the most keys
// first. Warpgroups 0 and 1 compute 64 rows each, warpgroup 2 loads; the
// loader drops to 24 registers and the compute warpgroups rise to 240
// (setmaxnreg): at hd 256 the O fragment alone is 128 fp32 registers a
// thread.
//
// - Products on tensor cores. S = Q K^T runs as wgmma (bf16 in, fp32
//   accumulate) with Q and K both read from shared memory (K-major); O += P V
//   takes P, converted to bf16 in registers, as the register A operand, and
//   V from shared memory through the descriptor's transpose bit (MN-major).
//   That conversion is the TPU kernel's "p rounded to v's type before PV".
// - Online softmax on the fragment. The wgmma accumulator gives each thread
//   two rows and each row to four neighbouring lanes, so a row's max and sum
//   take two xor shuffles; alpha rescales the O fragment in place; the S
//   fragment of 16 keys is already the A fragment of the PV product. Only
//   tiles that straddle the causal diagonal, the window's lower edge or Sk
//   are masked (an unsigned range test a score); a warpgroup skips a tile
//   its 64 rows cannot see (exact: such a tile changes neither m, l nor
//   acc), and tiles outside the whole item's band are never loaded.
// - Overlap. Step i issues S of tile i and then O += P V of tile i - 1 as
//   two commit groups; tile i's softmax runs as soon as S is done, beside
//   that PV product. The two compute warpgroups issue in turn (named
//   barriers), so one's products also run beside the other's softmax.
// - Loads by TMA. One thread of the loader issues every copy, 128-byte
//   swizzled: Q once an item (two Q buffers at hd 64 and 128, so the next
//   item's Q arrives during this one), K and V tiles into a ring of stages
//   (128 keys, 4 stages at hd 64: 160 KB of shared memory with Q; 128 keys, 2
//   stages at hd 128: 192 KB; 64 keys, 2 stages at hd 256: 192 KB), each
//   stage handed over by K-full, V-full, K-empty and
//   V-empty mbarriers, K released after its S product and V after its PV
//   product. The tensor maps are 3-D over (hd, positions, heads), encoded on
//   the host (libcuda's cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPointByVersion, so no libcuda link) and passed as
//   __grid_constant__ parameters; a key tile past Sk is zero-filled by TMA,
//   not read from the next head, and masked.
// - Output. Each warpgroup writes O / l in bf16 into its own rows of the Q
//   buffer (swizzled as TMA wrote Q) and stores them with one TMA store per
//   64 columns; rows at or past Sq fall outside the output's map and are
//   not written. Blocks take items back and forth (b, 2P - 1 - b, 2P + b,
//   ...) so that long and short items even out across blocks.
//
// float32: CUDA cores (tensor cores take fp32 only as TF32, which would not
// match the plain version). One thread block per (b*KV + kv, tile of BLOCK_Q
// query positions) holding the whole group of G query heads of that KV head,
// one thread per (head, position) row, so each K/V tile is read once for all
// G heads, as the TPU kernel's block does. K and V tiles of BLOCK_K positions
// go through shared memory; each thread keeps its q row, its accumulator and
// its tile's scores in registers and runs the online softmax with fp32 FMAs.
// Tiles wholly outside the causal or window band are skipped. At hd 256
// (recurrentgemma: MQA, 16 query heads over one KV head, a 2048-token window)
// a thread cannot hold a 256-wide q row and accumulator (512 floats), so the
// wide kernel splits each row over WIDE_LANES = 8 neighbouring threads of a
// warp: thread `lane` holds dims lane*4 + 32*c (c < 8; c < 4 at hd 128, the
// MoE models' head dim, which takes the same kernel) of q and of the
// accumulator, so the eight float4 reads of a K or V row by one row's
// threads fall on distinct banks; the QK dot product is summed over the 8
// threads by three xor shuffles. Each thread holds two rows, a block of 256
// threads 64 rows: the G query heads of one KV head times 64 / G query
// positions. K and V tiles of WIDE_BLOCK_K = 16 keys go through 32 KB (16 KB
// at hd 128) of static shared memory. The wrapper refuses other head dims and groups above
// the fp32 kernels' maximum (`flash_attention_max_group`), for both types.
//
// Built with nvcc into a shared library with a plain C interface (see
// kernels/build.py) and called through ctypes from kernels/ops.py.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <algorithm>
#include <cstdint>
#include <type_traits>

#define HEAD_DIM 64
#define BLOCK_Q 32
#define BLOCK_K 32
#define MAX_GROUP 8  // G * BLOCK_Q threads per block, at most 256
#define MID_HEAD_DIM 128   // the wide kernel's layout, 16 dims a thread
#define WIDE_HEAD_DIM 256
#define WIDE_LANES 8       // threads per row
#define WIDE_THREADS 256
#define WIDE_ROWS 64       // (head, query) rows per block: 2 per thread
#define WIDE_BLOCK_K 16
#define WIDE_MAX_GROUP 16  // at least 4 query positions per block

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- float32

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
// p is rounded to v's type before the PV product (a no-op for float32)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

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

template <typename T, int HD>
__global__ void __launch_bounds__(WIDE_THREADS)
flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int G, int Sq, int Sk, int causal, int window,
                            float scale) {
    constexpr int NC = HD / (WIDE_LANES * 4);             // float4s per row slice
    constexpr int DPT = NC * 4;                           // dims per thread
    constexpr int RPT = WIDE_ROWS * WIDE_LANES / WIDE_THREADS;  // rows per thread
    constexpr int ROW_STEP = WIDE_THREADS / WIDE_LANES;
    __shared__ __align__(16) float ks[WIDE_BLOCK_K][HD];
    __shared__ __align__(16) float vs[WIDE_BLOCK_K][HD];

    const int bh = blockIdx.y;
    const int BQ = WIDE_ROWS / G;  // query positions per block
    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const int lane = tid % WIDE_LANES;
    const int rg = tid / WIDE_LANES;

    float qr[RPT][DPT];
    float acc[RPT][DPT];
    float m[RPT];
    float l[RPT];
    int qpos[RPT];
    bool row_ok[RPT];
    size_t row_off[RPT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
        const int row = rg + rr * ROW_STEP;
        const int g = row / BQ;
        qpos[rr] = q0 + row % BQ;
        row_ok[rr] = g < G && qpos[rr] < Sq;
        row_off[rr] = (((size_t)bh * G + (row_ok[rr] ? g : 0)) * Sq +
                       (row_ok[rr] ? qpos[rr] : 0)) * HD;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = c * WIDE_LANES * 4 + lane * 4 + e;
                qr[rr][c * 4 + e] = row_ok[rr] ? load_f(q + row_off[rr] + d) : 0.f;
                acc[rr][c * 4 + e] = 0.f;
            }
        }
        m[rr] = kNegInf;
        l[rr] = 0.f;
    }

    // the keys this block's queries can see at all
    const int q_last = min(q0 + BQ, Sq) - 1;
    const int k_end = causal ? min(Sk, q_last + 1) : Sk;
    const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
    const int k_begin = (k_first / WIDE_BLOCK_K) * WIDE_BLOCK_K;
    const T* kb = k + (size_t)bh * Sk * HD;
    const T* vb = v + (size_t)bh * Sk * HD;

    for (int kt = k_begin; kt < k_end; kt += WIDE_BLOCK_K) {
        __syncthreads();  // the previous tile is consumed
        for (int i = tid; i < WIDE_BLOCK_K * HD; i += WIDE_THREADS) {
            const int r = i / HD;
            const int c = i - r * HD;
            const int key = kt + r;
            const bool in = key < Sk;
            ks[r][c] = in ? load_f(kb + (size_t)key * HD + c) : 0.f;
            vs[r][c] = in ? load_f(vb + (size_t)key * HD + c) : 0.f;
        }
        __syncthreads();

        float s[RPT][WIDE_BLOCK_K];
#pragma unroll
        for (int j = 0; j < WIDE_BLOCK_K; ++j) {
            float d0[RPT], d1[RPT];
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) d0[rr] = d1[rr] = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 kk = *reinterpret_cast<const float4*>(
                    &ks[j][c * WIDE_LANES * 4 + lane * 4]);
#pragma unroll
                for (int rr = 0; rr < RPT; ++rr) {
                    d0[rr] = fmaf(qr[rr][c * 4], kk.x, d0[rr]);
                    d1[rr] = fmaf(qr[rr][c * 4 + 1], kk.y, d1[rr]);
                    d0[rr] = fmaf(qr[rr][c * 4 + 2], kk.z, d0[rr]);
                    d1[rr] = fmaf(qr[rr][c * 4 + 3], kk.w, d1[rr]);
                }
            }
            const int key = kt + j;
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) {
                float dot = d0[rr] + d1[rr];
#pragma unroll
                for (int o = 1; o < WIDE_LANES; o <<= 1) {
                    dot += __shfl_xor_sync(0xffffffffu, dot, o);
                }
                bool ok = row_ok[rr] && key < Sk;
                if (causal) ok = ok && key <= qpos[rr];
                if (window > 0) ok = ok && qpos[rr] - key < window;
                s[rr][j] = ok ? dot * scale : kNegInf;
            }
        }
        // online softmax per row; s becomes p rounded to v's type
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
            float m_new = m[rr];
#pragma unroll
            for (int j = 0; j < WIDE_BLOCK_K; ++j) m_new = fmaxf(m_new, s[rr][j]);
            const float alpha = expf(fmaxf(m[rr] - m_new, -80.f));
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[rr][d] *= alpha;
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < WIDE_BLOCK_K; ++j) {
                const float p = s[rr][j] > 0.5f * kNegInf ? expf(s[rr][j] - m_new) : 0.f;
                psum += p;
                s[rr][j] = round_as(p, v);
            }
            l[rr] = l[rr] * alpha + psum;
            m[rr] = m_new;
        }
#pragma unroll
        for (int j = 0; j < WIDE_BLOCK_K; ++j) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 vv = *reinterpret_cast<const float4*>(
                    &vs[j][c * WIDE_LANES * 4 + lane * 4]);
#pragma unroll
                for (int rr = 0; rr < RPT; ++rr) {
                    acc[rr][c * 4] = fmaf(s[rr][j], vv.x, acc[rr][c * 4]);
                    acc[rr][c * 4 + 1] = fmaf(s[rr][j], vv.y, acc[rr][c * 4 + 1]);
                    acc[rr][c * 4 + 2] = fmaf(s[rr][j], vv.z, acc[rr][c * 4 + 2]);
                    acc[rr][c * 4 + 3] = fmaf(s[rr][j], vv.w, acc[rr][c * 4 + 3]);
                }
            }
        }
    }

#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
        if (!row_ok[rr]) continue;
        const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = c * WIDE_LANES * 4 + lane * 4 + e;
                store_f(out + row_off[rr] + d, acc[rr][c * 4 + e] / denom);
            }
        }
    }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* out, int BH,
            int G, int Sq, int Sk, int causal, int window, int hd,
            cudaStream_t st) {
    const float scale = 1.0f / sqrtf((float)hd);
    if (hd == HEAD_DIM) {
        const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, BH);
        flash_attention_kernel<T><<<grid, G * BLOCK_Q, 0, st>>>(
            (const T*)q, (const T*)k, (const T*)v, (T*)out, G, Sq, Sk, causal,
            window, scale);
    } else {
        const int bq = WIDE_ROWS / G;
        const dim3 grid((Sq + bq - 1) / bq, BH);
        if (hd == MID_HEAD_DIM) {
            flash_attention_wide_kernel<T, MID_HEAD_DIM><<<grid, WIDE_THREADS, 0, st>>>(
                (const T*)q, (const T*)k, (const T*)v, (T*)out, G, Sq, Sk, causal,
                window, scale);
        } else {
            flash_attention_wide_kernel<T, WIDE_HEAD_DIM><<<grid, WIDE_THREADS, 0, st>>>(
                (const T*)q, (const T*)k, (const T*)v, (T*)out, G, Sq, Sk, causal,
                window, scale);
        }
    }
}

// --------------------------------------------------- bfloat16, tensor cores

// One block of 384 threads: warpgroups 0 and 1 compute 64 query rows each,
// warpgroup 2 loads. Launched at 168 registers a thread (the whole register
// file); setmaxnreg then moves the loader to 24 and the compute warpgroups to
// 240: 24 x 128 + 240 x 256 = 168 x 384. A block cannot grow past what it
// was launched with, so `launch_wgmma` refuses a build launched with any
// other count.
constexpr int kRows = 128;
constexpr int kThreads = 384;
constexpr int kLoaderRegs = 24, kComputeRegs = 240, kLaunchRegs = 168;

// Shared-memory layout of one instantiation. Every tile is stored as blocks
// of 64 columns (128 bytes a row, the 128-byte swizzle's span), each block
// [rows][64] with its 8-row atoms 1024 bytes apart, as TMA writes it.
// At hd 128 a compute thread holds the O fragment (64 fp32 registers), S of
// a 128-key tile (64) and P twice (32 + 32): 192, as at hd 256 (128 + 32 +
// 16 + 16), within the 240 setmaxnreg gives. Two stages of 128-key K and V
// tiles (4 x 32 KB) and two Q buffers (2 x 32 KB) take 192 KB of the 227 KB
// a block may use; a third stage would need 256 KB.
template <int HD>
struct Layout {
    static constexpr int BK = HD == 256 ? 64 : 128;        // keys per tile
    static constexpr int STAGES = HD == 64 ? 4 : 2;        // K/V ring depth
    static constexpr int QBUF = HD == 256 ? 1 : 2;         // Q tiles (and O staging)
    static constexpr int NCB = HD / 64;                    // 64-column blocks
    static constexpr uint32_t Q_CB = kRows * 128;          // bytes of a Q column block
    static constexpr uint32_t KV_CB = BK * 128;            // of a K or V column block
    static constexpr uint32_t KV_TILE = NCB * KV_CB;       // one K or one V tile
    static constexpr uint32_t Q_TILE = NCB * Q_CB;
    static constexpr uint32_t K_OFF = QBUF * Q_TILE;
    static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_TILE;
    static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_TILE;
    // Q full and Q empty per Q buffer, K full, V full, K empty and V empty
    // per stage
    static constexpr uint32_t BYTES = BAR_OFF + 8 * (2 * QBUF + 4 * STAGES);
    static constexpr uint32_t DYN_BYTES = BYTES + 1024;    // room to align the base
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

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// `lbo` bytes between 64-column blocks of an MN-major operand (K-major
// operands pass 16, the value the hardware expects and ignores), 1024 bytes
// between 8-row atoms
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of a wgmma operand across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r]) :: "memory");
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) B (16 x 128, smem), both K-major;
// D is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) B (16 x 64, smem), both K-major;
// D is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// named barriers 1 and 2 (0 is __syncthreads): the two compute warpgroups
// take turns to issue their products
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// 2^x (ex2.approx: relative error ~2^-22, results below 2^-126 flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to, int G, int Sq,
                             int Sk, int causal, int window, float scale, int n_heads,
                             int n_qt) {
    using L = Layout<HD>;
    constexpr int BK = L::BK;
    constexpr int STAGES = L::STAGES;
    constexpr int QBUF = L::QBUF;
    constexpr float kLog2e = 1.4426950408889634f;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base =
        ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
    const uint32_t sk = base + L::K_OFF, sv = base + L::V_OFF;
    // barriers, 8 bytes each: per Q buffer (+ 8 * buffer) Q full and Q
    // empty, per stage (+ 8 * stage) K full, V full, K empty and V empty
    const uint32_t q_full = base + L::BAR_OFF;
    const uint32_t q_empty = q_full + 8 * QBUF;
    const uint32_t k_full = q_empty + 8 * QBUF;
    const uint32_t v_full = k_full + 8 * STAGES;
    const uint32_t k_empty = v_full + 8 * STAGES;
    const uint32_t v_empty = k_empty + 8 * STAGES;

    // Work items: (query head, tile of kRows queries), the tiles with the
    // most keys first. Block b of P takes item b, then 2P - 1 - b, 2P + b,
    // 4P - 1 - b, ...: back and forth, so that blocks given long items early
    // get short ones later. Its loader and compute warpgroups walk the same
    // items, and count the K/V tiles of all of them on one running ring.
    const int n_items = n_heads * n_qt;
    struct Item {
        int hg, q0, k_begin, n_tiles;
    };
    auto item = [&](int w) {
        Item it;
        it.hg = w % n_heads;  // query head: (b * KV + kv) * G + g
        it.q0 = (n_qt - 1 - w / n_heads) * kRows;
        // the key tiles the item's queries can see at all
        const int q_last = min(it.q0 + kRows, Sq) - 1;
        const int k_end = causal ? min(Sk, q_last + 1) : Sk;
        const int k_first = window > 0 ? max(0, it.q0 - window + 1) : 0;
        it.k_begin = (k_first / BK) * BK;
        it.n_tiles = k_end > it.k_begin ? (k_end - it.k_begin + BK - 1) / BK : 0;
        return it;
    };
    // the block's n-th item
    auto item_index = [&](int n) {
        const int P = gridDim.x, b = blockIdx.x;
        return n * P + (n % 2 ? P - 1 - b : b);
    };

    if (threadIdx.x == 0) {
        for (int b = 0; b < QBUF; ++b) {
            mbar_init(q_full + 8 * b, 1);
            mbar_init(q_empty + 8 * b, 2);  // one thread of each compute warpgroup
        }
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(k_empty + 8 * s, 8);  // lane 0 of each compute warp
            mbar_init(v_empty + 8 * s, 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the role, provably uniform over each warp (setmaxnreg needs it)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == 2) {
        // ------------------------------------------------------------ loader
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kLoaderRegs));
        if (threadIdx.x == 256) {
            int tile = 0;  // K/V tiles loaded so far, over all items
            for (int n = 0, w = item_index(0); w < n_items; w = item_index(++n)) {
                const Item it = item(w);
                const int bh = it.hg / G;
                auto load_q = [&] {
                    const int qb = n % QBUF;
                    mbar_wait(q_empty + 8 * qb, ((n / QBUF) & 1) ^ 1);
                    mbar_expect_tx(q_full + 8 * qb, L::Q_TILE);
#pragma unroll
                    for (int cb = 0; cb < L::NCB; ++cb) {
                        tma_load_3d(base + qb * L::Q_TILE + cb * L::Q_CB, &tq, q_full + 8 * qb,
                                    cb * 64, it.q0, it.hg);
                    }
                };
                // with one Q buffer, the item's first K/V tiles go before its
                // Q, which waits for the previous item's output to leave
                const int early = QBUF == 1 ? min(STAGES, it.n_tiles) : 0;
                for (int i = 0; i < it.n_tiles; ++i, ++tile) {
                    if (i == early) load_q();
                    const int s = tile % STAGES;
                    const uint32_t phase = (tile / STAGES) & 1;
                    const int kt = it.k_begin + i * BK;
                    mbar_wait(k_empty + 8 * s, phase ^ 1);
                    mbar_expect_tx(k_full + 8 * s, L::KV_TILE);
#pragma unroll
                    for (int cb = 0; cb < L::NCB; ++cb) {
                        tma_load_3d(sk + s * L::KV_TILE + cb * L::KV_CB, &tk, k_full + 8 * s,
                                    cb * 64, kt, bh);
                    }
                    mbar_wait(v_empty + 8 * s, phase ^ 1);
                    mbar_expect_tx(v_full + 8 * s, L::KV_TILE);
#pragma unroll
                    for (int cb = 0; cb < L::NCB; ++cb) {
                        tma_load_3d(sv + s * L::KV_TILE + cb * L::KV_CB, &tv, v_full + 8 * s,
                                    cb * 64, kt, bh);
                    }
                }
                if (early == it.n_tiles) load_q();
            }
        }
    } else {
        // ----------------------------------------------------------- compute
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kComputeRegs));
        const int t = threadIdx.x - 128 * wg;
        const int warp = t / 32, lane = t % 32;
        const int col = 2 * (lane & 3);
        // scores stay unscaled; exp(scale (x - m)) = 2^(x scale log2(e) - m scale log2(e))
        const float sl2 = scale * kLog2e;
        int tile = 0;  // K/V tiles consumed so far, over all items
        for (int n = 0, w = item_index(0); w < n_items; w = item_index(++n)) {
            const Item it = item(w);
            const int qb = n % QBUF;
            const int kt0 = it.k_begin, n_tiles = it.n_tiles;
            const int row0 = it.q0 + 64 * wg;  // this warpgroup's first query
            const int row_last = row0 + 63;
            // a thread holds rows qp[0] and qp[1] = qp[0] + 8 of the fragments,
            // columns 8 j + 2 (lane % 4) + {0, 1}; four lanes share a row
            const int qp[2] = {row0 + 16 * warp + lane / 4, row0 + 16 * warp + lane / 4 + 8};
            const uint32_t sq_wg = base + qb * L::Q_TILE + wg * 64 * 128;

            float o[HD / 2];
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
            float m[2] = {kNegInf, kNegInf};  // running max of the unscaled scores
            float l[2] = {0.f, 0.f};
            float sc[BK / 2];                 // S of the current tile
            uint32_t pa[BK / 16][4];          // P of the pending tile, bf16
            uint32_t pn[BK / 16][4];          // P of the current tile, while pa is read
            int pend = -1;                    // stage whose V the pending P multiplies
            uint32_t pend_phase = 0;

            // Step i issues S = Q K^T of tile i and then O += P V of tile i - 1,
            // as two commit groups; tile i's softmax runs once S is done, while
            // the PV product still runs, and O is rescaled once that is done too.
            // The two warpgroups issue in turn (warpgroup 0 first; warpgroup w
            // waits on named barrier 1 + w), so one's products overlap the
            // other's softmax. Step n_tiles only multiplies the last P.
            if (wg == 1) named_arrive(1);
            mbar_wait(q_full + 8 * qb, (n / QBUF) & 1);
            for (int i = 0; i <= n_tiles; ++i) {
                const bool last = i == n_tiles;
                const int s = (tile + i) % STAGES;
                const uint32_t phase = ((tile + i) / STAGES) & 1;
                const int kt = kt0 + i * BK;
                // whether the warpgroup's rows see any key of the tile, and
                // whether every row sees every key (no mask needed)
                const bool any = !last && row0 < Sq && (!causal || kt <= row_last) &&
                                 (window == 0 || kt + BK - 1 > row0 - window);
                const bool all = kt + BK <= Sk && (!causal || kt + BK - 1 <= row0) &&
                                 (window == 0 || row_last - kt < window);
                if (!last) mbar_wait(k_full + 8 * s, phase);
                if (pend >= 0) mbar_wait(v_full + 8 * pend, pend_phase);

                named_sync(1 + wg);
                fence_operand(o);
                wgmma_fence();
                if (any) {
                    const uint32_t ks = sk + s * L::KV_TILE;
#pragma unroll
                    for (int k = 0; k < HD / 16; ++k) {  // 16 columns a step, 4 a column block
                        const uint32_t off = (k % 4) * 32;
                        wgmma_ss(sc, smem_desc(sq_wg + (k / 4) * L::Q_CB + off, 16),
                                 smem_desc(ks + (k / 4) * L::KV_CB + off, 16), k > 0);
                    }
                }
                wgmma_commit();
                if (pend >= 0) {
                    const uint32_t vs = sv + pend * L::KV_TILE;
#pragma unroll
                    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys a step, V transposed
                        wgmma_rs(o, pa[kk], smem_desc(vs + kk * 16 * 128, L::KV_CB));
                    }
                }
                wgmma_commit();
                if (!(last && wg == 1)) named_arrive(2 - wg);
                wgmma_wait<1>();  // S of tile i
                fence_operand(sc);
                __syncwarp();
                if (lane == 0 && !last) mbar_arrive(k_empty + 8 * s);

                float alpha[2] = {1.f, 1.f};
                // online softmax on the fragment, into pn; sc stays as the
                // product wrote it (ptxas serializes the products if a register
                // of theirs is written while any is in flight). On a tile that
                // straddles an edge, row h sees the keys in [lo, hi), tested as
                // key - lo < hi - lo unsigned; masked scores count as -inf and
                // give p = 0.
                auto softmax = [&](auto masked) {
                    constexpr bool kMasked = decltype(masked)::value;
                    int first[2] = {0, 0};
                    uint32_t span[2] = {0, 0};
                    if (kMasked) {
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int lo = window > 0 ? max(0, qp[h] - window + 1) : 0;
                            const int hi = causal ? min(Sk, qp[h] + 1) : Sk;
                            span[h] = hi > lo ? hi - lo : 0;
                            first[h] = kt + col - lo;
                        }
                    }
                    auto score = [&](int j, int h, int c) {
                        const float x = sc[4 * j + 2 * h + c];
                        if (!kMasked) return x;
                        return (uint32_t)(first[h] + 8 * j + c) < span[h] ? x : kNegInf;
                    };
                    float mx[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {  // four partial maxima: shorter chains
                        float part[4] = {m[h], kNegInf, kNegInf, kNegInf};
#pragma unroll
                        for (int j = 0; j < BK / 8; ++j) {
                            part[j % 4] = fmaxf(part[j % 4], fmaxf(score(j, h, 0), score(j, h, 1)));
                        }
                        mx[h] = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
                        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                        // exp(max(scale (m_prev - m_new), -80))
                        alpha[h] = fast_exp2(fmaxf((m[h] - mx[h]) * sl2, -80.f * kLog2e));
                    }
                    float psum[2][4] = {};
#pragma unroll
                    for (int j = 0; j < BK / 8; ++j) {
                        float p[2][2];
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float neg_m = -mx[h] * sl2;
#pragma unroll
                            for (int c = 0; c < 2; ++c) {
                                // on an unmasked tile every score is
                                // visible and every row's max finite
                                const float x = score(j, h, c);
                                p[h][c] = !kMasked || x > 0.5f * kNegInf
                                              ? fast_exp2(fmaf(x, sl2, neg_m))
                                              : 0.f;
                                psum[h][j % 4] += p[h][c];
                            }
                        }
                        // p rounded to bf16: the fragment of keys 16 kk .. 16 kk + 15
                        // is the A fragment of the PV product's step kk
                        pn[j / 2][2 * (j % 2)] = pack_bf16(p[0][0], p[0][1]);
                        pn[j / 2][2 * (j % 2) + 1] = pack_bf16(p[1][0], p[1][1]);
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float sum = (psum[h][0] + psum[h][1]) + (psum[h][2] + psum[h][3]);
                        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
                        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
                        l[h] = l[h] * alpha[h] + sum;
                        m[h] = mx[h];
                    }
                };
                if (any) {
                    if (all) {
                        softmax(std::false_type{});
                    } else {
                        softmax(std::true_type{});
                    }
                }

                wgmma_wait<0>();  // O += P V of tile i - 1
                fence_operand(o);
                fence_operand(pa);  // read by that product until now
                __syncwarp();
                if (lane == 0 && pend >= 0) mbar_arrive(v_empty + 8 * pend);
                if (last) break;
                if (!any) {  // nothing of the tile to multiply: free its V once landed
                    mbar_wait(v_full + 8 * s, phase);
                    __syncwarp();
                    if (lane == 0) mbar_arrive(v_empty + 8 * s);
                    pend = -1;
                    continue;
                }
                if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
                    for (int j = 0; j < HD / 8; ++j) {
                        o[4 * j] *= alpha[0];
                        o[4 * j + 1] *= alpha[0];
                        o[4 * j + 2] *= alpha[1];
                        o[4 * j + 3] *= alpha[1];
                    }
                }
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
                }
                pend = s;
                pend_phase = phase;
            }

            // O / l in bf16 into this warpgroup's own rows of the Q tile (its
            // last product has read them), laid out and swizzled as TMA loaded
            // Q, then one TMA store per column block; rows at or past Sq lie
            // outside the output's map and are not written
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float inv = 1.f / fmaxf(l[h], 1e-30f);
                const int r = 16 * warp + lane / 4 + 8 * h;  // row within the warpgroup's 64
#pragma unroll
                for (int j = 0; j < HD / 8; ++j) {
                    const uint32_t dst = sq_wg + (j / 8) * L::Q_CB + r * 128 +
                                         (((j % 8) ^ (r % 8)) * 16) + col * 2;
                    const uint32_t v =
                        pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
                    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(dst), "r"(v) : "memory");
                }
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");  // ids 3 and 4
            if (t == 0) {
                if (row0 < Sq) {
#pragma unroll
                    for (int cb = 0; cb < L::NCB; ++cb) {
                        tma_store_3d(&to, sq_wg + cb * L::Q_CB, cb * 64, row0, it.hg);
                    }
                    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
                }
                mbar_arrive(q_empty + 8 * qb);  // the Q buffer may take the next item's Q
            }
            tile += n_tiles;
        }
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

// a 3-D map over a contiguous bf16 (depth, rows, hd) tensor, boxes of
// 64 columns x `box_rows` rows x 1, 128-byte swizzled, zero-filled outside
bool encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int hd,
                int rows, int depth, int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)depth};
    const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)rows * hd * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         int BH, int G, int Sq, int Sk, int causal, int window,
                         cudaStream_t st) {
    using L = Layout<HD>;
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv, to;
    // a map needs at least one row; with Sk == 0 no key tile is loaded
    const int rows_k = Sk > 0 ? Sk : 1;
    if (!encode_map(encode, &tq, q, HD, Sq, BH * G, kRows) ||
        !encode_map(encode, &to, out, HD, Sq, BH * G, 64) ||
        !encode_map(encode, &tk, k, HD, rows_k, BH, L::BK) ||
        !encode_map(encode, &tv, v, HD, rows_k, BH, L::BK)) {
        return cudaErrorInvalidValue;
    }
    // once per device: allow more than 48 KB of dynamic shared memory, count
    // the SMs, and refuse a build whose launch registers could not feed
    // setmaxnreg (the compute warpgroups would wait for registers forever)
    static uint32_t ready = 0;
    static int sm_count[32];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32) return cudaErrorInvalidDevice;
    if (!(ready >> dev & 1u)) {
        err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, flash_attention_wgmma_kernel<HD>);
        if (err != cudaSuccess) return err;
        if (attr.numRegs != kLaunchRegs) return cudaErrorInvalidConfiguration;
        err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L::DYN_BYTES);
        if (err != cudaSuccess) return err;
        ready |= 1u << dev;
    }
    // one block an SM, each walking its share of the work items
    const int n_qt = (Sq + kRows - 1) / kRows;
    const int grid = (int)std::min<long long>((long long)BH * G * n_qt, sm_count[dev]);
    flash_attention_wgmma_kernel<HD><<<grid, kThreads, L::DYN_BYTES, st>>>(
        tq, tk, tv, to, G, Sq, Sk, causal, window, 1.0f / sqrtf((float)HD), BH * G,
        n_qt);
    return cudaSuccess;
}

}  // namespace

// The largest group (query heads per KV head) the kernel takes at head dim
// `hd`; 0 if it was not built for that head dim.
extern "C" int flash_attention_max_group(int hd) {
    return hd == HEAD_DIM ? MAX_GROUP
           : hd == MID_HEAD_DIM || hd == WIDE_HEAD_DIM ? WIDE_MAX_GROUP
                                                       : 0;
}

// q (BH, G, Sq, hd), k and v (BH, Sk, hd), out like q, hd 64, 128 or 256; bf16
// != 0 selects bfloat16 (tensor cores), else float32 (CUDA cores). Launches
// on `stream`; returns the first CUDA error (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int G,
                                      int Sq, int Sk, int causal, int window,
                                      int hd, int bf16, void* stream) {
    const int max_g = flash_attention_max_group(hd);
    if (G < 1 || G > max_g || BH > 65535) return (int)cudaErrorInvalidValue;
    if (BH > 0 && Sq > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        if (bf16) {
            const cudaError_t err =
                hd == HEAD_DIM
                    ? launch_wgmma<HEAD_DIM>(q, k, v, out, BH, G, Sq, Sk, causal, window, st)
                : hd == MID_HEAD_DIM
                    ? launch_wgmma<MID_HEAD_DIM>(q, k, v, out, BH, G, Sq, Sk, causal,
                                                 window, st)
                    : launch_wgmma<WIDE_HEAD_DIM>(q, k, v, out, BH, G, Sq, Sk, causal,
                                                  window, st);
            if (err != cudaSuccess) return (int)err;
        } else {
            launch<float>(q, k, v, out, BH, G, Sq, Sk, causal, window, hd, st);
        }
    }
    return (int)cudaGetLastError();
}
