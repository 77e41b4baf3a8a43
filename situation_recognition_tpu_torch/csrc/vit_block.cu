// The ViT encoder block's row-local kernels for NVIDIA Hopper, sm_90a.
//
// Replaces two TPU kernels of situation_recognition_tpu/ops/vit_pallas.py:
//   K4 `_qkv_kernel`     (ln1 + the Q/K/V projections)   -> `vit_qkv_forward`;
//   K6 `_out_mlp_kernel` (out-projection + residual + ln2 + fc1 + GELU +
//                         fc2 + residual)                -> `vit_out_mlp_forward`.
//
// The TPU kernels keep every weight of the block resident in VMEM (31 MB at
// width 1024) and run all the products of a 256-row block in one grid step.
// A Hopper block has at most 227 KB of shared memory, so here each product
// is its own launch of one tiled GEMM (C = A @ W^T, A (M, K) bf16 row-major,
// W (N, K) bf16 in nn.Linear's layout), with the elementwise work in the
// GEMM's epilogue and the LayerNorms as separate row kernels:
//
//   K4:  y   = bf16(LN1_f32(x))                          layernorm_kernel
//        q|k|v = bf16(y @ Wqkv^T + bqkv)                 gemm EPI_QKV
//   K6:  r   = (x + ctx @ Wo^T) + bo          (f32)      gemm EPI_RES_F32
//        y   = bf16(LN2_f32(r))                          layernorm_kernel
//        h   = bf16(GELU(y @ W1^T + b1))                 gemm EPI_GELU(_QUICK)
//        out = bf16((r + h @ W2^T) + b2)                 gemm EPI_RES_OUT
//
// The numerics are the TPU kernels': bf16 operands, f32 sums, f32 biases,
// LayerNorm statistics and residual, exact GELU through erff (the TPU
// kernel's 1.5e-7 erf approximation is below bf16 resolution) or QuickGELU.
// The f32 residual r and the bf16 hidden h live in device memory between
// launches (269 MB and 539 MB at ViT-L/14, batch 256), where the TPU kernel
// kept them in VMEM.
//
// What bounds it on this card.  At ViT-L/14, batch 256 the stream is
// M = 65,792 rows (256 x 257 tokens, not padded), D = 1024, H = 4096.  K4
// does 6 M D^2 FLOP and K6 18 M D^2 against well under a GB of traffic
// each: both are bound by the tensor cores (0.42 ms and 1.26 ms at
// 989 TFLOP/s bf16), which Hopper runs at full rate only through wgmma.
//
// The GEMM, gemm_kernel<EPI, BN>: 128 x BN output tiles (BN = 256 where
// N % 256 == 0, else 128), one persistent block of three warpgroups per SM
// walking tiles b, b + gridDim.x, ... in row-major tile order.
// * Warpgroup 0 is the producer: one thread issues TMA loads
//   (cp.async.bulk.tensor.2d) of the 128 x 64 A tile and the BN x 64 W tile
//   of each depth step into a ring of stages, in the 128-byte swizzle, each
//   stage 1024-byte aligned (`Layout`: 4 stages at BN = 256, 6 at 128; 3
//   and 5 beside the output slabs below).  A stage has a `full` mbarrier
//   (the producer's expect_tx of the stage's bytes) and an `empty` one that
//   the 8 consumer warps arrive on.  The ring runs on from one tile to the
//   next, so the next tile's first stages load during this tile's
//   epilogue.  TMA zero-fills rows past M and N, so the ragged edge needs
//   no predicated loads (expect_tx still counts the whole box).
// * Warpgroups 1 and 2 are the consumers, 64 rows each: wgmma.mma_async
//   m64nBNk16 with both operands from shared-memory descriptors (K-major,
//   128-byte swizzle: 8-row groups 1024 bytes apart, +32 bytes per k16
//   step), four per stage, committed as one group; wait_group 1 keeps one
//   stage's products in flight while the stage before goes back to the
//   producer.  setmaxnreg gives the producer 40 registers a thread and the
//   consumers 232 (the 64 x 256 f32 accumulator is 128 of them).
// * The epilogue works on the accumulator in registers: lane l of warp w
//   holds rows 16w + l/4 (+8), columns 8j + 2(l%4) + {0, 1}.
//   - Without a residual (EPI_QKV, EPI_GELU*), `store_staged` adds the bias
//     and GELU, writes bf16 pairs into 64 x 64 slabs of shared memory in
//     the 128-byte swizzle, and one thread stores the slabs with TMA
//     (cp.async.bulk.tensor, bulk groups); the stores drain while the
//     warpgroup runs the next tile's products.
//   - With a residual (EPI_RES_*), `store_tile` transposes column pairs
//     within each lane quad (two shfl_xor stages) so that every lane holds
//     8 adjacent columns, loads the next chunk group's bias and residual
//     before this group's stores, and stores 16 (bf16) or 32 (f32) bytes.
//   Either keeps the order of `epilogue` (bias, residual, GELU) and masks
//   the ragged edge (TMA stores drop rows and columns past the map).
// While the consumers run the epilogue's arithmetic the tensor cores wait;
// PERF.md keeps the time beside the bound and says what was tried.
//
// The tensor maps are built on the host per call (cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point, so the library links
// no libcuda) and passed as __grid_constant__ parameters.  The mbarrier,
// TMA and wgmma helpers and the tensor maps are hopper.cuh's, shared with
// ggnn_folded.cu.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, nothing is synchronised or allocated here, and each function
// returns cudaGetLastError() of the first launch that failed (0 on
// success), or cudaErrorInvalidValue for shapes it does not take.  Every
// matrix must be contiguous and 16-byte aligned (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;           // rows of an output tile, 64 per consumer
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer ones
constexpr int A_BYTES = BM * BK * 2;
// an output slab: 64 rows x 128 bytes (64 bf16 columns), 128-byte swizzled,
// one TMA store box; each consumer warpgroup stages up to four
constexpr int SLAB = 64 * 128;
// registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take (128 x 40 + 256 x 232 = 384 x 168, the launch bound)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int LN_WARPS = 8;       // rows per LayerNorm block, one warp each

enum Epi { EPI_QKV, EPI_RES_F32, EPI_GELU, EPI_GELU_QUICK, EPI_RES_OUT };

// Shared memory of gemm_kernel<EPI, BN>: 1024 bytes to align the ring, the
// ring, the output slabs of the epilogues without a residual (their
// results leave through TMA stores), and the ring's mbarriers.
template <int EPI, int BN>
struct Layout {
    static constexpr bool STAGED =
        EPI == EPI_QKV || EPI == EPI_GELU || EPI == EPI_GELU_QUICK;
    static constexpr int STAGE = A_BYTES + BN * BK * 2;
    static constexpr int SLABS = STAGED ? 2 * 4 * SLAB : 0;
    // a block takes at most 232,448 bytes; 128 of them for the barriers
    static constexpr int FIT = (232448 - 1024 - 128 - SLABS) / STAGE;
    // 4 (BN 256) or 6 (128) stages, 3 or 5 beside the slabs
    static constexpr int STAGES = FIT < 6 ? FIT : 6;
    static constexpr int SMEM = 1024 + STAGES * STAGE + SLABS + 128;
    static_assert(STAGE % 1024 == 0 && STAGES >= 3, "ring");
};

struct EpiArgs {
    const float* bias;     // (N,)
    const bf16* res_bf16;  // (M, N) residual of EPI_RES_F32
    const float* res_f32;  // (M, N) residual of EPI_RES_OUT
    float* out_f32;        // (M, N) output of EPI_RES_F32
    bf16* out_bf16;        // (M, N) output of EPI_GELU* and EPI_RES_OUT
    bf16* q;               // EPI_QKV: three (M, split) outputs, columns
    bf16* k;               // [0, split), [split, 2 split), [2 split, 3 split)
    bf16* v;
    int split;
};

// ------------------------------------------------------------ epilogue

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* b = reinterpret_cast<const bf16*>(&raw);
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&raw);
    for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float s) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// A residual epilogue of 8 adjacent outputs (row gm, columns gn .. gn+7) of
// accumulator values v, their bias and residual r already loaded:
// (r + v) + bias in f32, stored as f32 (EPI_RES_F32) or bf16 (EPI_RES_OUT).
template <int EPI>
__device__ __forceinline__ void epilogue(const EpiArgs& ep, float (&v)[8],
                                         const float (&bias)[8],
                                         const float (&r)[8], int gm, int gn,
                                         int N) {
    const size_t o = (size_t)gm * N + gn;
    for (int i = 0; i < 8; ++i) v[i] = (r[i] + v[i]) + bias[i];
    if (EPI == EPI_RES_F32)
        store8(ep.out_f32 + o, v);
    else
        store8(ep.out_bf16 + o, v);
}

// What the residual epilogue of one group of 8-column chunks reads: the bias
// of the lane's chunk and the residual (bf16 x for EPI_RES_F32, f32 r for
// EPI_RES_OUT) of its two rows.  Rows and the column are clamped into the
// matrix, so the loads need no branch (only the stores are masked).
template <int EPI>
__device__ __forceinline__ void epilogue_inputs(const EpiArgs& ep, int r0,
                                                int r1, int gn, int N,
                                                float (&in)[3][8]) {
    load8(ep.bias + gn, in[0]);
    if (EPI == EPI_RES_F32) {
        load8(ep.res_bf16 + (size_t)r0 * N + gn, in[1]);
        load8(ep.res_bf16 + (size_t)r1 * N + gn, in[2]);
    } else {
        load8(ep.res_f32 + (size_t)r0 * N + gn, in[1]);
        load8(ep.res_f32 + (size_t)r1 * N + gn, in[2]);
    }
}

// The residual epilogues (EPI_RES_*), on the warpgroup's accumulator of a
// 64 x BN tile whose row of lane 0 of this warp is row0 (and row0 + 8) and
// whose first column is col0: a 4 x 4 transpose of column pairs within each
// lane quad gives lane q of the quad all 8 columns of chunk 4g + q of each
// group g of four 8-column chunks.  The next group's bias and residual are
// loaded before this group's stores, which the compiler could not move
// them past (the pointers may alias).
template <int EPI, int BN>
__device__ __forceinline__ void store_tile(const float (&d)[BN / 2],
                                           const EpiArgs& ep, int row0,
                                           int col0, int M, int N) {
    const int q = threadIdx.x & 3;
    const bool hi1 = q & 2, hi0 = q & 1;
    const int r0 = min(row0, M - 1), r1 = min(row0 + 8, M - 1);
    float in[2][3][8];
    epilogue_inputs<EPI>(ep, r0, r1, min(col0 + 8 * q, N - 8), N, in[0]);
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
        if (g + 1 < BN / 32)
            epilogue_inputs<EPI>(ep, r0, r1,
                                 min(col0 + 8 * (4 * g + 4 + q), N - 8), N,
                                 in[(g + 1) & 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float2 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                x[i] = make_float2(d[16 * g + 4 * i + 2 * h],
                                   d[16 * g + 4 * i + 2 * h + 1]);
            // swap the off-diagonal 2 x 2 blocks (lanes q and q ^ 2), then
            // the off-diagonal pairs within each block (q and q ^ 1)
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                const float2 s = hi1 ? x[t] : x[2 + t];
                const float2 r = make_float2(
                    __shfl_xor_sync(0xffffffffu, s.x, 2),
                    __shfl_xor_sync(0xffffffffu, s.y, 2));
                if (hi1) x[t] = r; else x[2 + t] = r;
            }
#pragma unroll
            for (int t = 0; t < 4; t += 2) {
                const float2 s = hi0 ? x[t] : x[t + 1];
                const float2 r = make_float2(
                    __shfl_xor_sync(0xffffffffu, s.x, 1),
                    __shfl_xor_sync(0xffffffffu, s.y, 1));
                if (hi0) x[t] = r; else x[t + 1] = r;
            }
            float v[8] = {x[0].x, x[0].y, x[1].x, x[1].y,
                          x[2].x, x[2].y, x[3].x, x[3].y};
            const int gm = row0 + 8 * h, gn = col0 + 8 * (4 * g + q);
            if (gm < M && gn < N)
                epilogue<EPI>(ep, v, in[g & 1][0], in[g & 1][1 + h], gm, gn,
                              N);
        }
    }
}

// The epilogues without a residual (EPI_QKV, EPI_GELU*), through TMA
// stores: the warpgroup's 64 x BN accumulator, bias and GELU added in the
// order of `epilogue`, goes as bf16 into BN/64 slabs of shared memory at
// `slabs` (each 64 rows x 64 columns in the 128-byte swizzle that the
// store box reads: 16-byte chunk j of row r at chunk j ^ (r % 8)), and one
// thread stores them to rows row0 .. row0 + 63, columns col0 .. (EPI_QKV:
// each 64-column slab into q, k or v, split being a multiple of 64).  The
// stores drain while the warpgroup goes on to the next tile; the slabs are
// written again only once the stores before have read them.
template <int EPI, int BN>
__device__ __forceinline__ void store_staged(
        const float (&d)[BN / 2], const EpiArgs& ep, const CUtensorMap* tq,
        const CUtensorMap* tk, const CUtensorMap* tv, uint32_t slabs,
        int row0, int col0, int N, int barrier) {
    const int q = threadIdx.x & 3;
    const int t = threadIdx.x & 127;
    const int r = (t >> 5) * 16 + ((t & 31) >> 2);   // and r + 8
    if (t == 0) bulk_wait_read();
    warpgroup_sync(barrier);
#pragma unroll
    for (int s = 0; s < BN / 64; ++s) {
        float2 bias[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            bias[j] = *reinterpret_cast<const float2*>(
                ep.bias + min(col0 + 64 * s + 8 * j + 2 * q, N - 2));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float v0 = d[4 * (8 * s + j) + 2 * h] + bias[j].x;
                float v1 = d[4 * (8 * s + j) + 2 * h + 1] + bias[j].y;
                if (EPI == EPI_GELU) {
                    v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
                    v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
                } else if (EPI == EPI_GELU_QUICK) {
                    v0 = v0 * __frcp_rn(1.f + expf(-1.702f * v0));
                    v1 = v1 * __frcp_rn(1.f + expf(-1.702f * v1));
                }
                const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
                const int row = r + 8 * h;
                st_shared(slabs + s * SLAB + row * 128
                              + ((j ^ (row & 7)) << 4) + 4 * q,
                          *reinterpret_cast<const uint32_t*>(&pair));
            }
        }
    }
    fence_async_shared();
    warpgroup_sync(barrier);
    if (t == 0) {
#pragma unroll
        for (int s = 0; s < BN / 64; ++s) {
            const int n = col0 + 64 * s;
            if (n >= N) break;
            if (EPI == EPI_QKV) {
                const int which = (n >= ep.split) + (n >= 2 * ep.split);
                tma_store(which == 0 ? tq : (which == 1 ? tk : tv),
                          slabs + s * SLAB, n - which * ep.split, row0);
            } else {
                tma_store(tq, slabs + s * SLAB, n, row0);
            }
        }
        bulk_commit();
    }
}

// ---------------------------------------------------------------- GEMM

// C = A @ W^T with the epilogue EPI.  ta: A (M, K), tw: W (N, K), both bf16
// row-major, boxes of 64 columns by BM (ta) and BN (tw) rows.  Takes any
// M >= 1, N % 64 == 0, K % 64 == 0.  Persistent: block b takes output
// tiles b, b + gridDim.x, ... in row-major tile order, and the ring runs on
// across them, so the producer loads the next tile's first stages while
// the consumers store this one.
template <int EPI, int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, int M, int N, int K,
            EpiArgs ep) {
    using L = Layout<EPI, BN>;
    constexpr int STAGE = L::STAGE, STAGES = L::STAGES;
    extern __shared__ uint8_t smem_raw[];
    // the 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t slabs = ring + STAGES * STAGE;
    const uint32_t full = slabs + L::SLABS, empty = full + 8 * STAGES;
    const int wg = threadIdx.x >> 7;
    const int kt_n = K / BK;
    const int n_tiles = (N + BN - 1) / BN;
    const int tiles = n_tiles * ((M + BM - 1) / BM);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 8);
        }
        fence_mbar_init();
    }
    __syncthreads();

    if (wg == 0) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            int it = 0;   // depth steps loaded so far, over all tiles
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
                for (int kt = 0; kt < kt_n; ++kt, ++it) {
                    const int s = it % STAGES;
                    if (it >= STAGES)
                        mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
                    const uint32_t a = ring + s * STAGE;
                    mbar_expect_tx(full + 8 * s, STAGE);
                    tma_load(a, &ta, kt * BK, m0, full + 8 * s);
                    tma_load(a + A_BYTES, &tw, kt * BK, n0, full + 8 * s);
                }
            }
        }
    } else {
        setmaxnreg_inc<CONSUMER_REGS>();
        const int c = wg - 1;   // rows 64c .. 64c + 63 of each tile
        const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        int it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
            float acc[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
            fence_acc(acc);
            for (int kt = 0; kt < kt_n; ++kt, ++it) {
                const int s = it % STAGES;
                mbar_wait(full + 8 * s, (it / STAGES) & 1);
                const uint32_t a = ring + s * STAGE + c * (64 * BK * 2);
                const uint32_t b = ring + s * STAGE + A_BYTES;
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < BK / 16; ++k)
                    wgmma<BN>(acc, sw128_desc(a + 32 * k),
                              sw128_desc(b + 32 * k));
                wgmma_commit();
                fence_acc(acc);
                wgmma_wait<1>();
                // the stage before is read: hand it back to the producer
                if (kt > 0 && lane == 0)
                    mbar_arrive(empty + 8 * ((it - 1) % STAGES));
            }
            wgmma_wait<0>();
            fence_acc(acc);
            if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
            if constexpr (L::STAGED)
                store_staged<EPI, BN>(acc, ep, &tq, &tk, &tv,
                                      slabs + c * 4 * SLAB, m0 + 64 * c, n0,
                                      N, 1 + c);
            else
                store_tile<EPI, BN>(acc, ep,
                                    m0 + 64 * c + 16 * w + (lane >> 2), n0,
                                    M, N);
        }
        if (L::STAGED && (threadIdx.x & 127) == 0) bulk_wait();
    }
}

// y = bf16(LayerNorm_f32(x) * g + b) row by row, one warp per row:
// mean, then the biased variance of the centred values, rsqrt(var + eps).
template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, bf16* __restrict__ y, int M,
                 int D, float eps) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
    if (row >= M) return;
    const T* xr = x + (size_t)row * D;
    float v[8];
    float s = 0.f;
    for (int c = lane * 8; c < D; c += 256) {
        load8(xr + c, v);
        for (int i = 0; i < 8; ++i) s += v[i];
    }
    const float mu = warp_sum(s) / D;
    float ss = 0.f;
    for (int c = lane * 8; c < D; c += 256) {
        load8(xr + c, v);
        for (int i = 0; i < 8; ++i) {
            const float t = v[i] - mu;
            ss += t * t;
        }
    }
    const float rstd = rsqrtf(warp_sum(ss) / D + eps);
    bf16* yr = y + (size_t)row * D;
    for (int c = lane * 8; c < D; c += 256) {
        float gg[8], bb[8];
        load8(xr + c, v);
        load8(g + c, gg);
        load8(b + c, bb);
        for (int i = 0; i < 8; ++i) v[i] = (v[i] - mu) * rstd * gg[i] + bb[i];
        store8(yr + c, v);
    }
}

// ----------------------------------------------------------------- host

template <int EPI, int BN>
int launch_gemm(const bf16* A, const bf16* W, int M, int N, int K,
                const EpiArgs& ep, cudaStream_t s) {
    using L = Layout<EPI, BN>;
    // one block per SM (the ring fills its shared memory), at most one
    // per tile
    const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
    const int sms = sm_count();
    if (sms < 1 || tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int grid = (int)(tiles < sms ? tiles : sms);
    // inputs in boxes of 64 columns by a tile's rows; the staged outputs in
    // boxes of one 64 x 64 slab
    CUtensorMap ta, tw, tq = {}, tk = {}, tv = {};
    bool ok = tensor_map(&ta, A, M, K, BM) && tensor_map(&tw, W, N, K, BN);
    if (EPI == EPI_QKV)
        ok = ok && tensor_map(&tq, ep.q, M, ep.split, 64)
             && tensor_map(&tk, ep.k, M, ep.split, 64)
             && tensor_map(&tv, ep.v, M, ep.split, 64);
    else if (L::STAGED)
        ok = ok && tensor_map(&tq, ep.out_bf16, M, N, 64);
    if (!ok) return (int)cudaErrorInvalidValue;
    // once per instantiation: the ring is above the 48 KB default
    static bool sized = false;
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            gemm_kernel<EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            L::SMEM);
        if (e != cudaSuccess) return (int)e;
        sized = true;
    }
    gemm_kernel<EPI, BN><<<grid, THREADS, L::SMEM, s>>>(ta, tw, tq, tk, tv,
                                                        M, N, K, ep);
    return (int)cudaGetLastError();
}

template <int EPI>
int gemm(const bf16* A, const bf16* W, int M, int N, int K,
         const EpiArgs& ep, cudaStream_t s) {
    return N % 256 == 0 ? launch_gemm<EPI, 256>(A, W, M, N, K, ep, s)
                        : launch_gemm<EPI, 128>(A, W, M, N, K, ep, s);
}

template <typename T>
int layernorm(const T* x, const float* g, const float* b, bf16* y, int M,
              int D, float eps, cudaStream_t s) {
    layernorm_kernel<T><<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, s>>>(
        x, g, b, y, M, D, eps);
    return (int)cudaGetLastError();
}

bool bad_width(int M, int D) { return M < 1 || D < 64 || D % 64 != 0; }

}  // namespace

extern "C" {

// K4.  x: (M, D) bf16 stream; g, b: (D,) f32 (ln1); w: (3D, D) bf16, the
// packed [Wq; Wk; Wv] rows; bias: (3D,) f32; y: (M, D) bf16 scratch;
// q, k, v: (M, D) bf16 outputs.  Takes any M >= 1 and D % 64 == 0.
int vit_qkv_forward(const void* x, const void* g, const void* b,
                    const void* w, const void* bias, void* y, void* q,
                    void* k, void* v, int M, int D, float eps, void* stream) {
    if (bad_width(M, D)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int e = layernorm<bf16>(static_cast<const bf16*>(x),
                            static_cast<const float*>(g),
                            static_cast<const float*>(b),
                            static_cast<bf16*>(y), M, D, eps, s);
    if (e) return e;
    EpiArgs ep = {};
    ep.bias = static_cast<const float*>(bias);
    ep.q = static_cast<bf16*>(q);
    ep.k = static_cast<bf16*>(k);
    ep.v = static_cast<bf16*>(v);
    ep.split = D;
    return gemm<EPI_QKV>(static_cast<const bf16*>(y),
                         static_cast<const bf16*>(w), M, 3 * D, D, ep, s);
}

// K6.  x, ctx: (M, D) bf16; wo: (D, D) bf16, bo: (D,) f32; g2, b2ln: (D,)
// f32 (ln2); w1: (H, D) bf16, b1: (H,) f32; w2: (D, H) bf16, b2: (D,) f32;
// scratch r: (M, D) f32, y: (M, D) bf16, h: (M, H) bf16; out: (M, D) bf16.
// quick != 0 selects QuickGELU.  Takes any M >= 1, D % 64 == 0 and
// H % 64 == 0.
int vit_out_mlp_forward(const void* x, const void* ctx, const void* wo,
                        const void* bo, const void* g2, const void* b2ln,
                        const void* w1, const void* b1, const void* w2,
                        const void* b2, void* r, void* y, void* h, void* out,
                        int M, int D, int H, float eps, int quick,
                        void* stream) {
    if (bad_width(M, D) || H < 64 || H % 64 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    EpiArgs ep = {};
    ep.bias = static_cast<const float*>(bo);
    ep.res_bf16 = static_cast<const bf16*>(x);
    ep.out_f32 = static_cast<float*>(r);
    int e = gemm<EPI_RES_F32>(static_cast<const bf16*>(ctx),
                              static_cast<const bf16*>(wo), M, D, D, ep, s);
    if (e) return e;
    e = layernorm<float>(static_cast<const float*>(r),
                         static_cast<const float*>(g2),
                         static_cast<const float*>(b2ln),
                         static_cast<bf16*>(y), M, D, eps, s);
    if (e) return e;
    ep = EpiArgs{};
    ep.bias = static_cast<const float*>(b1);
    ep.out_bf16 = static_cast<bf16*>(h);
    e = quick ? gemm<EPI_GELU_QUICK>(static_cast<const bf16*>(y),
                                     static_cast<const bf16*>(w1), M, H, D,
                                     ep, s)
              : gemm<EPI_GELU>(static_cast<const bf16*>(y),
                               static_cast<const bf16*>(w1), M, H, D, ep, s);
    if (e) return e;
    ep = EpiArgs{};
    ep.bias = static_cast<const float*>(b2);
    ep.res_f32 = static_cast<const float*>(r);
    ep.out_bf16 = static_cast<bf16*>(out);
    return gemm<EPI_RES_OUT>(static_cast<const bf16*>(h),
                             static_cast<const bf16*>(w2), M, D, H, ep, s);
}

// One product of the two entries above alone, for timing it: a (M, K) @
// w (N, K)^T with the epilogue `product` (0 qkv into one (M, N) bf16 out;
// 1 out-projection, res bf16, out f32; 2 fc1 + erf GELU, 3 fc1 +
// QuickGELU, out bf16; 4 fc2, res f32, out bf16); bias (N,) f32.  Takes any
// M >= 1, N % 64 == 0 and K % 64 == 0.
int vit_block_gemm(int product, const void* a, const void* w,
                   const void* bias, const void* res, void* out, int M, int N,
                   int K, void* stream) {
    if (bad_width(M, N) || bad_width(M, K) || product < EPI_QKV
        || product > EPI_RES_OUT)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* W = static_cast<const bf16*>(w);
    EpiArgs ep = {};
    ep.bias = static_cast<const float*>(bias);
    ep.res_bf16 = static_cast<const bf16*>(res);
    ep.res_f32 = static_cast<const float*>(res);
    ep.out_f32 = static_cast<float*>(out);
    ep.out_bf16 = static_cast<bf16*>(out);
    ep.q = ep.k = ep.v = static_cast<bf16*>(out);   // all of it in q
    ep.split = N;
    switch (product) {
        case EPI_QKV: return gemm<EPI_QKV>(A, W, M, N, K, ep, s);
        case EPI_RES_F32: return gemm<EPI_RES_F32>(A, W, M, N, K, ep, s);
        case EPI_GELU: return gemm<EPI_GELU>(A, W, M, N, K, ep, s);
        case EPI_GELU_QUICK: return gemm<EPI_GELU_QUICK>(A, W, M, N, K, ep, s);
        default: return gemm<EPI_RES_OUT>(A, W, M, N, K, ep, s);
    }
}

// bytes of dynamic shared memory a block of the GEMM takes with the
// epilogue `product` (as vit_block_gemm) and BN = bn (256 or 128); 0 for
// any other
int vit_block_gemm_smem(int product, int bn) {
    const bool wide = bn == 256;
    if (bn != 256 && bn != 128) return 0;
    switch (product) {
        case EPI_QKV: return wide ? Layout<EPI_QKV, 256>::SMEM
                                  : Layout<EPI_QKV, 128>::SMEM;
        case EPI_RES_F32: return wide ? Layout<EPI_RES_F32, 256>::SMEM
                                      : Layout<EPI_RES_F32, 128>::SMEM;
        case EPI_GELU: return wide ? Layout<EPI_GELU, 256>::SMEM
                                   : Layout<EPI_GELU, 128>::SMEM;
        case EPI_GELU_QUICK: return wide ? Layout<EPI_GELU_QUICK, 256>::SMEM
                                         : Layout<EPI_GELU_QUICK, 128>::SMEM;
        case EPI_RES_OUT: return wide ? Layout<EPI_RES_OUT, 256>::SMEM
                                      : Layout<EPI_RES_OUT, 128>::SMEM;
        default: return 0;
    }
}

// registers a thread of the GEMM's consumer (consumer != 0) or producer
// warpgroup holds after setmaxnreg
int vit_block_gemm_maxnreg(int consumer) {
    return consumer ? CONSUMER_REGS : PRODUCER_REGS;
}

}  // extern "C"
