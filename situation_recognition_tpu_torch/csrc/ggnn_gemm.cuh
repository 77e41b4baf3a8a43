// The persistent wgmma GEMM of the folded GGNN kernels for Hopper
// (sm_90a), shared by ggnn_folded.cu (K1/K2: a forward step's gate and
// candidate products) and ggnn_folded_bwd.cu (K3: a reverse step's drh,
// dagg and dh products).  Each source brings its epilogues.
//
// It is vit_block.cu's design: one persistent block per SM walking output
// tiles b, b + gridDim.x, ... with the row tiles of a column tile
// consecutive (the blocks of a wave share the weight tiles in L2); a
// producer warpgroup whose one thread issues TMA loads of 64-deep stages
// into a ring of 128-byte-swizzled stages with full and empty mbarriers;
// two consumer warpgroups on wgmma from shared-memory descriptors, one
// commit group in flight, each taking 64 rows of a 128-row tile or half
// the columns of a 64-row tile (so that two streams of products feed the
// tensor cores either way); setmaxnreg moves registers from the producer
// to them.  Epilogues work on the accumulator in registers.
//
// The K loop runs over two pairs of tensor maps: k0 stages from (ta0,
// tb0), then k1 from (ta1, tb1) (k1 = 0 for a single pair).  Every stage
// has boxes of BM rows of A and BN rows of B, 64 deep, so every stage
// expects the same bytes; TMA counts the whole box where it zero-fills
// rows past the edge.  A is (M, K) row-major (any row stride the map
// states), B is K-major: (n, K) row-major, row j giving output column j.
//
// Tiles: rows BM in {64, 128}, columns BN in {64, 128, 256}, chosen on the
// host and passed in.  ptxas allocates registers within the launch bound
// whatever setmaxnreg grants, so every instantiation keeps 384 threads
// (168 registers a thread; 40 for the producer and 232 for the consumers
// after setmaxnreg).

#pragma once

#include "hopper.cuh"

namespace {

constexpr int GEMM_THREADS = 384;   // producer warpgroup + 2 consumer ones
// registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take (128 x 40 + 256 x 232 = 384 x 168, the launch bound)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Shared memory of ggnn_gemm_kernel<KIND, BM, BN, Args>: 1024 bytes to
// align the ring, the ring, and its mbarriers.  A stage holds BM rows of A
// and BN rows of B, each 64 deep.  WN: the output columns of one consumer
// warpgroup.
template <int BM, int BN>
struct Layout {
    static constexpr int WN = BM == 128 ? BN : BN / 2;
    static constexpr int A_BYTES = BM * BK * 2;
    static constexpr int STAGE = A_BYTES + BN * BK * 2;
    // a block takes at most 232,448 bytes; 16 a stage for its barriers.
    // Up to 8 stages: at the verb shape, where each block streams its
    // weight tiles, 8 ran 6-20% faster than 6 (PERF.md §6)
    static constexpr int FIT = (232448 - 1024) / (STAGE + 16);
    static constexpr int STAGES = FIT < 8 ? FIT : 8;
    static constexpr int SMEM = 1024 + STAGES * (STAGE + 16);
    static_assert(STAGE % 1024 == 0 && STAGES >= 4, "ring");
};

// One GEMM launch: M rows, n output columns (a multiple of BN), and the K
// loop's k0 stages from the first pair of maps and k1 from the second.
struct GemmShape {
    int M, n, k0, k1;
};

// The GEMM on tiles of BM x BN.  Args (a source's own) carries what the
// epilogues read and write, and the member template
//   template <int KIND, int WN> void epilogue(const float (&acc)[WN / 2],
//                                             int row0, int n0) const;
// which gets one consumer warpgroup's 64 rows by WN columns: this
// thread's rows row0 and row0 + 8, the first column n0, the accumulator
// in wgmma's fragment layout (hopper.cuh).  It may get rows past M.
template <int KIND, int BM, int BN, class Args>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
ggnn_gemm_kernel(const __grid_constant__ CUtensorMap ta0,
                 const __grid_constant__ CUtensorMap tb0,
                 const __grid_constant__ CUtensorMap ta1,
                 const __grid_constant__ CUtensorMap tb1, GemmShape sh,
                 Args ep) {
    using L = Layout<BM, BN>;
    constexpr int WN = L::WN, STAGE = L::STAGE, STAGES = L::STAGES;
    extern __shared__ uint8_t smem_raw[];
    // the 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * STAGE, empty = full + 8 * STAGES;
    const int wg = threadIdx.x >> 7;
    const int depth = sh.k0 + sh.k1;
    const int m_tiles = (sh.M + BM - 1) / BM;
    const int tiles = m_tiles * (sh.n / BN);

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
                const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
                for (int kt = 0; kt < depth; ++kt, ++it) {
                    const int s = it % STAGES;
                    if (it >= STAGES)
                        mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
                    const uint32_t a = ring + s * STAGE, bar = full + 8 * s;
                    const bool first = kt < sh.k0;
                    const int k = (first ? kt : kt - sh.k0) * BK;
                    mbar_expect_tx(bar, STAGE);
                    tma_load(a, first ? &ta0 : &ta1, k, m0, bar);
                    tma_load(a + L::A_BYTES, first ? &tb0 : &tb1, k, n0, bar);
                }
            }
        }
    } else {
        setmaxnreg_inc<CONSUMER_REGS>();
        // consumer c takes rows 64c .. 64c + 63 of a 128-row tile, or
        // columns WN c .. WN c + WN - 1 of a 64-row tile
        const int c = wg - 1;
        const int a_off = BM == 128 ? c * 64 * BK * 2 : 0;
        const int b_off = BM == 128 ? 0 : c * WN * BK * 2;
        const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        int it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = (t % m_tiles) * BM, n = t / m_tiles;
            float acc[WN / 2];
#pragma unroll
            for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
            fence_acc(acc);
            for (int kt = 0; kt < depth; ++kt, ++it) {
                const int s = it % STAGES;
                mbar_wait(full + 8 * s, (it / STAGES) & 1);
                const uint32_t a = ring + s * STAGE + a_off;
                const uint32_t b = ring + s * STAGE + L::A_BYTES + b_off;
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < BK / 16; ++k)
                    wgmma<WN>(acc, sw128_desc(a + 32 * k),
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
            const int row0 = m0 + (BM == 128 ? 64 * c : 0) + 16 * w
                             + (lane >> 2);
            const int n0 = n * BN + (BM == 128 ? 0 : c * WN);
            ep.template epilogue<KIND, WN>(acc, row0, n0);
        }
    }
}

template <int KIND, int BM, int BN, class Args>
int launch_gemm(const CUtensorMap& ta0, const CUtensorMap& tb0,
                const CUtensorMap& ta1, const CUtensorMap& tb1,
                const GemmShape& sh, const Args& ep, cudaStream_t s) {
    using L = Layout<BM, BN>;
    const long long tiles = (long long)((sh.M + BM - 1) / BM) * (sh.n / BN);
    const int sms = sm_count();
    if (sms < 1 || tiles < 1 || tiles > 0x7fffffff || sh.n % BN != 0
        || sh.k0 + sh.k1 < 1)
        return (int)cudaErrorInvalidValue;
    // once per instantiation: the ring is above the 48 KB default
    static bool sized = false;
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            ggnn_gemm_kernel<KIND, BM, BN, Args>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
        if (e != cudaSuccess) return (int)e;
        sized = true;
    }
    ggnn_gemm_kernel<KIND, BM, BN, Args>
        <<<(int)(tiles < sms ? tiles : sms), GEMM_THREADS, L::SMEM, s>>>(
            ta0, tb0, ta1, tb1, sh, ep);
    return (int)cudaGetLastError();
}

// The GEMM of KIND on tiles of bm x bn: rows 128 or 64, columns 256 or
// 128, and 64 where NARROW.  cudaErrorInvalidValue for any other tile.
template <int KIND, bool NARROW, class Args>
int launch_tiles(int bm, int bn, const CUtensorMap& ta0,
                 const CUtensorMap& tb0, const CUtensorMap& ta1,
                 const CUtensorMap& tb1, const GemmShape& sh, const Args& ep,
                 cudaStream_t s) {
#define GGNN_LAUNCH(BM, BN)                                                 \
    if (bm == BM && bn == BN)                                               \
        return launch_gemm<KIND, BM, BN, Args>(ta0, tb0, ta1, tb1, sh, ep, s);
    GGNN_LAUNCH(128, 256)
    GGNN_LAUNCH(128, 128)
    GGNN_LAUNCH(64, 256)
    GGNN_LAUNCH(64, 128)
    if constexpr (NARROW) {
        GGNN_LAUNCH(128, 64)
        GGNN_LAUNCH(64, 64)
    }
#undef GGNN_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// bytes of dynamic shared memory a block of ggnn_gemm_kernel takes on
// tiles of bm (64 or 128) x bn (64, 128 or 256) rows; 0 for any other
int gemm_smem(int bm, int bn) {
    if (bm != 64 && bm != 128) return 0;
    const bool two = bm == 128;
    switch (bn) {
        case 256:
            return two ? Layout<128, 256>::SMEM : Layout<64, 256>::SMEM;
        case 128:
            return two ? Layout<128, 128>::SMEM : Layout<64, 128>::SMEM;
        case 64:
            return two ? Layout<128, 64>::SMEM : Layout<64, 64>::SMEM;
        default:
            return 0;
    }
}

// the bf16 pair at p, as two floats, and stores of pairs
__device__ __forceinline__ uint32_t ld_b2(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void st_b2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void st_f2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

}  // namespace
