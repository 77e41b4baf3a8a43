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
// launches (277 MB and 553 MB at ViT-L/14, batch 256), where the TPU kernel
// kept them in VMEM.
//
// What bounds it on this card.  At ViT-L/14, batch 256 (M = 67,584 rows,
// D = 1024, H = 4096) K4 does 6 M D^2 and K6 18 M D^2 FLOP against well
// under a GB of traffic: both are bound by the tensor cores (0.43 ms and
// 1.29 ms at 989 TFLOP/s).  The GEMM is the simple first design: 128 x 128
// output tiles, 8 warps of 64 x 32 on WMMA bf16 16x16x16 (mma.sync), a
// depth-32 stage double-buffered with cp.async so that the next stage's
// loads overlap this one's products, and the epilogue staged through a
// 1 KB shared-memory fragment per warp so that each lane stores 8 adjacent
// outputs (16 bytes).  Not TMA and wgmma; PERF.md keeps its time beside the
// bound.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, nothing is synchronised or allocated here, and each function
// returns cudaGetLastError() of the first launch that failed (0 on
// success), or cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;        // rows of an output tile
constexpr int BN = 128;        // columns of an output tile
constexpr int BK = 32;         // depth of one shared-memory stage
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
constexpr int LDS = BK + 8;    // bf16 leading dimension of a staged tile
constexpr int TILE = BM * LDS; // elements of one A (or B) stage; BN == BM
constexpr int LN_WARPS = 8;    // rows per LayerNorm block, one warp each

enum Epi { EPI_QKV, EPI_RES_F32, EPI_GELU, EPI_GELU_QUICK, EPI_RES_OUT };

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

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// 16-byte asynchronous copy global -> shared; with pred false the 16
// destination bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

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

// 8 adjacent outputs (row gm, columns gn .. gn+7) of accumulator values v.
template <int EPI>
__device__ __forceinline__ void epilogue(const EpiArgs& ep, float (&v)[8],
                                         int gm, int gn, int N) {
    float bias[8];
    load8(ep.bias + gn, bias);
    const size_t o = (size_t)gm * N + gn;
    if (EPI == EPI_QKV) {
        const int which = gn / ep.split;
        bf16* dst = which == 0 ? ep.q : (which == 1 ? ep.k : ep.v);
        for (int i = 0; i < 8; ++i) v[i] += bias[i];
        store8(dst + (size_t)gm * ep.split + (gn - which * ep.split), v);
    } else if (EPI == EPI_RES_F32) {
        float r[8];
        load8(ep.res_bf16 + o, r);
        for (int i = 0; i < 8; ++i) v[i] = (r[i] + v[i]) + bias[i];
        store8(ep.out_f32 + o, v);
    } else if (EPI == EPI_GELU) {
        for (int i = 0; i < 8; ++i) {
            const float t = v[i] + bias[i];
            v[i] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
        }
        store8(ep.out_bf16 + o, v);
    } else if (EPI == EPI_GELU_QUICK) {
        for (int i = 0; i < 8; ++i) {
            const float t = v[i] + bias[i];
            v[i] = t * (1.f / (1.f + expf(-1.702f * t)));
        }
        store8(ep.out_bf16 + o, v);
    } else {  // EPI_RES_OUT
        float r[8];
        load8(ep.res_f32 + o, r);
        for (int i = 0; i < 8; ++i) v[i] = (r[i] + v[i]) + bias[i];
        store8(ep.out_bf16 + o, v);
    }
}

// C = A @ W^T with the epilogue EPI.  A (M, K), W (N, K), both bf16
// row-major.  Takes any M >= 1, N % 8 == 0, K % 32 == 0.
template <int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
               int M, int N, int K, EpiArgs ep) {
    __shared__ __align__(128) bf16 smem[4 * TILE];
    bf16* As = smem;             // [2][BM][LDS]
    bf16* Bs = smem + 2 * TILE;  // [2][BN][LDS]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wr = warp >> 2, wc = warp & 3;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    // each thread copies 2 x 16 bytes of the A stage and of the B stage
    auto load_stage = [&](int stage, int k0) {
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * THREADS;
            const int row = c >> 2, col = (c & 3) * 8;
            const int gm = m0 + row, gn = n0 + row;
            const bool ok_a = gm < M, ok_b = gn < N;
            cp_async16(As + stage * TILE + row * LDS + col,
                       ok_a ? A + (size_t)gm * K + k0 + col : A, ok_a);
            cp_async16(Bs + stage * TILE + row * LDS + col,
                       ok_b ? W + (size_t)gn * K + k0 + col : W, ok_b);
        }
    };

    FragC acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const int kt_n = K / BK;
    load_stage(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < kt_n; ++kt) {
        if (kt + 1 < kt_n) {
            load_stage((kt + 1) & 1, (kt + 1) * BK);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* a = As + (kt & 1) * TILE;
        const bf16* b = Bs + (kt & 1) * TILE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragA fa[4];
            FragBt fb[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                wmma::load_matrix_sync(fa[i], a + (wr * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], b + (wc * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        // every warp is done with this stage before the next iteration
        // starts overwriting it
        __syncthreads();
    }

    // epilogue: one 16 x 16 fragment at a time through this warp's 1 KB of
    // the (now free) stage memory; lane l takes row l/2, 8 columns
    float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
    const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int gm = m0 + wr * 64 + i * 16 + r;
            const int gn = n0 + wc * 32 + j * 16 + c8;
            if (gm < M && gn < N) {
                float v[8];
                for (int q = 0; q < 8; ++q) v[q] = scratch[r * 16 + c8 + q];
                epilogue<EPI>(ep, v, gm, gn, N);
            }
            __syncwarp();
        }
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

template <int EPI>
int gemm(const bf16* A, const bf16* W, int M, int N, int K,
         const EpiArgs& ep, cudaStream_t s) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    gemm_nt_kernel<EPI><<<grid, THREADS, 0, s>>>(A, W, M, N, K, ep);
    return (int)cudaGetLastError();
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

}  // extern "C"
