// Folded multi-step GGNN propagation (backward) for NVIDIA Hopper, sm_90a.
//
// Replaces K3, the TPU kernel `_folded_kernel_bwd` in
// situation_recognition_tpu/ops/ggnn_pallas.py (driven there by
// `_pallas_bwd`).  Given the cotangent g of the propagate's output and the
// per-step residuals that K2 (`ggnn_folded_forward_res` in
// csrc/ggnn_folded.cu) stored -- the step's input h, and bf16 z, r, c --
// it runs the reverse steps t = steps-1 .. 0:
//
//   dz    = dh (c - h)          dc = dh z          dprev = dh (1 - z)
//   da_c  = dc (1 - c^2)
//   drh   = bf16(da_c) @ Uh^T
//   dprev += drh r              dr = drh h
//   da_z  = dz z (1 - z)        da_r = dr r (1 - r)
//   da[t] = bf16([da_z | da_r | da_c])                        (M, 3d)
//   dagg  = bf16(da[t] @ Wa^T)
//   dh    = dprev + E @ dagg + da[t][:, :2d] @ Uzr^T
//
// with dh kept in f32 between steps and cast to bf16 once at the end, E the
// per-example block adjacency of the forward (E is symmetric), and the
// gate chain in f32: the numerics of the TPU kernel.  The parameter
// gradients (three stacked products over the steps' rows) are left to the
// caller, as the JAX package leaves them to XLA.
//
// What bounds it on this card.  Per step 12 M d^2 FLOP of bf16 products
// (drh 2, dagg 6, da_zr @ Uzr^T 4) against 6 d^2 bf16 weights, so at
// training batches it is bound by the tensor cores, like the forward.  The
// TPU kernel runs all steps for a block of whole examples with the
// transposed weights resident in VMEM; here, as in the forward, each
// reverse step has two products that need a whole row before they can
// start -- drh needs da_c across all d columns, dagg needs da across all
// 3d -- so a step is two launches over a (column tile) x (row tile) grid,
// with the launch boundary as the synchronisation:
//
//   ggnn_bwd_a_kernel  forms bf16(da_c) from dh, z and c while loading each
//                      A tile, accumulates drh for its columns (WMMA bf16,
//                      f32 sums), then runs the elementwise chain and
//                      writes da[t] (bf16) and dprev (f32 scratch);
//   ggnn_bwd_b_kernel  accumulates da[t] @ Wa^T and da[t][:, :2d] @ Uzr^T
//                      for its columns, rounds the first to bf16 before
//                      applying E (row tiles hold whole examples, so E acts
//                      inside the tile), and writes the next dh (f32; bf16
//                      on the last step).
//
// The transposed weights (Wa^T (3d, d), Uzr^T (2d, d), Uh^T (d, d)) are
// given contiguous by the caller and stream from L2.  Simple first design,
// as the forward: single-buffered shared-memory tiles and WMMA, not TMA and
// wgmma; PERF.md keeps its time beside the bound.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, nothing is synchronised or allocated here, and the function
// returns cudaGetLastError() of the first launch that failed (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows of a tile
constexpr int BN = 64;        // columns of a tile (of d)
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns), 32 x 16 each
constexpr int A_LD = BK + 8;  // bf16 leading dimensions (multiples of 8)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // f32 staging leading dimension (multiple of 4)
constexpr int PER_THREAD = BM * BN / THREADS;  // epilogue elements a thread

constexpr int A_TILE = BM * A_LD;   // elements
constexpr int B_TILE = BK * B_LD;

constexpr int A_SMEM = (A_TILE + B_TILE) * 2;
constexpr int B_SMEM = (A_TILE + 2 * B_TILE) * 2;
constexpr int STAGE_SMEM = BM * C_LD * 4;
constexpr int A_BYTES = A_SMEM > STAGE_SMEM ? A_SMEM : STAGE_SMEM;
constexpr int B_BYTES = B_SMEM > STAGE_SMEM ? B_SMEM : STAGE_SMEM;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void copy8(bf16* dst, const bf16* src) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero8(bf16* dst) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void stage(float* cs, const FragC (&acc)[2],
                                      int wr, int wc) {
    for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * C_LD + wc * 16,
                                acc[i], C_LD, wmma::mem_row_major);
}

__device__ __forceinline__ float bf(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// the candidate pre-activation cotangent, formed the same way where the A
// tile is loaded and in the epilogue
__device__ __forceinline__ float da_c_of(float dh, float z, float c) {
    const float dc = dh * z;
    return dc * (1.f - c * c);
}

// Launch A of a reverse step: drh = bf16(da_c) @ Uh^T for this block's
// columns, then the gate chain.  dh (M, d) f32; h, z, r, c (M, d) bf16 of
// step t; uh_t (d, d) bf16; writes dprev (M, d) f32 and da (M, 3d) bf16.
__global__ void __launch_bounds__(THREADS)
ggnn_bwd_a_kernel(const float* __restrict__ dh, const bf16* __restrict__ h,
                  const bf16* __restrict__ z, const bf16* __restrict__ rr,
                  const bf16* __restrict__ c, const bf16* __restrict__ uh_t,
                  float* __restrict__ dprev, bf16* __restrict__ da, int M,
                  int d) {
    __shared__ __align__(128) unsigned char smem[A_BYTES];
    bf16* a_t = reinterpret_cast<bf16*>(smem);
    bf16* b_t = a_t + A_TILE;
    float* cs = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wr = warp >> 2, wc = warp & 3;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;
    const int a_row = tid >> 2, a_col = (tid & 3) * 8;
    const int gi = m0 + a_row;
    const int b_row = tid >> 3, b_col = (tid & 7) * 8;

    FragC acc[2];
    for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[i], 0.f);

    for (int k0 = 0; k0 < d; k0 += BK) {
        bf16* dst = a_t + a_row * A_LD + a_col;
        if (gi < M) {
            const size_t o = (size_t)gi * d + k0 + a_col;
            const float4 d0 = *reinterpret_cast<const float4*>(dh + o);
            const float4 d1 = *reinterpret_cast<const float4*>(dh + o + 4);
            const float dv[8] = {d0.x, d0.y, d0.z, d0.w,
                                 d1.x, d1.y, d1.z, d1.w};
            uint4 zraw = *reinterpret_cast<const uint4*>(z + o);
            uint4 craw = *reinterpret_cast<const uint4*>(c + o);
            const bf16* zv = reinterpret_cast<const bf16*>(&zraw);
            const bf16* cv = reinterpret_cast<const bf16*>(&craw);
            for (int q = 0; q < 8; ++q)
                dst[q] = __float2bfloat16(da_c_of(
                    dv[q], __bfloat162float(zv[q]), __bfloat162float(cv[q])));
        } else {
            zero8(dst);
        }
        copy8(b_t + b_row * B_LD + b_col,
              uh_t + ((size_t)k0 + b_row) * d + n0 + b_col);
        __syncthreads();
        for (int kk = 0; kk < BK; kk += 16) {
            FragB fb;
            wmma::load_matrix_sync(fb, b_t + kk * B_LD + wc * 16, B_LD);
            for (int i = 0; i < 2; ++i) {
                FragA fa;
                wmma::load_matrix_sync(fa, a_t + (wr * 32 + i * 16) * A_LD + kk, A_LD);
                wmma::mma_sync(acc[i], fa, fb, acc[i]);
            }
        }
        __syncthreads();
    }

    stage(cs, acc, wr, wc);
    __syncthreads();
    const size_t d3 = 3 * (size_t)d;
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int row = idx / BN, col = idx % BN;
        const int gr = m0 + row;
        if (gr >= M) continue;
        const int gc = n0 + col;
        const size_t o = (size_t)gr * d + gc;
        const float g = dh[o];
        const float hv = __bfloat162float(h[o]);
        const float zv = __bfloat162float(z[o]);
        const float rv = __bfloat162float(rr[o]);
        const float cv = __bfloat162float(c[o]);
        const float drh = cs[row * C_LD + col];
        const float dz = g * (cv - hv);
        float dp = g * (1.f - zv);
        const float dac = da_c_of(g, zv, cv);
        dp += drh * rv;
        const float dr = drh * hv;
        const float daz = dz * zv * (1.f - zv);
        const float dar = dr * rv * (1.f - rv);
        dprev[o] = dp;
        bf16* row_da = da + (size_t)gr * d3;
        row_da[gc] = __float2bfloat16(daz);
        row_da[d + gc] = __float2bfloat16(dar);
        row_da[2 * (size_t)d + gc] = __float2bfloat16(dac);
    }
}

// Launch B of a reverse step: dh = dprev + E @ bf16(da @ Wa^T)
// + da[:, :2d] @ Uzr^T for this block's columns.  A row tile holds
// `rows` = (BM / r) * r rows, whole examples, so E (at most r x r within an
// example) acts inside the tile.  dh_out (M, d) bf16: written as well when
// not null (the last reverse step).
__global__ void __launch_bounds__(THREADS)
ggnn_bwd_b_kernel(const bf16* __restrict__ da, const float* __restrict__ mask,
                  const bf16* __restrict__ wa_t, const bf16* __restrict__ uzr_t,
                  const float* __restrict__ dprev, float* __restrict__ dh,
                  bf16* __restrict__ dh_out, int M, int d, int r, int rows) {
    __shared__ __align__(128) unsigned char smem[B_BYTES];
    bf16* a_t = reinterpret_cast<bf16*>(smem);
    bf16* b_wa = a_t + A_TILE;
    bf16* b_uzr = b_wa + B_TILE;
    float* cs = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wr = warp >> 2, wc = warp & 3;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * rows;
    const int a_row = tid >> 2, a_col = (tid & 3) * 8;
    const int gi = m0 + a_row;
    const bool a_ok = a_row < rows && gi < M;
    const int b_row = tid >> 3, b_col = (tid & 7) * 8;
    const size_t d3 = 3 * (size_t)d;
    const int d2 = 2 * d;

    FragC acc_a[2], acc_u[2];   // da @ Wa^T, da[:, :2d] @ Uzr^T
    for (int i = 0; i < 2; ++i) {
        wmma::fill_fragment(acc_a[i], 0.f);
        wmma::fill_fragment(acc_u[i], 0.f);
    }

    for (int k0 = 0; k0 < 3 * d; k0 += BK) {
        const bool zr = k0 < d2;   // uniform over the block
        bf16* dst = a_t + a_row * A_LD + a_col;
        if (a_ok)
            copy8(dst, da + (size_t)gi * d3 + k0 + a_col);
        else
            zero8(dst);
        const size_t gk = (size_t)k0 + b_row;
        copy8(b_wa + b_row * B_LD + b_col, wa_t + gk * d + n0 + b_col);
        if (zr)
            copy8(b_uzr + b_row * B_LD + b_col, uzr_t + gk * d + n0 + b_col);
        __syncthreads();
        for (int kk = 0; kk < BK; kk += 16) {
            FragA fa[2];
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], a_t + (wr * 32 + i * 16) * A_LD + kk, A_LD);
            FragB fb;
            const int boff = kk * B_LD + wc * 16;
            wmma::load_matrix_sync(fb, b_wa + boff, B_LD);
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_a[i], fa[i], fb, acc_a[i]);
            if (zr) {
                wmma::load_matrix_sync(fb, b_uzr + boff, B_LD);
                for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_u[i], fa[i], fb, acc_u[i]);
            }
        }
        __syncthreads();
    }

    // E @ bf16(dagg): the staged dagg tile holds every row of each example
    // of the tile
    stage(cs, acc_a, wr, wc);
    __syncthreads();
    float edagg[PER_THREAD];
    for (int q = 0; q < PER_THREAD; ++q) {
        const int idx = tid + q * THREADS;
        const int row = idx / BN, col = idx % BN;
        const int gr = m0 + row;
        float s = 0.f;
        if (row < rows && gr < M) {
            const int ex = (row / r) * r;   // local start of the example
            const float mi = mask[gr];
            for (int j = 0; j < r; ++j) {
                const int gj = m0 + ex + j;
                const float mj = mask[gj];
                float e = mi * mj + (gj == gr ? 1.f - 2.f * mi : 0.f);
                e = bf(e);
                if (e == 0.f) continue;
                s += e * bf(cs[(ex + j) * C_LD + col]);
            }
        }
        edagg[q] = s;
    }
    __syncthreads();
    stage(cs, acc_u, wr, wc);
    __syncthreads();
    for (int q = 0; q < PER_THREAD; ++q) {
        const int idx = tid + q * THREADS;
        const int row = idx / BN, col = idx % BN;
        const int gr = m0 + row;
        if (row >= rows || gr >= M) continue;
        const size_t o = (size_t)gr * d + n0 + col;
        const float v = (dprev[o] + edagg[q]) + cs[row * C_LD + col];
        dh[o] = v;
        if (dh_out != nullptr) dh_out[o] = __float2bfloat16(v);
    }
}

}  // namespace

extern "C" {

// K3.  dh: (M, d) f32, holds the cotangent of the output on entry (g cast
// to f32) and is used as scratch.  mask: (M,) f32.  res_h, res_z, res_r,
// res_c: (steps, M, d) bf16 from K2.  wa_t: (3d, d), uzr_t: (2d, d),
// uh_t: (d, d) bf16, the transposed folded weights.  dprev: (M, d) f32
// scratch.  Writes da: (steps, M, 3d) bf16 and dh_out: (M, d) bf16.
// Takes any M >= 1 that is a multiple of r, r <= 64, any d that is a
// multiple of 64 and steps >= 1.  Returns 0, or the CUDA error of the first
// failed launch.
int ggnn_folded_backward(void* dh, const void* mask, const void* res_h,
                         const void* res_z, const void* res_r,
                         const void* res_c, const void* wa_t,
                         const void* uzr_t, const void* uh_t, void* dprev,
                         void* da, void* dh_out, int M, int d, int r,
                         int steps, void* stream) {
    if (M < 1 || r < 1 || r > BM || M % r != 0 || d < BN || d % BN != 0
        || steps < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows = (BM / r) * r;
    const dim3 grid_a(d / BN, (M + BM - 1) / BM);
    const dim3 grid_b(d / BN, (M + rows - 1) / rows);
    if (grid_b.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    const size_t plane = (size_t)M * d;
    float* dh_f = static_cast<float*>(dh);
    float* dprev_f = static_cast<float*>(dprev);
    const float* mask_f = static_cast<const float*>(mask);
    for (int t = steps - 1; t >= 0; --t) {
        const size_t off = (size_t)t * plane;
        bf16* da_t = static_cast<bf16*>(da) + 3 * off;
        ggnn_bwd_a_kernel<<<grid_a, THREADS, 0, s>>>(
            dh_f, static_cast<const bf16*>(res_h) + off,
            static_cast<const bf16*>(res_z) + off,
            static_cast<const bf16*>(res_r) + off,
            static_cast<const bf16*>(res_c) + off,
            static_cast<const bf16*>(uh_t), dprev_f, da_t, M, d);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        ggnn_bwd_b_kernel<<<grid_b, THREADS, 0, s>>>(
            da_t, mask_f, static_cast<const bf16*>(wa_t),
            static_cast<const bf16*>(uzr_t), dprev_f, dh_f,
            t == 0 ? static_cast<bf16*>(dh_out) : nullptr, M, d, r, rows);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // extern "C"
