// Folded multi-step GGNN propagation (forward) for NVIDIA Hopper, sm_90a.
//
// Replaces two TPU kernels of situation_recognition_tpu/ops/ggnn_pallas.py:
//   K1 `_folded_kernel` (driven by `ggnn_propagate_fused` /
//      `_propagate_fwd_impl`)        -> entry `ggnn_folded_forward`;
//   K2 `_folded_kernel_res` (driven by `_propagate_fwd_res_impl`), the same
//      forward that also writes each step's residuals for the backward
//      kernel (csrc/ggnn_folded_bwd.cu)  -> entry `ggnn_folded_forward_res`.
// The two entries launch the same kernels; K2's instantiation (RES = true)
// adds the residual stores to the epilogues and nothing else.  For rows of whole
// examples (r rows each) it runs `steps` GGNN steps with W_p folded into
// the gate weights (see `fold_gate_weights` in ops/ggnn_kernel.py):
//
//   E    = same_example * m m^T + diag(1 - 2m)       (block adjacency)
//   agg  = bf16(E @ h)
//   z    = sigmoid(agg @ WpWz + h @ Uz + bz)
//   r    = sigmoid(agg @ WpWr + h @ Ur + br)
//   c    = tanh   (agg @ WpWh + bf16(r * h) @ Uh + bc)
//   h'   = bf16((1 - z) h + z c)
//
// bf16 operands, f32 accumulation, gates in f32, h kept in bf16 between
// steps: the numerics of the TPU kernel.
//
// What bounds it on this card.  Per step the work is 12 M d^2 FLOP of bf16
// products against 6 d^2 bf16 weights (50 MB at d=2048), so at serving
// batches (M = B*R in the hundreds to thousands) it is bound by the tensor
// cores, not by memory.  The TPU design keeps all folded weights resident
// on chip and runs every step inside one grid block; a Hopper block has at
// most 227 KB of shared memory, so the weights cannot stay resident, and
// the candidate gate needs (r*h) across all d columns of a row before
// `@ Uh`, so one step cannot be split over column tiles without a
// synchronisation.  The design therefore spends two launches per step over
// a (column tile) x (row tile) grid, with the launch boundary as the
// synchronisation:
//
//   ggnn_gate_kernel  forms agg on the fly while loading each row tile
//                     (E is at most r x r within an example), accumulates
//                     [agg | h] @ [[WpWz WpWr WpWh], [Uz Ur 0]] for its
//                     columns in f32 on the tensor cores (WMMA bf16
//                     16x16x16), and writes z (f32), r*h (bf16) and the
//                     candidate pre-activation (f32) to scratch;
//   ggnn_cand_kernel  computes tanh(pre + (r*h) @ Uh) and updates h in
//                     place (each element of h is read and written only by
//                     the block that owns its tile).
//
// K2's residuals, each a (steps, M, d) bf16 stack: rh[t] is the step's
// input h (copied by the gate kernel, which reads h and never writes it),
// z[t] and r[t] are bf16 copies of the gates (r*h is still formed from
// the f32 r), and c[t] is the bf16 candidate, stored by the candidate
// kernel.  They add 8 M d bytes of writes per step (101 MB over 4 steps at
// M = 1536, d = 2048: 0.03 ms at 3.35 TB/s against 0.31 ms of products).
//
// The weights stream from L2 (they fit in its 50 MB at d=2048).  This is
// the simple first design: single-buffered shared-memory tiles and WMMA,
// not TMA and wgmma; PERF.md keeps its time beside the bound.
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

constexpr int A_TILE = BM * A_LD;   // elements
constexpr int B_TILE = BK * B_LD;

constexpr int GATE_SMEM = (2 * A_TILE + 5 * B_TILE) * 2;
constexpr int CAND_SMEM = (A_TILE + B_TILE) * 2;
constexpr int STAGE_SMEM = BM * C_LD * 4;
// shared memory of each kernel: its operand tiles, reused as the f32
// staging tile of the epilogue
constexpr int GATE_BYTES = GATE_SMEM > STAGE_SMEM ? GATE_SMEM : STAGE_SMEM;
constexpr int CAND_BYTES = CAND_SMEM > STAGE_SMEM ? CAND_SMEM : STAGE_SMEM;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float sigmoidf_(float x) {
    return 1.f / (1.f + expf(-x));
}

// Copy 8 bf16 (16 bytes) of row `k` of a row-major (rows, ld) matrix,
// columns [col, col + 8), into shared memory.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero8(bf16* dst) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Stage one 16x16 accumulator pair (rows wr*32 + {0,16}, columns wc*16) of
// every warp into the f32 staging tile.
__device__ __forceinline__ void stage(float* cs, const FragC (&acc)[2],
                                      int wr, int wc) {
    for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * C_LD + wc * 16,
                                acc[i], C_LD, wmma::mem_row_major);
}

// RES: also store the step's residuals res_h (input h), res_z, res_r
template <bool RES>
__global__ void __launch_bounds__(THREADS)
ggnn_gate_kernel(const bf16* __restrict__ h, const float* __restrict__ mask,
                 const bf16* __restrict__ wa, const bf16* __restrict__ uzr,
                 const float* __restrict__ ba, float* __restrict__ z_out,
                 bf16* __restrict__ rh_out, float* __restrict__ gc_out,
                 bf16* __restrict__ res_h, bf16* __restrict__ res_z,
                 bf16* __restrict__ res_r, int M, int d, int r) {
    __shared__ __align__(128) unsigned char smem[GATE_BYTES];
    bf16* a_agg = reinterpret_cast<bf16*>(smem);
    bf16* a_h = a_agg + A_TILE;
    bf16* b_t = a_h + A_TILE;   // 5 tiles: WpWz, WpWr, WpWh, Uz, Ur
    float* cs = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wr = warp >> 2, wc = warp & 3;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;
    const size_t d3 = 3 * (size_t)d, d2 = 2 * (size_t)d;

    // this thread's A-tile slot: one row, 8 columns
    const int a_row = tid >> 2, a_col = (tid & 3) * 8;
    const int gi = m0 + a_row;
    const bool row_ok = gi < M;
    int ex0 = 0;
    float mi = 0.f;
    if (row_ok) {
        ex0 = (gi / r) * r;
        mi = mask[gi];
    }
    // this thread's B-tile slot: one k row, 8 columns
    const int b_row = tid >> 3, b_col = (tid & 7) * 8;

    FragC acc_z[2], acc_r[2], acc_c[2];
    for (int i = 0; i < 2; ++i) {
        wmma::fill_fragment(acc_z[i], 0.f);
        wmma::fill_fragment(acc_r[i], 0.f);
        wmma::fill_fragment(acc_c[i], 0.f);
    }

    for (int k0 = 0; k0 < d; k0 += BK) {
        // ---- A tiles: h and agg = bf16(E @ h) for this row's example
        bf16* dst_h = a_h + a_row * A_LD + a_col;
        bf16* dst_a = a_agg + a_row * A_LD + a_col;
        if (row_ok) {
            const size_t kc = (size_t)k0 + a_col;
            copy8(dst_h, h + (size_t)gi * d + kc);
            float s[8];
            for (int q = 0; q < 8; ++q) s[q] = 0.f;
            for (int j = 0; j < r; ++j) {
                const int gj = ex0 + j;
                const float mj = mask[gj];
                float e = mi * mj + (gj == gi ? 1.f - 2.f * mi : 0.f);
                e = __bfloat162float(__float2bfloat16(e));
                if (e == 0.f) continue;
                uint4 raw = *reinterpret_cast<const uint4*>(h + (size_t)gj * d + kc);
                const bf16* v = reinterpret_cast<const bf16*>(&raw);
                for (int q = 0; q < 8; ++q) s[q] += e * __bfloat162float(v[q]);
            }
            for (int q = 0; q < 8; ++q) dst_a[q] = __float2bfloat16(s[q]);
        } else {
            zero8(dst_h);
            zero8(dst_a);
        }
        // ---- B tiles
        {
            const size_t gk = (size_t)k0 + b_row;
            const int off = b_row * B_LD + b_col;
            const size_t col = (size_t)n0 + b_col;
            copy8(b_t + 0 * B_TILE + off, wa + gk * d3 + col);
            copy8(b_t + 1 * B_TILE + off, wa + gk * d3 + d + col);
            copy8(b_t + 2 * B_TILE + off, wa + gk * d3 + 2 * (size_t)d + col);
            copy8(b_t + 3 * B_TILE + off, uzr + gk * d2 + col);
            copy8(b_t + 4 * B_TILE + off, uzr + gk * d2 + d + col);
        }
        __syncthreads();

        for (int kk = 0; kk < BK; kk += 16) {
            FragA fa[2], fh[2];
            for (int i = 0; i < 2; ++i) {
                wmma::load_matrix_sync(fa[i], a_agg + (wr * 32 + i * 16) * A_LD + kk, A_LD);
                wmma::load_matrix_sync(fh[i], a_h + (wr * 32 + i * 16) * A_LD + kk, A_LD);
            }
            FragB fb;
            const int boff = kk * B_LD + wc * 16;
            wmma::load_matrix_sync(fb, b_t + 0 * B_TILE + boff, B_LD);
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_z[i], fa[i], fb, acc_z[i]);
            wmma::load_matrix_sync(fb, b_t + 3 * B_TILE + boff, B_LD);
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_z[i], fh[i], fb, acc_z[i]);
            wmma::load_matrix_sync(fb, b_t + 1 * B_TILE + boff, B_LD);
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_r[i], fa[i], fb, acc_r[i]);
            wmma::load_matrix_sync(fb, b_t + 4 * B_TILE + boff, B_LD);
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_r[i], fh[i], fb, acc_r[i]);
            wmma::load_matrix_sync(fb, b_t + 2 * B_TILE + boff, B_LD);
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc_c[i], fa[i], fb, acc_c[i]);
        }
        __syncthreads();
    }

    // ---- epilogue: one accumulator at a time through the staging tile
    for (int g = 0; g < 3; ++g) {
        if (g == 0)
            stage(cs, acc_z, wr, wc);
        else if (g == 1)
            stage(cs, acc_r, wr, wc);
        else
            stage(cs, acc_c, wr, wc);
        __syncthreads();
        for (int idx = tid; idx < BM * BN; idx += THREADS) {
            const int row = idx / BN, col = idx % BN;
            const int gr = m0 + row;
            if (gr >= M) continue;
            const int gc = n0 + col;
            const size_t o = (size_t)gr * d + gc;
            const float v = cs[row * C_LD + col];
            if (g == 0) {
                const float zz = sigmoidf_(v + ba[gc]);
                z_out[o] = zz;
                if (RES) res_z[o] = __float2bfloat16(zz);
            } else if (g == 1) {
                const float rr = sigmoidf_(v + ba[d + gc]);
                const bf16 hv = h[o];
                rh_out[o] = __float2bfloat16(rr * __bfloat162float(hv));
                if (RES) {
                    res_h[o] = hv;
                    res_r[o] = __float2bfloat16(rr);
                }
            } else {
                gc_out[o] = v + ba[2 * (size_t)d + gc];
            }
        }
        __syncthreads();
    }
}

// RES: also store the step's candidate gate res_c
template <bool RES>
__global__ void __launch_bounds__(THREADS)
ggnn_cand_kernel(bf16* __restrict__ h, const bf16* __restrict__ rh,
                 const bf16* __restrict__ uh, const float* __restrict__ z,
                 const float* __restrict__ gc_in, bf16* __restrict__ res_c,
                 int M, int d) {
    __shared__ __align__(128) unsigned char smem[CAND_BYTES];
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
        if (gi < M)
            copy8(dst, rh + (size_t)gi * d + k0 + a_col);
        else
            zero8(dst);
        copy8(b_t + b_row * B_LD + b_col,
              uh + ((size_t)k0 + b_row) * d + n0 + b_col);
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
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int row = idx / BN, col = idx % BN;
        const int gr = m0 + row;
        if (gr >= M) continue;
        const size_t o = (size_t)gr * d + n0 + col;
        const float c = tanhf(gc_in[o] + cs[row * C_LD + col]);
        if (RES) res_c[o] = __float2bfloat16(c);
        const float zz = z[o];
        const float hf = __bfloat162float(h[o]);
        h[o] = __float2bfloat16((1.f - zz) * hf + zz * c);
    }
}

// `steps` steps over h in place; with RES also the residual
// stacks of K2 (steps x M x d each).  Returns 0 or the first launch error.
template <bool RES>
int run_steps(bf16* h, const float* mask, const bf16* wa, const bf16* uzr,
              const bf16* uh, const float* ba, float* z, bf16* rh, float* gc,
              bf16* res_h, bf16* res_z, bf16* res_r, bf16* res_c, int M,
              int d, int r, int steps, cudaStream_t s) {
    if (M < 1 || r < 1 || M % r != 0 || d < BN || d % BN != 0 || steps < 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(d / BN, (M + BM - 1) / BM);
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    const size_t plane = (size_t)M * d;
    for (int t = 0; t < steps; ++t) {
        const size_t off = RES ? (size_t)t * plane : 0;
        ggnn_gate_kernel<RES><<<grid, THREADS, 0, s>>>(
            h, mask, wa, uzr, ba, z, rh, gc, RES ? res_h + off : nullptr,
            RES ? res_z + off : nullptr, RES ? res_r + off : nullptr, M, d,
            r);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        ggnn_cand_kernel<RES><<<grid, THREADS, 0, s>>>(
            h, rh, uh, z, gc, RES ? res_c + off : nullptr, M, d);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

extern "C" {

// K1.  h: (M, d) bf16, updated in place over `steps` steps.  mask: (M,)
// f32.  wa: (d, 3d) bf16, uzr: (d, 2d) bf16, uh: (d, d) bf16, ba: (3d,)
// f32.  z, gc: (M, d) f32 scratch; rh: (M, d) bf16 scratch.
// Takes any M >= 1 that is a multiple of r, and any d that is a multiple
// of 64.  Returns 0, or the CUDA error of the first failed launch.
int ggnn_folded_forward(void* h, const void* mask, const void* wa,
                        const void* uzr, const void* uh, const void* ba,
                        void* z, void* rh, void* gc, int M, int d, int r,
                        int steps, void* stream) {
    return run_steps<false>(
        static_cast<bf16*>(h), static_cast<const float*>(mask),
        static_cast<const bf16*>(wa), static_cast<const bf16*>(uzr),
        static_cast<const bf16*>(uh), static_cast<const float*>(ba),
        static_cast<float*>(z), static_cast<bf16*>(rh),
        static_cast<float*>(gc), nullptr, nullptr, nullptr, nullptr, M, d,
        r, steps, static_cast<cudaStream_t>(stream));
}

// K2: K1's arguments plus the residual stacks res_h, res_z, res_r, res_c,
// each (steps, M, d) bf16, written step by step.
int ggnn_folded_forward_res(void* h, const void* mask, const void* wa,
                            const void* uzr, const void* uh, const void* ba,
                            void* z, void* rh, void* gc, void* res_h,
                            void* res_z, void* res_r, void* res_c, int M,
                            int d, int r, int steps, void* stream) {
    return run_steps<true>(
        static_cast<bf16*>(h), static_cast<const float*>(mask),
        static_cast<const bf16*>(wa), static_cast<const bf16*>(uzr),
        static_cast<const bf16*>(uh), static_cast<const float*>(ba),
        static_cast<float*>(z), static_cast<bf16*>(rh),
        static_cast<float*>(gc), static_cast<bf16*>(res_h),
        static_cast<bf16*>(res_z), static_cast<bf16*>(res_r),
        static_cast<bf16*>(res_c), M, d, r, steps,
        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
