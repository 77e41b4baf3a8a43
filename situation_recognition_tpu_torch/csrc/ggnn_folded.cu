// Folded multi-step GGNN propagation (forward) for NVIDIA Hopper, sm_90a.
//
// Replaces two TPU kernels of situation_recognition_tpu/ops/ggnn_pallas.py:
//   K1 `_folded_kernel` (driven by `ggnn_propagate_fused` /
//      `_propagate_fwd_impl`)        -> entry `ggnn_folded_forward`;
//   K2 `_folded_kernel_res` (driven by `_propagate_fwd_res_impl`), the same
//      forward that also writes each step's residuals for the backward
//      kernel (csrc/ggnn_folded_bwd.cu)  -> entry `ggnn_folded_forward_res`.
// Both entries launch the same kernels; K2 passes the residual planes of
// each step, which the epilogues store beside their outputs.  For rows of
// whole examples (r rows each) it runs `steps` GGNN steps with W_p folded
// into the gate weights (`fold_gate_weights` in ops/ggnn_kernel.py):
//
//   E    = same_example * m m^T + diag(1 - 2m)       (block adjacency)
//   agg  = bf16(E @ h)
//   z    = sigmoid(agg @ WpWz + h @ Uz + bz)
//   r    = sigmoid(agg @ WpWr + h @ Ur + br)
//   c    = tanh   (agg @ WpWh + bf16(r * h) @ Uh + bc)
//   h'   = bf16((1 - z) h + z c)
//
// bf16 operands, f32 accumulation, gates in f32, agg, r*h and h rounded to
// bf16 where the TPU kernel rounds them (the twin `_folded_steps`).
//
// What bounds it on this card.  A step is 12 M d^2 FLOP of bf16 products
// against 6 d^2 bf16 weights (50 MB at d=2048): at M = 1536 the tensor
// cores would take 0.078 ms a step at 989 TFLOP/s, and reading the weights
// once 0.015 ms at 3.35 TB/s.  The TPU kernel keeps the weights resident on
// chip and runs every step inside one grid block; a Hopper block has at
// most 227 KB of shared memory, and the candidate needs r*h across all d
// columns of a row before `@ Uh`, so a step is three launches, the launch
// boundary being the synchronisation (the candidate writes h in place; the
// next step's agg kernel reads it):
//
//   ggnn_agg_kernel          agg = bf16(E @ h) into an (M, d) bf16 scratch
//                            (E is r x r within an example; memory-bound,
//                            6 MB at the noun shape).  K2: also the step's
//                            input h.
//   ggnn_gemm_kernel<GATE>   [agg | h] @ [W_zr ; U_zr], K = 2d, 8 M d^2:
//                            each 128 output columns are z and r of the
//                            same 64 columns of h.  Epilogue: z = sigmoid(.
//                            + bz) f32 and rh = bf16(sigmoid(. + br) * h).
//                            K2: bf16 z and r.
//   ggnn_gemm_kernel<CAND>   [agg | rh] @ [W_h ; U_h], K = 2d, 4 M d^2.
//                            Epilogue: c = tanh(. + bc), h = bf16((1 - z) h
//                            + z c) in place.  K2: bf16 c.
//
// The candidate's agg @ WpWh is summed with rh @ Uh in one accumulator,
// not in the gate GEMM: the gate's tiles then hold z and r only (up to 128
// x 256 instead of 128 x 192 of z, r and c), and no f32 pre-activation
// makes a round trip through device memory.  Both GEMMs run their K loop
// over two pairs of tensor maps (the agg half, then the h or rh half),
// with the same boxes, so every stage expects the same bytes; TMA counts
// the whole box where it zero-fills rows past M.  Measured (PERF.md §6):
// at the noun shape the gate's main loop runs at ~76% of the tensor cores'
// rate and the epilogues, during which they wait, take ~20% of a launch;
// at the verb shape each block streams its weight tiles.
//
// The GEMM (csrc/ggnn_gemm.cuh, shared with K3's ggnn_folded_bwd.cu) is
// vit_block.cu's design: a persistent block per SM, a producer warpgroup
// feeding a TMA ring of 128-byte-swizzled stages, two consumer warpgroups
// on wgmma, setmaxnreg 40 / 232.  Epilogues work on the accumulator in
// registers, their inputs loaded before their first store (the pointers
// may alias, so the compiler would not move a load past a store).
//
// Weights (prepared once per weight change by `folded_operands` in
// ops/ggnn_kernel.py), K-major as wgmma's B wants: W_zr (2d, d) =
// WpW[z|r]^T and U_zr (2d, d) = U[z|r]^T, each with its rows in 64-row
// groups [z_j | r_j] for column group j; W_h (d, d) = WpWh^T; U_h (d, d) =
// Uh^T.
//
// Tiles, chosen on the host (`tile_plan` in ops/ggnn_kernel.py, from M, d
// and the SM count) and passed in: rows in {64, 128}; columns gate_bn in
// {128, 256} (one or two groups of z and r) and cand_bn in {64, 128, 256},
// each dividing its GEMM's output width.  The rule: the fewest clocks of
// the busiest SM, rounds of tiles over the SMs times each tile's clocks
// per 64-deep stage (its products at 4096 FLOP/clk plus its operand bytes
// at 64 B/clk), ties to the larger tile.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, nothing is synchronised or allocated here, and each function
// returns cudaGetLastError() of the first launch that failed (0 on
// success), or cudaErrorInvalidValue for shapes or tiles it does not take.
// Every matrix must be contiguous and 16-byte aligned (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ggnn_gemm.cuh"
#include "hopper.cuh"

namespace {

constexpr int GATE = 0, CAND = 1;
constexpr int GROUP = 64;   // columns of h in a [z | r] group of the gate
constexpr int AGG_THREADS = 256;

// What a step's GEMMs read and write beside their tensor maps.
struct StepArgs {
    bf16* h;           // (M, d): read by the gate, updated by the candidate
    const float* ba;   // (3d,) [bz | br | bc]
    float* z;          // (M, d) f32
    bf16* rh;          // (M, d)
    bf16* res_z;       // K2: this step's (M, d) planes; null for K1
    bf16* res_r;
    bf16* res_c;
    int M, d;

    // the gate's or the candidate's epilogue (ggnn_gemm.cuh)
    template <int KIND, int WN>
    __device__ void epilogue(const float (&acc)[WN / 2], int row0,
                             int n0) const;
};

__device__ __forceinline__ float sigmoidf_(float x) {
    return 1.f / (1.f + expf(-x));
}

// agg = bf16(E @ h) for 8 columns of one row per thread; E's entries are
// rounded to bf16 as the TPU kernel's adjacency scratch, and the products
// of bf16 values are exact in f32.  res_h (K2): the step's input h.
__global__ void __launch_bounds__(AGG_THREADS)
ggnn_agg_kernel(const bf16* __restrict__ h, const float* __restrict__ mask,
                bf16* __restrict__ agg, bf16* __restrict__ res_h, int M,
                int d, int r) {
    const int per_row = d / 8;
    const long long idx = (long long)blockIdx.x * AGG_THREADS + threadIdx.x;
    if (idx >= (long long)M * per_row) return;
    const int i = (int)(idx / per_row);
    const int col = (int)(idx % per_row) * 8;
    const size_t o = (size_t)i * d + col;
    const int ex0 = (i / r) * r;
    const float mi = mask[i];
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = ex0; j < ex0 + r; ++j) {
        float e = mi * mask[j] + (j == i ? 1.f - 2.f * mi : 0.f);
        e = __bfloat162float(__float2bfloat16(e));
        if (e == 0.f) continue;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            h + (size_t)j * d + col);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) s[q] += e * __bfloat162float(v[q]);
    }
    uint4 out;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        p[q] = __floats2bfloat162_rn(s[2 * q], s[2 * q + 1]);
    *reinterpret_cast<uint4*>(agg + o) = out;
    if (res_h != nullptr)
        *reinterpret_cast<uint4*>(res_h + o) =
            *reinterpret_cast<const uint4*>(h + o);
}

// The gate epilogue of one warpgroup's 64 rows (this thread's rows row0
// and row0 + 8) by WN accumulator columns, the first being column n0 of the
// gate's 2d: in each 128 columns from a multiple of 128, the first 64 are
// z and the next 64 r, of the same 64 columns of h.  Each 64-column block
// loads its biases (and for r, h) before its first store.
template <int WN>
__device__ __forceinline__ void gate_epilogue(const float (&acc)[WN / 2],
                                              const StepArgs& ep, int row0,
                                              int n0) {
    const int q = threadIdx.x & 3;
    const size_t d = ep.d;
    const int r0 = min(row0, ep.M - 1), r1 = min(row0 + 8, ep.M - 1);
#pragma unroll
    for (int blk = 0; blk < WN / 64; ++blk) {
        const int n = n0 + 64 * blk;
        const bool is_r = (n / GROUP) & 1;
        const int col0 = GROUP * (n / (2 * GROUP)) + 2 * q;
        float2 bias[8];
        uint32_t hv[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const size_t col = col0 + 8 * j;
            bias[j] = ld_f2(ep.ba + (is_r ? d : 0) + col);
            if (is_r) {
                hv[j][0] = ld_b2(ep.h + (size_t)r0 * d + col);
                hv[j][1] = ld_b2(ep.h + (size_t)r1 * d + col);
            }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            if (row >= ep.M) break;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const size_t o = (size_t)row * d + col0 + 8 * j;
                const int i = 4 * (8 * blk + j) + 2 * hh;
                const float g0 = sigmoidf_(acc[i] + bias[j].x);
                const float g1 = sigmoidf_(acc[i + 1] + bias[j].y);
                if (is_r) {
                    const float2 hf = unpack(hv[j][hh]);
                    st_b2(ep.rh + o, g0 * hf.x, g1 * hf.y);
                    if (ep.res_r != nullptr) st_b2(ep.res_r + o, g0, g1);
                } else {
                    st_f2(ep.z + o, g0, g1);
                    if (ep.res_z != nullptr) st_b2(ep.res_z + o, g0, g1);
                }
            }
        }
    }
}

// What the candidate epilogue of one group of G 8-column chunks reads: the
// bias of each chunk, and z (an f32 pair) and h (a bf16 pair) of each
// chunk in rows r0 and r1.
template <int G>
struct CandIn {
    float2 bc[G], z[G][2];
    uint32_t h[G][2];
};

template <int G>
__device__ __forceinline__ void cand_inputs(const StepArgs& ep, int r0,
                                            int r1, int col,
                                            CandIn<G>& in) {
    const size_t d = ep.d;
#pragma unroll
    for (int j = 0; j < G; ++j) {
        in.bc[j] = ld_f2(ep.ba + 2 * d + col + 8 * j);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const size_t o = (size_t)(hh ? r1 : r0) * d + col + 8 * j;
            in.z[j][hh] = ld_f2(ep.z + o);
            in.h[j][hh] = ld_b2(ep.h + o);
        }
    }
}

// The candidate epilogue of one warpgroup's 64 rows by WN columns from
// col0: c = tanh(acc + bc), h = bf16((1 - z) h + z c) in
// place, K2's bf16 c.  The next chunk group's inputs are loaded before
// this group's stores.
template <int WN>
__device__ __forceinline__ void cand_epilogue(const float (&acc)[WN / 2],
                                              const StepArgs& ep, int row0,
                                              int col0) {
    constexpr int G = WN == 128 || WN == 64 ? 4 : 2;
    constexpr int GROUPS = WN / 8 / G;
    const int q = threadIdx.x & 3;
    const size_t d = ep.d;
    const int r0 = min(row0, ep.M - 1), r1 = min(row0 + 8, ep.M - 1);
    const int col = col0 + 2 * q;
    CandIn<G> in[2];
    cand_inputs<G>(ep, r0, r1, col, in[0]);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
        if (g + 1 < GROUPS)
            cand_inputs<G>(ep, r0, r1, col + 8 * G * (g + 1),
                           in[(g + 1) & 1]);
        const CandIn<G>& cur = in[g & 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            if (row >= ep.M) break;
#pragma unroll
            for (int j = 0; j < G; ++j) {
                const int i = 4 * (G * g + j) + 2 * hh;
                const size_t o = (size_t)row * d + col + 8 * (G * g + j);
                const float c0 = tanhf(acc[i] + cur.bc[j].x);
                const float c1 = tanhf(acc[i + 1] + cur.bc[j].y);
                const float2 z = cur.z[j][hh];
                const float2 hf = unpack(cur.h[j][hh]);
                st_b2(ep.h + o, (1.f - z.x) * hf.x + z.x * c0,
                      (1.f - z.y) * hf.y + z.y * c1);
                if (ep.res_c != nullptr) st_b2(ep.res_c + o, c0, c1);
            }
        }
    }
}

template <int KIND, int WN>
__device__ __forceinline__ void StepArgs::epilogue(
    const float (&acc)[WN / 2], int row0, int n0) const {
    if constexpr (KIND == GATE)
        gate_epilogue<WN>(acc, *this, row0, n0);
    else
        cand_epilogue<WN>(acc, *this, row0, n0);
}

// ----------------------------------------------------------------- host

// tiles the kernels take: rows 64 or 128; gate columns 128 or 256 dividing
// 2d, candidate columns 64, 128 or 256 dividing d
bool bad_plan(int d, int gate_bm, int gate_bn, int cand_bm, int cand_bn) {
    const bool rows_ok = (gate_bm == 64 || gate_bm == 128)
                         && (cand_bm == 64 || cand_bm == 128);
    const bool gate_ok = (gate_bn == 128 || gate_bn == 256)
                         && (2 * d) % gate_bn == 0;
    const bool cand_ok = (cand_bn == 64 || cand_bn == 128 || cand_bn == 256)
                         && d % cand_bn == 0;
    return !(rows_ok && gate_ok && cand_ok);
}

// `steps` steps over h in place; with res (K2) also the four residual
// stacks (steps x M x d each).  Returns 0 or the first launch error.
int run_steps(bf16* h, const float* mask, const bf16* w_zr,
              const bf16* u_zr, const bf16* w_h, const bf16* u_h,
              const float* ba, bf16* agg, float* z, bf16* rh,
              bf16* const* res, int M, int d, int r, int steps,
              int gate_bm, int gate_bn, int cand_bm, int cand_bn,
              cudaStream_t s) {
    if (M < 1 || r < 1 || M % r != 0 || d < GROUP || d % GROUP != 0
        || steps < 0 || bad_plan(d, gate_bm, gate_bn, cand_bm, cand_bn))
        return (int)cudaErrorInvalidValue;
    CUtensorMap g_agg, g_h, g_w, g_u, c_agg, c_rh, c_w, c_u;
    if (!(tensor_map(&g_agg, agg, M, d, gate_bm)
          && tensor_map(&g_h, h, M, d, gate_bm)
          && tensor_map(&g_w, w_zr, 2 * d, d, gate_bn)
          && tensor_map(&g_u, u_zr, 2 * d, d, gate_bn)
          && tensor_map(&c_agg, agg, M, d, cand_bm)
          && tensor_map(&c_rh, rh, M, d, cand_bm)
          && tensor_map(&c_w, w_h, d, d, cand_bn)
          && tensor_map(&c_u, u_h, d, d, cand_bn)))
        return (int)cudaErrorInvalidValue;
    const size_t plane = (size_t)M * d;
    const long long agg_threads = (long long)M * (d / 8);
    const int agg_blocks =
        (int)((agg_threads + AGG_THREADS - 1) / AGG_THREADS);
    StepArgs ep = {h, ba, z, rh, nullptr, nullptr, nullptr, M, d};
    // K = 2d over the two pairs of maps; the gate's outputs are z and r of
    // every column of h
    const GemmShape gate = {M, 2 * d, d / BK, d / BK};
    const GemmShape cand = {M, d, d / BK, d / BK};
    for (int t = 0; t < steps; ++t) {
        const size_t off = (size_t)t * plane;
        if (res != nullptr) {
            ep.res_z = res[1] + off;
            ep.res_r = res[2] + off;
            ep.res_c = res[3] + off;
        }
        ggnn_agg_kernel<<<agg_blocks, AGG_THREADS, 0, s>>>(
            h, mask, agg, res != nullptr ? res[0] + off : nullptr, M, d, r);
        int e = (int)cudaGetLastError();
        if (e) return e;
        e = launch_tiles<GATE, false>(gate_bm, gate_bn, g_agg, g_w, g_h,
                                      g_u, gate, ep, s);
        if (e) return e;
        e = launch_tiles<CAND, true>(cand_bm, cand_bn, c_agg, c_w, c_rh,
                                     c_u, cand, ep, s);
        if (e) return e;
    }
    return 0;
}

}  // namespace

extern "C" {

// K1.  h: (M, d) bf16, updated in place over `steps` steps.  mask: (M,)
// f32.  w_zr, u_zr: (2d, d), w_h, u_h: (d, d) bf16, the prepared weights
// (see the note above); ba: (3d,) f32.  agg, rh: (M, d) bf16 and z: (M, d)
// f32 scratch.  gate_bm, gate_bn, cand_bm, cand_bn: the tiles.  Takes any
// M >= 1 that is a multiple of r, and any d that is a multiple of 64.
int ggnn_folded_forward(void* h, const void* mask, const void* w_zr,
                        const void* u_zr, const void* w_h, const void* u_h,
                        const void* ba, void* agg, void* z, void* rh, int M,
                        int d, int r, int steps, int gate_bm, int gate_bn,
                        int cand_bm, int cand_bn, void* stream) {
    return run_steps(
        static_cast<bf16*>(h), static_cast<const float*>(mask),
        static_cast<const bf16*>(w_zr), static_cast<const bf16*>(u_zr),
        static_cast<const bf16*>(w_h), static_cast<const bf16*>(u_h),
        static_cast<const float*>(ba), static_cast<bf16*>(agg),
        static_cast<float*>(z), static_cast<bf16*>(rh), nullptr, M, d, r,
        steps, gate_bm, gate_bn, cand_bm, cand_bn,
        static_cast<cudaStream_t>(stream));
}

// K2: K1's arguments plus the residual stacks res_h, res_z, res_r, res_c,
// each (steps, M, d) bf16, written step by step: the step's input h and
// the bf16 gates z, r, c.
int ggnn_folded_forward_res(void* h, const void* mask, const void* w_zr,
                            const void* u_zr, const void* w_h,
                            const void* u_h, const void* ba, void* agg,
                            void* z, void* rh, void* res_h, void* res_z,
                            void* res_r, void* res_c, int M, int d, int r,
                            int steps, int gate_bm, int gate_bn,
                            int cand_bm, int cand_bn, void* stream) {
    bf16* const res[4] = {
        static_cast<bf16*>(res_h), static_cast<bf16*>(res_z),
        static_cast<bf16*>(res_r), static_cast<bf16*>(res_c)};
    return run_steps(
        static_cast<bf16*>(h), static_cast<const float*>(mask),
        static_cast<const bf16*>(w_zr), static_cast<const bf16*>(u_zr),
        static_cast<const bf16*>(w_h), static_cast<const bf16*>(u_h),
        static_cast<const float*>(ba), static_cast<bf16*>(agg),
        static_cast<float*>(z), static_cast<bf16*>(rh), res, M, d, r, steps,
        gate_bm, gate_bn, cand_bm, cand_bn,
        static_cast<cudaStream_t>(stream));
}

// bytes of dynamic shared memory a block of ggnn_gemm_kernel takes on
// tiles of bm (64 or 128) x bn (64, 128 or 256) rows; 0 for any other
int ggnn_folded_smem(int bm, int bn) { return gemm_smem(bm, bn); }

// registers a thread of the consumer (consumer != 0) or producer warpgroup
// holds after setmaxnreg, in every GEMM instantiation
int ggnn_folded_maxnreg(int consumer) {
    return consumer ? CONSUMER_REGS : PRODUCER_REGS;
}

}  // extern "C"
