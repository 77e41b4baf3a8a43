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
//   dh    = (dprev + E @ dagg) + da[t][:, :2d] @ Uzr^T
//
// with dh kept in f32 between steps and cast to bf16 once at the end, E the
// per-example block adjacency of the forward (E is symmetric), and the
// gate chain in f32: the numerics of the TPU kernel and of the twin
// `folded_bwd_reference` (ops/ggnn_kernel.py), sums in the same order.  The
// parameter gradients (three stacked products over the steps' rows) are
// left to the caller, as the JAX package leaves them to XLA.
//
// What bounds it on this card.  Per step 12 M d^2 FLOP of bf16 products
// (drh 2, dagg 6, da_zr @ Uzr^T 4) against 6 d^2 bf16 weights: at M = 1536,
// d = 2048 the tensor cores take 0.078 ms a step at 989 TFLOP/s, and
// reading the weights once 0.015 ms at 3.35 TB/s, so at training batches
// it is bound by the tensor cores, like the forward.  The TPU kernel runs
// all steps for a block of whole examples with the weights resident in
// VMEM; a Hopper block has at most 227 KB of shared memory, and each
// reverse step has two products that need a whole row before they can
// start -- drh needs da_c across all d columns, dagg needs da across all
// 3d -- so a step is four launches, the launch boundaries being the
// synchronisation:
//
//   ggnn_gemm_kernel<DRH>   drh = da[t][:, 2d:] @ Uh^T, K = d.  Epilogue:
//                           the gate chain from dh (f32) and h, z, r, c;
//                           writes dprev (f32) and da[t][:, :2d] (bf16
//                           da_z, da_r).
//   ggnn_gemm_kernel<DAGG>  dagg = bf16(da[t] @ Wa^T), K = 3d, into an
//                           (M, d) bf16 scratch.
//   ggnn_bwd_agg_kernel     dprev += E @ dagg (E is r x r within an
//                           example; memory-bound, 31 MB a step at the
//                           noun shape).
//   ggnn_gemm_kernel<DH>    u = da[t][:, :2d] @ Uzr^T, K = 2d.  Epilogue:
//                           dh = dprev + u (f32); at t = 0 bf16(dh) into
//                           the output, else step t-1's bf16(da_c) into
//                           da[t-1][:, 2d:] (its z and c are residuals of
//                           the same columns), the A operand of the next
//                           drh product.
//
// Before the first reverse step ggnn_bwd_prep_kernel writes dh = f32(g)
// and that step's da_c.  So the bf16 da_c that the drh product reads is
// the very value stored in da, as in the twin, which casts one f32 da_c
// for both.  Each GEMM has one accumulator and any row tile, and every
// stage of its ring carries the same bytes.  One launch for dagg, E and u
// (two accumulators, row tiles of whole examples, E on a dagg tile staged
// in shared memory) would save dagg's round trip, 12 MB a step, at the
// price of 128-column tiles and uneven stages; not taken.
//
// The GEMM is K1/K2's (csrc/ggnn_gemm.cuh): a persistent block per SM, a
// producer warpgroup feeding a TMA ring of 128-byte-swizzled stages, two
// consumer warpgroups on wgmma, setmaxnreg 40 / 232.  Epilogues load a
// group's inputs before the previous group's stores.
//
// Weights: the folded weights as `fold_gate_weights` returns them, wa (d,
// 3d), uzr (d, 2d) and uh (d, d) row-major.  Every backward product
// contracts over a forward weight's output features, so row j of the
// weight is output column j of the product: K-major for wgmma's B as it
// stands, with no transpose.  da[t][:, 2d:] and da[t][:, :2d] are read
// through tensor maps of row stride 3d.
//
// Tiles, chosen on the host for each GEMM (`bwd_tile_plan` in
// ops/ggnn_kernel.py, K1's rule `_rounds_cost` over its (M, d) output) and
// passed in: rows in {64, 128}, columns in {64, 128, 256} dividing d.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, nothing is synchronised or allocated here, and the function
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

// GEMM kinds, apart from the forward's (GATE 0, CAND 1) so that a kernel's
// name says which product it is
constexpr int DRH = 2, DAGG = 3, DH = 4;
constexpr int EW_THREADS = 256;   // the elementwise kernels

// What a reverse step's GEMMs read and write beside their tensor maps.
// "next": the next reverse step, t - 1.
struct BwdArgs {
    float* dh;             // (M, d) f32: DH's epilogue writes, DRH's reads
    float* dprev;          // (M, d) f32: DRH's epilogue writes, DH's reads
    bf16* da;              // this step's (M, 3d) plane
    bf16* da_next;         // step t-1's plane; null at t = 0
    bf16* dagg;            // (M, d) scratch
    bf16* dh_out;          // (M, d): written at t = 0; null before
    const bf16* h;         // this step's residual planes, (M, d)
    const bf16* z;
    const bf16* r;
    const bf16* c;
    const bf16* z_next;    // step t-1's; null at t = 0
    const bf16* c_next;
    int M, d;

    template <int KIND, int WN>
    __device__ void epilogue(const float (&acc)[WN / 2], int row0,
                             int n0) const;
};

// the candidate pre-activation cotangent, formed the same way from g and
// in DH's epilogue, as the twin does: (dh z) (1 - c^2)
__device__ __forceinline__ float da_c_of(float dh, float z, float c) {
    const float dc = dh * z;
    return dc * (1.f - c * c);
}

// One warpgroup's epilogue over 64 rows (this thread's row0 and row0 + 8)
// by WN columns from n0, in groups of G 8-column chunks: `load(in, r0, r1,
// col)` reads what the group from column col needs in rows r0 and r1
// (clamped into M), `put(in, j, hh, row, col, x, y)` computes and stores
// the pair of columns col, col + 1 of chunk j in row row0 + 8 hh.  The next
// group's inputs are loaded before this group's stores.
template <int WN, int G, class In, class Load, class Put>
__device__ __forceinline__ void grouped(const float (&acc)[WN / 2], int M,
                                        int row0, int n0, Load load,
                                        Put put) {
    constexpr int GROUPS = WN / 8 / G;
    static_assert(GROUPS * G * 8 == WN, "groups");
    const int col = n0 + 2 * (threadIdx.x & 3);
    const int r0 = min(row0, M - 1), r1 = min(row0 + 8, M - 1);
    In in[2];
    load(in[0], r0, r1, col);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
        if (g + 1 < GROUPS)
            load(in[(g + 1) & 1], r0, r1, col + 8 * G * (g + 1));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            if (row >= M) break;
#pragma unroll
            for (int j = 0; j < G; ++j) {
                const int i = 4 * (G * g + j) + 2 * hh;
                put(in[g & 1], j, hh, row, col + 8 * (G * g + j), acc[i],
                    acc[i + 1]);
            }
        }
    }
}

template <int G>
struct DrhIn {
    float2 dh[G][2];
    uint32_t h[G][2], z[G][2], r[G][2], c[G][2];
};

template <int G>
struct DhIn {
    float2 dprev[G][2];
    uint32_t z[G][2], c[G][2];
};

struct NoIn {};

template <int KIND, int WN>
__device__ __forceinline__ void BwdArgs::epilogue(const float (&acc)[WN / 2],
                                                  int row0, int n0) const {
    constexpr int G = WN >= 128 ? 2 : 4;
    const size_t ld = d, ld3 = 3 * (size_t)d;
    if constexpr (KIND == DRH) {
        // acc: drh.  dprev = dh (1 - z) + drh r, da_z, da_r
        grouped<WN, G, DrhIn<G>>(
            acc, M, row0, n0,
            [&](DrhIn<G>& in, int r0, int r1, int col) {
#pragma unroll
                for (int j = 0; j < G; ++j)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const size_t o = (size_t)(hh ? r1 : r0) * ld + col
                                         + 8 * j;
                        in.dh[j][hh] = ld_f2(dh + o);
                        in.h[j][hh] = ld_b2(h + o);
                        in.z[j][hh] = ld_b2(z + o);
                        in.r[j][hh] = ld_b2(r + o);
                        in.c[j][hh] = ld_b2(c + o);
                    }
            },
            [&](const DrhIn<G>& in, int j, int hh, int row, int col,
                float x, float y) {
                const float2 g = in.dh[j][hh], hv = unpack(in.h[j][hh]),
                             zv = unpack(in.z[j][hh]),
                             rv = unpack(in.r[j][hh]),
                             cv = unpack(in.c[j][hh]);
                const float drh[2] = {x, y};
                const float gg[2] = {g.x, g.y}, hs[2] = {hv.x, hv.y},
                            zs[2] = {zv.x, zv.y}, rs[2] = {rv.x, rv.y},
                            cs[2] = {cv.x, cv.y};
                float dp[2], daz[2], dar[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float dz = gg[e] * (cs[e] - hs[e]);
                    dp[e] = gg[e] * (1.f - zs[e]);
                    dp[e] = dp[e] + drh[e] * rs[e];
                    const float dr = drh[e] * hs[e];
                    daz[e] = dz * zs[e] * (1.f - zs[e]);
                    dar[e] = dr * rs[e] * (1.f - rs[e]);
                }
                st_f2(dprev + (size_t)row * ld + col, dp[0], dp[1]);
                bf16* out = da + (size_t)row * ld3 + col;
                st_b2(out, daz[0], daz[1]);
                st_b2(out + d, dar[0], dar[1]);
            });
    } else if constexpr (KIND == DAGG) {
        grouped<WN, G, NoIn>(
            acc, M, row0, n0, [](NoIn&, int, int, int) {},
            [&](const NoIn&, int, int, int row, int col, float x, float y) {
                st_b2(dagg + (size_t)row * ld + col, x, y);
            });
    } else {
        static_assert(KIND == DH, "epilogue kind");
        // acc: da[:, :2d] @ Uzr^T.  dh = dprev + acc, then bf16(dh) at
        // t = 0, else the next step's da_c
        const bool last = dh_out != nullptr;
        grouped<WN, G, DhIn<G>>(
            acc, M, row0, n0,
            [&](DhIn<G>& in, int r0, int r1, int col) {
#pragma unroll
                for (int j = 0; j < G; ++j)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const size_t o = (size_t)(hh ? r1 : r0) * ld + col
                                         + 8 * j;
                        in.dprev[j][hh] = ld_f2(dprev + o);
                        if (!last) {
                            in.z[j][hh] = ld_b2(z_next + o);
                            in.c[j][hh] = ld_b2(c_next + o);
                        }
                    }
            },
            [&](const DhIn<G>& in, int j, int hh, int row, int col,
                float x, float y) {
                const float2 p = in.dprev[j][hh];
                const float v0 = p.x + x, v1 = p.y + y;
                const size_t o = (size_t)row * ld + col;
                if (last) {
                    st_b2(dh_out + o, v0, v1);
                    return;
                }
                st_f2(dh + o, v0, v1);
                const float2 zv = unpack(in.z[j][hh]),
                             cv = unpack(in.c[j][hh]);
                st_b2(da_next + (size_t)row * ld3 + 2 * ld + col,
                      da_c_of(v0, zv.x, cv.x), da_c_of(v1, zv.y, cv.y));
            });
    }
}

// dh = f32(g) and the first reverse step's da_c = bf16((g z)(1 - c^2))
// into da[:, 2d:], 8 columns of one row per thread
__global__ void __launch_bounds__(EW_THREADS)
ggnn_bwd_prep_kernel(const bf16* __restrict__ g, const bf16* __restrict__ z,
                     const bf16* __restrict__ c, float* __restrict__ dh,
                     bf16* __restrict__ da, int M, int d) {
    const int per_row = d / 8;
    const long long idx = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
    if (idx >= (long long)M * per_row) return;
    const int i = (int)(idx / per_row);
    const int col = (int)(idx % per_row) * 8;
    const size_t o = (size_t)i * d + col;
    const uint4 graw = *reinterpret_cast<const uint4*>(g + o);
    const uint4 zraw = *reinterpret_cast<const uint4*>(z + o);
    const uint4 craw = *reinterpret_cast<const uint4*>(c + o);
    const bf16* gv = reinterpret_cast<const bf16*>(&graw);
    const bf16* zv = reinterpret_cast<const bf16*>(&zraw);
    const bf16* cv = reinterpret_cast<const bf16*>(&craw);
    float f[8];
    uint4 out;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(gv[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        p[q] = __floats2bfloat162_rn(
            da_c_of(f[2 * q], __bfloat162float(zv[2 * q]),
                    __bfloat162float(cv[2 * q])),
            da_c_of(f[2 * q + 1], __bfloat162float(zv[2 * q + 1]),
                    __bfloat162float(cv[2 * q + 1])));
    *reinterpret_cast<float4*>(dh + o) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(dh + o + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
    *reinterpret_cast<uint4*>(da + (size_t)i * 3 * d + 2 * d + col) = out;
}

// dprev += E @ dagg for 8 columns of one row per thread: E's entries are
// rounded to bf16 as in the forward (csrc/ggnn_folded.cu's agg kernel),
// and the products of bf16 values are exact in f32
__global__ void __launch_bounds__(EW_THREADS)
ggnn_bwd_agg_kernel(const bf16* __restrict__ dagg,
                    const float* __restrict__ mask,
                    float* __restrict__ dprev, int M, int d, int r) {
    const int per_row = d / 8;
    const long long idx = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
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
            dagg + (size_t)j * d + col);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) s[q] += e * __bfloat162float(v[q]);
    }
    float4* out = reinterpret_cast<float4*>(dprev + o);
    const float4 a = out[0], b = out[1];
    out[0] = make_float4(a.x + s[0], a.y + s[1], a.z + s[2], a.w + s[3]);
    out[1] = make_float4(b.x + s[4], b.y + s[5], b.z + s[6], b.w + s[7]);
}

// ----------------------------------------------------------------- host

// tiles the GEMMs take: rows 64 or 128, columns 64, 128 or 256 dividing d
bool bad_tile(int d, int bm, int bn) {
    return !((bm == 64 || bm == 128) && (bn == 64 || bn == 128 || bn == 256)
             && d % bn == 0);
}

int run_backward(const bf16* g, const float* mask, const bf16* res_h,
                 const bf16* res_z, const bf16* res_r, const bf16* res_c,
                 const bf16* wa, const bf16* uzr, const bf16* uh, float* dh,
                 float* dprev, bf16* dagg, bf16* da, bf16* dh_out, int M,
                 int d, int r, int steps, const int (&tiles)[6],
                 cudaStream_t s) {
    if (M < 1 || r < 1 || M % r != 0 || d < BK || d % BK != 0 || steps < 1
        || bad_tile(d, tiles[0], tiles[1]) || bad_tile(d, tiles[2], tiles[3])
        || bad_tile(d, tiles[4], tiles[5]))
        return (int)cudaErrorInvalidValue;
    CUtensorMap b_uh, b_wa, b_uzr;
    if (!(tensor_map(&b_uh, uh, d, d, tiles[1])
          && tensor_map(&b_wa, wa, d, 3 * d, tiles[3])
          && tensor_map(&b_uzr, uzr, d, 2 * d, tiles[5])))
        return (int)cudaErrorInvalidValue;
    const size_t plane = (size_t)M * d;
    const GemmShape drh = {M, d, d / BK, 0}, dagg_sh = {M, d, 3 * d / BK, 0},
                    dh_sh = {M, d, 2 * d / BK, 0};
    const long long ew = (long long)M * (d / 8);
    const int ew_blocks = (int)((ew + EW_THREADS - 1) / EW_THREADS);
    const size_t last = (size_t)(steps - 1);
    ggnn_bwd_prep_kernel<<<ew_blocks, EW_THREADS, 0, s>>>(
        g, res_z + last * plane, res_c + last * plane, dh,
        da + 3 * last * plane, M, d);
    int e = (int)cudaGetLastError();
    if (e) return e;
    for (int t = steps - 1; t >= 0; --t) {
        const size_t off = (size_t)t * plane;
        bf16* da_t = da + 3 * off;
        // A operands in this step's plane of da: da_c (row stride 3d), all
        // of it, and [da_z | da_r]
        CUtensorMap a_drh, a_dagg, a_dh;
        if (!(tensor_map(&a_drh, da_t + 2 * d, M, d, tiles[0], 3 * d)
              && tensor_map(&a_dagg, da_t, M, 3 * d, tiles[2])
              && tensor_map(&a_dh, da_t, M, 2 * d, tiles[4], 3 * d)))
            return (int)cudaErrorInvalidValue;
        const bool next = t > 0;
        const BwdArgs ep = {
            dh, dprev, da_t, next ? da_t - 3 * plane : nullptr, dagg,
            next ? nullptr : dh_out, res_h + off, res_z + off, res_r + off,
            res_c + off, next ? res_z + off - plane : nullptr,
            next ? res_c + off - plane : nullptr, M, d};
        e = launch_tiles<DRH, true>(tiles[0], tiles[1], a_drh, b_uh, a_drh,
                                    b_uh, drh, ep, s);
        if (e) return e;
        e = launch_tiles<DAGG, true>(tiles[2], tiles[3], a_dagg, b_wa,
                                     a_dagg, b_wa, dagg_sh, ep, s);
        if (e) return e;
        ggnn_bwd_agg_kernel<<<ew_blocks, EW_THREADS, 0, s>>>(dagg, mask,
                                                             dprev, M, d, r);
        e = (int)cudaGetLastError();
        if (e) return e;
        e = launch_tiles<DH, true>(tiles[4], tiles[5], a_dh, b_uzr, a_dh,
                                   b_uzr, dh_sh, ep, s);
        if (e) return e;
    }
    return 0;
}

}  // namespace

extern "C" {

// K3.  g: (M, d) bf16, the cotangent of the output.  mask: (M,) f32.
// res_h, res_z, res_r, res_c: (steps, M, d) bf16 from K2.  wa: (d, 3d),
// uzr: (d, 2d), uh: (d, d) bf16, the folded weights.  dh, dprev: (M, d)
// f32 and dagg: (M, d) bf16 scratch.  Writes da: (steps, M, 3d) bf16 and
// dh_out: (M, d) bf16.  drh_bm .. dh_bn: the tiles of the three GEMMs.
// Takes any M >= 1 that is a multiple of r, any d that is a multiple of 64
// and steps >= 1.
int ggnn_folded_backward(const void* g, const void* mask, const void* res_h,
                         const void* res_z, const void* res_r,
                         const void* res_c, const void* wa, const void* uzr,
                         const void* uh, void* dh, void* dprev, void* dagg,
                         void* da, void* dh_out, int M, int d, int r,
                         int steps, int drh_bm, int drh_bn, int dagg_bm,
                         int dagg_bn, int dh_bm, int dh_bn, void* stream) {
    const int tiles[6] = {drh_bm, drh_bn, dagg_bm, dagg_bn, dh_bm, dh_bn};
    return run_backward(
        static_cast<const bf16*>(g), static_cast<const float*>(mask),
        static_cast<const bf16*>(res_h), static_cast<const bf16*>(res_z),
        static_cast<const bf16*>(res_r), static_cast<const bf16*>(res_c),
        static_cast<const bf16*>(wa), static_cast<const bf16*>(uzr),
        static_cast<const bf16*>(uh), static_cast<float*>(dh),
        static_cast<float*>(dprev), static_cast<bf16*>(dagg),
        static_cast<bf16*>(da), static_cast<bf16*>(dh_out), M, d, r, steps,
        tiles, static_cast<cudaStream_t>(stream));
}

// bytes of dynamic shared memory a block of ggnn_gemm_kernel takes on
// tiles of bm (64 or 128) x bn (64, 128 or 256) rows; 0 for any other
int ggnn_folded_bwd_smem(int bm, int bn) { return gemm_smem(bm, bn); }

// registers a thread of the consumer (consumer != 0) or producer warpgroup
// holds after setmaxnreg, in every GEMM instantiation
int ggnn_folded_bwd_maxnreg(int consumer) {
    return consumer ? CONSUMER_REGS : PRODUCER_REGS;
}

}  // extern "C"
