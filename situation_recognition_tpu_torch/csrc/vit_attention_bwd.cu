// The ViT attention core's backward for NVIDIA Hopper, sm_90a.
//
// Replaces K8 of situation_recognition_tpu/ops/vit_pallas.py,
// `_attn_bwd_stream_kernel`: the gradients dq, dk, dv of the stream's
// attention core (K7), given its inputs q, k, v, its bf16 output o and the
// cotangent do, all (B * row_stride, D) bf16 with n_valid real rows per
// example.  It is the backward of the fine-tuning path's differentiable
// attention (ops/vit_train.py, `DiffAttention`).
//
// For each example, head h (columns h*64 .. h*64+63), query row i and key j,
// whatever the forward's softmax flavour (the TPU kernel's numerics):
//   s_ij  = (q_i . k_j in f32) * scale,   m_i = max_j s_ij
//   e_ij  = exp(s_ij - m_i) in f32,       inv_i = 1 / sum_j e_ij
//   delta_i = sum over the head's 64 columns of do_i * o_i in f32
//   dv_j  = sum_i bf16(e_ij) * bf16(do_i * inv_i)
//   dp_ij = do_i . v_j
//   ds_ij = bf16(e_ij * (dp_ij - delta_i) * (inv_i * scale))
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// with bf16 operands and f32 sums, over the real rows only; dq, dk, dv in
// bf16, and the pad rows n_valid .. row_stride-1 of each example written as
// zero (never read).  Every bf16 cast is elementwise once m, inv and delta
// are known, so tiling changes only the order of the f32 sums.
//
// Design: FlashAttention-2's split into two launches with no atomics, so
// the result does not depend on the order in which blocks run.
//   1. `dq_kernel`, one block per (64-query tile, head, example).  Pass 1
//      loops over 64-key tiles forming S = Q K^T (WMMA bf16 16x16x16, f32
//      sums) and keeps each row's maximum and its running sum of exponents
//      (rescaled when the maximum grows); with delta from do and o it
//      writes the row statistics m, inv, delta to a (3, B, heads,
//      row_stride) f32 scratch.  Pass 2 loops over the key tiles again,
//      forms S and dP = dO V^T, turns them into the bf16 dS tile and adds
//      dS K into f32 accumulator fragments that stay in registers.
//   2. `dkv_kernel`, one block per (64-key tile, head, example), holds its
//      K and V tiles and loops over the 64-query tiles: it recomputes S and
//      dP, reads the row statistics of those queries, forms the bf16
//      exponent and dS tiles, and adds E^T bf16(dO * inv) and dS^T Q into
//      register accumulators for dv and dk.
// Nothing of the (B, h, N, N) scores reaches device memory.  Shared memory:
// 81.7 KB and 100.4 KB, and at most 128 registers a thread, so two blocks
// of either kernel share an SM.
//
// What bounds it on this card.  At ViT-L/14, batch 256 (16 heads, N = 257)
// the work is five products of 2 N^2 64 per head and example (1.73e11
// FLOP, 0.175 ms at 989 TFLOP/s) against eight (B N, D) bf16 tensors read
// or written (1.08 GB, 0.322 ms at 3.35 TB/s): bound by memory.  This
// simple design computes Q K^T three times and dO V^T twice, reads each
// K/V tile once per query tile and each Q/dO tile once per key tile (from
// L2), and serialises load, products and the elementwise passes within a
// block; PERF.md keeps its time beside the bound.
//
// Interface: plain C, loaded with ctypes.  The launches go on the caller's
// stream in order, nothing is synchronised or allocated here, and the
// function returns cudaGetLastError() after each launch (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;


namespace {

constexpr int T = 64;          // query rows of a query tile, keys of a key tile
constexpr int DH = 64;         // head width
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = T / WARPS;
constexpr int LDH = DH + 8;    // bf16 leading dimension of every 64x64 bf16 tile
constexpr int LDS = T + 4;     // f32 leading dimension of the score tiles
static_assert(T == DH, "every operand of the five products is 64 x 64");

constexpr size_t TILE_H = (size_t)T * LDH * sizeof(bf16);    // 9,216 bytes
constexpr size_t TILE_F = (size_t)T * LDS * sizeof(float);   // 17,408 bytes
// dq_kernel: Q, dO, K, V, dS; S, dP; m, inv * scale, delta per row
constexpr size_t SMEM_DQ = 5 * TILE_H + 2 * TILE_F + 3 * T * sizeof(float);
// dkv_kernel: K, V, Q, dO, bf16(dO * inv), E, dS; S, dP; m, inv,
// inv * scale, delta per row
constexpr size_t SMEM_DKV = 7 * TILE_H + 2 * TILE_F + 4 * T * sizeof(float);

template <typename L>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, L>;
template <typename L>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, L>;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float warp_sum(float s) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

__device__ __forceinline__ float warp_max(float s) {
    for (int o = 16; o > 0; o >>= 1)
        s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, o));
    return s;
}

__device__ __forceinline__ void zero8(bf16* p) {
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// The 16x16 block (i, j) of a 64x64 operand held in a row-major tile x
// (leading dimension LDH): of x itself (row_major), or of its transpose
// (col_major: block (i, j) of x^T is block (j, i) of x, read column-major).
template <typename L>
__device__ __forceinline__ const bf16* block_at(const bf16* x, int i, int j) {
    if constexpr (std::is_same<L, wmma::row_major>::value)
        return x + i * 16 * LDH + j * 16;
    else
        return x + j * 16 * LDH + i * 16;
}

// acc[jj] += (A B) block (wrow, jc + jj) for 64x64 operands A, B given as
// tiles read in layouts LA, LB; warp w owns row block w & 3 and column
// blocks jc, jc + 1 of the 64x64 result
template <typename LA, typename LB>
__device__ __forceinline__ void mma_tile(FragC (&acc)[2], const bf16* a,
                                         const bf16* b, int wrow, int jc) {
#pragma unroll
    for (int t = 0; t < T / 16; ++t) {
        FragA<LA> fa;
        wmma::load_matrix_sync(fa, block_at<LA>(a, wrow, t), LDH);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            FragB<LB> fb;
            wmma::load_matrix_sync(fb, block_at<LB>(b, t, jc + jj), LDH);
            wmma::mma_sync(acc[jj], fa, fb, acc[jj]);
        }
    }
}

__device__ __forceinline__ void store_tile(float* s, const FragC (&acc)[2],
                                           int wrow, int jc) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
        wmma::store_matrix_sync(s + wrow * 16 * LDS + (jc + jj) * 16, acc[jj],
                                LDS, wmma::mem_row_major);
}

// s = A B^T into an f32 tile, for row-major 64x64 tiles A, B
__device__ __forceinline__ void scores(float* s, const bf16* a, const bf16* b,
                                       int wrow, int jc) {
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    mma_tile<wmma::row_major, wmma::col_major>(acc, a, b, wrow, jc);
    store_tile(s, acc, wrow, jc);
}

// rows r0 .. r0 + count - 1 of an example's head columns into a 64-row
// tile; the tile's other rows are zero
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                      size_t base, int r0, int count, int col0,
                                      int D) {
    for (int c = threadIdx.x; c < T * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        bf16* d = dst + row * LDH + c8;
        if (row < count)
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(
                src + (base + r0 + row) * D + col0 + c8);
        else
            zero8(d);
    }
}

// rows r0 .. r_end - 1 of an example's head columns from an f32 tile in
// bf16: the first `real` rows from the tile, the others zero
__device__ __forceinline__ void write_rows(bf16* __restrict__ out,
                                           const float* tile, size_t base,
                                           int r0, int r_end, int real,
                                           int col0, int D) {
    for (int c = threadIdx.x; c < T * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        if (r0 + row >= r_end) continue;
        bf16* dst = out + (base + r0 + row) * D + col0 + c8;
        if (row < real) {
            uint4 raw;
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&raw);
            const float* s = tile + row * LDS + c8;
            for (int i = 0; i < 4; ++i)
                o[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
            *reinterpret_cast<uint4*>(dst) = raw;
        } else {
            zero8(dst);
        }
    }
}

// ds of one score element: e * (dp - delta) * (inv * scale), each product
// rounded as written (no fused multiply-add across them)
__device__ __forceinline__ float ds_of(float e, float dp, float delta,
                                       float invs) {
    return __fmul_rn(__fmul_rn(e, __fsub_rn(dp, delta)), invs);
}

__global__ void __launch_bounds__(THREADS, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, bf16* __restrict__ dq,
          float* __restrict__ stats, int row_stride, int n_valid, int D,
          int heads, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* dOs = Qs + T * LDH;
    bf16* Ks = dOs + T * LDH;
    bf16* Vs = Ks + T * LDH;
    bf16* dSs = Vs + T * LDH;
    float* Ss = reinterpret_cast<float*>(dSs + T * LDH);
    float* dPs = Ss + T * LDS;
    float* r_max = dPs + T * LDS;
    float* r_invs = r_max + T;
    float* r_delta = r_invs + T;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int q0 = blockIdx.x * T, h = blockIdx.y;
    const int col0 = h * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + T, row_stride);
    if (q0 >= n_valid) {  // a tile of pad rows only
        write_rows(dq, nullptr, base, q0, q_end, 0, col0, D);
        return;
    }
    const int rows = min(T, n_valid - q0);   // real query rows here
    const size_t plane = (size_t)gridDim.z * heads * row_stride;
    float* st = stats + ((size_t)blockIdx.z * heads + h) * row_stride + q0;

    stage(Qs, q, base, q0, rows, col0, D);
    stage(dOs, dout, base, q0, rows, col0, D);

    // delta of warp w's rows w, w + 8, ..., w + 56, from do and o in device
    // memory (two columns a lane)
    float delta[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp + WARPS * i;
        float part = 0.f;
        if (r < rows) {
            const size_t at = (base + q0 + r) * D + col0 + 2 * lane;
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(dout + at));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(o + at));
            part = __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
        }
        delta[i] = warp_sum(part);
    }
    __syncthreads();

    const int wrow = warp & 3, jc = (warp >> 2) * 2;
    const int n_tiles = (n_valid + T - 1) / T;

    // ---- pass 1: each row's maximum of s = QK^T * scale over the real keys
    // and its f32 sum of exp(s - max), rescaled as the maximum grows
    float mx[ROWS_PER_WARP], den[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
        mx[i] = -INFINITY;
        den[i] = 0.f;
    }
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * T, kv = min(T, n_valid - k0);
        stage(Ks, k, base, k0, kv, col0, D);
        __syncthreads();
        scores(Ss, Qs, Ks, wrow, jc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const float* srow = Ss + (warp + WARPS * i) * LDS;
            const float s0 = lane < kv ? __fmul_rn(srow[lane], scale)
                                       : -INFINITY;
            const float s1 = lane + 32 < kv ? __fmul_rn(srow[lane + 32], scale)
                                            : -INFINITY;
            const float m = fmaxf(mx[i], warp_max(fmaxf(s0, s1)));
            const float e = (lane < kv ? expf(s0 - m) : 0.f)
                            + (lane + 32 < kv ? expf(s1 - m) : 0.f);
            den[i] = den[i] * expf(mx[i] - m) + warp_sum(e);
            mx[i] = m;
        }
    }

    // ---- the row statistics: to shared memory for pass 2, and m, inv,
    // delta of the real rows to the scratch for dkv_kernel
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int r = warp + WARPS * i;
            const bool real = r < rows;
            const float inv = 1.f / den[i];
            r_max[r] = real ? mx[i] : 0.f;
            r_invs[r] = real ? __fmul_rn(inv, scale) : 0.f;
            r_delta[r] = real ? delta[i] : 0.f;
            if (real) {
                st[r] = mx[i];
                st[plane + r] = inv;
                st[2 * plane + r] = delta[i];
            }
        }
    }
    __syncthreads();

    // ---- pass 2: dQ += dS K over the key tiles
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * T, kv = min(T, n_valid - k0);
        stage(Ks, k, base, k0, kv, col0, D);
        stage(Vs, v, base, k0, kv, col0, D);
        __syncthreads();
        scores(Ss, Qs, Ks, wrow, jc);
        scores(dPs, dOs, Vs, wrow, jc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int r = warp + WARPS * i;
            for (int c = lane; c < T; c += 32) {
                float ds = 0.f;
                if (r < rows && c < kv) {
                    const float e = expf(
                        __fmul_rn(Ss[r * LDS + c], scale) - r_max[r]);
                    ds = ds_of(e, dPs[r * LDS + c], r_delta[r], r_invs[r]);
                }
                dSs[r * LDH + c] = __float2bfloat16(ds);
            }
        }
        __syncthreads();
        mma_tile<wmma::row_major, wmma::row_major>(acc, dSs, Ks, wrow, jc);
        __syncthreads();  // K, V and dS of this tile are read
    }
    store_tile(Ss, acc, wrow, jc);
    __syncthreads();
    write_rows(dq, Ss, base, q0, q_end, rows, col0, D);
}

__global__ void __launch_bounds__(THREADS, 2)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           bf16* __restrict__ dk, bf16* __restrict__ dv,
           const float* __restrict__ stats, int row_stride, int n_valid,
           int D, int heads, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + T * LDH;
    bf16* Qs = Vs + T * LDH;
    bf16* dOs = Qs + T * LDH;
    bf16* dOi = dOs + T * LDH;     // bf16(dO * inv)
    bf16* Es = dOi + T * LDH;      // bf16(e)
    bf16* dSs = Es + T * LDH;
    float* Ss = reinterpret_cast<float*>(dSs + T * LDH);
    float* dPs = Ss + T * LDS;
    float* r_max = dPs + T * LDS;
    float* r_inv = r_max + T;
    float* r_invs = r_inv + T;
    float* r_delta = r_invs + T;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int k0 = blockIdx.x * T, h = blockIdx.y;
    const int col0 = h * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int k_end = min(k0 + T, row_stride);
    if (k0 >= n_valid) {  // a tile of pad rows only
        write_rows(dk, nullptr, base, k0, k_end, 0, col0, D);
        write_rows(dv, nullptr, base, k0, k_end, 0, col0, D);
        return;
    }
    const int kv = min(T, n_valid - k0);     // real keys here
    const size_t plane = (size_t)gridDim.z * heads * row_stride;
    const float* st = stats + ((size_t)blockIdx.z * heads + h) * row_stride;

    stage(Ks, k, base, k0, kv, col0, D);
    stage(Vs, v, base, k0, kv, col0, D);

    const int wrow = warp & 3, jc = (warp >> 2) * 2;
    FragC acc_k[2], acc_v[2];
    for (int jj = 0; jj < 2; ++jj) {
        wmma::fill_fragment(acc_k[jj], 0.f);
        wmma::fill_fragment(acc_v[jj], 0.f);
    }
    const int n_tiles = (n_valid + T - 1) / T;
    for (int t = 0; t < n_tiles; ++t) {
        const int q0 = t * T, rows = min(T, n_valid - q0);
        if (tid < T) {
            const bool real = tid < rows;
            const float inv = real ? st[plane + q0 + tid] : 0.f;
            r_max[tid] = real ? st[q0 + tid] : 0.f;
            r_inv[tid] = inv;
            r_invs[tid] = __fmul_rn(inv, scale);
            r_delta[tid] = real ? st[2 * plane + q0 + tid] : 0.f;
        }
        __syncthreads();
        stage(Qs, q, base, q0, rows, col0, D);
        for (int c = tid; c < T * 8; c += THREADS) {
            const int row = c >> 3, c8 = (c & 7) * 8;
            bf16* d = dOs + row * LDH + c8;
            bf16* di = dOi + row * LDH + c8;
            if (row < rows) {
                const uint4 raw = *reinterpret_cast<const uint4*>(
                    dout + (base + q0 + row) * D + col0 + c8);
                *reinterpret_cast<uint4*>(d) = raw;
                const bf16* e = reinterpret_cast<const bf16*>(&raw);
                const float f = r_inv[row];
                for (int i = 0; i < 8; ++i)
                    di[i] = __float2bfloat16(
                        __fmul_rn(__bfloat162float(e[i]), f));
            } else {
                zero8(d);
                zero8(di);
            }
        }
        __syncthreads();
        scores(Ss, Qs, Ks, wrow, jc);
        scores(dPs, dOs, Vs, wrow, jc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int r = warp + WARPS * i;
            for (int c = lane; c < T; c += 32) {
                float e = 0.f, ds = 0.f;
                if (r < rows && c < kv) {
                    e = expf(__fmul_rn(Ss[r * LDS + c], scale) - r_max[r]);
                    ds = ds_of(e, dPs[r * LDS + c], r_delta[r], r_invs[r]);
                }
                Es[r * LDH + c] = __float2bfloat16(e);
                dSs[r * LDH + c] = __float2bfloat16(ds);
            }
        }
        __syncthreads();
        // rows of these products are keys: dV += E^T bf16(dO inv),
        // dK += dS^T Q
        mma_tile<wmma::col_major, wmma::row_major>(acc_v, Es, dOi, wrow, jc);
        mma_tile<wmma::col_major, wmma::row_major>(acc_k, dSs, Qs, wrow, jc);
        __syncthreads();  // Q, dO and the E and dS tiles are read
    }
    store_tile(Ss, acc_v, wrow, jc);
    store_tile(dPs, acc_k, wrow, jc);
    __syncthreads();
    write_rows(dv, Ss, base, k0, k_end, kv, col0, D);
    write_rows(dk, dPs, base, k0, k_end, kv, col0, D);
}

}  // namespace

extern "C" {

// K8.  q, k, v, o, dout, dq, dk, dv: (B * row_stride, D) bf16 row-major;
// head h is columns h*64 .. h*64+63 (D = heads * 64); rows n_valid ..
// row_stride-1 of each example are not read, and their gradients are
// written as zero.  stats: f32 scratch of 3 * B * heads * row_stride
// (m, inv, delta per row).  scale = 1/sqrt(64).
int vit_attention_backward(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, void* dq,
                           void* dk, void* dv, void* stats, int B,
                           int row_stride, int n_valid, int D, int heads,
                           float scale, void* stream) {
    if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || D != heads * DH
        || n_valid < 1 || n_valid > row_stride)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((row_stride + T - 1) / T, heads, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_DQ);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_DKV);
    if (e != cudaSuccess) return (int)e;
    const bf16 *bq = static_cast<const bf16*>(q),
               *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v),
               *bdo = static_cast<const bf16*>(dout);
    float* fst = static_cast<float*>(stats);
    dq_kernel<<<grid, THREADS, SMEM_DQ, s>>>(
        bq, bk, bv, static_cast<const bf16*>(o), bdo, static_cast<bf16*>(dq),
        fst, row_stride, n_valid, D, heads, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dkv_kernel<<<grid, THREADS, SMEM_DKV, s>>>(
        bq, bk, bv, bdo, static_cast<bf16*>(dk), static_cast<bf16*>(dv), fst,
        row_stride, n_valid, D, heads, scale);
    return (int)cudaGetLastError();
}

}  // extern "C"
