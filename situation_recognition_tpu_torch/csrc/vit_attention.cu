// The ViT encoder block's attention core for NVIDIA Hopper, sm_90a.
//
// Replaces two TPU kernels of situation_recognition_tpu/ops/vit_pallas.py
// with one kernel, `vit_attention_forward`:
//   K5 `_attn_core_kernel`         the per-block path: (B, N, D) blocks,
//                                  row_stride = n_valid = N;
//   K7 `_attn_core_stream_kernel`  the stream stack: the (B * row_stride, D)
//                                  token stream with n_valid = N real rows
//                                  per example and the pad rows written
//                                  as zero.
// On the TPU the two differ because a 3-D (B, 257, D) block and a 2-D
// (B * 257, D) row stream tile differently, so a reshape between them is
// a physical relayout, and the stream pads every example to
// n8 = ceil(N / 8) * 8 rows to make the two layouts the same bytes
// (`_fused_stack_impl`).  On this card a row-major (B, N, D) tensor and
// its (B * N, D) view are the same bytes whatever N is, so the port's
// stream is not padded (row_stride = N); the kernel still takes a row
// stride and pad rows, the layout of the TPU's stream, and is tested at it.
//
// For each example, head h (columns h*64 .. h*64+63) and query row i:
//   folded:  q' = bf16(q * scale * log2(e))          (f32 product)
//            s  = q' k^T (f32),  e = bf16(exp2(s - max s))
//            ctx = (e V) * (1 / sum_f32(e))
//   plain:   p  = bf16(softmax_f32(s * scale)),  ctx = p V
// over the n_valid real keys only; bf16 operands, f32 sums, ctx in bf16.
// These are the TPU kernels' numerics (SRTPU_ATTN_CORE selects the flavour).
//
// Design.  One block per (64-query tile, head, example), 8 warps, and a
// loop over tiles of 64 keys, so that any token count runs in 54 KB of
// shared memory (up to four blocks per SM): the query tile (pre-scaled in
// the folded flavour), one K tile, one V tile, an f32 score tile that
// also stages the output, and a bf16 probability tile.  The loop runs
// twice.  Pass 1 forms S = Q K^T tile by tile (WMMA bf16 16x16x16, f32
// sums) and keeps each row's maximum (and, for the plain flavour, its
// running f32 sum of exponents, rescaled when the maximum grows).  Pass 2
// forms the same S again, turns it into the bf16 exponents or
// probabilities against the whole row's maximum, and adds P V into f32
// accumulator fragments that stay in registers across the key tiles.  So
// the folded flavour's roundings are the TPU kernel's exactly: the bf16
// exponent is taken against the row's final maximum, never rescaled; the
// cost is a second Q K^T.  Nothing of the (B, h, N, N) scores reaches
// device memory.
//
// What bounds it on this card.  At ViT-L/14, batch 256 (16 heads, N = 257)
// the work is 4 B h N^2 64 = 6.9e10 FLOP against 0.54 GB of q, k, v and
// context: bound by memory (0.16 ms at 3.35 TB/s).  This simple design
// reads K and V twice per query tile (5 tiles per head, from L2), computes
// Q K^T twice and serialises load, products and softmax within a block;
// PERF.md keeps its time beside the bound.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, nothing is synchronised or allocated here, and the function
// returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;


namespace {

constexpr int QT = 64;         // query rows of a block
constexpr int KT = 64;         // keys of a tile
constexpr int DH = 64;         // head width
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = QT / WARPS;
constexpr int LDH = DH + 8;    // bf16 leading dimension of the Q, K, V tiles
constexpr int LDS = KT + 4;    // f32 leading dimension of the score tile
constexpr int LDP = KT + 8;    // bf16 leading dimension of the probabilities
static_assert(KT == DH, "the score tile stages the 64-wide output");

// dynamic shared memory of a block: Q, K and V tiles, f32 scores, bf16
// probabilities and a factor per row (54,528 bytes)
constexpr size_t SMEM = (size_t)(QT + 2 * KT) * LDH * 2 + (size_t)QT * LDS * 4
                        + (size_t)QT * LDP * 2 + QT * 4;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
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

// rows r0 .. r0 + count - 1 of an example's head columns into a 64-row
// tile; the tile's other rows are zero
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* __restrict__ src,
                                           size_t base, int r0, int count,
                                           int col0, int D) {
    for (int c = threadIdx.x; c < KT * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        bf16* d = dst + row * LDH + c8;
        if (row < count)
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(
                src + (base + r0 + row) * D + col0 + c8);
        else
            zero8(d);
    }
}

// S = Q K^T for one key tile: warp w takes row tile w & 3 and column tiles
// jc, jc + 1, with its Q fragments held in registers
__device__ __forceinline__ void scores(float* Ss, const FragA (&fq)[DH / 16],
                                       const bf16* Ks, int wrow, int jc) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int t = 0; t < DH / 16; ++t) {
            FragBt fk;
            wmma::load_matrix_sync(fk, Ks + (jc + jj) * 16 * LDH + t * 16, LDH);
            wmma::mma_sync(acc, fq[t], fk, acc);
        }
        wmma::store_matrix_sync(Ss + wrow * 16 * LDS + (jc + jj) * 16, acc,
                                LDS, wmma::mem_row_major);
    }
}

template <bool FOLDED>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out,
            int row_stride, int n_valid, int D, float qscale, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + QT * LDH;
    bf16* Vs = Ks + KT * LDH;
    float* Ss = reinterpret_cast<float*>(Vs + KT * LDH);
    bf16* Ps = reinterpret_cast<bf16*>(Ss + QT * LDS);
    float* rowf = reinterpret_cast<float*>(Ps + QT * LDP);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int q0 = blockIdx.x * QT;
    const int col0 = blockIdx.y * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + QT, row_stride);

    if (q0 >= n_valid) {  // a tile of pad rows only
        for (int c = tid; c < QT * 8; c += THREADS) {
            const int gi = q0 + (c >> 3);
            if (gi < q_end) zero8(out + (base + gi) * D + col0 + (c & 7) * 8);
        }
        return;
    }
    const int rows = min(QT, n_valid - q0);   // real query rows here

    // ---- the query tile, rows past the real ones zero
    for (int c = tid; c < QT * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        bf16* dq = Qs + row * LDH + c8;
        if (row < rows) {
            uint4 raw = *reinterpret_cast<const uint4*>(
                q + (base + q0 + row) * D + col0 + c8);
            if (FOLDED) {
                bf16* e = reinterpret_cast<bf16*>(&raw);
                for (int i = 0; i < 8; ++i)
                    e[i] = __float2bfloat16(__bfloat162float(e[i]) * qscale);
            }
            *reinterpret_cast<uint4*>(dq) = raw;
        } else {
            zero8(dq);
        }
    }
    __syncthreads();

    const int wrow = warp & 3, jc = (warp >> 2) * 2;
    FragA fq[DH / 16];
#pragma unroll
    for (int t = 0; t < DH / 16; ++t)
        wmma::load_matrix_sync(fq[t], Qs + wrow * 16 * LDH + t * 16, LDH);
    const int n_tiles = (n_valid + KT - 1) / KT;

    // the softmax state of warp w's rows w, w + 8, ..., w + 56
    float mx[ROWS_PER_WARP], den[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
        mx[i] = -INFINITY;
        den[i] = 0.f;
    }

    // ---- pass 1: each row's maximum over the real keys (and the plain
    // flavour's f32 sum of exp(s * scale - max * scale))
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * KT, kv = min(KT, n_valid - k0);
        stage_tile(Ks, k, base, k0, kv, col0, D);
        __syncthreads();
        scores(Ss, fq, Ks, wrow, jc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const float* srow = Ss + (warp + WARPS * i) * LDS;
            const float s0 = lane < kv ? srow[lane] : -INFINITY;
            const float s1 = lane + 32 < kv ? srow[lane + 32] : -INFINITY;
            const float m = fmaxf(mx[i], warp_max(fmaxf(s0, s1)));
            if (!FOLDED) {
                const float ms = m * scale;
                float e = (lane < kv ? expf(s0 * scale - ms) : 0.f)
                          + (lane + 32 < kv ? expf(s1 * scale - ms) : 0.f);
                den[i] = den[i] * expf(mx[i] * scale - ms) + warp_sum(e);
            }
            mx[i] = m;
        }
    }

    // ---- pass 2: the same scores, exponents against the row's maximum,
    // ctx += P V; warp w accumulates row tile w & 3, column tiles jc, jc + 1
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * KT, kv = min(KT, n_valid - k0);
        stage_tile(Ks, k, base, k0, kv, col0, D);
        stage_tile(Vs, v, base, k0, kv, col0, D);
        __syncthreads();
        scores(Ss, fq, Ks, wrow, jc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int r = warp + WARPS * i;
            const float* srow = Ss + r * LDS;
            bf16* prow = Ps + r * LDP;
            float part = 0.f;
            for (int c = lane; c < KT; c += 32) {
                bf16 p = __float2bfloat16(0.f);
                if (c < kv) {
                    if (FOLDED) {
                        p = __float2bfloat16(exp2f(srow[c] - mx[i]));
                        part += __bfloat162float(p);
                    } else {
                        p = __float2bfloat16(
                            expf(srow[c] * scale - mx[i] * scale) / den[i]);
                    }
                }
                prow[c] = p;
            }
            if (FOLDED) den[i] += warp_sum(part);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
            FragA fp;
            wmma::load_matrix_sync(fp, Ps + wrow * 16 * LDP + kk * 16, LDP);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                FragB fv;
                wmma::load_matrix_sync(fv, Vs + kk * 16 * LDH + (jc + jj) * 16,
                                       LDH);
                wmma::mma_sync(acc[jj], fp, fv, acc[jj]);
            }
        }
        __syncthreads();  // K, V and P of this tile are read
    }

    // ---- stage ctx through the score tile; the folded flavour divides by
    // its f32 sum of the bf16 exponents here, after P V
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i)
            rowf[warp + WARPS * i] = FOLDED ? 1.f / den[i] : 1.f;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
        wmma::store_matrix_sync(Ss + wrow * 16 * LDS + (jc + jj) * 16, acc[jj],
                                LDS, wmma::mem_row_major);
    __syncthreads();

    // ---- write rows q0 .. q_end - 1: real rows scaled by their factor,
    // pad rows zero
    for (int c = tid; c < QT * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        const int gi = q0 + row;
        if (gi >= q_end) continue;
        bf16* dst = out + (base + gi) * D + col0 + c8;
        if (row < rows) {
            const float f = rowf[row];
            uint4 raw;
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&raw);
            const float* src = Ss + row * LDS + c8;
            for (int i = 0; i < 4; ++i)
                o[i] = __floats2bfloat162_rn(src[2 * i] * f, src[2 * i + 1] * f);
            *reinterpret_cast<uint4*>(dst) = raw;
        } else {
            zero8(dst);
        }
    }
}

template <bool FOLDED>
cudaError_t launch(const dim3& grid, cudaStream_t s, const void* q,
                   const void* k, const void* v, void* out, int row_stride,
                   int n_valid, int D, float qscale, float scale) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<FOLDED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e != cudaSuccess) return e;
    attn_kernel<FOLDED><<<grid, THREADS, SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), row_stride,
        n_valid, D, qscale, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5 / K7.  q, k, v, out: (B * row_stride, D) bf16 row-major; head h is
// columns h*64 .. h*64+63 (D = heads * 64).  Rows n_valid .. row_stride-1
// of each example are not read and are written as zero.  qscale =
// scale * log2(e) (the folded flavour), scale = 1/sqrt(64).
int vit_attention_forward(const void* q, const void* k, const void* v,
                          void* out, int B, int row_stride, int n_valid,
                          int D, int heads, float qscale, float scale,
                          int folded, void* stream) {
    if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || D != heads * DH
        || n_valid < 1 || n_valid > row_stride)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((row_stride + QT - 1) / QT, heads, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(folded ? launch<true>(grid, s, q, k, v, out, row_stride,
                                       n_valid, D, qscale, scale)
                        : launch<false>(grid, s, q, k, v, out, row_stride,
                                        n_valid, D, qscale, scale));
}

}  // extern "C"
