// The ViT attention core's backward for NVIDIA Hopper, sm_90a.
//
// Replaces K8 of situation_recognition_tpu/ops/vit_pallas.py,
// `_attn_bwd_stream_kernel`: the gradients dq, dk, dv of the stream's
// attention core (K7), given its inputs q, k, v, its bf16 output o and the
// cotangent do, all (B * row_stride, D) bf16 with n_valid real rows per
// example.  It is the backward of the fine-tuning path's differentiable
// attention (ops/vit_train.py, `DiffAttention`).
//
// For each example, head h (columns h*dh .. h*dh+dh-1, dh = D / heads any
// multiple of 64, as the TPU kernel takes), query row i and key j,
// whatever the forward's softmax flavour (the TPU kernel's numerics):
//   s_ij  = (q_i . k_j in f32) * scale,   m_i = max_j s_ij
//   e_ij  = exp(s_ij - m_i) in f32,       inv_i = 1 / sum_j e_ij
//   delta_i = sum over the head's dh columns of do_i * o_i in f32
//   dv_j  = sum_i bf16(e_ij) * bf16(do_i * inv_i)
//   dp_ij = do_i . v_j
//   ds_ij = bf16(e_ij * (dp_ij - delta_i) * (inv_i * scale))
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// with scale = 1/sqrt(dh), bf16 operands and f32 sums, over the real rows
// only; dq, dk, dv in bf16, and the pad rows n_valid .. row_stride-1 of
// each example written as zero (never read).  Every bf16 cast is
// elementwise once m, inv and delta are known, so tiling changes only the
// order of the f32 sums.  The statistics are the unfolded f32 softmax's:
// the folded forward's maximum and sum are of bf16 exponents of
// bf16(q * scale * log2 e) k^T, which differ from these by those
// roundings, so they are formed here and not taken from the forward.
//
// What bounds it on this card.  At ViT-L/14, batch 256 (16 heads, N = 257)
// the work is five products of 2 N^2 dh per head and example (1.73e11
// FLOP, 0.175 ms at 989 TFLOP/s) against eight (B N, D) bf16 tensors read
// or written (1.08 GB, 0.322 ms at 3.35 TB/s): bound by memory, whatever
// the split of D = 1024 into heads.  The kernels compute eight products
// (Q K^T three times, dO V^T twice) to stay free of atomics; what held
// the first design back was not those products but f32 score tiles
// round-tripped through shared memory between block barriers, and tiles
// staged synchronously.
//
// Design: FlashAttention-2's split into two launches with no atomics, so
// the result does not depend on the order in which blocks run, with
// FlashAttention-2's warp layout in each: 4 warps, each owning 16 rows of
// the products it forms, mma.sync.m16n8k16 bf16 with f32 sums, operands
// through ldmatrix, and S, dP, the exponents and dS in registers, formed
// in chunks of 16 keys (or queries).
//   1. `dq_kernel`, blocks over (64-query tile, head, example); warp w
//      owns query rows 16w .. 16w+15.  Pass 1 over the 64-key tiles forms
//      S = Q K^T; each lane keeps the maximum of its columns and its f32
//      sum of exponents (rescaled as that maximum grows), combined over
//      the row's four lanes by shuffles at the end; with delta from do and
//      o it writes m, inv, delta to a (3, B, heads, row_stride) f32
//      scratch.  Pass 2 forms S and dP = dO V^T, dS elementwise in the
//      accumulators, and dQ += dS K with dS's accumulators reused as the A
//      fragment and K through ldmatrix.trans.
//   2. `dkv_kernel`, blocks over (64-key tile, head, example); warp w
//      owns keys 16w .. 16w+15 and forms the transposed tiles S^T = K Q^T
//      and dP^T = V dO^T over the 64-query tiles, so that E^T and dS^T are
//      born in the A-fragment layout of dV += E^T bf16(dO inv) and
//      dK += dS^T Q.  The per-query m, inv, delta are per column there:
//      each lane reads its columns' from a copy of the scratch that comes
//      in with the query tile.  bf16(dO inv) is formed in the B fragments
//      (ldmatrix.trans of dO, each element times its query's inv), with no
//      tile or barrier of its own.
// The tiles each kernel loops over come in through a 3-stage cp.async
// ring, zero-filled past the real rows, one block barrier per step, and
// the results are staged through a free stage for 16-byte stores.  A
// ragged last tile runs a masked copy of the work, whose 16-row chunks
// with no real key (dq_kernel) or query (dkv_kernel) are skipped; warps
// whose rows are all pad rows skip the products.  Products that the TPU
// kernel rounds separately are written with __fmul_rn and __fsub_rn so
// that the compiler fuses none of them.
//
// Two forms of each kernel, by head width (template argument RESIDENT):
//   resident (dh = 64)  one block per (tile, head, example).  The block's
//      own operands (Q and dO, or K and V) come in with the first stage
//      into the third and stay in registers as A fragments; the tiles it
//      loops over (K and V, or Q, dO and the statistics) take one ring
//      step each, and the products go over them in chunks of 16 rows.
//      55,296 and 57,600 bytes of shared memory, at most 168 registers a
//      thread: three blocks of either kernel per SM (uncapped registers,
//      two blocks, measured slower).
//   chunked (any dh that is a multiple of 64)  at dh = 128 the resident
//      dkv_kernel's dk and dv accumulators and its K and V fragments alone
//      would take 192 registers, so the head width is cut both ways, as in
//      the forward's chunked form.  The reductions over dh (Q K^T, dO V^T,
//      delta) run in chunks of 64 columns: one ring step per (tile,
//      chunk) brings that chunk of both operands of each product (Q, K,
//      dO, V), and S and dP of the warp's 16 rows against the tile's 64
//      columns accumulate in registers over the chunks (delta is summed
//      from device memory before the loop).  The outputs are cut into
//      groups of 64 columns, one more grid axis (blockIdx.y = head *
//      dh / 64 + group): each block forms its rows' S and dP over all dh
//      columns and its own 64 columns of dq (or of dk and dv), so the
//      score products are formed dh / 64 times over.  One more step per
//      tile brings the group's columns of the tile the outputs multiply (K
//      for dq; Q, dO and the statistics for dk, dv).  Only the group-0
//      blocks of dq_kernel write the statistics; every group forms them
//      alike (the same chunks in the same order).  110,592 bytes of shared
//      memory a block (four chunk slots a stage), at most 255 registers:
//      two blocks per SM.
// `-Xptxas -v` gives each instantiation's registers and spills (PERF.md).
//
// Interface: plain C, loaded with ctypes.  The launches go on the caller's
// stream in order, nothing is synchronised or allocated here, and the
// function returns cudaGetLastError() after each launch (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;


namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int T = 16 * WARPS;  // query rows of a query tile, keys of a key tile
constexpr int DH = 64;         // columns of a tile: the resident head width, a chunk
constexpr int LDH = DH + 8;    // bf16 row pitch: conflict-free ldmatrix
constexpr int STAGES = 3;
constexpr int SLOT = T * LDH;  // bf16 elements of one 64-row tile
static_assert(T == DH, "every operand of the products is 64 x 64");

// blocks an SM must hold (bounds the registers), by form
template <bool RESIDENT>
struct MinBlocks {
    static constexpr int value = RESIDENT ? 3 : 2;
};

// dq_kernel's resident stage: a K slot and a V slot (18,432 bytes)
constexpr size_t STAGE_DQ = 2 * SLOT * sizeof(bf16);
// dkv_kernel's resident stage: a Q slot, a dO slot and m, inv, delta of
// the 64 queries (19,200 bytes)
constexpr size_t STAGE_DKV = 2 * SLOT * sizeof(bf16) + 3 * T * sizeof(float);
// a chunked stage: four slots (36,864 bytes), which also hold the dkv
// group step's two slots and statistics
constexpr size_t STAGE_CHUNKED = 4 * SLOT * sizeof(bf16);
constexpr size_t SMEM_DQ = STAGES * STAGE_DQ;            // 55,296 bytes
constexpr size_t SMEM_DKV = STAGES * STAGE_DKV;          // 57,600 bytes
constexpr size_t SMEM_CHUNKED = STAGES * STAGE_CHUNKED;  // 110,592 bytes
static_assert(STAGE_DKV % 16 == 0, "stages stay 16-byte aligned");
static_assert(STAGE_DKV <= STAGE_CHUNKED, "the group step fits a stage");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled, and the source
// not read, when `src_bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared, asynchronously, zero-filled as cp_async16
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is pending
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// a B-fragment register of two bf16 dO elements, each times its query's
// inv and rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t r, float lo, float hi) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&r));
    return pack_bf16(__fmul_rn(f.x, lo), __fmul_rn(f.y, hi));
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void zero(float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
}

// rows r0 .. r0 + count - 1 of an example's 64 columns from col0 into a
// 64-row slot, asynchronously; the slot's other rows are zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          size_t base, int r0, int count,
                                          int col0, int D) {
    for (int c = threadIdx.x; c < T * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        const bool real = row < count;
        cp_async16(dst + row * LDH + c8,
                   src + (real ? (base + r0 + row) * D + col0 + c8 : 0),
                   real ? 16 : 0);
    }
}

// m, inv, delta of the 64 rows q0 .. q0+63 (those below `rows`, the
// others zero-filled) into a stage's statistics, asynchronously
__device__ __forceinline__ void load_stats(float* dst, const float* st,
                                           size_t plane, int q0, int rows) {
    for (int c = threadIdx.x; c < 3 * T; c += THREADS) {
        const int which = c / T, i = c % T;
        const bool real = i < rows;
        cp_async4(dst + c, st + (real ? which * plane + q0 + i : 0),
                  real ? 4 : 0);
    }
}

// the 16 x 64 A fragments of rows r0 .. r0+15 of a slot
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4],
                                       const bf16* slot, int r0, int lane) {
#pragma unroll
    for (int t = 0; t < DH / 16; ++t)
        ldsm_x4(a[t], slot + (r0 + (lane & 15)) * LDH + t * 16
                      + (lane >> 4) * 8);
}

// s += A B^T for the warp's 16 rows of A (fragments a) against rows c0 ..
// c0+15 of a slot b: s[j] is the m16n8 accumulator of b's rows c0 + 8j .. +7
__device__ __forceinline__ void chunk_abt(float (&s)[2][4],
                                          const uint32_t (&a)[DH / 16][4],
                                          const bf16* b, int c0, int lane) {
    const bf16* p = b + (c0 + (lane & 7) + ((lane >> 4) << 3)) * LDH
                    + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int t = 0; t < DH / 16; ++t) {
        uint32_t r[4];
        ldsm_x4(r, p + t * 16);
        mma(s[0], a[t], r[0], r[1]);
        mma(s[1], a[t], r[2], r[3]);
    }
}

// chunk_abt over the 16-row chunks of a slot that hold a row below
// `count`: s[c] += A B^T of rows 16c .. 16c+15
__device__ __forceinline__ void tile_abt(float (&s)[T / 16][2][4],
                                         const uint32_t (&a)[DH / 16][4],
                                         const bf16* b, int count, int lane) {
#pragma unroll
    for (int c = 0; c < T / 16; ++c)
        if (16 * c < count) chunk_abt(s[c], a, b, 16 * c, lane);
}

// the address of lane's row for ldmatrix.trans of rows c0 .. c0+15 of a
// slot as the k16 x n64 B operand
__device__ __forceinline__ const bf16* trans_rows(const bf16* slot, int c0,
                                                  int lane) {
    return slot + (c0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH
           + (lane >> 4) * 8;
}

// acc += dS K for dS's A fragment over rows c0 .. c0+15 of a K slot
__device__ __forceinline__ void ds_times(float (&acc)[DH / 8][4],
                                         const uint32_t (&dsa)[4],
                                         const bf16* b, int c0, int lane) {
    const bf16* p = trans_rows(b, c0, lane);
#pragma unroll
    for (int nb = 0; nb < DH / 16; ++nb) {
        uint32_t r[4];
        ldsm_x4_t(r, p + nb * 16);
        mma(acc[2 * nb], dsa, r[0], r[1]);
        mma(acc[2 * nb + 1], dsa, r[2], r[3]);
    }
}

// the warp's 16 rows (f32 accumulators, 8 n8 tiles) in bf16 into the
// warp's rows of a free slot, then rows r0 .. r0+15 of an example's 64
// columns from col0 with 16-byte stores: rows below `real_end` from the
// slot, rows up to `end` zero
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, bf16* slot,
                                           const float (&acc)[DH / 8][4],
                                           bool busy, size_t base, int r0,
                                           int real_end, int end, int col0,
                                           int D, int lane) {
    const int g = lane >> 2, tq = lane & 3;
    if (busy) {
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r)
                *reinterpret_cast<__nv_bfloat162*>(
                    slot + (g + 8 * r) * LDH + 8 * n + 2 * tq) =
                    __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * 8; c += 32) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        const int gi = r0 + row;
        if (gi >= end) continue;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gi < real_end)
            val = *reinterpret_cast<const uint4*>(slot + row * LDH + c8);
        *reinterpret_cast<uint4*>(out + (base + gi) * D + col0 + c8) = val;
    }
}

__device__ __forceinline__ void zero_rows(bf16* __restrict__ out, size_t base,
                                          int r0, int r_end, int col0, int D) {
    for (int c = threadIdx.x; c < T * 8; c += THREADS) {
        const int gi = r0 + (c >> 3);
        if (gi < r_end)
            *reinterpret_cast<uint4*>(out + (base + gi) * D + col0
                                      + (c & 7) * 8) = make_uint4(0, 0, 0, 0);
    }
}

// ds of one score element: e * (dp - delta) * (inv * scale), each product
// rounded as written (no fused multiply-add across them)
__device__ __forceinline__ float ds_of(float e, float dp, float delta,
                                       float invs) {
    return __fmul_rn(__fmul_rn(e, __fsub_rn(dp, delta)), invs);
}

// part + the f32 dot product of eight bf16 pairs (do, o), each product and
// sum rounded as written
__device__ __forceinline__ float dot8(float part, uint4 dv, uint4 ov) {
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(dp[i]);
        const float2 b = __bfloat1622float2(op[i]);
        part = __fadd_rn(part, __fmul_rn(a.x, b.x));
        part = __fadd_rn(part, __fmul_rn(a.y, b.y));
    }
    return part;
}

// dq pass 1 on the scores s of 16 keys k0 .. k0+15: s * scale in place,
// the lane's maxima of rows g and g + 8 and its f32 sums of exp(s * scale
// - max), rescaled as the maxima grow; masked (M): keys from kv on enter
// as -inf
template <bool M>
__device__ __forceinline__ void dq_stats_chunk(float (&s)[2][4],
                                               float (&mx)[2],
                                               float (&den)[2], int k0,
                                               int kv, int tq, float scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float cm = mx[r];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
                float x = __fmul_rn(s[j][e], scale);
                if (M && k0 + 8 * j + 2 * tq + (e & 1) >= kv)
                    x = -INFINITY;
                s[j][e] = x;
                cm = fmaxf(cm, x);
            }
        if (cm != -INFINITY) {
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 2 * r; e < 2 * r + 2; ++e)
                    if (!M || s[j][e] != -INFINITY)
                        part += expf(s[j][e] - cm);
            const float f = mx[r] == -INFINITY ? 0.f : expf(mx[r] - cm);
            den[r] = den[r] * f + part;
        }
        mx[r] = cm;
    }
}

// the end of dq's pass 1: the rows' m and inv * scale over all keys; the
// real rows' m, inv, delta to the scratch `st` (per plane), if given
__device__ __forceinline__ void dq_finish_stats(float (&mx)[2],
                                                const float (&den)[2],
                                                float (&invs)[2],
                                                const float (&delta)[2],
                                                float* st, size_t plane,
                                                int r_warp, int n_valid,
                                                int lane, float scale) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float m = quad_max(mx[r]);
        const float f = mx[r] == -INFINITY ? 0.f : expf(mx[r] - m);
        const float inv = 1.f / quad_sum(den[r] * f);
        mx[r] = m;
        invs[r] = __fmul_rn(inv, scale);
        const int gi = r_warp + g + 8 * r;
        if (st != nullptr && tq == 0 && gi < n_valid) {
            st[gi] = m;
            st[plane + gi] = inv;
            st[2 * plane + gi] = delta[r];
        }
    }
}

// dq pass 2 on S and dP of 16 keys k0 .. k0+15: dS as the A fragment over
// these keys (the accumulators of keys k0 .. +7 and k0+8 .. +15 are its
// halves); masked (M) keys give 0
template <bool M>
__device__ __forceinline__ void ds_chunk(uint32_t (&dsa)[4],
                                         const float (&s)[2][4],
                                         const float (&dp)[2][4],
                                         const float (&mx)[2],
                                         const float (&delta)[2],
                                         const float (&invs)[2], int k0,
                                         int kv, int tq, float scale) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float x[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int e = 2 * r + hh;
                const float ev = expf(__fmul_rn(s[j][e], scale) - mx[r]);
                x[hh] = ds_of(ev, dp[j][e], delta[r], invs[r]);
                if (M && k0 + 8 * j + 2 * tq + hh >= kv) x[hh] = 0.f;
            }
            dsa[2 * j + r] = pack_bf16(x[0], x[1]);
        }
}

// dkv on S^T and dP^T of the warp's 16 keys against the 16 queries q0 ..
// q0+15 of a group stage (qs: the Q slot, then the dO slot, then m, inv,
// delta of its 64 queries): E^T and dS^T, dV += E^T bf16(dO inv), dK +=
// dS^T Q; masked (M) queries from `rows` on give 0
template <bool M>
__device__ __forceinline__ void dkv_chunk(float (&acc_k)[DH / 8][4],
                                          float (&acc_v)[DH / 8][4],
                                          const float (&sc)[2][4],
                                          const float (&dp)[2][4],
                                          const bf16* qs, int q0, int rows,
                                          int lane, float scale) {
    const int tq = lane & 3;
    const bf16* dos = qs + SLOT;
    const float* s_m = reinterpret_cast<const float*>(qs + 2 * SLOT);
    const float* s_inv = s_m + T;
    const float* s_delta = s_inv + T;
    uint32_t ea[4], dsa[4];
    float inv[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int qi = q0 + 8 * j + 2 * tq;   // the lane's columns
        const float2 m2 = *reinterpret_cast<const float2*>(s_m + qi);
        const float2 i2 = *reinterpret_cast<const float2*>(s_inv + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(s_delta + qi);
        inv[j][0] = i2.x;
        inv[j][1] = i2.y;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float ev[2], x[2];
#pragma unroll
            for (int col = 0; col < 2; ++col) {
                const int e = 2 * r + col;
                ev[col] = 0.f;
                x[col] = 0.f;
                if (!M || qi + col < rows) {
                    ev[col] = expf(__fmul_rn(sc[j][e], scale)
                                   - (col ? m2.y : m2.x));
                    x[col] = ds_of(ev[col], dp[j][e],
                                   col ? d2.y : d2.x,
                                   __fmul_rn(col ? i2.y : i2.x, scale));
                }
            }
            ea[2 * j + r] = pack_bf16(ev[0], ev[1]);
            dsa[2 * j + r] = pack_bf16(x[0], x[1]);
        }
    }
    // dV += E^T bf16(dO inv): the B fragments of dO over these 16 queries
    // hold queries q0 + 2tq, +1 (b0, b2) and q0 + 8 + 2tq, +1 (b1, b3),
    // the lane's own columns above
    const bf16* dp_rows = trans_rows(dos, q0, lane);
    const bf16* q_rows = trans_rows(qs, q0, lane);
#pragma unroll
    for (int nb = 0; nb < DH / 16; ++nb) {
        uint32_t b[4];
        ldsm_x4_t(b, dp_rows + nb * 16);
        mma(acc_v[2 * nb], ea, scale_pair(b[0], inv[0][0], inv[0][1]),
            scale_pair(b[1], inv[1][0], inv[1][1]));
        mma(acc_v[2 * nb + 1], ea, scale_pair(b[2], inv[0][0], inv[0][1]),
            scale_pair(b[3], inv[1][0], inv[1][1]));
        // dK += dS^T Q
        ldsm_x4_t(b, q_rows + nb * 16);
        mma(acc_k[2 * nb], dsa, b[0], b[1]);
        mma(acc_k[2 * nb + 1], dsa, b[2], b[3]);
    }
}

// the resident dq: dh = 64, one block per (query tile, head, example)
__device__ __forceinline__ void dq_resident(
        unsigned char* smem, const bf16* __restrict__ q,
        const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ o, const bf16* __restrict__ dout,
        bf16* __restrict__ dq, float* __restrict__ stats, int row_stride,
        int n_valid, int D, int heads, float scale) {
    bf16* ring = reinterpret_cast<bf16*>(smem);   // stage s: K at 2s, V at 2s+1

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int q0 = blockIdx.x * T, h = blockIdx.y;
    const int col0 = h * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + T, row_stride);
    if (q0 >= n_valid) {  // a tile of pad rows only
        zero_rows(dq, base, q0, q_end, col0, D);
        return;
    }
    const int rows = min(T, n_valid - q0);   // real query rows here
    const int r_warp = q0 + 16 * warp;       // the warp's first query row
    const bool busy = 16 * warp < rows;
    const int n_tiles = (n_valid + T - 1) / T;
    const int n_steps = 2 * n_tiles;         // pass 1, then pass 2

    // step s of the ring: key tile s % n_tiles; K always, V in pass 2
    auto issue = [&](int s) {
        if (s < n_steps) {
            const int t = s < n_tiles ? s : s - n_tiles;
            const int k0 = t * T, kv = min(T, n_valid - k0);
            bf16* st = ring + (s % STAGES) * 2 * SLOT;
            load_tile(st, k, base, k0, kv, col0, D);
            if (s >= n_tiles) load_tile(st + SLOT, v, base, k0, kv, col0, D);
        }
        cp_async_commit();
    };

    // prologue: Q and dO into stage 2 with step 0, then step 1
    bf16* qs = ring + 2 * 2 * SLOT;
    bf16* dos = qs + SLOT;
    load_tile(qs, q, base, q0, rows, col0, D);
    load_tile(dos, dout, base, q0, rows, col0, D);
    issue(0);
    issue(1);
    cp_async_wait1();
    __syncthreads();

    uint32_t qa[DH / 16][4], da[DH / 16][4];
    float delta[2] = {0.f, 0.f};
    if (busy) {
        load_a(qa, qs, 16 * warp, lane);
        load_a(da, dos, 16 * warp, lane);
        // delta of the warp's rows: lanes L and L + 16 sum halves of row
        // L % 16
        const int rr = lane & 15, c0 = (lane >> 4) * 32;
        float part = 0.f;
        if (r_warp + rr < n_valid) {
            const bf16* orow = o + (base + r_warp + rr) * D + col0 + c0;
            const bf16* drow = dos + (16 * warp + rr) * LDH + c0;
#pragma unroll
            for (int c = 0; c < 32; c += 8)
                part = dot8(part, *reinterpret_cast<const uint4*>(drow + c),
                            *reinterpret_cast<const uint4*>(orow + c));
        }
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 16));
        delta[0] = __shfl_sync(0xffffffffu, part, g);
        delta[1] = __shfl_sync(0xffffffffu, part, g + 8);
    }

    // per lane, rows g and g + 8: the maximum of its columns of s * scale
    // and its f32 sum of exp(s * scale - max); after pass 1, the rows' m
    // and inv * scale
    float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
    float invs[2] = {0.f, 0.f};
    float acc[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // pass 1 over one key tile; `masked`: kv < T, and chunks with no real
    // key are skipped
    auto pass1 = [&](const bf16* ks, int kv, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < T / 16; ++c) {
            if (M && 16 * c >= kv) continue;
            float sc[2][4];
            zero(sc);
            chunk_abt(sc, qa, ks, 16 * c, lane);
            dq_stats_chunk<M>(sc, mx, den, 16 * c, kv, tq, scale);
        }
    };

    // pass 2 over one key tile: dS, dQ += dS K; `masked` as in pass 1
    auto pass2 = [&](const bf16* ks, const bf16* vs, int kv, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < T / 16; ++c) {
            if (M && 16 * c >= kv) continue;
            float sc[2][4], dp[2][4];
            zero(sc);
            zero(dp);
            chunk_abt(sc, qa, ks, 16 * c, lane);
            chunk_abt(dp, da, vs, 16 * c, lane);
            uint32_t dsa[4];
            ds_chunk<M>(dsa, sc, dp, mx, delta, invs, 16 * c, kv, tq, scale);
            ds_times(acc, dsa, ks, 16 * c, lane);
        }
    };

    for (int s = 0; s < n_steps; ++s) {
        cp_async_wait1();
        __syncthreads();   // step s landed; every warp is done with step s - 1
        issue(s + 2);      // into the stage step s - 1 used
        if (!busy) continue;
        const bf16* ks = ring + (s % STAGES) * 2 * SLOT;
        const bool second = s >= n_tiles;
        const int kv = min(T, n_valid - (second ? s - n_tiles : s) * T);
        if (second) {
            if (kv < T) pass2(ks, ks + SLOT, kv, std::true_type{});
            else pass2(ks, ks + SLOT, kv, std::false_type{});
            continue;
        }
        if (kv < T) pass1(ks, kv, std::true_type{});
        else pass1(ks, kv, std::false_type{});
        if (s == n_tiles - 1) {
            // the rows' statistics over all keys; the real rows' go to the
            // scratch for dkv_kernel
            const size_t plane = (size_t)gridDim.z * heads * row_stride;
            dq_finish_stats(mx, den, invs, delta,
                            stats + ((size_t)blockIdx.z * heads + h)
                                    * row_stride,
                            plane, r_warp, n_valid, lane, scale);
        }
    }
    cp_async_wait_all();
    store_rows(dq, ring + (n_steps % STAGES) * 2 * SLOT + 16 * warp * LDH,
               acc, busy, base, r_warp, n_valid, q_end, col0, D, lane);
}

// the resident dk, dv: dh = 64, one block per (key tile, head, example)
__device__ __forceinline__ void dkv_resident(
        unsigned char* smem, const bf16* __restrict__ q,
        const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ dout, bf16* __restrict__ dk,
        bf16* __restrict__ dv, const float* __restrict__ stats,
        int row_stride, int n_valid, int D, int heads, float scale) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int k0 = blockIdx.x * T, h = blockIdx.y;
    const int col0 = h * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int k_end = min(k0 + T, row_stride);
    if (k0 >= n_valid) {  // a tile of pad rows only
        zero_rows(dk, base, k0, k_end, col0, D);
        zero_rows(dv, base, k0, k_end, col0, D);
        return;
    }
    const int kv = min(T, n_valid - k0);     // real keys here
    const int r_warp = k0 + 16 * warp;       // the warp's first key
    const bool busy = 16 * warp < kv;
    const int n_steps = (n_valid + T - 1) / T;   // query tiles
    const size_t plane = (size_t)gridDim.z * heads * row_stride;
    const float* st = stats + ((size_t)blockIdx.z * heads + h) * row_stride;

    // stage s: Q slot, dO slot, then m, inv, delta of its 64 queries
    auto q_slot = [&](int s) {
        return reinterpret_cast<bf16*>(smem + (s % STAGES) * STAGE_DKV);
    };
    auto issue = [&](int s) {
        if (s < n_steps) {
            const int q0 = s * T, rows = min(T, n_valid - q0);
            bf16* qs = q_slot(s);
            load_tile(qs, q, base, q0, rows, col0, D);
            load_tile(qs + SLOT, dout, base, q0, rows, col0, D);
            load_stats(reinterpret_cast<float*>(qs + 2 * SLOT), st, plane,
                       q0, rows);
        }
        cp_async_commit();
    };

    // prologue: K and V into stage 2 with step 0, then step 1
    load_tile(q_slot(2), k, base, k0, kv, col0, D);
    load_tile(q_slot(2) + SLOT, v, base, k0, kv, col0, D);
    issue(0);
    issue(1);
    cp_async_wait1();
    __syncthreads();

    uint32_t ka[DH / 16][4], va[DH / 16][4];
    if (busy) {
        load_a(ka, q_slot(2), 16 * warp, lane);
        load_a(va, q_slot(2) + SLOT, 16 * warp, lane);
    }
    float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_k[n][e] = 0.f;
            acc_v[n][e] = 0.f;
        }

    // one query tile in chunks of 16 queries; `masked`: rows < T, and
    // chunks with no real query are skipped
    auto tile = [&](const bf16* qs, int rows, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < T / 16; ++c) {
            if (M && 16 * c >= rows) continue;
            // S^T and dP^T of the warp's 16 keys against queries 16c .. 16c+15
            float sc[2][4], dp[2][4];
            zero(sc);
            zero(dp);
            chunk_abt(sc, ka, qs, 16 * c, lane);
            chunk_abt(dp, va, qs + SLOT, 16 * c, lane);
            dkv_chunk<M>(acc_k, acc_v, sc, dp, qs, 16 * c, rows, lane, scale);
        }
    };

    for (int s = 0; s < n_steps; ++s) {
        cp_async_wait1();
        __syncthreads();   // step s landed; every warp is done with step s - 1
        issue(s + 2);      // into the stage step s - 1 used
        if (!busy) continue;
        const int rows = min(T, n_valid - s * T);
        if (rows < T) tile(q_slot(s), rows, std::true_type{});
        else tile(q_slot(s), rows, std::false_type{});
    }
    cp_async_wait_all();
    bf16* out_slot = q_slot(n_steps) + 16 * warp * LDH;
    store_rows(dk, out_slot, acc_k, busy, base, r_warp, n_valid, k_end, col0,
               D, lane);
    store_rows(dv, out_slot + SLOT, acc_v, busy, base, r_warp, n_valid, k_end,
               col0, D, lane);
}

// a chunked block's place: its head's first column, its 64 output columns
// and whether it is its head's group 0
struct Group {
    int h, hcol, col0;
    bool first;
};

__device__ __forceinline__ Group group_of(int dh) {
    const int chunks = dh / DH;
    const int h = blockIdx.y / chunks, grp = blockIdx.y % chunks;
    return {h, h * dh, h * dh + grp * DH, grp == 0};
}

// the chunked dq: any dh that is a multiple of 64, one block per (query
// tile, head and 64-column group, example).  Steps: pass 1 (key tile,
// chunk): Q and K chunks; pass 2 (key tile, chunk): Q, K, dO and V
// chunks, then (key tile, group): the group's K columns
__device__ __forceinline__ void dq_chunked(
        unsigned char* smem, const bf16* __restrict__ q,
        const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ o, const bf16* __restrict__ dout,
        bf16* __restrict__ dq, float* __restrict__ stats, int row_stride,
        int n_valid, int D, int heads, int dh, float scale) {
    bf16* ring = reinterpret_cast<bf16*>(smem);
    constexpr int STAGE = 4 * SLOT;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const Group grp = group_of(dh);
    const int chunks = dh / DH;
    const int q0 = blockIdx.x * T;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + T, row_stride);
    if (q0 >= n_valid) {
        zero_rows(dq, base, q0, q_end, grp.col0, D);
        return;
    }
    const int rows = min(T, n_valid - q0);
    const int r_warp = q0 + 16 * warp;
    const bool busy = 16 * warp < rows;
    const int n_tiles = (n_valid + T - 1) / T;
    const int n1 = n_tiles * chunks;
    const int n_steps = n1 + n_tiles * (chunks + 1);

    // step s -> key tile t and chunk c; c == chunks is pass 2's K step
    auto step_of = [&](int s, int& t, int& c) {
        const int per = s < n1 ? chunks : chunks + 1;
        const int i = s < n1 ? s : s - n1;
        t = i / per;
        c = i - t * per;
    };
    auto issue = [&](int s) {
        if (s < n_steps) {
            int t, c;
            step_of(s, t, c);
            const int k0 = t * T, kv = min(T, n_valid - k0);
            bf16* st = ring + (s % STAGES) * STAGE;
            if (c == chunks) {
                load_tile(st, k, base, k0, kv, grp.col0, D);
            } else {
                const int cc = grp.hcol + c * DH;
                load_tile(st, q, base, q0, rows, cc, D);
                load_tile(st + SLOT, k, base, k0, kv, cc, D);
                if (s >= n1) {
                    load_tile(st + 2 * SLOT, dout, base, q0, rows, cc, D);
                    load_tile(st + 3 * SLOT, v, base, k0, kv, cc, D);
                }
            }
        }
        cp_async_commit();
    };
    issue(0);
    issue(1);

    // delta of the warp's rows over the head's dh columns, from device
    // memory: lanes L and L + 16 sum halves of row L % 16
    float delta[2] = {0.f, 0.f};
    if (busy) {
        const int rr = lane & 15, half = dh / 2;
        float part = 0.f;
        if (r_warp + rr < n_valid) {
            const size_t row = (base + r_warp + rr) * D + grp.hcol
                               + (lane >> 4) * half;
            for (int c = 0; c < half; c += 8)
                part = dot8(part, *reinterpret_cast<const uint4*>(dout + row + c),
                            *reinterpret_cast<const uint4*>(o + row + c));
        }
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 16));
        delta[0] = __shfl_sync(0xffffffffu, part, g);
        delta[1] = __shfl_sync(0xffffffffu, part, g + 8);
    }

    float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
    float invs[2] = {0.f, 0.f};
    // S and dP of the warp's rows against keys 16c .. 16c+15 of the tile,
    // summed over the chunks; dS of pass 2 as A fragments
    float sc[T / 16][2][4], dp[T / 16][2][4];
    uint32_t dsa[T / 16][4];
    float acc[DH / 8][4];
#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
        zero(sc[c]);
        zero(dp[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) dsa[c][e] = 0u;
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // the tile's S (and dP) are summed: statistics (pass 1) or dS (pass 2)
    auto tile_done = [&](bool second, int kv, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < T / 16; ++c) {
            if (M && 16 * c >= kv) continue;
            if (second)
                ds_chunk<M>(dsa[c], sc[c], dp[c], mx, delta, invs, 16 * c,
                            kv, tq, scale);
            else
                dq_stats_chunk<M>(sc[c], mx, den, 16 * c, kv, tq, scale);
            zero(sc[c]);
            zero(dp[c]);
        }
    };

    for (int s = 0; s < n_steps; ++s) {
        cp_async_wait1();
        __syncthreads();   // step s landed; every warp is done with step s - 1
        issue(s + 2);      // into the stage step s - 1 used
        if (!busy) continue;
        int t, c;
        step_of(s, t, c);
        const bool second = s >= n1;
        const int kv = min(T, n_valid - t * T);
        const bf16* st = ring + (s % STAGES) * STAGE;
        if (c == chunks) {   // dQ += dS K over the group's columns
#pragma unroll
            for (int kc = 0; kc < T / 16; ++kc)
                if (16 * kc < kv) ds_times(acc, dsa[kc], st, 16 * kc, lane);
            continue;
        }
        {
            uint32_t a[DH / 16][4];
            load_a(a, st, 16 * warp, lane);
            tile_abt(sc, a, st + SLOT, kv, lane);
            if (second) {
                load_a(a, st + 2 * SLOT, 16 * warp, lane);
                tile_abt(dp, a, st + 3 * SLOT, kv, lane);
            }
        }
        if (c < chunks - 1) continue;
        if (kv < T) tile_done(second, kv, std::true_type{});
        else tile_done(second, kv, std::false_type{});
        if (!second && t == n_tiles - 1) {
            const size_t plane = (size_t)gridDim.z * heads * row_stride;
            dq_finish_stats(mx, den, invs, delta,
                            grp.first ? stats + ((size_t)blockIdx.z * heads
                                                 + grp.h) * row_stride
                                      : nullptr,
                            plane, r_warp, n_valid, lane, scale);
        }
    }
    cp_async_wait_all();
    store_rows(dq, ring + (n_steps % STAGES) * STAGE + 16 * warp * LDH, acc,
               busy, base, r_warp, n_valid, q_end, grp.col0, D, lane);
}

// the chunked dk, dv: any dh that is a multiple of 64, one block per (key
// tile, head and 64-column group, example).  Steps per query tile:
// (chunk): K, V, Q and dO chunks; then (group): the group's Q and dO
// columns and the tile's statistics, as a resident stage
__device__ __forceinline__ void dkv_chunked(
        unsigned char* smem, const bf16* __restrict__ q,
        const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ dout, bf16* __restrict__ dk,
        bf16* __restrict__ dv, const float* __restrict__ stats,
        int row_stride, int n_valid, int D, int heads, int dh, float scale) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const Group grp = group_of(dh);
    const int chunks = dh / DH;
    const int k0 = blockIdx.x * T;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int k_end = min(k0 + T, row_stride);
    if (k0 >= n_valid) {
        zero_rows(dk, base, k0, k_end, grp.col0, D);
        zero_rows(dv, base, k0, k_end, grp.col0, D);
        return;
    }
    const int kv = min(T, n_valid - k0);
    const int r_warp = k0 + 16 * warp;
    const bool busy = 16 * warp < kv;
    const int n_steps = (n_valid + T - 1) / T * (chunks + 1);
    const size_t plane = (size_t)gridDim.z * heads * row_stride;
    const float* st = stats + ((size_t)blockIdx.z * heads + grp.h)
                              * row_stride;

    auto slot = [&](int s) {
        return reinterpret_cast<bf16*>(smem + (s % STAGES) * STAGE_CHUNKED);
    };
    auto issue = [&](int s) {
        if (s < n_steps) {
            const int t = s / (chunks + 1), c = s - t * (chunks + 1);
            const int q0 = t * T, rows = min(T, n_valid - q0);
            bf16* b = slot(s);
            if (c < chunks) {
                const int cc = grp.hcol + c * DH;
                load_tile(b, k, base, k0, kv, cc, D);
                load_tile(b + SLOT, v, base, k0, kv, cc, D);
                load_tile(b + 2 * SLOT, q, base, q0, rows, cc, D);
                load_tile(b + 3 * SLOT, dout, base, q0, rows, cc, D);
            } else {
                load_tile(b, q, base, q0, rows, grp.col0, D);
                load_tile(b + SLOT, dout, base, q0, rows, grp.col0, D);
                load_stats(reinterpret_cast<float*>(b + 2 * SLOT), st, plane,
                           q0, rows);
            }
        }
        cp_async_commit();
    };
    issue(0);
    issue(1);

    // S^T and dP^T of the warp's keys against queries 16c .. 16c+15 of
    // the query tile, summed over the chunks
    float sc[T / 16][2][4], dp[T / 16][2][4];
    float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
        zero(sc[c]);
        zero(dp[c]);
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_k[n][e] = 0.f;
            acc_v[n][e] = 0.f;
        }

    // the group step of a query tile: dV and dK from S^T, dP^T
    auto tile_done = [&](const bf16* qs, int rows, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < T / 16; ++c) {
            if (M && 16 * c >= rows) continue;
            dkv_chunk<M>(acc_k, acc_v, sc[c], dp[c], qs, 16 * c, rows, lane,
                         scale);
            zero(sc[c]);
            zero(dp[c]);
        }
    };

    for (int s = 0; s < n_steps; ++s) {
        cp_async_wait1();
        __syncthreads();   // step s landed; every warp is done with step s - 1
        issue(s + 2);      // into the stage step s - 1 used
        if (!busy) continue;
        const int t = s / (chunks + 1), c = s - t * (chunks + 1);
        const int rows = min(T, n_valid - t * T);
        const bf16* b = slot(s);
        if (c < chunks) {
            uint32_t a[DH / 16][4];
            load_a(a, b, 16 * warp, lane);                // K chunk
            tile_abt(sc, a, b + 2 * SLOT, rows, lane);    // S^T += K Q^T
            load_a(a, b + SLOT, 16 * warp, lane);         // V chunk
            tile_abt(dp, a, b + 3 * SLOT, rows, lane);    // dP^T += V dO^T
            continue;
        }
        if (rows < T) tile_done(b, rows, std::true_type{});
        else tile_done(b, rows, std::false_type{});
    }
    cp_async_wait_all();
    bf16* out_slot = slot(n_steps) + 16 * warp * LDH;
    store_rows(dk, out_slot, acc_k, busy, base, r_warp, n_valid, k_end,
               grp.col0, D, lane);
    store_rows(dv, out_slot + SLOT, acc_v, busy, base, r_warp, n_valid, k_end,
               grp.col0, D, lane);
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, MinBlocks<RESIDENT>::value)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, bf16* __restrict__ dq,
          float* __restrict__ stats, int row_stride, int n_valid, int D,
          int heads, int dh, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    if constexpr (RESIDENT)
        dq_resident(smem, q, k, v, o, dout, dq, stats, row_stride, n_valid,
                    D, heads, scale);
    else
        dq_chunked(smem, q, k, v, o, dout, dq, stats, row_stride, n_valid, D,
                   heads, dh, scale);
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, MinBlocks<RESIDENT>::value)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           bf16* __restrict__ dk, bf16* __restrict__ dv,
           const float* __restrict__ stats, int row_stride, int n_valid,
           int D, int heads, int dh, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    if constexpr (RESIDENT)
        dkv_resident(smem, q, k, v, dout, dk, dv, stats, row_stride, n_valid,
                     D, heads, scale);
    else
        dkv_chunked(smem, q, k, v, dout, dk, dv, stats, row_stride, n_valid,
                    D, heads, dh, scale);
}

template <bool RESIDENT>
cudaError_t launch(const dim3& grid, cudaStream_t s, const bf16* q,
                   const bf16* k, const bf16* v, const bf16* o,
                   const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                   float* stats, int row_stride, int n_valid, int D,
                   int heads, int dh, float scale) {
    constexpr size_t smem_dq = RESIDENT ? SMEM_DQ : SMEM_CHUNKED;
    constexpr size_t smem_dkv = RESIDENT ? SMEM_DKV : SMEM_CHUNKED;
    cudaError_t e = cudaFuncSetAttribute(
        dq_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_dq);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dkv_kernel<RESIDENT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
    if (e != cudaSuccess) return e;
    dq_kernel<RESIDENT><<<grid, THREADS, smem_dq, s>>>(
        q, k, v, o, dout, dq, stats, row_stride, n_valid, D, heads, dh,
        scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dkv_kernel<RESIDENT><<<grid, THREADS, smem_dkv, s>>>(
        q, k, v, dout, dk, dv, stats, row_stride, n_valid, D, heads, dh,
        scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8.  q, k, v, o, dout, dq, dk, dv: (B * row_stride, D) bf16 row-major;
// head h is columns h*dh .. h*dh+dh-1 (D = heads * dh, dh a multiple of
// 64); rows n_valid .. row_stride-1 of each example are not read, and
// their gradients are written as zero.  stats: f32 scratch of 3 * B *
// heads * row_stride (m, inv, delta per row).  scale = 1/sqrt(dh).
int vit_attention_backward(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, void* dq,
                           void* dk, void* dv, void* stats, int B,
                           int row_stride, int n_valid, int D, int heads,
                           float scale, void* stream) {
    if (B < 1 || B > 65535 || heads < 1 || D < 64 || D % heads
        || (D / heads) % DH || n_valid < 1 || n_valid > row_stride
        || D / DH > 65535)
        return (int)cudaErrorInvalidValue;
    const int dh = D / heads;
    const bool resident = dh == DH;
    // blockIdx.y: the head (resident) or the head's 64-column group
    const dim3 grid((row_stride + T - 1) / T, resident ? heads : D / DH, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bf16 *bq = static_cast<const bf16*>(q),
               *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v),
               *bo = static_cast<const bf16*>(o),
               *bdo = static_cast<const bf16*>(dout);
    bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk),
         *gv = static_cast<bf16*>(dv);
    float* fst = static_cast<float*>(stats);
    return (int)(resident
        ? launch<true>(grid, s, bq, bk, bv, bo, bdo, gq, gk, gv, fst,
                       row_stride, n_valid, D, heads, dh, scale)
        : launch<false>(grid, s, bq, bk, bv, bo, bdo, gq, gk, gv, fst,
                        row_stride, n_valid, D, heads, dh, scale));
}

// bytes of dynamic shared memory a block takes at head width dh (a
// multiple of 64): dq_kernel (which = 0) or dkv_kernel (which = 1)
int vit_attention_backward_smem(int which, int dh) {
    if (dh != DH) return (int)SMEM_CHUNKED;
    return (int)(which ? SMEM_DKV : SMEM_DQ);
}

}  // extern "C"
