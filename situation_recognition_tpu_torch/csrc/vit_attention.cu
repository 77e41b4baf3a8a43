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
// For each example, head h (columns h*dh .. h*dh+dh-1, dh = D / heads any
// multiple of 64, as the TPU kernels take) and query row i:
//   folded:  q' = bf16(q * scale * log2(e))          (f32 product)
//            s  = q' k^T (f32),  e = bf16(exp2(s - max s))
//            ctx = (e V) * (1 / sum_f32(e))
//   plain:   p  = bf16(softmax_f32(s * scale)),  ctx = p V
// over the n_valid real keys only, scale = 1/sqrt(dh); bf16 operands, f32
// sums, ctx in bf16.  These are the TPU kernels' numerics (SRTPU_ATTN_CORE
// selects the flavour).
//
// What bounds it on this card.  At ViT-L/14, batch 256 (16 heads, N = 257)
// the work is 4 B h N^2 dh = 6.9e10 FLOP against 0.54 GB of q, k, v and
// context: bound by memory (0.16 ms at 3.35 TB/s; operations 0.07 ms),
// whatever the split of D = 1024 into heads.  The folded roundings need
// the bf16 exponent taken against the row's final maximum, so the kernel
// makes two passes over the keys (one-pass online rescaling,
// bf16(exp2(s - m_run)) * 2^(m_run - m), is not what the TPU kernel
// computes): Q K^T is formed twice, 1.5x the products.  The first design
// lost its time not to the products but to how they ran: scores through
// an f32 shared tile read back by other warps, several block barriers per
// key tile, and K/V staged synchronously.  In this one each score costs a
// few instructions of exponent, rounding and sum beside the products'
// share, issued by the same warps at the occupancy that the registers and
// shared memory allow; PERF.md keeps the measured time beside the bound
// and the variants that did not beat it.
//
// Design (FlashAttention-2's warp layout).  Blocks of 4 warps over
// (64-query tile, head, example); the grid keeps the query tile fastest so
// that the blocks of one head share K and V in L2.  Warp w owns query rows
// 16w .. 16w+15.  Products are mma.sync.m16n8k16 bf16 with f32 sums,
// operands through ldmatrix (.trans for V), and the scores never leave
// registers.  Per key tile:
//   pass 1  S = Q K^T; each lane keeps the maximum of its own columns
//           (and, for the plain flavour, its f32 sum of exponents,
//           rescaled as that maximum grows); two quad shuffles combine the
//           four lanes of a row at the end;
//   pass 2  S again; the bf16 exponents (or probabilities) against the
//           row's final maximum are formed in the accumulators, and two
//           adjacent n8 accumulator tiles are already the A fragment of
//           the next m16n8k16, so P V runs from registers.  The folded
//           flavour adds the same bf16 values into a per-lane f32
//           denominator, reduced by shuffles once, at the end.
// K, V (and Q) tiles of 64 rows come in through a 3-stage cp.async ring
// (16-byte copies, zero-filled past the real rows), one block barrier per
// step: the step after next is issued while this one is computed.  The
// context is staged through a free stage for 16-byte stores.  The ragged
// last key tile runs a masked copy of each pass: masked keys enter the
// maximum as -inf and the exponents as 0, and its 16-key chunks that hold
// no real key are skipped (at N = 257 it holds one key); warps whose rows
// are all pad rows skip the products.  No atomics: the result does not
// depend on the order in which blocks run.
//
// Two forms of that design, by head width (`attn_kernel<FOLDED, DH, G>`):
//   resident (DH = dh = 64 or 128; G = DH)  one block per (query tile,
//           head, example).  The warp's Q (pre-scaled in the folded
//           flavour) stays in registers as A fragments and the context
//           accumulates in registers over the head's DH columns; each
//           pass goes over a key tile in chunks of 16 keys, one ring step
//           a key tile (K; K and V in pass 2).  The query tile is loaded
//           into the third stage with the first one and read into
//           registers before that stage is reused.  At 64: 55,296 bytes
//           of shared memory and at most 128 registers a thread, four
//           blocks per SM.  At 128 the Q fragments and the accumulator
//           double: 104,448 bytes and at most 255 registers, two blocks
//           per SM.
//   chunked (DH = 0; any dh that is a multiple of 64; G = 128 where dh is
//           a multiple of 128, else 64)  a Q fragment set and a context
//           accumulator over dh columns do not fit in registers, so the
//           head width is cut both ways.  The reduction of Q K^T runs in
//           chunks of 64 columns: one ring step per (key tile, chunk)
//           brings that chunk of the query tile and of the key tile, and
//           the warp's S of its 16 rows against the tile's 64 keys
//           accumulates in registers over the chunks.  The output is cut
//           into column groups of G, one more grid axis (blockIdx.y =
//           head * dh / G + group): each block forms its rows' scores and
//           statistics over all dh columns and its own G context columns,
//           so Q K^T is formed dh / G times over.  Pass 2 adds one step
//           per key tile that brings the V tile's G columns, P V from the
//           exponents kept in registers.  55,296 bytes of shared memory (a
//           stage holds a Q and a K chunk, or a V tile), at most 255
//           registers (G = 128, two blocks per SM) or 170 (G = 64, three).
// `-Xptxas -v` gives each instantiation's registers and spills (PERF.md).
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, nothing is synchronised or allocated here, and the function
// returns cudaGetLastError() of the launch (0 on success), or
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
constexpr int QT = 16 * WARPS;  // query rows of a block, 16 per warp
constexpr int KT = 64;          // keys of a tile
constexpr int CH = 64;          // head columns of a chunk (the chunked form)
constexpr int STAGES = 3;
static_assert(QT == KT, "the query tile takes a ring slot");

// bf16 row pitch of a tile W columns wide: conflict-free ldmatrix
__host__ __device__ constexpr int pitch(int w) { return w + 8; }

// log2 of the 16-byte copies a row of a tile W = 64 or 128 columns wide
// takes: the copy loops index by shifts, as signed division by a power of
// two does not (that cost the 64-wide kernel 10%, PERF.md)
template <int W>
constexpr int ROW_SHIFT = W == 64 ? 3 : 4;

// blocks an SM must hold (bounds the registers), by form: DH the head
// width held in registers (0: the chunked form), G its output columns
template <int DH, int G>
struct MinBlocks {
    static constexpr int value = DH == 64 ? 4 : (DH == 128 || G == 128) ? 2 : 3;
};

// dynamic shared memory: STAGES x 2 tiles of 64 rows, DH columns wide for
// the resident form, a chunk wide for the chunked one (55,296 bytes at 64,
// 104,448 at 128)
constexpr size_t smem_bytes(int dh) {
    return (size_t)STAGES * 2 * KT * pitch(dh ? dh : CH) * sizeof(bf16);
}

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 p) {
    return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows r0 .. r0 + count - 1, columns col0 .. col0 + W - 1 of an example
// into a 64-row slot of pitch W + 8, asynchronously; the slot's other rows
// are zero-filled
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          size_t base, int r0, int count,
                                          int col0, int D) {
    static_assert(W == 64 || W == 128, "tiles are 64 or 128 columns wide");
    constexpr int SH = ROW_SHIFT<W>;
    for (int c = threadIdx.x; c < KT << SH; c += THREADS) {
        const int row = c >> SH, c8 = (c & ((1 << SH) - 1)) * 8;
        const bool real = row < count;
        cp_async16(dst + row * pitch(W) + c8,
                   src + (real ? (base + r0 + row) * D + col0 + c8 : 0),
                   real ? 16 : 0);
    }
}

// the A fragments of the 16 rows r0 .. r0+15 of a slot of pitch W + 8
// over its W columns, times qscale and rounded to bf16 in the folded
// flavour
template <int W, bool FOLDED>
__device__ __forceinline__ void load_q(uint32_t (&qa)[W / 16][4],
                                       const bf16* slot, int r0, int lane,
                                       float qscale) {
#pragma unroll
    for (int t = 0; t < W / 16; ++t) {
        ldsm_x4(qa[t], slot + (r0 + (lane & 15)) * pitch(W) + t * 16
                       + (lane >> 4) * 8);
        if (FOLDED) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&qa[t][r]));
                qa[t][r] = as_u32(__floats2bfloat162_rn(f.x * qscale,
                                                        f.y * qscale));
            }
        }
    }
}

// s += the warp's 16 rows (A fragments qa over W columns) against the 16
// keys k0 .. k0+15 of a K slot of pitch W + 8: s[j] is the m16n8
// accumulator of keys k0 + 8j .. +7
template <int W>
__device__ __forceinline__ void score_chunk(float (&s)[2][4],
                                            const uint32_t (&qa)[W / 16][4],
                                            const bf16* ks, int k0, int lane) {
    const bf16* p = ks + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch(W)
                    + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int t = 0; t < W / 16; ++t) {
        uint32_t b[4];
        ldsm_x4(b, p + t * 16);
        mma(s[0], qa[t], b[0], b[1]);
        mma(s[1], qa[t], b[2], b[3]);
    }
}

__device__ __forceinline__ void zero(float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
}

// pass 1 on the scores s of 16 keys k0 .. k0+15 (the lane's columns as in
// score_chunk): the lane's maxima of rows g and g + 8 and, for the plain
// flavour, its f32 sums of exp(s * scale - max * scale), rescaled as the
// maxima grow; masked (M): keys from kv on enter as -inf
template <bool FOLDED, bool M>
__device__ __forceinline__ void stats_chunk(float (&s)[2][4], float (&mx)[2],
                                            float (&den)[2], int k0, int kv,
                                            int tq, float scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float cm = mx[r];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
                if (M && k0 + 8 * j + 2 * tq + (e & 1) >= kv)
                    s[j][e] = -INFINITY;
                cm = fmaxf(cm, s[j][e]);
            }
        if (!FOLDED && cm != -INFINITY) {
            const float ms = __fmul_rn(cm, scale);
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 2 * r; e < 2 * r + 2; ++e)
                    if (!M || s[j][e] != -INFINITY)
                        part += expf(__fmul_rn(s[j][e], scale) - ms);
            const float f = mx[r] == -INFINITY
                ? 0.f : expf(__fmul_rn(mx[r], scale) - ms);
            den[r] = den[r] * f + part;
        }
        mx[r] = cm;
    }
}

// the end of pass 1: the rows' maxima over all keys, and the plain
// flavour's sums rescaled to them
template <bool FOLDED>
__device__ __forceinline__ void finish_stats(float (&mx)[2], float (&den)[2],
                                             float scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float m = quad_max(mx[r]);
        if (!FOLDED) {
            const float f = mx[r] == -INFINITY
                ? 0.f
                : expf(__fmul_rn(mx[r], scale) - __fmul_rn(m, scale));
            den[r] = quad_sum(den[r] * f);
        }
        mx[r] = m;
    }
}

// pass 2 on the scores s of 16 keys k0 .. k0+15: the bf16 exponents (or
// probabilities) against the rows' maxima as the A fragment of P over
// these keys (the accumulators of keys k0 .. +7 and k0+8 .. +15 are its
// two halves); the folded flavour adds the bf16 values to its per-lane
// denominators; masked (M) keys give 0
template <bool FOLDED, bool M>
__device__ __forceinline__ void probs_chunk(uint32_t (&pa)[4],
                                            const float (&s)[2][4],
                                            const float (&mx)[2],
                                            float (&den)[2], int k0, int kv,
                                            int tq, float scale) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float x[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float sv = s[j][2 * r + h];
                x[h] = FOLDED
                    ? exp2f(sv - mx[r])
                    : expf(__fmul_rn(sv, scale)
                           - __fmul_rn(mx[r], scale)) / den[r];
                if (M && k0 + 8 * j + 2 * tq + h >= kv) x[h] = 0.f;
            }
            const uint32_t p = as_u32(__floats2bfloat162_rn(x[0], x[1]));
            if (FOLDED)   // the two bf16 values as f32
                den[r] += __uint_as_float(p << 16)
                          + __uint_as_float(p & 0xffff0000u);
            pa[2 * j + r] = p;
        }
}

// acc += P V for the 16 keys k0 .. k0+15 of a V slot of pitch W + 8 over
// its W columns (P's A fragment pa)
template <int W>
__device__ __forceinline__ void pv_chunk(float (&acc)[W / 8][4],
                                         const uint32_t (&pa)[4],
                                         const bf16* vs, int k0, int lane) {
    const bf16* vp = vs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch(W)
                     + (lane >> 4) * 8;
#pragma unroll
    for (int nb = 0; nb < W / 16; ++nb) {
        uint32_t b[4];
        ldsm_x4_t(b, vp + nb * 16);
        mma(acc[2 * nb], pa, b[0], b[1]);
        mma(acc[2 * nb + 1], pa, b[2], b[3]);
    }
}

// the context: the warp's 16 rows (accumulators over W columns, the
// folded flavour divided here by its f32 sum of the bf16 exponents) in
// bf16 into the warp's rows of a free stage, then rows r_warp .. +15 of
// the output's columns col0 .. col0 + W - 1 with 16-byte stores: rows
// below n_valid from the stage, rows up to q_end zero
template <bool FOLDED, int W>
__device__ __forceinline__ void store_ctx(bf16* __restrict__ out, bf16* os,
                                          const float (&acc)[W / 8][4],
                                          const float (&den)[2], bool busy,
                                          size_t base, int r_warp,
                                          int n_valid, int q_end, int col0,
                                          int D, int lane) {
    const int g = lane >> 2, tq = lane & 3;
    if (busy) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float inv = FOLDED ? 1.f / quad_sum(den[r]) : 1.f;
#pragma unroll
            for (int n = 0; n < W / 8; ++n)
                *reinterpret_cast<__nv_bfloat162*>(
                    os + (g + 8 * r) * pitch(W) + 8 * n + 2 * tq) =
                    __floats2bfloat162_rn(acc[n][2 * r] * inv,
                                          acc[n][2 * r + 1] * inv);
        }
    }
    __syncwarp();
    constexpr int SH = ROW_SHIFT<W>;
    for (int c = lane; c < 16 << SH; c += 32) {
        const int row = c >> SH, c8 = (c & ((1 << SH) - 1)) * 8;
        const int gi = r_warp + row;
        if (gi >= q_end) continue;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gi < n_valid)
            val = *reinterpret_cast<const uint4*>(os + row * pitch(W) + c8);
        *reinterpret_cast<uint4*>(out + (base + gi) * D + col0 + c8) = val;
    }
}

// rows q0 .. q_end - 1, columns col0 .. col0 + W - 1, as zero (a tile of
// pad rows only)
template <int W>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ out, size_t base,
                                          int q0, int q_end, int col0, int D) {
    constexpr int SH = ROW_SHIFT<W>;
    for (int c = threadIdx.x; c < QT << SH; c += THREADS) {
        const int gi = q0 + (c >> SH);
        if (gi < q_end)
            *reinterpret_cast<uint4*>(out + (base + gi) * D + col0
                                      + (c & ((1 << SH) - 1)) * 8) =
                make_uint4(0, 0, 0, 0);
    }
}

// the resident form: head width DH in registers, one block per (query
// tile, head, example)
template <bool FOLDED, int DH>
__device__ __forceinline__ void attn_resident(
        unsigned char* smem, const bf16* __restrict__ q,
        const bf16* __restrict__ k, const bf16* __restrict__ v,
        bf16* __restrict__ out, int row_stride, int n_valid, int D,
        float qscale, float scale) {
    constexpr int SLOT = KT * pitch(DH);   // bf16 elements of a 64-row tile
    bf16* ring = reinterpret_cast<bf16*>(smem);   // stage s: K at 2s, V at 2s+1

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int tq = lane & 3;
    const int q0 = blockIdx.x * QT;
    const int col0 = blockIdx.y * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + QT, row_stride);
    const int r_warp = q0 + 16 * warp;   // the warp's first query row

    if (q0 >= n_valid) {
        zero_rows<DH>(out, base, q0, q_end, col0, D);
        return;
    }
    const int rows = min(QT, n_valid - q0);      // real query rows here
    const bool busy = 16 * warp < rows;          // the warp has real rows
    const int n_tiles = (n_valid + KT - 1) / KT;
    const int n_steps = 2 * n_tiles;             // pass 1, then pass 2

    // step s of the ring: key tile s % n_tiles; K always, V in pass 2
    auto issue = [&](int s) {
        if (s < n_steps) {
            const int t = s < n_tiles ? s : s - n_tiles;
            const int k0 = t * KT, kv = min(KT, n_valid - k0);
            bf16* st = ring + (s % STAGES) * 2 * SLOT;
            load_tile<DH>(st, k, base, k0, kv, col0, D);
            if (s >= n_tiles) load_tile<DH>(st + SLOT, v, base, k0, kv, col0, D);
        }
        cp_async_commit();
    };

    // prologue: the query tile into stage 2's K slot with step 0, then step 1
    bf16* qs = ring + 2 * 2 * SLOT;
    load_tile<DH>(qs, q, base, q0, rows, col0, D);
    issue(0);
    issue(1);
    cp_async_wait1();
    __syncthreads();

    // the warp's Q as A fragments, pre-scaled in the folded flavour
    uint32_t qa[DH / 16][4];
    load_q<DH, FOLDED>(qa, qs, 16 * warp, lane, qscale);

    // per lane, rows g and g + 8: the maximum over its own columns and,
    // for the plain flavour, its f32 sum of exp(s * scale - max * scale);
    // after pass 1 the rows' maxima (and sums) over all keys; in pass 2 the
    // folded flavour's per-lane f32 sum of its bf16 exponents
    float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
    float acc[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // pass 1 over one key tile; `masked`: kv < KT, and chunks with no real
    // key are skipped
    auto pass1 = [&](const bf16* ks, int kv, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < KT / 16; ++c) {
            if (M && 16 * c >= kv) continue;
            float sc[2][4];
            zero(sc);
            score_chunk<DH>(sc, qa, ks, 16 * c, lane);
            stats_chunk<FOLDED, M>(sc, mx, den, 16 * c, kv, tq, scale);
        }
    };

    // pass 2 over one key tile: exponents against the rows' maxima,
    // ctx += P V; `masked` as in pass 1
    auto pass2 = [&](const bf16* ks, const bf16* vs, int kv, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int c = 0; c < KT / 16; ++c) {
            if (M && 16 * c >= kv) continue;
            float sc[2][4];
            zero(sc);
            score_chunk<DH>(sc, qa, ks, 16 * c, lane);
            uint32_t pa[4];
            probs_chunk<FOLDED, M>(pa, sc, mx, den, 16 * c, kv, tq, scale);
            pv_chunk<DH>(acc, pa, vs, 16 * c, lane);
        }
    };

    for (int s = 0; s < n_steps; ++s) {
        cp_async_wait1();
        __syncthreads();   // step s landed; every warp is done with step s - 1
        issue(s + 2);      // into the stage step s - 1 used
        if (!busy) continue;
        const bf16* ks = ring + (s % STAGES) * 2 * SLOT;
        const bool second = s >= n_tiles;
        const int kv = min(KT, n_valid - (second ? s - n_tiles : s) * KT);
        if (second) {
            if (kv < KT) pass2(ks, ks + SLOT, kv, std::true_type{});
            else pass2(ks, ks + SLOT, kv, std::false_type{});
            continue;
        }
        if (kv < KT) pass1(ks, kv, std::true_type{});
        else pass1(ks, kv, std::false_type{});
        if (s == n_tiles - 1) finish_stats<FOLDED>(mx, den, scale);
    }
    cp_async_wait_all();

    // the context through a free stage (the warp's own rows), pad rows zero
    store_ctx<FOLDED, DH>(out, ring + (n_steps % STAGES) * 2 * SLOT
                               + 16 * warp * pitch(DH),
                          acc, den, busy, base, r_warp, n_valid, q_end, col0,
                          D, lane);
}

// the chunked form: any head width dh that is a multiple of 64, one block
// per (query tile, head and group of G output columns, example)
template <bool FOLDED, int G>
__device__ __forceinline__ void attn_chunked(
        unsigned char* smem, const bf16* __restrict__ q,
        const bf16* __restrict__ k, const bf16* __restrict__ v,
        bf16* __restrict__ out, int row_stride, int n_valid, int D, int dh,
        float qscale, float scale) {
    constexpr int SLOT = KT * pitch(CH);   // bf16 elements of a chunk slot
    constexpr int STAGE = 2 * SLOT;        // a Q and a K chunk, or a V tile
    static_assert(KT * pitch(G) <= STAGE, "a V tile fits in a stage");
    bf16* ring = reinterpret_cast<bf16*>(smem);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int tq = lane & 3;
    const int chunks = dh / CH, groups = dh / G;
    const int hcol = (blockIdx.y / groups) * dh;   // the head's first column
    const int col0 = hcol + (blockIdx.y % groups) * G;   // the block's output
    const int q0 = blockIdx.x * QT;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + QT, row_stride);
    const int r_warp = q0 + 16 * warp;

    if (q0 >= n_valid) {
        zero_rows<G>(out, base, q0, q_end, col0, D);
        return;
    }
    const int rows = min(QT, n_valid - q0);
    const bool busy = 16 * warp < rows;
    const int n_tiles = (n_valid + KT - 1) / KT;
    const int n1 = n_tiles * chunks;                  // pass 1: (tile, chunk)
    const int n_steps = n1 + n_tiles * (chunks + 1);  // pass 2: then V

    // step s -> key tile t and chunk c; c == chunks is pass 2's V step
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
            const int k0 = t * KT, kv = min(KT, n_valid - k0);
            bf16* st = ring + (s % STAGES) * STAGE;
            if (c < chunks) {
                load_tile<CH>(st, q, base, q0, rows, hcol + c * CH, D);
                load_tile<CH>(st + SLOT, k, base, k0, kv, hcol + c * CH, D);
            } else {
                load_tile<G>(st, v, base, k0, kv, col0, D);
            }
        }
        cp_async_commit();
    };
    issue(0);
    issue(1);

    // per lane as in the resident form; sc[kc] the scores of the warp's
    // rows against keys 16kc .. 16kc+15 of the tile, summed over the
    // chunks; pa[kc] their P in pass 2
    float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
    float sc[KT / 16][2][4];
    uint32_t pa[KT / 16][4];
    float acc[G / 8][4];
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
        zero(sc[kc]);
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kc][e] = 0u;
    }
#pragma unroll
    for (int n = 0; n < G / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // the tile's scores are summed: statistics (pass 1) or P (pass 2)
    auto tile_done = [&](bool second, int kv, auto masked) {
        constexpr bool M = decltype(masked)::value;
#pragma unroll
        for (int kc = 0; kc < KT / 16; ++kc) {
            if (M && 16 * kc >= kv) continue;
            if (second)
                probs_chunk<FOLDED, M>(pa[kc], sc[kc], mx, den, 16 * kc, kv,
                                       tq, scale);
            else
                stats_chunk<FOLDED, M>(sc[kc], mx, den, 16 * kc, kv, tq,
                                       scale);
            zero(sc[kc]);
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
        const int kv = min(KT, n_valid - t * KT);
        const bf16* st = ring + (s % STAGES) * STAGE;
        if (c == chunks) {   // ctx += P V over the tile's real keys
#pragma unroll
            for (int kc = 0; kc < KT / 16; ++kc)
                if (16 * kc < kv) pv_chunk<G>(acc, pa[kc], st, 16 * kc, lane);
            continue;
        }
        // S += Q_c K_c^T
        uint32_t qa[CH / 16][4];
        load_q<CH, FOLDED>(qa, st, 16 * warp, lane, qscale);
#pragma unroll
        for (int kc = 0; kc < KT / 16; ++kc)
            if (16 * kc < kv) score_chunk<CH>(sc[kc], qa, st + SLOT, 16 * kc,
                                              lane);
        if (c < chunks - 1) continue;
        if (kv < KT) tile_done(second, kv, std::true_type{});
        else tile_done(second, kv, std::false_type{});
        if (!second && t == n_tiles - 1) finish_stats<FOLDED>(mx, den, scale);
    }
    cp_async_wait_all();

    store_ctx<FOLDED, G>(out, ring + (n_steps % STAGES) * STAGE
                              + 16 * warp * pitch(G),
                         acc, den, busy, base, r_warp, n_valid, q_end, col0,
                         D, lane);
}

// DH: the head width held in registers (64, 128), or 0 for the chunked
// form; G: the output columns of a block
template <bool FOLDED, int DH, int G>
__global__ void __launch_bounds__(THREADS, MinBlocks<DH, G>::value)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out,
            int row_stride, int n_valid, int D, int dh, float qscale,
            float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    if constexpr (DH > 0)
        attn_resident<FOLDED, DH>(smem, q, k, v, out, row_stride, n_valid, D,
                                  qscale, scale);
    else
        attn_chunked<FOLDED, G>(smem, q, k, v, out, row_stride, n_valid, D,
                                dh, qscale, scale);
}

template <bool FOLDED, int DH, int G>
cudaError_t launch(const dim3& grid, cudaStream_t s, const void* q,
                   const void* k, const void* v, void* out, int row_stride,
                   int n_valid, int D, int dh, float qscale, float scale) {
    constexpr size_t SMEM = smem_bytes(DH);
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<FOLDED, DH, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return e;
    attn_kernel<FOLDED, DH, G><<<grid, THREADS, SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), row_stride,
        n_valid, D, dh, qscale, scale);
    return cudaGetLastError();
}

template <int DH, int G>
cudaError_t launch_form(bool folded, const dim3& grid, cudaStream_t s,
                        const void* q, const void* k, const void* v,
                        void* out, int row_stride, int n_valid, int D,
                        int dh, float qscale, float scale) {
    return folded ? launch<true, DH, G>(grid, s, q, k, v, out, row_stride,
                                        n_valid, D, dh, qscale, scale)
                  : launch<false, DH, G>(grid, s, q, k, v, out, row_stride,
                                         n_valid, D, dh, qscale, scale);
}

// the chunked form's output columns a block: 128 where they divide dh
int group_cols(int dh) { return dh % 128 == 0 ? 128 : 64; }

}  // namespace

extern "C" {

// K5 / K7.  q, k, v, out: (B * row_stride, D) bf16 row-major; head h is
// columns h*dh .. h*dh+dh-1 (D = heads * dh, dh a multiple of 64).  Rows
// n_valid .. row_stride-1 of each example are not read and are written as
// zero.  qscale = scale * log2(e) (the folded flavour), scale =
// 1/sqrt(dh).
int vit_attention_forward(const void* q, const void* k, const void* v,
                          void* out, int B, int row_stride, int n_valid,
                          int D, int heads, float qscale, float scale,
                          int folded, void* stream) {
    if (B < 1 || B > 65535 || heads < 1 || D < 64 || D % heads
        || (D / heads) % 64 || n_valid < 1 || n_valid > row_stride)
        return (int)cudaErrorInvalidValue;
    const int dh = D / heads;
    const int per_head = dh <= 128 ? 1 : dh / group_cols(dh);
    if ((long long)heads * per_head > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((row_stride + QT - 1) / QT, heads * per_head, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool f = folded != 0;
    cudaError_t e;
    if (dh == 64)
        e = launch_form<64, 64>(f, grid, s, q, k, v, out, row_stride,
                                n_valid, D, dh, qscale, scale);
    else if (dh == 128)
        e = launch_form<128, 128>(f, grid, s, q, k, v, out, row_stride,
                                  n_valid, D, dh, qscale, scale);
    else if (group_cols(dh) == 128)
        e = launch_form<0, 128>(f, grid, s, q, k, v, out, row_stride,
                                n_valid, D, dh, qscale, scale);
    else
        e = launch_form<0, 64>(f, grid, s, q, k, v, out, row_stride, n_valid,
                               D, dh, qscale, scale);
    return (int)e;
}

// bytes of dynamic shared memory a block of the kernel takes at head
// width dh (a multiple of 64)
int vit_attention_forward_smem(int dh) {
    return (int)smem_bytes(dh == 64 || dh == 128 ? dh : 0);
}

}  // extern "C"
