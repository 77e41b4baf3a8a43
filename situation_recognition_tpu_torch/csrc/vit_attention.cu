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
// What bounds it on this card.  At ViT-L/14, batch 256 (16 heads, N = 257)
// the work is 4 B h N^2 64 = 6.9e10 FLOP against 0.54 GB of q, k, v and
// context: bound by memory (0.16 ms at 3.35 TB/s; operations 0.07 ms).
// The folded roundings need the bf16 exponent taken against the row's
// final maximum, so the kernel makes two passes over the keys (one-pass
// online rescaling, bf16(exp2(s - m_run)) * 2^(m_run - m), is not what the
// TPU kernel computes): Q K^T is formed twice, 1.5x the products.  The
// first design lost its time not to the products but to how they ran:
// scores through an f32 shared tile read back by other warps, several
// block barriers per key tile, and K/V staged synchronously.  In this one
// each score costs a few instructions of exponent, rounding and sum beside
// the products' share, issued by the same warps at the occupancy that the
// registers and shared memory allow; PERF.md keeps the measured time
// beside the bound and the variants that did not beat it.
//
// Design (FlashAttention-2's warp layout).  One block of 4 warps per
// (64-query tile, head, example); the grid keeps the query tile fastest so
// that the blocks of one head share K and V in L2.  Warp w owns query rows
// 16w .. 16w+15 and keeps their Q (pre-scaled in the folded flavour) as
// mma.sync A fragments in registers.  Products are mma.sync.m16n8k16 bf16
// with f32 sums, operands through ldmatrix (.trans for V), and the scores
// never leave registers; each pass goes over a key tile in chunks of 16
// keys:
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
// K and V tiles of 64 keys come in through a 3-stage cp.async ring (16-byte
// copies, zero-filled past the real keys), one block barrier per tile: the
// tile after next is issued while this one is computed.  The query tile is
// loaded into the third stage with the first one and read into registers
// before that stage is reused; the context is staged through a free stage
// for 16-byte stores.  55,296 bytes of shared memory and at most 128
// registers a thread: four blocks per SM.  The ragged last key tile runs
// a masked copy of each pass: masked keys enter the maximum as -inf and
// the exponents as 0, and its chunks that hold no real key are skipped (at
// N = 257 it holds one key); warps whose rows are all pad rows skip the
// products.  No atomics: the result does not depend on the order in which
// blocks run.
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
constexpr int MIN_BLOCKS = 4;   // blocks an SM must hold (bounds the registers)
constexpr int QT = 16 * WARPS;  // query rows of a block, 16 per warp
constexpr int KT = 64;          // keys of a tile
constexpr int DH = 64;          // head width
constexpr int LDH = DH + 8;     // bf16 row pitch: conflict-free ldmatrix
constexpr int STAGES = 3;
constexpr int SLOT = KT * LDH;  // bf16 elements of one 64-row tile
static_assert(QT == KT, "the query tile takes a ring slot");

// dynamic shared memory: STAGES x (K tile, V tile) = 55,296 bytes
constexpr size_t SMEM = (size_t)STAGES * 2 * SLOT * sizeof(bf16);

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

// rows r0 .. r0 + count - 1 of an example's head columns into a 64-row
// slot, asynchronously; the slot's other rows are zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          size_t base, int r0, int count,
                                          int col0, int D) {
    for (int c = threadIdx.x; c < KT * 8; c += THREADS) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        const bool real = row < count;
        cp_async16(dst + row * LDH + c8,
                   src + (real ? (base + r0 + row) * D + col0 + c8 : 0),
                   real ? 16 : 0);
    }
}

// scores of the warp's 16 rows (A fragments qa) against the 16 keys k0 ..
// k0+15 of a K slot: s[j] is the m16n8 accumulator of keys k0 + 8j .. +7
__device__ __forceinline__ void score_chunk(float (&s)[2][4],
                                            const uint32_t (&qa)[DH / 16][4],
                                            const bf16* ks, int k0, int lane) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* p = ks + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LDH
                    + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int t = 0; t < DH / 16; ++t) {
        uint32_t b[4];
        ldsm_x4(b, p + t * 16);
        mma(s[0], qa[t], b[0], b[1]);
        mma(s[1], qa[t], b[2], b[3]);
    }
}

template <bool FOLDED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out,
            int row_stride, int n_valid, int D, float qscale, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* ring = reinterpret_cast<bf16*>(smem);   // stage s: K at 2s, V at 2s+1

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;  // accumulator row and column pair
    const int q0 = blockIdx.x * QT;
    const int col0 = blockIdx.y * DH;
    const size_t base = (size_t)blockIdx.z * row_stride;
    const int q_end = min(q0 + QT, row_stride);
    const int r_warp = q0 + 16 * warp;   // the warp's first query row

    if (q0 >= n_valid) {  // a tile of pad rows only
        for (int c = tid; c < QT * 8; c += THREADS) {
            const int gi = q0 + (c >> 3);
            if (gi < q_end)
                *reinterpret_cast<uint4*>(out + (base + gi) * D + col0
                                          + (c & 7) * 8) = make_uint4(0, 0, 0, 0);
        }
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
            load_tile(st, k, base, k0, kv, col0, D);
            if (s >= n_tiles) load_tile(st + SLOT, v, base, k0, kv, col0, D);
        }
        cp_async_commit();
    };

    // prologue: the query tile into stage 2's K slot with step 0, then step 1
    bf16* qs = ring + 2 * 2 * SLOT;
    load_tile(qs, q, base, q0, rows, col0, D);
    issue(0);
    issue(1);
    cp_async_wait1();
    __syncthreads();

    // the warp's Q as A fragments, pre-scaled in the folded flavour
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int t = 0; t < DH / 16; ++t) {
        ldsm_x4(qa[t], qs + (16 * warp + (lane & 15)) * LDH + t * 16
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
            score_chunk(sc, qa, ks, 16 * c, lane);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float cm = mx[r];
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 2 * r; e < 2 * r + 2; ++e) {
                        if (M && 16 * c + 8 * j + 2 * tq + (e & 1) >= kv)
                            sc[j][e] = -INFINITY;
                        cm = fmaxf(cm, sc[j][e]);
                    }
                if (!FOLDED && cm != -INFINITY) {
                    const float ms = __fmul_rn(cm, scale);
                    float part = 0.f;
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int e = 2 * r; e < 2 * r + 2; ++e)
                            if (!M || sc[j][e] != -INFINITY)
                                part += expf(__fmul_rn(sc[j][e], scale) - ms);
                    const float f = mx[r] == -INFINITY
                        ? 0.f : expf(__fmul_rn(mx[r], scale) - ms);
                    den[r] = den[r] * f + part;
                }
                mx[r] = cm;
            }
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
            score_chunk(sc, qa, ks, 16 * c, lane);
            // the accumulators of keys 16c .. 16c+7 and 16c+8 .. 16c+15 are
            // the A fragment of P over these 16 keys
            uint32_t pa[4];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float x[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float sv = sc[j][2 * r + h];
                        x[h] = FOLDED
                            ? exp2f(sv - mx[r])
                            : expf(__fmul_rn(sv, scale)
                                   - __fmul_rn(mx[r], scale)) / den[r];
                        if (M && 16 * c + 8 * j + 2 * tq + h >= kv) x[h] = 0.f;
                    }
                    const uint32_t p = as_u32(__floats2bfloat162_rn(x[0], x[1]));
                    if (FOLDED)   // the two bf16 values as f32
                        den[r] += __uint_as_float(p << 16)
                                  + __uint_as_float(p & 0xffff0000u);
                    pa[2 * j + r] = p;
                }
            const bf16* vp = vs + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * LDH + (lane >> 4) * 8;
#pragma unroll
            for (int nb = 0; nb < DH / 16; ++nb) {
                uint32_t b[4];
                ldsm_x4_t(b, vp + nb * 16);
                mma(acc[2 * nb], pa, b[0], b[1]);
                mma(acc[2 * nb + 1], pa, b[2], b[3]);
            }
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
        if (s == n_tiles - 1) {
            // the rows' maxima over all keys, and the plain flavour's sums
            // rescaled to them
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
    }
    cp_async_wait_all();

    // ---- the context: the folded flavour divides by its f32 sum of the
    // bf16 exponents here, after P V; staged through a free stage (the
    // warp's own rows) for 16-byte stores, pad rows zero
    bf16* os = ring + (n_steps % STAGES) * 2 * SLOT + 16 * warp * LDH;
    if (busy) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float inv = FOLDED ? 1.f / quad_sum(den[r]) : 1.f;
#pragma unroll
            for (int n = 0; n < DH / 8; ++n)
                *reinterpret_cast<__nv_bfloat162*>(
                    os + (g + 8 * r) * LDH + 8 * n + 2 * tq) =
                    __floats2bfloat162_rn(acc[n][2 * r] * inv,
                                          acc[n][2 * r + 1] * inv);
        }
    }
    __syncwarp();
    for (int c = lane; c < 16 * 8; c += 32) {
        const int row = c >> 3, c8 = (c & 7) * 8;
        const int gi = r_warp + row;
        if (gi >= q_end) continue;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gi < n_valid)
            val = *reinterpret_cast<const uint4*>(os + row * LDH + c8);
        *reinterpret_cast<uint4*>(out + (base + gi) * D + col0 + c8) = val;
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

// bytes of dynamic shared memory a block of the kernel takes
int vit_attention_forward_smem(void) { return (int)SMEM; }

}  // extern "C"
