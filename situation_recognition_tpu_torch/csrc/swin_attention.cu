// The Swin Transformer's window attention for NVIDIA Hopper, sm_90a: a
// forward and a backward kernel, and a pass that sums the bias's
// gradient.
//
// Replaces no TPU kernel: the JAX package has no Swin.  The port's Swin-L
// (arXiv:2103.14030, swin_large_patch4_window7_224) needs an attention
// core that its other kernels do not compute: heads 32 wide over windows
// of 7x7 = 49 tokens, a learned per-head relative-position bias (h, N, N)
// added to the scores, and in every second block a mask (nW, N, N) of 0 /
// -100 chosen by the window's place in its image.  Autograd over plain
// torch keeps every block's (B nW, h, N, N) scores and probabilities (1.83
// G scores a forward at batch 256) and runs the bias, the mask and the
// softmax as passes of their own over them.
//
// For window w (rows w N .. w N + N - 1 of qkv), head h and query i:
//   s_ij = (q_i . k_j) * scale + bias[h][i][j] + mask[w mod nW][i][j]
//   p_i  = softmax_f32(s_i),  ctx_i = bf16(p_i) V  (f32 sums, bf16 out)
// and the backward, from the context's cotangent dO:
//   P recomputed as above, dP = dO V^T, D_i = sum_j P_ij dP_ij,
//   dS = P (dP - D)                                          (all f32)
//   dV = bf16(P)^T dO,  dQ = bf16(dS) K scale,  dK = bf16(dS)^T Q scale
//   dbias[h] = sum over every window of dS                   (f32)
// qkv is (B nW N, 3C) bf16, the heads packed as the published
// reshape(B_, N, 3, h, 32): q of head h at columns 32h, k at C + 32h, v at
// 2C + 32h; the context and dO are (B nW N, C), dqkv as qkv.  The twins
// are ops/swin.py's wattn_reference and wattn_bwd_reference.
//
// What bounds it on this card.  At Swin-L, batch 256, a block's forward
// reads its qkv and writes the context: 0.31-1.23 GB by stage against 4 B
// nW h N^2 32 operations, 24 FLOP a byte; the backward reads qkv and dO
// and writes dqkv, 10 B nW h N^2 32 operations.  Both are bound by memory
// (benchmark/window_work.py counts them), so the design keeps every
// window's scores, probabilities and gradients on chip and reads each
// operand once.
//
// Design.  A window is one 64-row tile (N <= 64; the 15 pad rows of a
// window of 49 are zero-filled on load and masked: their keys enter the
// softmax as -inf, their rows take P = 0 and dS = 0 and are not stored).
// A block of 4 warps holds one head and walks a group of windows, w =
// blockIdx.x, + gridDim.x, ... (the host picks the groups from the shape
// alone); warp i owns query rows 16i .. 16i + 15.  Q, K, V (and dO) tiles,
// 32 columns of 64 rows, come in through a 2-stage cp.async ring: the next
// window's tiles load while this one is computed.  Products are
// mma.sync.m16n8k16 bf16 with f32 sums, operands through ldmatrix (.trans
// for the right-hand operand of P V, dS K, P^T dO and dS^T Q), the
// fragment layouts of csrc/vit_attention.cu.  A warp's scores of its 16
// rows against all 64 keys stay in registers, so the softmax is exact in
// one pass (no running maximum) and the backward recomputes it without
// saved statistics.  The backward writes bf16 P^T and dS^T to shared
// memory for dV and dK, whose rows are keys.  The bias's gradient is
// summed in registers over the block's windows and written once as the
// group's partial (G, h, N, N); swin_wattn_dbias_kernel then sums the
// groups in order.  No atomics: every output is summed in a fixed order,
// so two launches on the same inputs are bit-equal.
//
// Interface: plain C, loaded with ctypes.  The launches go on the caller's
// stream, nothing is synchronised or allocated here, and each function
// returns cudaGetLastError() of its launches (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int T = 16 * WARPS;     // rows of a tile: a window's tokens, padded
constexpr int DH = 32;            // head width
constexpr int PD = DH + 8;        // pitch of a 32-column tile (80 bytes)
constexpr int PT = T + 8;         // pitch of a 64-column tile (144 bytes)
constexpr int TILE = T * PD;      // bf16 elements of a 64 x 32 tile
constexpr int TILE64 = T * PT;    // bf16 elements of a 64 x 64 tile
constexpr int STAGES = 2;
constexpr int FWD_TILES = 3;      // Q, K, V
constexpr int BWD_TILES = 4;      // Q, K, V, dO
constexpr int DBIAS_THREADS = 256;

constexpr size_t FWD_SMEM = (size_t)STAGES * FWD_TILES * TILE * sizeof(bf16);
constexpr size_t BWD_SMEM = ((size_t)STAGES * BWD_TILES * TILE
                             + 2 * (size_t)TILE64) * sizeof(bf16);

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

__device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
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

// The accumulators of a warp's 16 rows against the 64 keys of a tile:
// s[c][j][e] is key chunk c (keys 16c ..), n8 tile j (keys 16c + 8j ..),
// element e: row g + 8 (e >> 1), key 16c + 8j + 2 tq + (e & 1), with g =
// lane / 4 and tq = lane % 4 (the m16n8 accumulator layout).
typedef float Acc[4][2][4];

__device__ __forceinline__ void zero(Acc& s) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[c][j][e] = 0.f;
}

// rows 0 .. n - 1 of a window starting at row `row0` of a row-major matrix
// of `ld` columns, columns col0 .. col0 + 31, into a 64-row tile of pitch
// PD, asynchronously; the tile's rows from n on are zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          size_t row0, int n, int col0,
                                          int ld) {
    for (int c = threadIdx.x; c < T * 4; c += THREADS) {
        const int row = c >> 2, c8 = (c & 3) * 8;
        const bool real = row < n;
        cp_async16(dst + row * PD + c8,
                   src + (real ? (row0 + row) * (size_t)ld + col0 + c8 : 0),
                   real ? 16 : 0);
    }
}

// the A fragments of rows r0 .. r0 + 15 of a tile of pitch PD over its 32
// columns
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* tile,
                                       int r0, int lane) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
        ldsm_x4(a[t], tile + (r0 + (lane & 15)) * PD + t * 16
                      + (lane >> 4) * 8);
}

// s[c] += the warp's rows (A fragments a over 32 columns) against rows
// 16c .. 16c + 15 of a tile of pitch PD, for every c: Q K^T, or dO V^T
__device__ __forceinline__ void rows_by_rows(Acc& s, const uint32_t (&a)[2][4],
                                             const bf16* kt, int lane) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const bf16* p = kt + (16 * c + (lane & 7) + ((lane >> 4) << 3)) * PD
                        + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            uint32_t b[4];
            ldsm_x4(b, p + t * 16);
            mma(s[c][0], a[t], b[0], b[1]);
            mma(s[c][1], a[t], b[2], b[3]);
        }
    }
}

// acc += A (16 rows over the contraction rows k0 .. k0 + 15) times rows
// k0 .. k0 + 15 of a tile of pitch PD over its 32 columns: P V, dS K,
// P^T dO, dS^T Q
__device__ __forceinline__ void times_tile(float (&acc)[4][4],
                                           const uint32_t (&a)[4],
                                           const bf16* vt, int k0, int lane) {
    const bf16* vp = vt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * PD
                     + (lane >> 4) * 8;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        ldsm_x4_t(b, vp + nb * 16);
        mma(acc[2 * nb], a, b[0], b[1]);
        mma(acc[2 * nb + 1], a, b[2], b[3]);
    }
}

// key chunk c of accumulators as the bf16 A fragment of the next product
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
            a[2 * j + r] = pack(s[j][2 * r], s[j][2 * r + 1]);
}

// the scores of the warp's rows into probabilities, in place: s * scale +
// bias (+ the window's mask) in f32 for real rows and keys, -inf for pad
// keys, the f32 softmax of each real row, and 0 in every pad row
__device__ __forceinline__ void probs(Acc& s, const float* __restrict__ hb,
                                      const float* __restrict__ wm, int N,
                                      int r_warp, int g, int tq,
                                      float scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int i = r_warp + g + 8 * r;
        const bool real = i < N;
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int key = 16 * c + 8 * j + 2 * tq + h;
                    float v = -INFINITY;
                    if (real && key < N) {
                        v = __fadd_rn(__fmul_rn(s[c][j][2 * r + h], scale),
                                      __ldg(hb + i * N + key));
                        if (wm) v = __fadd_rn(v, __ldg(wm + i * N + key));
                    }
                    s[c][j][2 * r + h] = v;
                    m = fmaxf(m, v);
                }
        m = quad_max(m);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float& v = s[c][j][2 * r + h];
                    v = v == -INFINITY ? 0.f : expf(v - m);
                    sum += v;
                }
        sum = quad_sum(sum);
        const float inv = real ? 1.f / sum : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) s[c][j][2 * r + h] *= inv;
    }
}

// the warp's rows of an m16 x 32 accumulator, times `mul`, in bf16 into
// rows row0 + r_warp + .. (those below N) of a matrix of `ld` columns at
// column col0
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[4][4],
                                           size_t row0, int r_warp, int N,
                                           int col0, int ld, float mul,
                                           int g, int tq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int i = r_warp + g + 8 * r;
        if (i >= N) continue;
        bf16* row = dst + (row0 + i) * (size_t)ld + col0 + 2 * tq;
#pragma unroll
        for (int n = 0; n < 4; ++n)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
                __floats2bfloat162_rn(acc[n][2 * r] * mul,
                                      acc[n][2 * r + 1] * mul);
    }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

__global__ void __launch_bounds__(THREADS, 4)
swin_wattn_fwd_kernel(const bf16* __restrict__ qkv,
                      const float* __restrict__ bias,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      int BW, int nW, int N, int C, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* ring = reinterpret_cast<bf16*>(smem);   // stage s: Q, K, V

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int head = blockIdx.y, G = gridDim.x;
    const int r_warp = 16 * warp;
    const float* hb = bias + (size_t)head * N * N;

    auto issue = [&](int w, int stage) {
        if (w < BW) {
            bf16* st = ring + stage * FWD_TILES * TILE;
            for (int t = 0; t < FWD_TILES; ++t)
                load_tile(st + t * TILE, qkv, (size_t)w * N, N,
                          t * C + head * DH, 3 * C);
        }
        cp_async_commit();
    };

    issue(blockIdx.x, 0);
    int it = 0;
    for (int w = blockIdx.x; w < BW; w += G, ++it) {
        issue(w + G, (it + 1) % STAGES);
        cp_async_wait1();
        __syncthreads();   // this window's tiles landed
        const bf16* st = ring + (it % STAGES) * FWD_TILES * TILE;
        uint32_t qa[2][4];
        load_a(qa, st, r_warp, lane);
        Acc s;
        zero(s);
        rows_by_rows(s, qa, st + TILE, lane);
        probs(s, hb, mask ? mask + (size_t)(w % nW) * N * N : nullptr, N,
              r_warp, g, tq, scale);
        float acc[4][4];
        zero4(acc);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            uint32_t pa[4];
            as_a(pa, s[c]);
            times_tile(acc, pa, st + 2 * TILE, 16 * c, lane);
        }
        store_rows(out, acc, (size_t)w * N, r_warp, N, head * DH, C, 1.f, g,
                   tq);
        __syncthreads();   // every warp is done with this stage
    }
    cp_async_wait_all();
}

__global__ void __launch_bounds__(THREADS, 3)
swin_wattn_bwd_kernel(const bf16* __restrict__ qkv,
                      const float* __restrict__ bias,
                      const float* __restrict__ mask,
                      const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                      float* __restrict__ part, int BW, int nW, int N, int C,
                      float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* ring = reinterpret_cast<bf16*>(smem);   // stage s: Q, K, V, dO
    bf16* pt = ring + STAGES * BWD_TILES * TILE;  // bf16(P)^T: [key][query]
    bf16* dst = pt + TILE64;                      // bf16(dS)^T

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int head = blockIdx.y, heads = gridDim.y, G = gridDim.x;
    const int r_warp = 16 * warp;
    const float* hb = bias + (size_t)head * N * N;

    auto issue = [&](int w, int stage) {
        if (w < BW) {
            bf16* st = ring + stage * BWD_TILES * TILE;
            for (int t = 0; t < 3; ++t)
                load_tile(st + t * TILE, qkv, (size_t)w * N, N,
                          t * C + head * DH, 3 * C);
            load_tile(st + 3 * TILE, dout, (size_t)w * N, N, head * DH, C);
        }
        cp_async_commit();
    };

    Acc db;   // the group's sum of dS
    zero(db);
    issue(blockIdx.x, 0);
    int it = 0;
    for (int w = blockIdx.x; w < BW; w += G, ++it) {
        issue(w + G, (it + 1) % STAGES);
        cp_async_wait1();
        __syncthreads();   // this window's tiles landed
        const bf16* st = ring + (it % STAGES) * BWD_TILES * TILE;
        const bf16 *qt = st, *kt = st + TILE, *vt = st + 2 * TILE,
                   *dot = st + 3 * TILE;
        Acc s, dp;
        {
            uint32_t a[2][4];
            load_a(a, qt, r_warp, lane);
            zero(s);
            rows_by_rows(s, a, kt, lane);
            load_a(a, dot, r_warp, lane);
            zero(dp);
            rows_by_rows(dp, a, vt, lane);
        }
        probs(s, hb, mask ? mask + (size_t)(w % nW) * N * N : nullptr, N,
              r_warp, g, tq, scale);
        // dS = P (dP - D), D the row's sum of P dP; pad rows and keys have
        // P = 0 and so dS = 0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        d += s[c][j][2 * r + h] * dp[c][j][2 * r + h];
            d = quad_sum(d);
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float& x = dp[c][j][2 * r + h];
                        x = s[c][j][2 * r + h] * (x - d);
                        db[c][j][2 * r + h] += x;
                    }
        }
        // bf16 P^T and dS^T for the products over the queries
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = 16 * c + 8 * j + 2 * tq + (e & 1);
                    const int q = r_warp + g + 8 * (e >> 1);
                    pt[key * PT + q] = __float2bfloat16_rn(s[c][j][e]);
                    dst[key * PT + q] = __float2bfloat16_rn(dp[c][j][e]);
                }
        // dQ of the warp's rows = dS K scale
        {
            float dq[4][4];
            zero4(dq);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                uint32_t a[4];
                as_a(a, dp[c]);
                times_tile(dq, a, kt, 16 * c, lane);
            }
            store_rows(dqkv, dq, (size_t)w * N, r_warp, N, head * DH, 3 * C,
                       scale, g, tq);
        }
        __syncthreads();   // P^T and dS^T are whole
        // the warp's keys: dV = P^T dO, dK = dS^T Q scale
        {
            float dv[4][4], dk[4][4];
            zero4(dv);
            zero4(dk);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int off = (r_warp + (lane & 15)) * PT + t * 16
                                + (lane >> 4) * 8;
                uint32_t a[4];
                ldsm_x4(a, pt + off);
                times_tile(dv, a, dot, 16 * t, lane);
                ldsm_x4(a, dst + off);
                times_tile(dk, a, qt, 16 * t, lane);
            }
            store_rows(dqkv, dk, (size_t)w * N, r_warp, N, C + head * DH,
                       3 * C, scale, g, tq);
            store_rows(dqkv, dv, (size_t)w * N, r_warp, N, 2 * C + head * DH,
                       3 * C, 1.f, g, tq);
        }
        __syncthreads();   // every warp is done with this stage and P^T, dS^T
    }
    cp_async_wait_all();
    // the group's partial of dbias: (group, head, N, N)
    float* gp = part + ((size_t)blockIdx.x * heads + head) * N * N;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = 16 * c + 8 * j + 2 * tq + (e & 1);
                const int i = r_warp + g + 8 * (e >> 1);
                if (i < N && key < N) gp[i * N + key] = db[c][j][e];
            }
}

// dbias[x] = the sum over the G groups, in order, of part[g][x], x over
// (h, N, N)
__global__ void __launch_bounds__(DBIAS_THREADS)
swin_wattn_dbias_kernel(const float* __restrict__ part,
                        float* __restrict__ dbias, int G, int total) {
    const int x = blockIdx.x * DBIAS_THREADS + threadIdx.x;
    if (x >= total) return;
    float sum = 0.f;
    for (int g = 0; g < G; ++g) sum += part[(size_t)g * total + x];
    dbias[x] = sum;
}

bool takes(int BW, int nW, int N, int heads, int C, int groups) {
    return BW >= 1 && N >= 1 && N <= T && heads >= 1 && heads <= 65535
           && C == heads * DH && nW >= 1 && BW % nW == 0 && groups >= 1
           && groups <= BW;
}

}  // namespace

extern "C" {

// The forward.  qkv (BW N, 3C) bf16, bias (heads, N, N) f32, mask (nW, N,
// N) f32 or null (then nW is 1), out (BW N, C) bf16; `groups` blocks a
// head, each walking windows g, g + groups, ...
int swin_wattn_forward(const void* qkv, const void* bias, const void* mask,
                       void* out, int BW, int nW, int N, int heads, int C,
                       int groups, float scale, void* stream) {
    if (!takes(BW, nW, N, heads, C, groups))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        swin_wattn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)FWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    swin_wattn_fwd_kernel<<<dim3(groups, heads), THREADS, FWD_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<bf16*>(out), BW, nW, N,
        C, scale);
    return (int)cudaGetLastError();
}

// The backward.  As the forward, with dout (BW N, C) bf16 in, dqkv (BW N,
// 3C) bf16, dbias (heads, N, N) f32 out, and part (groups, heads, N, N)
// f32 the groups' partials (scratch)
int swin_wattn_backward(const void* qkv, const void* bias, const void* mask,
                        const void* dout, void* dqkv, void* part,
                        void* dbias, int BW, int nW, int N, int heads, int C,
                        int groups, float scale, void* stream) {
    if (!takes(BW, nW, N, heads, C, groups))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaFuncSetAttribute(
        swin_wattn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    swin_wattn_bwd_kernel<<<dim3(groups, heads), THREADS, BWD_SMEM, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), static_cast<float*>(part), BW, nW, N, C,
        scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int total = heads * N * N;
    swin_wattn_dbias_kernel<<<(total + DBIAS_THREADS - 1) / DBIAS_THREADS,
                              DBIAS_THREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dbias), groups,
        total);
    return (int)cudaGetLastError();
}

}  // extern "C"
