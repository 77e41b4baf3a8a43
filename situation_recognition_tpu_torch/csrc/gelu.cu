// Bias + GELU over the last axis of a (rows, H) tensor, forward and
// backward, for NVIDIA Hopper (sm_90a): the fine-tuning blocks' MLP
// activation (the ViT's ``ft_block`` fc1, every Swin block's fc1).
//
// Replaces no TPU kernel: the JAX package writes the activation as jnp ops
// after the fc1 product, which XLA fuses on the TPU.  On the card the port
// ran them as torch ops under autograd (``ops/vit.py`` ``gelu`` after the
// bias add): a bias pass and five bf16 passes forward, eleven backward and
// the bias gradient's sum, each over a full (rows, H) tensor in device
// memory, and three of them kept for the backward.
//
//   gelu_rows_fwd_kernel<QUICK>    y = GELU(h + b): h the fc1 product
//                                  without its bias (bf16), b (H,) f32;
//                                  x = h + b and GELU(x) in f32, y rounded
//                                  once to bf16.  Exact GELU 0.5 x (1 +
//                                  erf(x / sqrt 2)), or QuickGELU
//                                  x sigmoid(1.702 x).
//   gelu_rows_bwd_kernel<QUICK>    dh = dy GELU'(h + b), rounded once to
//                                  bf16; a persistent grid, each thread
//                                  keeping its columns' partial db = sum
//                                  of the unrounded dh in f32 registers
//                                  over the rows it walks; one (H,)
//                                  partial a block, its rows summed in
//                                  order.
//   gelu_rows_dbias_kernel         the blocks' partials summed in a fixed
//                                  order into db: no atomics, so two runs
//                                  on one card are bit-equal.
//
// What bounds it on this card: bytes (a few dozen operations an element,
// erf and exp included).  The least traffic is one read of h and one write
// of y forward, one read of h and of dy and one write of dh backward; the
// bias is a row's worth.  A thread owns fixed columns of every row it
// walks: TPR threads of VPT 16-byte loads of 8 values each span a row (TPR
// * VPT * 8 = H, TPR a power of two up to 256, as ``ops/layernorm.py``
// ``plan`` gives them), 256 / TPR rows a block a step, and the grid strides
// over the rows, so the bias stays in registers and the db partials never
// leave them until the block's last row.  A thread loads its next row
// before it computes the current one, so that its loads stay in flight
// through the erf and exp: on an H100 at the fine-tuning cells' shapes the
// backward ran 7-10% faster with the prefetch and the forward 1-7%, at 3
// resident blocks an SM forward and 2 backward (the best of 2-4 forward
// and 1-3 backward; none spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
// loads of a row a thread holds; values a load
constexpr int kMaxVpt = 3;
constexpr int E = 8;
constexpr int kFwdBlocksPerSm = 3;
constexpr int kBwdBlocksPerSm = 2;
// gelu_rows_dbias_kernel: columns a block, and the slices of the partials
// its threads sum before the block adds them
constexpr int kBiasCols = 32;
constexpr int kBiasSlices = kThreads / kBiasCols;
constexpr float kRsqrt2 = 0.70710678118654752f;
constexpr float kRsqrt2Pi = 0.39894228040143268f;
constexpr float kQuick = 1.702f;

// ------------------------------------------------------- element access

// value i of 8 bf16 packed in a 16-byte word, as f32
__device__ __forceinline__ float bf16_at(const uint4& q, int i) {
    const unsigned u = i < 2 ? q.x : i < 4 ? q.y : i < 6 ? q.z : q.w;
    return __uint_as_float(i % 2 ? u & 0xffff0000u : u << 16);
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
           | (static_cast<unsigned>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// 8 f32 values rounded to bf16, as one 16-byte word
__device__ __forceinline__ uint4 pack8(const float (&f)[E]) {
    return make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                      bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7]));
}

// ------------------------------------------------------------ the math

template <bool QUICK>
__device__ __forceinline__ float gelu(float x) {
    if constexpr (QUICK) return x / (1.f + expf(-kQuick * x));
    return 0.5f * x * (1.f + erff(x * kRsqrt2));
}

// d GELU(x) / dx
template <bool QUICK>
__device__ __forceinline__ float gelu_grad(float x) {
    if constexpr (QUICK) {
        const float s = 1.f / (1.f + expf(-kQuick * x));
        return s + kQuick * x * s * (1.f - s);
    }
    return 0.5f * (1.f + erff(x * kRsqrt2))
           + x * kRsqrt2Pi * expf(-0.5f * x * x);
}

// The thread's bias: load j's 8 columns from (j * tpr + lane) * 8.
template <int VPT>
__device__ __forceinline__ void load_bias(const float* __restrict__ bias,
                                          int tpr, int lane,
                                          float (&b)[VPT][E]) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        const float4* p = reinterpret_cast<const float4*>(
            bias + (j * tpr + lane) * E);
        const float4 lo = __ldg(p), hi = __ldg(p + 1);
        b[j][0] = lo.x; b[j][1] = lo.y; b[j][2] = lo.z; b[j][3] = lo.w;
        b[j][4] = hi.x; b[j][5] = hi.y; b[j][6] = hi.z; b[j][7] = hi.w;
    }
}

// --------------------------------------------------------------- forward

// h, y: (rows, d) bf16, d = tpr * VPT * 8; bias: (d,) f32.  The grid
// strides over the rows, 256 / tpr a block a step.
template <bool QUICK, int VPT>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
gelu_rows_fwd_kernel(const uint4* __restrict__ h,
                     const float* __restrict__ bias, uint4* __restrict__ y,
                     int rows, int d, int tpr) {
    const int lane = threadIdx.x % tpr;
    const int per_block = kThreads / tpr;
    const int words = d / E;
    float b[VPT][E];
    load_bias<VPT>(bias, tpr, lane, b);
    const long long stride = static_cast<long long>(gridDim.x) * per_block;
    long long row = static_cast<long long>(blockIdx.x) * per_block
                    + threadIdx.x / tpr;
    uint4 v[VPT];
    if (row < rows) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) v[j] = h[row * words + lane + j * tpr];
    }
    for (; row < rows; row += stride) {
        const long long at = row * words + lane;
        const long long nxt = (row + stride) * words + lane;
        uint4 nv[VPT];
        if (row + stride < rows) {
#pragma unroll
            for (int j = 0; j < VPT; ++j) nv[j] = h[nxt + j * tpr];
        }
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
            float o[E];
#pragma unroll
            for (int i = 0; i < E; ++i) {
                o[i] = gelu<QUICK>(bf16_at(v[j], i) + b[j][i]);
            }
            y[at + j * tpr] = pack8(o);
        }
#pragma unroll
        for (int j = 0; j < VPT; ++j) v[j] = nv[j];
    }
}

// -------------------------------------------------------------- backward

// h, dy, dh: (rows, d) bf16; bias: (d,) f32; part: (gridDim.x, d) f32,
// each block's sum of the unrounded dh over the rows it took.
template <bool QUICK, int VPT>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
gelu_rows_bwd_kernel(const uint4* __restrict__ h,
                     const float* __restrict__ bias,
                     const uint4* __restrict__ dy, uint4* __restrict__ dh,
                     float* __restrict__ part, int rows, int d, int tpr) {
    __shared__ float sums[kThreads * E];
    const int lane = threadIdx.x % tpr;
    const int per_block = kThreads / tpr;
    const int words = d / E;
    float b[VPT][E], db[VPT][E];
    load_bias<VPT>(bias, tpr, lane, b);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
        for (int i = 0; i < E; ++i) db[j][i] = 0.f;
    }

    const long long stride = static_cast<long long>(gridDim.x) * per_block;
    long long row = static_cast<long long>(blockIdx.x) * per_block
                    + threadIdx.x / tpr;
    uint4 hv[VPT], gv[VPT];
    if (row < rows) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
            hv[j] = h[row * words + lane + j * tpr];
            gv[j] = dy[row * words + lane + j * tpr];
        }
    }
    for (; row < rows; row += stride) {
        const long long at = row * words + lane;
        const long long nxt = (row + stride) * words + lane;
        uint4 nh[VPT], ng[VPT];
        if (row + stride < rows) {
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
                nh[j] = h[nxt + j * tpr];
                ng[j] = dy[nxt + j * tpr];
            }
        }
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
            float o[E];
#pragma unroll
            for (int i = 0; i < E; ++i) {
                o[i] = bf16_at(gv[j], i)
                       * gelu_grad<QUICK>(bf16_at(hv[j], i) + b[j][i]);
                db[j][i] += o[i];
            }
            dh[at + j * tpr] = pack8(o);
        }
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
            hv[j] = nh[j];
            gv[j] = ng[j];
        }
    }

    // the block's partial: each column's sum over the block's slots, in
    // slot order, from shared memory, load j at a time
    float* out = part + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < E; ++i) sums[threadIdx.x * E + i] = db[j][i];
        __syncthreads();
        for (int c = threadIdx.x; c < tpr * E; c += kThreads) {
            float s = 0.f;
            for (int k = 0; k < per_block; ++k) s += sums[k * tpr * E + c];
            out[j * tpr * E + c] = s;
        }
    }
}

// part: (blocks, cols) f32 → out: (cols,) f32, each column's sum over the
// blocks: kBiasSlices slices (block g in slice g % kBiasSlices) summed in
// order, then the slices in order.
__global__ void __launch_bounds__(kThreads)
gelu_rows_dbias_kernel(const float* __restrict__ part,
                       float* __restrict__ out, int blocks, int cols) {
    __shared__ float s[kBiasSlices][kBiasCols + 1];
    const int tx = threadIdx.x % kBiasCols;
    const int ty = threadIdx.x / kBiasCols;
    const int c = blockIdx.x * kBiasCols + tx;
    float v = 0.f;
    if (c < cols) {
        for (int g = ty; g < blocks; g += kBiasSlices) {
            v += part[static_cast<long long>(g) * cols + c];
        }
    }
    s[ty][tx] = v;
    __syncthreads();
    if (ty == 0 && c < cols) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < kBiasSlices; ++k) t += s[k][tx];
        out[c] = t;
    }
}

// -------------------------------------------------------------- launches

static bool plan_ok(int rows, int d, int tpr, int vpt, int blocks) {
    return rows >= 1 && blocks >= 1 && tpr >= 1 && tpr <= kThreads
           && (tpr & (tpr - 1)) == 0 && vpt >= 1 && vpt <= kMaxVpt
           && d == tpr * vpt * E;
}

template <bool QUICK, int VPT>
static int fwd_as(const void* h, const void* bias, void* y, int rows, int d,
                  int tpr, int blocks, cudaStream_t s) {
    gelu_rows_fwd_kernel<QUICK, VPT><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(h), static_cast<const float*>(bias),
        static_cast<uint4*>(y), rows, d, tpr);
    return static_cast<int>(cudaGetLastError());
}

template <bool QUICK>
static int fwd_vpt(int vpt, const void* h, const void* bias, void* y,
                   int rows, int d, int tpr, int blocks, cudaStream_t s) {
    switch (vpt) {
        case 1: return fwd_as<QUICK, 1>(h, bias, y, rows, d, tpr, blocks, s);
        case 2: return fwd_as<QUICK, 2>(h, bias, y, rows, d, tpr, blocks, s);
        case 3: return fwd_as<QUICK, 3>(h, bias, y, rows, d, tpr, blocks, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool QUICK, int VPT>
static int bwd_as(const void* h, const void* bias, const void* dy, void* dh,
                  void* part, void* dbias, int rows, int d, int tpr,
                  int blocks, cudaStream_t s) {
    gelu_rows_bwd_kernel<QUICK, VPT><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(h), static_cast<const float*>(bias),
        static_cast<const uint4*>(dy), static_cast<uint4*>(dh),
        static_cast<float*>(part), rows, d, tpr);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    gelu_rows_dbias_kernel<<<(d + kBiasCols - 1) / kBiasCols, kThreads, 0,
                             s>>>(static_cast<const float*>(part),
                                  static_cast<float*>(dbias), blocks, d);
    return static_cast<int>(cudaGetLastError());
}

template <bool QUICK>
static int bwd_vpt(int vpt, const void* h, const void* bias, const void* dy,
                   void* dh, void* part, void* dbias, int rows, int d,
                   int tpr, int blocks, cudaStream_t s) {
    switch (vpt) {
        case 1: return bwd_as<QUICK, 1>(h, bias, dy, dh, part, dbias, rows,
                                        d, tpr, blocks, s);
        case 2: return bwd_as<QUICK, 2>(h, bias, dy, dh, part, dbias, rows,
                                        d, tpr, blocks, s);
        case 3: return bwd_as<QUICK, 3>(h, bias, dy, dh, part, dbias, rows,
                                        d, tpr, blocks, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

// h: (rows, d) bf16, d = tpr * vpt * 8, tpr a power of two in [1, 256],
// vpt in [1, 3]; bias: (d,) f32; every tensor contiguous and 16-byte
// aligned; rows >= 1; blocks: the grid (at most the rows' blocks of
// 256 / tpr rows, as many as fill the card).  quick: QuickGELU, else the
// exact GELU.

// y: (rows, d) bf16 out.
int gelu_rows_forward(int quick, const void* h, const void* bias, void* y,
                      int rows, int d, int tpr, int vpt, int blocks,
                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!plan_ok(rows, d, tpr, vpt, blocks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (quick) return fwd_vpt<true>(vpt, h, bias, y, rows, d, tpr, blocks, s);
    return fwd_vpt<false>(vpt, h, bias, y, rows, d, tpr, blocks, s);
}

// dy: (rows, d) bf16, the cotangent of y; dh: (rows, d) bf16 out; part:
// (blocks, d) f32 scratch; dbias: (d,) f32 out.
int gelu_rows_backward(int quick, const void* h, const void* bias,
                       const void* dy, void* dh, void* part, void* dbias,
                       int rows, int d, int tpr, int vpt, int blocks,
                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!plan_ok(rows, d, tpr, vpt, blocks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (quick) {
        return bwd_vpt<true>(vpt, h, bias, dy, dh, part, dbias, rows, d, tpr,
                             blocks, s);
    }
    return bwd_vpt<false>(vpt, h, bias, dy, dh, part, dbias, rows, d, tpr,
                          blocks, s);
}

}  // extern "C"
