// LayerNorm over the last axis of a (rows, D) tensor, forward and backward,
// for NVIDIA Hopper (sm_90a): the port's fine-tuning paths (the ViT's
// block norms under autograd, every norm of the Swin backbone).
//
// Replaces no TPU kernel: the JAX package writes its LayerNorm as f32 jnp
// ops, which XLA fuses into one pass on the TPU.  On the card the port ran
// that composition (``ops/vit.py`` ``ln_f32``) under autograd: a cast to
// f32 and nine f32 elementwise ops or reductions forward, 21 backward, each
// a pass over a full f32 (rows, D) tensor in device memory.
//
//   ln_rows_fwd_kernel     y = (x - mean) * rstd * gamma + beta, with the
//                          mean and the biased variance of each row in f32
//                          (two passes over the row held in registers,
//                          as ln_f32 takes them), rstd = rsqrt(var + eps);
//                          writes y in its type and mean, rstd (f32, one
//                          each a row).
//   ln_rows_bwd_kernel     dx = rstd * (gamma dy - mean(gamma dy)
//                          - xhat * mean(gamma dy xhat)), xhat recomputed
//                          from x, mean and rstd; a persistent grid, each
//                          thread keeping its columns' partial dgamma =
//                          sum dy xhat and dbeta = sum dy in f32 registers
//                          over the rows it walks; one (2, D) partial a
//                          block, the block's rows summed in order.
//   ln_rows_dparam_kernel  the blocks' partials summed in a fixed order
//                          into dgamma, dbeta: no atomics, so two runs on
//                          one card are bit-equal.
//
// What bounds it on this card: bytes (a handful of operations an element).
// The least traffic is one read of x and one write of y forward, one read
// of x and of dy and one write of dx backward; gamma, beta and the row
// statistics are a row's worth.  So a row of bf16 is read once, in
// 16-byte loads of 8 values, by TPR threads of VPT loads each (TPR * VPT *
// 16 bytes = one row of x), and stays in registers through both of its
// reductions and the write: TPR a power of two up to 256, a warp's shuffles
// within a row of up to 32 threads, the row's warps through shared memory
// above that; 256 / TPR rows a block.  The plan (TPR, VPT) is a function of
// D alone (ops/layernorm.py ``plan``): one warp a row of 768 or 1024 bf16
// forward (two warps of 2 loads at 1024 backward), 8 or 16 threads at 192
// and 384, two or four warps at 1536 and 3072.
//
// Rounding is ln_f32's: every value in f32 from the stored input, y (or dx)
// rounded once to its type at the store.  The sums run in another order
// than torch's reductions, so the mean and variance may differ from
// ln_f32's by f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
// loads of a row a thread holds: forward, and backward (whose thread also
// holds dy and 2 x E partial sums a load; at 4 loads of bf16 it spills)
constexpr int kMaxVpt = 4;
constexpr int kMaxVptBwd = 3;
constexpr int kBwdBlocksPerSm = 2;
// ln_rows_dparam_kernel: columns a block, and the slices of the partials
// its threads sum before the block adds them
constexpr int kParamCols = 32;
constexpr int kParamSlices = kThreads / kParamCols;

// ------------------------------------------------------- element access

// N consecutive values of T as loaded: N * sizeof(T) / 16 raw 16-byte
// words, each value read as f32 when used (bf16 widens by a shift)
template <typename T, int N>
struct Vec {
    static constexpr int kWords = N * sizeof(T) / 16;
    static_assert(kWords * 16 == N * static_cast<int>(sizeof(T)),
                  "whole 16-byte words");
    uint4 w[kWords];

    __device__ __forceinline__ void load(const T* p) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
            w[k] = reinterpret_cast<const uint4*>(p)[k];
        }
    }
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int k = 0; k < kWords; ++k) w[k] = make_uint4(0u, 0u, 0u, 0u);
    }
    __device__ __forceinline__ float get(int i) const {
        constexpr int kPer = 16 / sizeof(T);
        const uint4& q = w[i / kPer];
        const int k = (i % kPer) * static_cast<int>(sizeof(T)) / 4;
        const unsigned u = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
        if constexpr (sizeof(T) == 4) return __uint_as_float(u);
        return __uint_as_float(i % 2 ? u & 0xffff0000u : u << 16);
    }
};

__device__ __forceinline__ unsigned bf16_bits(float v) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// N f32 values rounded to T and stored at p (16-byte aligned)
template <typename T, int N>
__device__ __forceinline__ void store_vals(T* p, const float (&f)[N]) {
    constexpr int kWords = N * sizeof(T) / 16;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
        unsigned u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if constexpr (sizeof(T) == 4) {
                u[i] = __float_as_uint(f[4 * k + i]);
            } else {
                u[i] = bf16_bits(f[8 * k + 2 * i])
                       | (bf16_bits(f[8 * k + 2 * i + 1]) << 16);
            }
        }
        reinterpret_cast<uint4*>(p)[k] = make_uint4(u[0], u[1], u[2], u[3]);
    }
}

// N f32 values at p (16-byte aligned, N a multiple of 4)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[N]) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p) + k);
        f[4 * k] = q.x;
        f[4 * k + 1] = q.y;
        f[4 * k + 2] = q.z;
        f[4 * k + 3] = q.w;
    }
}

// The sum of v over the tpr threads of a row (consecutive threads of the
// block, tpr a power of two), the same in each of them: a butterfly of
// shuffles within the warp, then, for a row of several warps, the warps'
// sums from shared memory in order.  Every thread of the block calls it.
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
    const int width = tpr < 32 ? tpr : 32;
    for (int o = width / 2; o > 0; o >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    if (tpr > 32) {
        const int warps = tpr / 32;
        const int warp = threadIdx.x / 32;
        __syncthreads();                  // the last call's readers are done
        if (threadIdx.x % 32 == 0) red[warp] = v;
        __syncthreads();
        v = 0.f;
        for (int k = warp / warps * warps, e = k + warps; k < e; ++k) {
            v += red[k];
        }
    }
    return v;
}

// --------------------------------------------------------------- forward

// x: (rows, d) of TI, d = tpr * VPT * E; y: (rows, d) of TO; mean, rstd:
// (rows,) f32.  Thread lane of a row holds its row's loads j = 0..VPT-1 at
// columns (j * tpr + lane) * E, so that a warp's load j reads consecutive
// 16-byte words.
template <typename TI, typename TO, int VPT>
__global__ void __launch_bounds__(kThreads)
ln_rows_fwd_kernel(const TI* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, TO* __restrict__ y,
                   float* __restrict__ mean, float* __restrict__ rstd,
                   int rows, int d, int tpr, float eps) {
    constexpr int E = 16 / sizeof(TI);
    __shared__ float red[kThreads / 32];
    const int lane = threadIdx.x % tpr;
    const long long row = static_cast<long long>(blockIdx.x)
                          * (kThreads / tpr) + threadIdx.x / tpr;
    const bool live = row < rows;

    Vec<TI, E> v[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        if (live) {
            v[j].load(x + row * d + (j * tpr + lane) * E);
        } else {
            v[j].zero();
        }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
        for (int i = 0; i < E; ++i) s += v[j].get(i);
    }
    const float mu = row_sum(s, tpr, red) / static_cast<float>(d);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
            const float c = v[j].get(i) - mu;
            q += c * c;
        }
    }
    const float r = rsqrtf(row_sum(q, tpr, red) / static_cast<float>(d)
                           + eps);
    if (!live) return;

#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        const int c0 = (j * tpr + lane) * E;
        float g[E], b[E], o[E];
        load_f32<E>(gamma + c0, g);
        load_f32<E>(beta + c0, b);
#pragma unroll
        for (int i = 0; i < E; ++i) o[i] = (v[j].get(i) - mu) * r * g[i] + b[i];
        store_vals<TO, E>(y + row * d + c0, o);
    }
    if (lane == 0) {
        mean[row] = mu;
        rstd[row] = r;
    }
}

// -------------------------------------------------------------- backward

// x, dx: (rows, d) of TX; dy: (rows, d) of TD; mean, rstd as the forward
// wrote them.  The grid strides over the rows, 256 / tpr a block a step;
// part: (gridDim.x, 2, d) f32, each block's sum of dy * xhat, then of dy,
// over the rows it took.
template <typename TX, typename TD, int VPT>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
ln_rows_bwd_kernel(const TX* __restrict__ x, const TD* __restrict__ dy,
                   const float* __restrict__ gamma,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, TX* __restrict__ dx,
                   float* __restrict__ part, int rows, int d, int tpr) {
    constexpr int E = 16 / sizeof(TX);
    __shared__ float red[kThreads / 32];
    __shared__ float sums[kThreads * E];
    const int lane = threadIdx.x % tpr;
    const int slot = threadIdx.x / tpr;
    const int per_block = kThreads / tpr;
    const float inv_d = 1.f / static_cast<float>(d);

    float dg[VPT][E], db[VPT][E];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
        for (int i = 0; i < E; ++i) dg[j][i] = db[j][i] = 0.f;
    }

    for (long long first = static_cast<long long>(blockIdx.x) * per_block;
         first < rows;
         first += static_cast<long long>(gridDim.x) * per_block) {
        const long long row = first + slot;
        const bool live = row < rows;
        Vec<TX, E> xv[VPT];
        Vec<TD, E> gv[VPT];
        float mu = 0.f, r = 0.f;
        if (live) {
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
                const long long at = row * d + (j * tpr + lane) * E;
                xv[j].load(x + at);
                gv[j].load(dy + at);
            }
            mu = mean[row];
            r = rstd[row];
        } else {
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
                xv[j].zero();
                gv[j].zero();
            }
        }
        // a dead row reads zeros: it adds nothing to a, b, dg or db
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
            float g[E];
            load_f32<E>(gamma + (j * tpr + lane) * E, g);
#pragma unroll
            for (int i = 0; i < E; ++i) {
                const float xh = (xv[j].get(i) - mu) * r;
                const float d_y = gv[j].get(i);
                const float gd = g[i] * d_y;
                a += gd;
                b += gd * xh;
                dg[j][i] += d_y * xh;
                db[j][i] += d_y;
            }
        }
        a = row_sum(a, tpr, red) * inv_d;
        b = row_sum(b, tpr, red) * inv_d;
        if (live) {
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
                const int c0 = (j * tpr + lane) * E;
                float g[E], o[E];
                load_f32<E>(gamma + c0, g);
#pragma unroll
                for (int i = 0; i < E; ++i) {
                    const float xh = (xv[j].get(i) - mu) * r;
                    o[i] = r * (g[i] * gv[j].get(i) - a - xh * b);
                }
                store_vals<TX, E>(dx + row * d + c0, o);
            }
        }
    }

    // the block's partial: each column's sum over the block's slots, in
    // slot order, from shared memory, load j and dg / db at a time
    float* out = part + static_cast<long long>(blockIdx.x) * 2 * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
        for (int which = 0; which < 2; ++which) {
            __syncthreads();
#pragma unroll
            for (int i = 0; i < E; ++i) {
                sums[threadIdx.x * E + i] = which ? db[j][i] : dg[j][i];
            }
            __syncthreads();
            for (int c = threadIdx.x; c < tpr * E; c += kThreads) {
                float s = 0.f;
                for (int k = 0; k < per_block; ++k) s += sums[k * tpr * E + c];
                out[which * d + j * tpr * E + c] = s;
            }
        }
    }
}

// part: (blocks, cols) f32 → out: (cols,) f32, each column's sum over the
// blocks: kParamSlices slices (block g in slice g % kParamSlices) summed in
// order, then the slices in order.
__global__ void __launch_bounds__(kThreads)
ln_rows_dparam_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int blocks, int cols) {
    __shared__ float s[kParamSlices][kParamCols + 1];
    const int tx = threadIdx.x % kParamCols;
    const int ty = threadIdx.x / kParamCols;
    const int c = blockIdx.x * kParamCols + tx;
    float v = 0.f;
    if (c < cols) {
        for (int g = ty; g < blocks; g += kParamSlices) {
            v += part[static_cast<long long>(g) * cols + c];
        }
    }
    s[ty][tx] = v;
    __syncthreads();
    if (ty == 0 && c < cols) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < kParamSlices; ++k) t += s[k][tx];
        out[c] = t;
    }
}

// -------------------------------------------------------------- launches

static bool plan_ok(int d, int tpr, int vpt, int e, int most) {
    return tpr >= 1 && tpr <= kThreads && (tpr & (tpr - 1)) == 0
           && vpt >= 1 && vpt <= most && d == tpr * vpt * e;
}

template <typename TI, typename TO, int VPT>
static int fwd_as(const void* x, const void* gamma, const void* beta,
                  void* y, void* mean, void* rstd, int rows, int d, int tpr,
                  float eps, cudaStream_t s) {
    const int per_block = kThreads / tpr;
    const int grid = (rows + per_block - 1) / per_block;
    ln_rows_fwd_kernel<TI, TO, VPT><<<grid, kThreads, 0, s>>>(
        static_cast<const TI*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<TO*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, tpr,
        eps);
    return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO>
static int fwd_vpt(int vpt, const void* x, const void* gamma,
                   const void* beta, void* y, void* mean, void* rstd,
                   int rows, int d, int tpr, float eps, cudaStream_t s) {
    if (!plan_ok(d, tpr, vpt, 16 / sizeof(TI), kMaxVpt)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (vpt) {
        case 1: return fwd_as<TI, TO, 1>(x, gamma, beta, y, mean, rstd, rows,
                                         d, tpr, eps, s);
        case 2: return fwd_as<TI, TO, 2>(x, gamma, beta, y, mean, rstd, rows,
                                         d, tpr, eps, s);
        case 3: return fwd_as<TI, TO, 3>(x, gamma, beta, y, mean, rstd, rows,
                                         d, tpr, eps, s);
        case 4: return fwd_as<TI, TO, 4>(x, gamma, beta, y, mean, rstd, rows,
                                         d, tpr, eps, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX, typename TD, int VPT>
static int bwd_as(const void* x, const void* dy, const void* gamma,
                  const void* mean, const void* rstd, void* dx, void* part,
                  void* dparams, int rows, int d, int tpr, int blocks,
                  cudaStream_t s) {
    ln_rows_bwd_kernel<TX, TD, VPT><<<blocks, kThreads, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TD*>(dy),
        static_cast<const float*>(gamma), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<TX*>(dx),
        static_cast<float*>(part), rows, d, tpr);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const int cols = 2 * d;
    ln_rows_dparam_kernel<<<(cols + kParamCols - 1) / kParamCols, kThreads, 0,
                            s>>>(static_cast<const float*>(part),
                                 static_cast<float*>(dparams), blocks, cols);
    return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TD>
static int bwd_vpt(int vpt, const void* x, const void* dy, const void* gamma,
                   const void* mean, const void* rstd, void* dx, void* part,
                   void* dparams, int rows, int d, int tpr, int blocks,
                   cudaStream_t s) {
    if (!plan_ok(d, tpr, vpt, 16 / sizeof(TX), kMaxVptBwd) || blocks < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (vpt) {
        case 1: return bwd_as<TX, TD, 1>(x, dy, gamma, mean, rstd, dx, part,
                                         dparams, rows, d, tpr, blocks, s);
        case 2: return bwd_as<TX, TD, 2>(x, dy, gamma, mean, rstd, dx, part,
                                         dparams, rows, d, tpr, blocks, s);
        case 3: return bwd_as<TX, TD, 3>(x, dy, gamma, mean, rstd, dx, part,
                                         dparams, rows, d, tpr, blocks, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

// x: (rows, d) bf16, d = tpr * vpt * 8, tpr a power of two in [1, 256],
// vpt in [1, 4] forward and [1, 3] backward; every tensor contiguous and
// 16-byte aligned; rows >= 1.

// gamma, beta: (d,) f32; y: (rows, d) out, bf16 or, where y_f32, f32;
// mean, rstd: (rows,) f32 out.
int ln_rows_forward(int y_f32, const void* x, const void* gamma,
                    const void* beta, void* y, void* mean, void* rstd,
                    int rows, int d, int tpr, int vpt, float eps,
                    void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (y_f32) {
        return fwd_vpt<bf16, float>(vpt, x, gamma, beta, y, mean, rstd, rows,
                                    d, tpr, eps, s);
    }
    return fwd_vpt<bf16, bf16>(vpt, x, gamma, beta, y, mean, rstd, rows, d,
                               tpr, eps, s);
}

// dy: (rows, d) bf16 or, where dy_f32, f32; gamma: (d,) f32; mean, rstd:
// (rows,) f32 as the forward wrote them; dx: (rows, d) bf16 out; part:
// (blocks, 2, d) f32 scratch; dparams: (2, d) f32 out, dgamma then dbeta.
// blocks: the backward's grid.
int ln_rows_backward(int dy_f32, const void* x, const void* dy,
                     const void* gamma, const void* mean, const void* rstd,
                     void* dx, void* part, void* dparams, int rows, int d,
                     int tpr, int vpt, int blocks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dy_f32) {
        return bwd_vpt<bf16, float>(vpt, x, dy, gamma, mean, rstd, dx, part,
                                    dparams, rows, d, tpr, blocks, s);
    }
    return bwd_vpt<bf16, bf16>(vpt, x, dy, gamma, mean, rstd, dx, part,
                               dparams, rows, d, tpr, blocks, s);
}

}  // extern "C"
