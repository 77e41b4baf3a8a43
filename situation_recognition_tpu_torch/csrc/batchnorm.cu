// Train-mode BatchNorm of the frozen ResNet, with the ReLU and the residual
// add that follow it, for NVIDIA Hopper (sm_90a): two kernels a layer.
//
// Replaces no TPU kernel: the JAX package leaves BN to XLA, which fuses the
// statistics into the convolution's consumers on the TPU.  On the card the
// port ran ATen's train-mode BN (a channels-last statistics kernel and a
// transform kernel), then 13 small kernels of running-statistics update,
// the residual add and ReLU as passes of their own: 17 launches and five
// full reads or writes of the activation a layer where three suffice.
//
//   batchnorm_stats_kernel   per channel of an (N, C, H, W) tensor, over
//                            its rows = N·H·W: the mean and the biased
//                            variance in f32 (Welford within a thread,
//                            Chan's merge across threads and blocks), in
//                            one read of x.  The last block of each column
//                            of blocks writes mean and invstd and updates
//                            the running statistics; the last of column 0
//                            adds 1 to num_batches_tracked.
//   batchnorm_apply_kernel   y = relu?(round(w (x - mean) invstd + b)
//                            + residual?), in place where out == x.
//
// What bounds it on this card: bytes.  A layer moves its input twice, its
// output once and a block's residual once; per ResNet-152 step at batch
// 1536 and 224² that is 248 GB, 74 ms at 3.35 TB/s, against 4 FLOP an
// element.  So each thread moves 16 bytes a load (8 bf16 or 4 f32 of
// consecutive channels), keeps 4 loads in flight, and a block of 256
// threads covers TX such vectors of a row by 256/TX rows.  The statistics
// grid is one wave (4 blocks an SM, `__launch_bounds__`), each thread
// striding over rows; the block's partials go to scratch, and the last
// block of a column, found by an integer ticket after a fence, merges them
// in index order: two runs on one card are bit-equal, and no float atomics
// are used.  The ticket is reset by that block for the next launch.  That
// merge is one SM reading gy x TX x V partials through its own L2 port
// while the card idles, so the statistics take narrower columns than the
// apply (TX = 8 for C = 256 bf16: a 128-byte line of a row, 4 columns).
//
// Rounding is where ATen's composition rounds: the statistics are f32
// (invstd from the f32 variance as ATen's InvStd takes it, in double), the
// normalised value is ATen's channels-last transform, w * (x - mean) *
// invstd + b in f32, rounded to x's type; the residual is added in f32 and
// rounded; ReLU last.  With equal statistics the output is bit-equal to
// native_batch_norm + add + relu on the card.  The running statistics take
// (1 - momentum) * running + momentum * batch, products and sum each
// rounded in f32 as the tensor ops round them, the batch's biased variance.
//
// The vector path takes channels-last tensors with C % (16 / sizeof(T)) ==
// 0, 16-byte aligned; any other C runs the same kernels one channel a
// thread.  A plain contiguous NCHW tensor ("planar": row r = n·HW + s of
// channel c at (n C + c) HW + s) runs them one channel a block column,
// the 256 threads of a block along the rows, so that a warp reads 32
// consecutive elements of a plane.  The port's convolutions return
// channels-last on the card; the planar layout is there for a model whose
// convolutions give NCHW.  The wrapper (ops/batchnorm.py) chooses the
// path and the grids and checks every operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kStatsBlocksPerSm = 4;

// ------------------------------------------------------- element access

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
    return __bfloat162float(v);
}

// v rounded to T and back: the value a T tensor would hold
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// V consecutive elements of T as loaded: one uint4 where V * sizeof(T)
// == 16, held as such until each element is read as f32 (bf16 widens by
// a shift), so that the loads in flight take 4 registers each.
template <typename T, int V>
struct Packed {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    uint4 r;
    __device__ __forceinline__ void load(const T* p) {
        r = *reinterpret_cast<const uint4*>(p);
    }
    __device__ __forceinline__ float get(int i) const {
        const int k = sizeof(T) == 4 ? i : i / 2;
        const unsigned w = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
        if constexpr (sizeof(T) == 4) return __uint_as_float(w);
        return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
    }
};

template <typename T>
struct Packed<T, 1> {
    T v;
    __device__ __forceinline__ void load(const T* p) { v = *p; }
    __device__ __forceinline__ float get(int) const { return to_float(v); }
};

// V values that T holds exactly (round_to's), stored as T.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
    if constexpr (V == 1) {
        if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float*>(p) = f[0];
        } else {
            *p = __float2bfloat16_rn(f[0]);
        }
    } else {
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if constexpr (sizeof(T) == 4) {
                w[i] = __float_as_uint(f[i]);
            } else {
                w[i] = (__float_as_uint(f[2 * i]) >> 16)
                       | (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
            }
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// Offset of row r, channel c: channels-last (rows, C), or planar (N, C, HW)
template <bool PLANAR>
__device__ __forceinline__ long long offset(long long r, int c, int channels,
                                            int hw) {
    if constexpr (PLANAR) {
        return (r / hw * channels + c) * hw + r % hw;
    } else {
        return r * channels + c;
    }
}

// ------------------------------------------------------------ statistics

// V partials of f32 at p (16-byte aligned where V % 4 == 0) from L2: they
// were written by other blocks of the launch
template <int V>
__device__ __forceinline__ void load_partials(const float* p,
                                              float (&f)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
            const float4 q = __ldcg(reinterpret_cast<const float4*>(p) + j);
            f[4 * j] = q.x;
            f[4 * j + 1] = q.y;
            f[4 * j + 2] = q.z;
            f[4 * j + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = __ldcg(p + i);
    }
}

// (n, mean, m2) += (nb, mean_b, m2_b) over V channels that share their
// counts: Chan's merge
template <int V>
__device__ __forceinline__ void merge(int& n, float (&mean)[V],
                                      float (&m2)[V], int nb,
                                      const float (&mean_b)[V],
                                      const float (&m2_b)[V]) {
    if (nb == 0) return;
    if (n == 0) {
        n = nb;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            mean[i] = mean_b[i];
            m2[i] = m2_b[i];
        }
        return;
    }
    const int total = n + nb;
    const float share = static_cast<float>(nb) / static_cast<float>(total);
    const float cross = static_cast<float>(n) * share;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const float delta = mean_b[i] - mean[i];
        mean[i] += delta * share;
        m2[i] += m2_b[i] + delta * delta * cross;
    }
    n = total;
}

// Merges the block's column of threads (same threadIdx.x) into row 0, in
// a fixed tree: s_mean / s_m2 hold ty-major (ty, tx, V) states, s_n one
// count a thread.  blockDim.y is a power of two.
template <int V>
__device__ __forceinline__ void merge_column(int& n, float (&mean)[V],
                                             float (&m2)[V], float* s_mean,
                                             float* s_m2, int* s_n) {
    const int TX = blockDim.x;
    const int me = threadIdx.y * TX + threadIdx.x;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        s_mean[me * V + i] = mean[i];
        s_m2[me * V + i] = m2[i];
    }
    s_n[me] = n;
    __syncthreads();
    for (int s = blockDim.y / 2; s > 0; s >>= 1) {
        if (threadIdx.y < s) {
            const int other = me + s * TX;
            float mean_b[V], m2_b[V];
#pragma unroll
            for (int i = 0; i < V; ++i) {
                mean_b[i] = s_mean[other * V + i];
                m2_b[i] = s_m2[other * V + i];
            }
            merge<V>(n, mean, m2, s_n[other], mean_b, m2_b);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                s_mean[me * V + i] = mean[i];
                s_m2[me * V + i] = m2[i];
            }
            s_n[me] = n;
        }
        __syncthreads();
    }
}

// x: (rows, C) channels-last, or planar (TX = 1, V = 1) with hw elements
// a plane; the grid is (gx, gy) blocks of (TX, TY) threads, TX * TY = 256;
// thread (tx, ty) of block (bx, by) owns channels [(bx TX + tx) V, + V)
// and rows by TY + ty, + gy TY, ...
// part_mean, part_m2: (gy, C) f32; part_n: (gx, gy) int; tickets: (gx,)
// zero between launches.  stats: (2, C) f32, mean then invstd.
template <typename T, int V, bool PLANAR>
__global__ void __launch_bounds__(kThreads, kStatsBlocksPerSm)
batchnorm_stats_kernel(const T* __restrict__ x, int rows, int channels,
                       int hw,
                       float* __restrict__ part_mean,
                       float* __restrict__ part_m2, int* __restrict__ part_n,
                       unsigned* __restrict__ tickets,
                       float* __restrict__ stats,
                       float* __restrict__ running_mean,
                       float* __restrict__ running_var,
                       long long* __restrict__ num_batches, float keep,
                       float momentum, double eps) {
    __shared__ float s_mean[kThreads * V];
    __shared__ float s_m2[kThreads * V];
    __shared__ int s_n[kThreads];
    __shared__ bool s_last;

    const int cvec = channels / V;
    const int cv = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = cv < cvec;
    const int c0 = cv * V;
    const long long step = static_cast<long long>(gridDim.y) * blockDim.y;

    int n = 0;
    float mean[V], m2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;

    if (live) {
        for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y
                           + threadIdx.y;
             r < rows; r += step * kUnroll) {
            Packed<T, V> v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const long long rr = r + u * step;
                if (rr < rows) {
                    v[u].load(x + offset<PLANAR>(rr, c0, channels, hw));
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (r + u * step < rows) {
                    ++n;
                    const float inv = 1.f / static_cast<float>(n);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float xi = v[u].get(i);
                        const float d = xi - mean[i];
                        mean[i] += d * inv;
                        m2[i] += d * (xi - mean[i]);
                    }
                }
            }
        }
    }
    merge_column<V>(n, mean, m2, s_mean, s_m2, s_n);

    if (threadIdx.y == 0) {
        if (live) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
                part_mean[static_cast<long long>(blockIdx.y) * channels + c0
                          + i] = mean[i];
                part_m2[static_cast<long long>(blockIdx.y) * channels + c0
                        + i] = m2[i];
            }
        }
        if (threadIdx.x == 0) part_n[blockIdx.x * gridDim.y + blockIdx.y] = n;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        s_last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    // the column's last block: every partial, in index order
    n = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
    if (live) {
        for (int y = threadIdx.y; y < gridDim.y; y += blockDim.y) {
            const long long at = static_cast<long long>(y) * channels + c0;
            float mean_b[V], m2_b[V];
            load_partials<V>(part_mean + at, mean_b);
            load_partials<V>(part_m2 + at, m2_b);
            merge<V>(n, mean, m2,
                     __ldcg(part_n + blockIdx.x * gridDim.y + y), mean_b,
                     m2_b);
        }
    }
    merge_column<V>(n, mean, m2, s_mean, s_m2, s_n);
    if (threadIdx.y == 0 && live) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const int c = c0 + i;
            const float var = m2[i] / static_cast<float>(n);
            float invstd = 0.f;
            if (var != 0.f || eps != 0.0) {
                invstd = static_cast<float>(
                    1.0 / sqrt(static_cast<double>(var) + eps));
            }
            stats[c] = mean[i];
            stats[channels + c] = invstd;
            running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]),
                                        __fmul_rn(momentum, mean[i]));
            running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                                       __fmul_rn(momentum, var));
        }
    }
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        tickets[blockIdx.x] = 0;
        if (blockIdx.x == 0) *num_batches += 1;
    }
}

// ----------------------------------------------------------------- apply

// The statistics grid's thread layout; the grid strides over rows.  out
// may be x (each element is read, then written, by one thread), so x and
// out are not __restrict__.
template <typename T, int V, bool RES, bool RELU, bool PLANAR>
__global__ void __launch_bounds__(kThreads)
batchnorm_apply_kernel(const T* x, const T* __restrict__ residual, T* out,
                       int rows, int channels, int hw,
                       const float* __restrict__ stats,
                       const float* __restrict__ weight,
                       const float* __restrict__ bias) {
    const int cv = blockIdx.x * blockDim.x + threadIdx.x;
    if (cv >= channels / V) return;
    const int c0 = cv * V;
    float m[V], inv[V], w[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        m[i] = stats[c0 + i];
        inv[i] = stats[channels + c0 + i];
        w[i] = weight[c0 + i];
        b[i] = bias[c0 + i];
    }
    const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
    for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y
                       + threadIdx.y;
         r < rows; r += step * kUnroll) {
        Packed<T, V> v[kUnroll], res[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long rr = r + u * step;
            if (rr < rows) {
                const long long at = offset<PLANAR>(rr, c0, channels, hw);
                v[u].load(x + at);
                if constexpr (RES) res[u].load(residual + at);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long rr = r + u * step;
            if (rr < rows) {
                float y[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    // ATen's channels-last transform, term for term
                    float t = round_to<T>(
                        w[i] * (v[u].get(i) - m[i]) * inv[i] + b[i]);
                    if constexpr (RES) t = round_to<T>(t + res[u].get(i));
                    if constexpr (RELU) t = t < 0.f ? 0.f : t;
                    y[i] = t;
                }
                store_vec<T, V>(out + offset<PLANAR>(rr, c0, channels, hw),
                                y);
            }
        }
    }
}

// -------------------------------------------------------------- launches

template <typename T, int V, bool PLANAR>
static int launch_stats(const void* x, int rows, int channels, int hw,
                        int tx, int gy, void* scratch, void* tickets,
                        void* stats,
                        void* running_mean, void* running_var,
                        void* num_batches, float keep, float momentum,
                        double eps, cudaStream_t stream) {
    const int ty = kThreads / tx;
    const int gx = (channels / V + tx - 1) / tx;
    float* part_mean = static_cast<float*>(scratch);
    float* part_m2 = part_mean + static_cast<long long>(gy) * channels;
    int* part_n = reinterpret_cast<int*>(
        part_m2 + static_cast<long long>(gy) * channels);
    batchnorm_stats_kernel<T, V, PLANAR>
        <<<dim3(gx, gy), dim3(tx, ty), 0, stream>>>(
        static_cast<const T*>(x), rows, channels, hw, part_mean, part_m2,
        part_n,
        static_cast<unsigned*>(tickets), static_cast<float*>(stats),
        static_cast<float*>(running_mean), static_cast<float*>(running_var),
        static_cast<long long*>(num_batches), keep, momentum, eps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool PLANAR, bool RES, bool RELU>
static int launch_apply_as(const void* x, const void* residual, void* out,
                           int rows, int channels, int hw, int tx, int gy,
                           const void* stats, const void* weight,
                           const void* bias, cudaStream_t stream) {
    const int ty = kThreads / tx;
    const int gx = (channels / V + tx - 1) / tx;
    batchnorm_apply_kernel<T, V, RES, RELU, PLANAR>
        <<<dim3(gx, gy), dim3(tx, ty), 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(residual),
            static_cast<T*>(out), rows, channels, hw,
            static_cast<const float*>(stats),
            static_cast<const float*>(weight),
            static_cast<const float*>(bias));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool PLANAR>
static int launch_apply(const void* x, const void* residual, void* out,
                        int rows, int channels, int hw, int tx, int gy,
                        const void* stats, const void* weight,
                        const void* bias, int relu, cudaStream_t stream) {
    if (residual != nullptr) {
        return relu ? launch_apply_as<T, V, PLANAR, true, true>(
                          x, residual, out, rows, channels, hw, tx, gy,
                          stats, weight, bias, stream)
                    : launch_apply_as<T, V, PLANAR, true, false>(
                          x, residual, out, rows, channels, hw, tx, gy,
                          stats, weight, bias, stream);
    }
    return relu ? launch_apply_as<T, V, PLANAR, false, true>(
                      x, residual, out, rows, channels, hw, tx, gy, stats,
                      weight, bias, stream)
                : launch_apply_as<T, V, PLANAR, false, false>(
                      x, residual, out, rows, channels, hw, tx, gy, stats,
                      weight, bias, stream);
}

// The instantiation for a type and a layout: 0 one channel a thread, 1
// the vector path, 2 planar
template <typename T>
static int stats_as(int layout, const void* x, int rows, int channels,
                    int hw, int tx, int gy, void* scratch, void* tickets,
                    void* stats, void* running_mean, void* running_var,
                    void* num_batches, float keep, float momentum,
                    double eps, cudaStream_t s) {
    constexpr int kVec = 16 / sizeof(T);
    switch (layout) {
        case 0:
            return launch_stats<T, 1, false>(
                x, rows, channels, hw, tx, gy, scratch, tickets, stats,
                running_mean, running_var, num_batches, keep, momentum, eps,
                s);
        case 1:
            return launch_stats<T, kVec, false>(
                x, rows, channels, hw, tx, gy, scratch, tickets, stats,
                running_mean, running_var, num_batches, keep, momentum, eps,
                s);
        case 2:
            return launch_stats<T, 1, true>(
                x, rows, channels, hw, tx, gy, scratch, tickets, stats,
                running_mean, running_var, num_batches, keep, momentum, eps,
                s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int apply_as(int layout, const void* x, const void* residual,
                    void* out, int rows, int channels, int hw, int tx,
                    int gy, const void* stats, const void* weight,
                    const void* bias, int relu, cudaStream_t s) {
    constexpr int kVec = 16 / sizeof(T);
    switch (layout) {
        case 0:
            return launch_apply<T, 1, false>(x, residual, out, rows,
                                             channels, hw, tx, gy, stats,
                                             weight, bias, relu, s);
        case 1:
            return launch_apply<T, kVec, false>(x, residual, out, rows,
                                                channels, hw, tx, gy, stats,
                                                weight, bias, relu, s);
        case 2:
            return launch_apply<T, 1, true>(x, residual, out, rows,
                                            channels, hw, tx, gy, stats,
                                            weight, bias, relu, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

// dtype: 0 f32, 1 bf16.  layout: 0 channels-last one channel a thread, 1
// channels-last 16 / sizeof(T) channels a thread (C a multiple of that,
// the tensors 16-byte aligned), 2 planar (NCHW, tx = 1).  hw: H·W, the
// elements of a plane.  tx: threads of a block along the channels (a
// power of two, at most 32); gy: blocks along the rows.

// x: (rows, C).  scratch: 2 gy C f32 then gx gy int32, gx = ceil(C / V /
// tx).  tickets: gx uint32, zero (and left zero).  stats: (2, C) f32 out,
// mean then invstd.  running_mean, running_var: (C,) f32, num_batches: one
// int64, updated.  keep = 1 - momentum.
int batchnorm_stats(int dtype, int layout, const void* x, int rows,
                    int channels, int hw, int tx, int gy, void* scratch,
                    void* tickets, void* stats, void* running_mean,
                    void* running_var, void* num_batches, float keep,
                    float momentum, double eps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        return stats_as<bf16>(layout, x, rows, channels, hw, tx, gy, scratch,
                              tickets, stats, running_mean, running_var,
                              num_batches, keep, momentum, eps, s);
    }
    if (dtype == 0) {
        return stats_as<float>(layout, x, rows, channels, hw, tx, gy,
                               scratch, tickets, stats, running_mean,
                               running_var, num_batches, keep, momentum, eps,
                               s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// x, out (may be x), residual (or null): (rows, C) of one type and layout.
// stats: (2, C) f32, mean then invstd; weight, bias: (C,) f32.  relu: 0 or
// 1.
int batchnorm_apply(int dtype, int layout, const void* x,
                    const void* residual, void* out, int rows, int channels,
                    int hw, int tx, int gy, const void* stats,
                    const void* weight, const void* bias, int relu,
                    void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        return apply_as<bf16>(layout, x, residual, out, rows, channels, hw,
                              tx, gy, stats, weight, bias, relu, s);
    }
    if (dtype == 0) {
        return apply_as<float>(layout, x, residual, out, rows, channels, hw,
                               tx, gy, stats, weight, bias, relu, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
