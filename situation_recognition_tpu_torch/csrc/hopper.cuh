// Hopper (sm_90a) building blocks shared by this package's wgmma + TMA
// kernels (vit_block.cu, ggnn_folded.cu, ggnn_folded_bwd.cu and their
// GEMM in ggnn_gemm.cuh): mbarriers, TMA loads and stores
// of 2-D tiles in the 128-byte swizzle, wgmma from shared-memory
// descriptors, and the host side of the tensor maps.
//
// Every tile here is K-major with rows of BK = 64 bf16 (128 bytes, one
// swizzle row): a TMA box of 64 columns by up to 256 rows lands as 8-row
// groups 1024 bytes apart, chunk j of row r at chunk j ^ (r % 8), which is
// what `sw128_desc` describes to wgmma.  `_build.py` hashes this header
// with every source that includes it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;   // depth of a ring stage: one 128-byte row of bf16

// ------------------------------------------------ mbarrier, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// the mbarriers just initialised by this thread, visible to the block and
// to the TMA
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the box at (x = column, y = row) of the map into shared memory at dst,
// completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
           "r"(bar)
        : "memory");
}

// the box at shared memory src into the map at (x = column, y = row);
// rows and columns past the map's edge are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
        "[%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(x), "r"(y)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have written device memory
__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of the 128 threads of one warpgroup (ids 1, 2; 0 is the block's)
__device__ __forceinline__ void warpgroup_sync(int id) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v));
}

// registers a thread of this warpgroup holds from here on: the producer
// gives up what the consumers take (both counts multiples of 8)
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading byte offset 16 (unused by this layout),
// stride byte offset 1024 (from one 8-row group to the next), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(1) << 16)
           | (static_cast<uint64_t>(1024 >> 4) << 32)
           | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N f32, the warpgroup's fragment: lane l of warp w holds rows
// 16w + l/4 (+8), columns 8j + 2(l%4) + {0, 1} in d[4j .. 4j+3]) +=
// A (64 x 16) @ B (N x 16)^T, both bf16 from shared memory through the
// descriptors a and b.
#define D8(x, i)                                                          \
    "+f"(x[i]), "+f"(x[i + 1]), "+f"(x[i + 2]), "+f"(x[i + 3]),           \
        "+f"(x[i + 4]), "+f"(x[i + 5]), "+f"(x[i + 6]), "+f"(x[i + 7])

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24),
          D8(d, 32), D8(d, 40), D8(d, 48), D8(d, 56),
          D8(d, 64), D8(d, 72), D8(d, 80), D8(d, 88),
          D8(d, 96), D8(d, 104), D8(d, 112), D8(d, 120)
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24),
          D8(d, 32), D8(d, 40), D8(d, 48), D8(d, 56)
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24)
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                           uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : D8(d, 0), D8(d, 8)
        : "l"(a), "l"(b), "r"(1));
}

#undef D8

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b) {
    if constexpr (N == 256)
        wgmma_n256(d, a, b);
    else if constexpr (N == 128)
        wgmma_n128(d, a, b);
    else if constexpr (N == 64)
        wgmma_n64(d, a, b);
    else {
        static_assert(N == 32, "wgmma width");
        wgmma_n32(d, a, b);
    }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime (null if absent),
// so that a library links no libcuda
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// the tensor map of a (rows, K) bf16 row-major matrix, rows ld elements
// apart (K when ld is 0), read in boxes of BK columns by box_rows rows,
// 128-byte swizzled, zero past the edges
bool tensor_map(CUtensorMap* map, const void* base, int rows, int K,
                int box_rows, int ld = 0) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {
        static_cast<cuuint64_t>(ld ? ld : K) * sizeof(bf16)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(base), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// streaming multiprocessors of the current device (0 if unknown)
int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return 0;
    return n;
}

}  // namespace
