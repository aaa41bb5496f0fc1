// Hopper (sm_90a) building blocks of the forward layer's wgmma kernels:
// TMA tensor maps and loads, mbarriers, wgmma shared-memory descriptors and
// the m64nNk16 bf16 products with fp32 accumulation.
//
// Layouts. Every operand tile in shared memory uses the 128-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64 bf16 (128 B),
// 8-row atoms of 1024 B, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8). A (activations, M x K) is K-major: one [rows][64] region per
// 64 columns of K. B (weights, K x N, row-major in device memory, so
// N-major) is read with the transpose flag: one [K rows][64] box per 64
// columns of N, loaded by TMA; the descriptor's leading offset steps from
// one 64-column box to the next, its stride offset from one 8-row group of
// K to the next.
//
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime library: it
// is looked up in the libcuda.so.1 the process already has loaded (dlsym),
// so the build links nothing beyond the runtime.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

#define TMA_BOX 64  // a box is 64 columns (128 B, the swizzle's width) x 64 rows
#define TMA_BOX_BYTES (TMA_BOX * TMA_BOX * 2)

// `layers` bf16 (rows, cols) matrices, row r of layer l at base + l
// layer_stride + r row_stride (elements; both multiples of 8), read in 64 x
// 64 boxes with the 128-byte swizzle; rows past the end read as zeros.
static int tensor_map_strided(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                              uint64_t layers, uint64_t row_stride, uint64_t layer_stride) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorSharedObjectInitFailed;
  // the encode is a driver call and needs a current context, which a thread
  // has only once a runtime call has bound it: torch runs the backward on its
  // own autograd thread, whose allocations may all come from the cache
  static thread_local bool bound = false;
  if (!bound) {
    LAUNCH((int)cudaFree(nullptr));
    bound = true;
  }
  const cuuint64_t dims[3] = {cols, rows, layers};
  const cuuint64_t strides[2] = {row_stride * 2, layer_stride * 2};
  const cuuint32_t box[3] = {TMA_BOX, TMA_BOX, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) return 0;
  fprintf(stderr, "vit2spn: cuTensorMapEncodeTiled: %d at %p, %llu x %llu x %llu, map at %p\n",
          (int)r, base, (unsigned long long)cols, (unsigned long long)rows,
          (unsigned long long)layers, (void*)map);
  return (int)cudaErrorInvalidValue;
}

// `layers` row-major bf16 (rows, cols) matrices one after another
static int tensor_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                      uint64_t layers) {
  return tensor_map_strided(map, base, cols, rows, layers, cols, cols * rows);
}

// ---------------------------------------------------------------------------
// Device: barriers, TMA, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity) : "memory");
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* b, int parity) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return r != 0;
}

// one 64 x 64 box at (column c0, row c1, layer c2) into `dst`, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` into `dst`, both 16-byte
// aligned, completing its bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one 64 x 64 box from `src` to (column c0, row c1, layer c2); rows past the
// tensor's end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes made visible to wgmma / TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the `n` threads of a named barrier (id >= 1; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// this warpgroup's registers a thread, lowered (a producer) or raised (the
// consumers) to N, a multiple of 8 in [24, 256]; every warp of the
// warpgroup executes it. ptxas allocates the code that follows within N
// (it reports the kernel's count at entry, the launch bound's).
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// byte offset of bf16 element (r, c) in a 128-byte-swizzled [rows][64] region
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

// ---------------------------------------------------------------------------
// A ring of stages in shared memory, filled by the producer warp's TMA loads
// in the order the consumers take them; a stage is free again once every
// consumer warp has released it.
// ---------------------------------------------------------------------------

struct Ring {
  uint64_t* full;   // count 1: the producer's expect_tx, then the bytes
  uint64_t* empty;  // count: the consumer warps
  uint8_t* base;
  int stage_bytes, stages, it;

  // producer: the next stage, once free, expecting `bytes`
  __device__ __forceinline__ uint8_t* fill(uint32_t bytes, uint64_t** bar) {
    const int s = it % stages;
    mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    ++it;
    *bar = &full[s];
    return base + s * stage_bytes;
  }
  // consumer: the next stage, once loaded; returns its index
  __device__ __forceinline__ int take() {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    ++it;
    return s;
  }
  __device__ __forceinline__ const uint8_t* at(int s) const { return base + s * stage_bytes; }
  // consumer: done with stage s (lane 0 speaks for its warp)
  __device__ __forceinline__ void release(int s, int lane) const {
    if (lane == 0) mbar_arrive(&empty[s]);
  }
};

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages,
                                          int consumer_warps) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], consumer_warps);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at `p` (1024-byte-aligned atoms)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// A: 64 rows of a K-major region from row `p`, K step 16 at byte 32 k
__device__ __forceinline__ uint64_t a_desc(const void* p) { return sw128_desc(p, 16, 1024); }
// B: 16 K rows from `p` of N-major boxes, `box_bytes` apart along N
__device__ __forceinline__ uint64_t b_desc(const void* p, uint32_t box_bytes) {
  return sw128_desc(p, box_bytes, 1024);
}
// B K-major (TB = 0): rows of 64 K (128 B) per N, N rows from `p` in 8-row
// groups 1024 B apart (64-row boxes back to back), K step 16 at byte 32 k
__device__ __forceinline__ uint64_t k_desc(const void* p) { return sw128_desc(p, 16, 1024); }
// A M-major (TA = 1): 16 K rows from `p` of one [K rows][64 M] box, as
// b_desc reads B
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return sw128_desc(p, TMA_BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[OFF ..] (64 x N fp32, the warpgroup's fragment: register OFF + i of
// thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2) = A B (+ d when acc != 0). TA = 0: A
// K-major (a_desc); TA = 1: A M-major, [K rows][64 M] (mn_desc). TB = 1: B
// N-major, [K rows][64 N] boxes (b_desc); TB = 0: B K-major, [N rows][64 K]
// (k_desc), the product with a row-major weight's transpose. A 64-column
// box of a wider fragment is 32 registers at OFF = 32 x (its first column /
// 64).
template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 8 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<32> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 16 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<48> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 24 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
          "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<64> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 32 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
          "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
          "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<128> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 64 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
          "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
          "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
          "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
          "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
          "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
          "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<192> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 96 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
          "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
          "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
          "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
          "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
          "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
          "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]),
          "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),
          "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]),
          "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]),
          "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]),
          "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};
template <> struct Wgmma<256> {
  template <int OFF = 0, int TA = 0, int TB = 1, int R>
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t da, uint64_t db, int acc) {
    static_assert(OFF + 128 <= R, "the product's registers lie outside d");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
          "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
          "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
          "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
          "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
          "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
          "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
          "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
          "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]),
          "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),
          "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]),
          "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]),
          "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]),
          "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95]),
          "+f"(d[OFF + 96]), "+f"(d[OFF + 97]), "+f"(d[OFF + 98]), "+f"(d[OFF + 99]), "+f"(d[OFF + 100]), "+f"(d[OFF + 101]),
          "+f"(d[OFF + 102]), "+f"(d[OFF + 103]), "+f"(d[OFF + 104]), "+f"(d[OFF + 105]), "+f"(d[OFF + 106]), "+f"(d[OFF + 107]),
          "+f"(d[OFF + 108]), "+f"(d[OFF + 109]), "+f"(d[OFF + 110]), "+f"(d[OFF + 111]), "+f"(d[OFF + 112]), "+f"(d[OFF + 113]),
          "+f"(d[OFF + 114]), "+f"(d[OFF + 115]), "+f"(d[OFF + 116]), "+f"(d[OFF + 117]), "+f"(d[OFF + 118]), "+f"(d[OFF + 119]),
          "+f"(d[OFF + 120]), "+f"(d[OFF + 121]), "+f"(d[OFF + 122]), "+f"(d[OFF + 123]), "+f"(d[OFF + 124]), "+f"(d[OFF + 125]),
          "+f"(d[OFF + 126]), "+f"(d[OFF + 127])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

// d[OFF ..] (64 x N fp32) = A B (+ d when acc != 0) for any N = 16 j <= 256
// with B K-major (k_desc): one product of the widest of 64 .. 256 columns
// and, for N % 64, one of 16, 32 or 48 columns from B's row N - N % 64
template <int N, int OFF = 0, int R>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[R], uint64_t da, const uint8_t* b,
                                             int acc) {
  static_assert(N % 16 == 0 && N >= 16 && N <= 256, "N must be a multiple of 16 up to 256");
  constexpr int WIDE = N / 64 * 64, REST = N % 64;
  if constexpr (WIDE > 0) Wgmma<WIDE>::template mma<OFF, 0, 0>(d, da, k_desc(b), acc);
  if constexpr (REST > 0)
    Wgmma<REST>::template mma<OFF + WIDE / 2, 0, 0>(d, da, k_desc(b + WIDE * 128), acc);
}

// d (64 x 64 fp32, the fragment above) = A B (+ d when acc != 0) with A from
// registers: a[0..3] of thread t are A's bf16 pairs (row r, k 2 (t % 4)),
// (r + 8, same k), (r, k + 8), (r + 8, k + 8) with r = 16 (t / 32) + (t % 32)
// / 4, the m16n8k16 A fragment; B N-major (b_desc). The registers are read
// asynchronously: keep them unchanged until the product has been waited for.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// keep the compiler from reusing a register operand's registers before the
// asynchronous products that read it have been waited for
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3])::"memory");
}
