// Hopper building blocks shared by the sm_90a tensor-core kernels
// (flash_attention_sm90.cu, mlstm_chunk_sm90.cu, mlstm_chunk_bwd.cu):
// mbarriers, TMA copies and their tensor maps, a ring of TMA stages,
// `wgmma` descriptors and products, the split of float32 values into bf16
// terms and the accumulator fragment layout.
// Included once per source, inside no namespace; every name is internal
// to the including library.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A tile of R rows x HD bf16 columns lies in shared memory as HD / PW
// panels of R rows x PW columns, each row SW bytes, swizzled over SW-byte
// rows: the layout TMA writes and `wgmma` reads back through a descriptor
// of the same swizzle.  PW is the widest of 64, 32 and 16 columns that
// divides HD: two panels of 64 at hd 128, one of 32 at hd 32, five of 16
// (32-byte rows) at hd 80.
template <int HD>
struct Geo {
  static constexpr int PW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int SW = PW * 2;
  static constexpr uint64_t LAYOUT =            // 128 B, 64 B or 32 B
      SW == 128 ? 1 : SW == 64 ? 2 : 3;
  __host__ __device__ static constexpr uint32_t bytes(int rows) {
    return rows * HD * 2;
  }
};

// ---- shared memory, barriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed.  A wait
// that outlasts 10 s traps, so a lost copy or a miscounted barrier ends
// the launch with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map,
                                       int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand: rows row0.. of a tile of R rows, the 16 columns of
// k-step kk (the product's K dim runs along the tile's columns).
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int row0,
                                           int kk) {
  using G = Geo<HD>;
  const int col = kk * 16;
  return make_desc(tile + (col / G::PW) * R * G::SW + row0 * G::SW +
                       (col % G::PW) * 2,
                   16, 8 * G::SW, G::LAYOUT);
}

// MN-major operand: rows 16kk..16kk+15 of a tile of R rows (the product's
// K dim runs along the tile's rows), all HD columns; LBO steps panels.
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int kk) {
  using G = Geo<HD>;
  return make_desc(tile + kk * 16 * G::SW, R * G::SW, 8 * G::SW, G::LAYOUT);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed product groups are still running.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
#define D32(i) D16(i), D16(i + 16)
#define D64(i) D32(i), D32(i + 32)
#define D40(i) D32(i), D4(i + 32), D4(i + 36)

// d (64 x N, this thread's N/2 floats) = A B (+ d if acc): A 64 x 16 and
// B 16 x N from shared memory, K-major, or MN-major where TA / TB is 1
// (read through the descriptor's transpose bit).
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : D16(0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : D32(0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
        "1, %67, %68;\n}\n"
        : D64(0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
}

// d += A B: A 64 x 16 from registers (4 x 2 bf16), B 16 x N MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, "
      "%43}, %44, p, 1, 1, 1;\n}\n"
      : D40(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D4
#undef D16
#undef D32
#undef D64
#undef D40

// ---- registers and fragments ----------------------------------------------

// The four lanes of a quad hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator x (64 x N, N/2 floats a thread) as T bf16 terms, each
// the A operands of the next product (N/16 k-steps of 4 registers): term 0
// = bf16(x), term t = bf16 of what terms 0..t-1 left (each remainder is
// exact in float32); pairs of neighbouring columns packed low word first.
template <int N, int T>
__device__ __forceinline__ void split(const float (&x)[N / 2],
                                      uint32_t (&terms)[T][N / 4]) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    float r0 = x[2 * g], r1 = x[2 * g + 1];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      uint32_t b;  // r1 rounded into the high half, r0 into the low
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(b) : "f"(r1), "f"(r0));
      terms[t][g] = b;
      r0 -= __uint_as_float(b << 16);
      r1 -= __uint_as_float(b & 0xffff0000u);
    }
  }
}

// Where a thread's accumulator values sit: element e of a 64 x N fragment
// is row (16 * warp + lane / 4) + 8 * rr(e), column col(e).
__device__ __forceinline__ int frag_rr(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int frag_col(int e, int lane) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

// Orders this thread's shared-memory accesses before the copies it issues.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- the TMA ring -----------------------------------------------------------

// A ring of S shared-memory stages filled by TMA: the 1024-aligned start
// of the tiles (for the swizzle), then one mbarrier per stage and the
// count of warps done with each stage.
template <int S, int kWarps>
struct Ring {
  uint32_t base, bars;
  unsigned* done;
  __device__ Ring(unsigned char* raw, uint32_t tile_bytes) {
    const uint32_t s = smem_u32(raw);
    base = (s + 1023) & ~1023u;
    bars = base + tile_bytes;
    done = reinterpret_cast<unsigned*>(raw + (base - s) + tile_bytes + 8 * S);
    if (threadIdx.x == 0) {
      for (int b = 0; b < S; ++b) bar_init(bars + 8 * b, 1);
      for (int b = 0; b < S; ++b) done[b] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  __device__ uint32_t full(int st) const { return bars + 8 * st; }
  // Lane 0 of each warp, once its products on stage st are done: true for
  // the last of the block's warps, which then refills the stage.
  __device__ bool release(int st) {
    return atomicAdd(done + st, 1u) % kWarps == kWarps - 1;
  }
  static constexpr size_t slack() { return 1024 + 12 * S; }
};

// ---- tensor maps ----------------------------------------------------------

// Error codes past CUDA's own: the tensor-map encoder was not found, or
// it refused a map (kMapError + its CUresult).
constexpr int kNoEncoder = 9000;
constexpr int kMapError = 10000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}


// The encoder needs a context current on the calling thread.  A thread
// whose first CUDA work is a tensor map has none: autograd runs a backward
// on a thread of its own, and PyTorch sets that thread's device only when
// it differs from the runtime's current one.  cudaSetDevice to the
// runtime's current device makes that device's primary context current, as
// a kernel launch would.
int bind_context() {
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  return (int)cudaSetDevice(dev);
}

// A row-major (rows, cols) bf16 matrix, cols a multiple of 64, in boxes of
// box_rows rows x 64 columns (128-byte rows, 128-byte swizzle).
int map_bf16_2d(CUtensorMap* map, const void* p, long long rows, int cols,
                int box_rows) {
  if (int e = bind_context()) return e;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
