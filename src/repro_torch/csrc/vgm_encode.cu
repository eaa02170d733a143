// VGM mode-specific normalization (CTGAN encode), sm_90a: the table-wide
// kernel and the single-column one, one tile kernel for both.
//
// The table-wide entry replaces the Pallas kernel `vgm_encode_table` of
// the JAX package (src/repro/kernels/vgm_encode.py:137, body
// `_mode_normalize` :63); the single-column entry replaces `vgm_encode`
// (:89, pallas_call :103), which the per-column `encode_loop` oracle
// reaches: the Q = 1 case, writing alpha (N,) and beta (N, K) apart.  For
// every (row, continuous column) it scores the column's Kmax Gaussian modes
// (log-pdf + log mixture weight + a pre-drawn Gumbel), takes the first
// maximum, and writes the column's slot [alpha, beta_0 .. beta_{Kmax-1}]:
// alpha = clip((x - mu) / (4 sd), -1, 1) and beta the one-hot of the mode.
//
// What bounds it: bytes.  Per cell it reads x (4 B) and Kmax Gumbels and
// writes 1+Kmax floats, against ~9 Kmax flops, far below the card's
// ~20 flop/B balance point.  A thread per cell reading its own Gumbels and
// writing its own slot moves them at a 4 (1+Kmax)-byte stride: a store
// instruction touches 32 sectors for 128 useful bytes.  Design: a block
// takes a tile of consecutive rows, all columns at once, so the tile's x
// values, Gumbels and slots are each one contiguous stretch of device
// memory.
//   1. stage: the tile's x and Gumbel stretches go to shared memory as
//      16-byte `cp.async` copies, with 4-byte copies for the head before
//      the first 16-byte boundary and the tail after the last one (any
//      base: a caller's view need not be aligned); the columns' (mean,
//      std, log std, log weight) are staged while the copies fly, one
//      float4 per (mode, column), mode-major so neighbouring columns fall
//      in neighbouring banks;
//   2. score: a thread per cell reads x and its Gumbels from shared memory
//      and writes its slot into a shared-memory output tile, at the offset
//      within 16 bytes that the slot has in device memory;
//   3. store: the block copies the output tile to device memory as 16-byte
//      loads and stores (scalar head and tail).
// A tile holds about as many cells as the block has threads (at most 256),
// so each thread scores one cell: on the card that beat fewer, larger
// tiles, and blocks that walk several tiles with the params staged once.
// The launch plan (rows per tile, threads, shared-memory bytes) is
// computed by `encode_plan` in kernels/vgm_encode.py; the kernel follows
// it.
//
// Numerics: built with --fmad=false and no fast math, so every product and
// sum rounds as in the plain PyTorch version (kernels/ref.py) and logf is
// IEEE-accurate; divisions are IEEE divisions.  Ties go to the first mode
// (strict >), as jnp.argmax.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 0.5 * log(2 pi), rounded to float as the plain version's scalar is.
constexpr float kHalfLog2Pi = 0.9189385332046727f;
// threads a block may have (`MAX_THREADS` in kernels/vgm_encode.py)
constexpr int kMaxThreads = 256;
// the mode count the kernel is unrolled for: `max_modes`' default
// (repro_torch.tabular.encoders.ColumnSpec), so every Kmax of a table fitted
// with the defaults
constexpr int kModesDefault = 10;

__host__ __device__ constexpr long long round_up4(long long v) {
  return (v + 3) & ~3LL;
}

// Floats of a region that stages n floats at any offset within 16 bytes
// (up to 3 floats of lead, see `stage_async`).
__host__ __device__ inline long long stage_floats(long long n) {
  return round_up4(n + 3);
}

// Floats of a tile buffer of `cells` cells of k modes: an x and a Gumbel
// stage, or for the output the alphas and the betas of the column entry;
// the table's slots, cells * (1+k) floats at a lead, fit in it too.
__host__ __device__ inline long long buffer_floats(long long cells, int k) {
  return stage_floats(cells) + stage_floats(cells * k);
}

// Shared memory of a block: the params (a float4 per mode and column),
// the input buffer and the output tile.  Mirrored by `tile_smem_bytes` in
// kernels/vgm_encode.py.
__host__ inline long long tile_smem_bytes(int q, int k, int rows) {
  return 4 * (4LL * q * k + 2 * buffer_floats((long long)rows * q, k));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The split of n floats at p around 16-byte boundaries: `lead` floats of
// p's address past one, `head` floats up to the next (at most 3), `body`
// 16-byte chunks, `tail` floats after the last.  Mirrored by `split16` in
// kernels/vgm_encode.py.
struct Split {
  int lead, head, body, tail;
};

__device__ __forceinline__ int lead_of(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

__device__ __forceinline__ Split split16(const float* p, int n) {
  Split s;
  s.lead = lead_of(p);
  s.head = min(n, (4 - s.lead) & 3);
  s.body = (n - s.head) >> 2;
  s.tail = n - s.head - 4 * s.body;
  return s;
}

// Copy n floats from src into the 16-byte aligned region `stage`, at
// stage[lead + i], so that source and copy share their offset within 16
// bytes and the body goes as 16-byte copies.  Asynchronous: the caller
// commits and waits.
__device__ __forceinline__ void stage_async(float* stage, const float* src,
                                           int n) {
  const Split s = split16(src, n);
  float* dst = stage + s.lead;
  if ((int)threadIdx.x < s.head)
    cp_async4(dst + threadIdx.x, src + threadIdx.x);
  for (int v = threadIdx.x; v < s.body; v += blockDim.x)
    cp_async16(dst + s.head + 4 * v, src + s.head + 4 * v);
  if ((int)threadIdx.x < s.tail) {
    const int i = s.head + 4 * s.body + threadIdx.x;
    cp_async4(dst + i, src + i);
  }
}

// Store n floats from tile[lead + i] to dst[i], lead being dst's offset
// within 16 bytes (as `stage_async` placed them): 16-byte loads and
// stores for the body, scalar ones for the head and tail.
__device__ __forceinline__ void store_tile(float* dst, const float* tile,
                                           int n) {
  const Split s = split16(dst, n);
  const float* src = tile + s.lead;
  if ((int)threadIdx.x < s.head) dst[threadIdx.x] = src[threadIdx.x];
  for (int v = threadIdx.x; v < s.body; v += blockDim.x) {
    const int i = s.head + 4 * v;
    *reinterpret_cast<float4*>(dst + i) =
        *reinterpret_cast<const float4*>(src + i);
  }
  if ((int)threadIdx.x < s.tail) {
    const int i = s.head + 4 * s.body + threadIdx.x;
    dst[i] = src[i];
  }
}

// One block per tile of consecutive rows.  Table: x (N, Q), gumbel
// (N, Q*K), out (N, Q*(1+K)), beta null.  Column (Q = 1): out is alpha
// (N,), beta (N, K).  Block b holds rows [b * rows_per_tile,
// min((b + 1) * rows_per_tile, N)).  KC > 0 fixes the mode count at KC
// (the mode loop unrolls, so a thread has all its modes' loads and
// divisions in flight at once); KC = 0 takes any k.
template <int KC>
__global__ void __launch_bounds__(kMaxThreads)
vgm_encode_tile_kernel(const float* __restrict__ x,
                       const float* __restrict__ means,
                       const float* __restrict__ stds,
                       const float* __restrict__ logw,
                       const float* __restrict__ gumbel,
                       float* __restrict__ out, float* __restrict__ beta,
                       long long n, int q, int k_any, int rows_per_tile) {
  const int k = KC > 0 ? KC : k_any;
  extern __shared__ float4 smem4[];
  const int qk = q * k;
  const int max_cells = rows_per_tile * q;
  float4* s_par = smem4;                     // [mode][col]: mu, sd, log sd, lw
  float* s_x = reinterpret_cast<float*>(s_par + qk);
  float* s_g = s_x + stage_floats(max_cells);
  // the output tile: the table's slots from s_o; the column's alphas from
  // s_o and betas from s_ob
  float* s_o = s_g + stage_floats((long long)max_cells * k);
  float* s_ob = s_o + stage_floats(max_cells);

  const long long row0 = (long long)blockIdx.x * rows_per_tile;
  const int cells = (int)min((long long)rows_per_tile, n - row0) * q;
  const float* xt = x + row0 * q;
  const float* gt = gumbel + row0 * qk;
  // the loads go out first; the params are staged while they fly
  stage_async(s_x, xt, cells);
  stage_async(s_g, gt, cells * k);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < qk; i += blockDim.x) {
    const float sd = stds[i];                // params are (Q, K) row-major
    s_par[(i % k) * q + i / k] = make_float4(means[i], sd, logf(sd), logw[i]);
  }
  // where the cells' outputs go in the output tile: at the leads of their
  // stretches in device memory
  float* dst = beta == nullptr ? out + row0 * q * (1 + k) : beta + row0 * k;
  float* o_alpha;
  float* o_beta;
  int stride_alpha, stride_beta;
  if (beta == nullptr) {
    o_alpha = s_o + lead_of(dst);
    o_beta = o_alpha + 1;
    stride_alpha = stride_beta = 1 + k;
  } else {
    o_alpha = s_o + lead_of(out + row0);
    o_beta = s_ob + lead_of(dst);
    stride_alpha = 1;
    stride_beta = k;
  }
  const float* sx = s_x + lead_of(xt);
  const float* sg = s_g + lead_of(gt);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // a thread's cells c = threadIdx.x + i * blockDim.x: their columns step
  // by blockDim.x mod q
  int col = threadIdx.x % q;
  const int col_step = blockDim.x % q;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const float xv = sx[c];
    const float* g = sg + c * k;
    const float4* p = s_par + col;
    // the mode of the largest score log N(x; mu, sd) + log w + g (the
    // first on ties)
    int best = 0;
    float best_v = 0.0f;
#pragma unroll (KC > 0 ? KC : 1)
    for (int m = 0; m < k; ++m) {
      const float4 pm = p[m * q];
      const float z = (xv - pm.x) / pm.y;
      const float v = -0.5f * z * z - pm.z - kHalfLog2Pi + pm.w + g[m];
      if (m == 0 || v > best_v) {
        best_v = v;
        best = m;
      }
    }
    const float4 pb = p[best * q];
    const float a = (xv - pb.x) / (4.0f * pb.y);
    o_alpha[c * stride_alpha] = fminf(fmaxf(a, -1.0f), 1.0f);
    float* ob = o_beta + c * stride_beta;
#pragma unroll (KC > 0 ? KC : 1)
    for (int m = 0; m < k; ++m) ob[m] = (m == best) ? 1.0f : 0.0f;
    col += col_step;
    if (col >= q) col -= q;
  }
  __syncthreads();
  if (beta == nullptr) {
    store_tile(dst, s_o, cells * (1 + k));
  } else {
    store_tile(out + row0, s_o, cells);
    store_tile(dst, s_ob, cells * k);
  }
}

// Check the plan against the layout, raise the block's shared-memory
// limit where the plan asks, launch one block per tile.
int launch_tiles(const float* x, const float* means, const float* stds,
                 const float* logw, const float* gumbel, float* out,
                 float* beta, long long n, int q, int k, int rows_per_tile,
                 int threads, int smem_bytes, int smem_attr, void* stream) {
  const long long tiles = (n + rows_per_tile - 1) / rows_per_tile;
  if (rows_per_tile < 1 || tiles > 0x7fffffffLL || threads < 32 ||
      threads > kMaxThreads ||
      smem_bytes < tile_smem_bytes(q, k, rows_per_tile))
    return (int)cudaErrorInvalidValue;
  auto kernel = k == kModesDefault ? vgm_encode_tile_kernel<kModesDefault>
                                   : vgm_encode_tile_kernel<0>;
  if (smem_attr > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_attr);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)tiles, threads, smem_bytes, (cudaStream_t)stream>>>(
      x, means, stds, logw, gumbel, out, beta, n, q, k, rows_per_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vgm_encode_column_f32(const float* x, const float* means,
                                     const float* stds, const float* logw,
                                     const float* gumbel, float* alpha,
                                     float* beta, long long n, int k,
                                     int rows_per_tile, int threads,
                                     int smem_bytes, int smem_attr,
                                     void* stream) {
  return launch_tiles(x, means, stds, logw, gumbel, alpha, beta, n, 1, k,
                      rows_per_tile, threads, smem_bytes, smem_attr, stream);
}

extern "C" int vgm_encode_table_f32(const float* x, const float* means,
                                    const float* stds, const float* logw,
                                    const float* gumbel, float* out,
                                    long long n, int q, int k,
                                    int rows_per_tile, int threads,
                                    int smem_bytes, int smem_attr,
                                    void* stream) {
  return launch_tiles(x, means, stds, logw, gumbel, out, nullptr, n, q, k,
                      rows_per_tile, threads, smem_bytes, smem_attr, stream);
}

extern "C" const char* vgm_encode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
