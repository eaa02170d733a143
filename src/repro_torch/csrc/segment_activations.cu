// Per-span output activations of the CTGAN generator, forward and
// backward, sm_90a.
//
// The forward replaces the Pallas kernel `segment_activations` of the JAX
// package (src/repro/kernels/segment_activations.py:134, block
// `_segment_act_block` :107); the backward replaces its custom VJP
// (`_packed_bwd` :200-205, the jnp oracle's VJP; see the backward kernel
// below).  Spans are packed into an (S, Wmax) lane grid per row; padded
// logit lanes hold -inf.  A tanh span gets tanh(x) on every lane.  Any
// other span gets the Gumbel-softmax at temperature tau of its logits with
// the pre-drawn uniforms u: g = -log(-log(u + eps) + eps), y = softmax((x +
// g) / tau); with `hard` the straight-through forward ((onehot - y) + y) of
// the first maximum of y.
//
// What bounds it: bytes.  It reads the packed logits and uniforms and writes
// the packed activations once each, 12 bytes per lane, against two logf, one
// expf and a few flops per lane.  The forward reads each lane once and
// writes it once, neighbouring threads on neighbouring lanes, in one of two
// layouts by Wmax (kTileMaxWidth below, chosen from the layouts' times on
// the card).  Narrow spans (the CTGAN tables'): a block stages a tile of 32
// rows x up to 8 spans in shared memory and a thread per cell walks its
// lanes there, a warp per span, so that padded lanes are skipped by whole
// warps.  Wider spans: a warp per (row, span) walks it in coalesced strides
// of 32 lanes, the scaled logits and then their weights held in the warp's
// own stage of shared memory between the passes.  No cap on the width: a
// span wider than a block's shared memory recomputes the scaled logits in
// each pass instead of staging them.
//
// Numerics: built with --fmad=false and no fast math: expf, logf and tanhf
// are the IEEE-accurate versions (1/tau = 5 amplifies their error).  Spans
// are summed in lane order (a shuffle tree in the warp layout and in the
// backward's groups), so y can differ from the plain version's reduction
// order by an ulp.  Ties go to the first lane, as jnp.argmax.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kGumbelEps = 1e-20f;

__device__ __forceinline__ float scaled_logit(float x, float u, float tau) {
  const float g = -logf(-logf(u + kGumbelEps) + kGumbelEps);
  return (x + g) / tau;
}

// The larger of two (value, lane) pairs, the lower lane on equal values:
// the first maximum, as jnp.argmax.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The tile: a block stages 32 rows x `spans` spans of x and u in shared
// memory with coalesced loads (each row's stretch of spans is contiguous),
// each cell's lanes at an odd stride so that the walks below hit distinct
// banks.  Warp w takes span s0 + w of the 32 rows, lane t row r0 + t, and
// walks the cell's lanes in the stage: scaled logits and their max, exp and
// the sum in lane order, y and its first maximum, the straight-through
// value.  A warp's cells share their span, so the tanh / softmax choice and
// the padded (-inf) lanes are the same on every lane: padded lanes skip the
// logs and the exp (their scaled logit is -inf and their weight 0 exactly,
// as computed).  The block writes the tile back with coalesced stores.
// Spans a tile: up to 8, as many as kTileLanes stage columns hold.
constexpr int kTileRows = 32, kTileMaxSpans = 8, kTileLanes = 8 * 33;

__host__ __device__ inline int tile_spans(int w) {
  const int k = kTileLanes / (w | 1);
  return k < 1 ? 1 : k > kTileMaxSpans ? kTileMaxSpans : k;
}

__global__ void __launch_bounds__(kTileRows * kTileMaxSpans)
segment_activations_tile(const float* __restrict__ x,
                         const float* __restrict__ u,
                         const float* __restrict__ kinds,
                         float* __restrict__ out, long long n, int s, int w,
                         float tau, int hard) {
  extern __shared__ float stage[];
  const int wp = w | 1, tspans = tile_spans(w);
  float* sx = stage;
  float* su = stage + kTileRows * tspans * wp;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int s0 = blockIdx.y * tspans;
  const int spans = min(tspans, s - s0);
  const int rows = (int)min((long long)kTileRows, n - r0);
  const int seg = spans * w;                      // a row's lanes in the tile
  const float inv_w = 1.0f / (float)w, inv_seg = 1.0f / (float)seg;
  // tile lane i is lane j = i % seg of row i / seg, lane j % w of span
  // j / w; (i + 0.5) / seg stays at least 0.5 / seg from an integer, far
  // above its rounding (and likewise for w)
  auto stage_at = [&](int i, long long& g) {
    const int r = (int)(((float)i + 0.5f) * inv_seg);
    const int j = i - r * seg;
    const int sp = (int)(((float)j + 0.5f) * inv_w);
    g = ((r0 + r) * s + s0) * w + j;
    return (sp * kTileRows + r) * wp + (j - sp * w);
  };
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < rows * seg; i += nt) {
    long long g;
    const int at = stage_at(i, g);
    sx[at] = x[g];
    su[at] = u[g];
  }
  __syncthreads();
  const int sp = tid / kTileRows, r = tid % kTileRows;
  if (sp < spans && r < rows) {
    float* o = sx + (sp * kTileRows + r) * wp;
    const float* us = su + (sp * kTileRows + r) * wp;
    if (kinds[(s0 + sp) * w] > 0.5f) {            // kinds rows are uniform
      for (int l = 0; l < w; ++l)
        o[l] = o[l] == -INFINITY ? -1.0f : tanhf(o[l]);
    } else {
      float m = -INFINITY;
      for (int l = 0; l < w; ++l) {
        if (o[l] != -INFINITY) o[l] = scaled_logit(o[l], us[l], tau);
        m = fmaxf(m, o[l]);
      }
      float sum = 0.0f;
      for (int l = 0; l < w; ++l) {
        o[l] = o[l] == -INFINITY ? 0.0f : expf(o[l] - m);
        sum += o[l];
      }
      float best_v = -INFINITY;
      int best = w;
      for (int l = 0; l < w; ++l) {
        o[l] /= sum;                              // y
        arg_better(best_v, best, o[l], l);
      }
      if (hard)
        for (int l = 0; l < w; ++l)
          o[l] = ((l == best ? 1.0f : 0.0f) - o[l]) + o[l];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * seg; i += nt) {
    long long g;
    const int at = stage_at(i, g);
    out[g] = sx[at];
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp per (row, span): lane t takes lanes t, t + 32, ... of the span.
// kStaged: the warp's w floats of shared memory hold the scaled logits,
// then their weights, so x and u are read once; otherwise (a span wider
// than a block's shared memory) each pass recomputes the scaled logits.
// Padded lanes skip the logs, as in the tile.
template <bool kStaged>
__global__ void __launch_bounds__(256)
segment_activations_warp(const float* __restrict__ x,
                         const float* __restrict__ u,
                         const float* __restrict__ kinds,
                         float* __restrict__ out, long long n, int s, int w,
                         float tau, int hard) {
  extern __shared__ float stage[];
  const int warps = blockDim.x / 32;
  const long long cell =
      (long long)blockIdx.x * warps + threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  if (cell >= n * s) return;                      // whole warps
  const long long base = cell * w;
  const float* xs = x + base;
  const float* us = u + base;
  float* o = out + base;
  if (kinds[(cell % s) * w] > 0.5f) {
    for (int l = t; l < w; l += 32) o[l] = tanhf(xs[l]);
    return;
  }
  float* z = stage + (long long)(threadIdx.x / 32) * w;
  auto logit = [&](int l) {
    const float xl = xs[l];
    return xl == -INFINITY ? -INFINITY : scaled_logit(xl, us[l], tau);
  };
  float m = -INFINITY;
  for (int l = t; l < w; l += 32) {
    const float zl = logit(l);
    if (kStaged) z[l] = zl;
    m = fmaxf(m, zl);
  }
  m = warp_max(m);
  float sum = 0.0f;
  for (int l = t; l < w; l += 32) {
    const float e = expf((kStaged ? z[l] : logit(l)) - m);
    if (kStaged) z[l] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  auto y_at = [&](int l) {
    return (kStaged ? z[l] : expf(logit(l) - m)) / sum;
  };
  float best_v = -INFINITY;
  int best = w;
  if (hard) {
    for (int l = t; l < w; l += 32) arg_better(best_v, best, y_at(l), l);
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, best, off);
      arg_better(best_v, best, v2, i2);
    }
  }
  for (int l = t; l < w; l += 32) {
    const float y = y_at(l);
    o[l] = hard ? ((l == best ? 1.0f : 0.0f) - y) + y : y;
  }
}

// Backward: the gradient w.r.t. the packed logits for the upstream
// gradient ct.  Tanh lanes give ct * (1 - tanh(x)^2).  Softmax lanes
// recompute the soft sample y from x and u (in hard mode the forward's
// output is the one-hot, so it cannot be reused) and give
// y * (ct - sum_lanes(ct * y)) / tau; hard mode passes this soft gradient
// (straight-through).  Padded lanes (x = -inf) give exactly 0.  u and kinds
// take no gradient.
//
// What bounds it: bytes (x, u and ct read, the gradient written: 16 bytes a
// lane); at the training shape (500 rows x 19 spans x 18 lanes, 2.7 MB) the
// launch and one wave of blocks, and at thousands of rows issuing the two
// IEEE logf, an expf and three divisions a lane.  Two layouts, chosen by
// Wmax: the groups up to 32 lanes, a warp per span past them.  A group of
// G threads (G the least power of two >= Wmax, at most 32) takes one (row,
// span), a thread per lane, so a warp holds 32 / G neighbouring cells and
// its loads of x, u and ct are coalesced and made once.  Each lane's values stay in registers;
// the span's max, its sum of exponentials and the dot with ct are
// __shfl_xor_sync trees within the group; the gradient is written once.
// Padded lanes skip the logs and the exp.  All 32 threads of a warp run
// every shuffle (no early return, no divergent branch around one), so a
// group of tanh lanes or past the last cell shuffles neutral values.
template <int G>
__global__ void __launch_bounds__(256)
segment_activations_bwd_groups(const float* __restrict__ x,
                               const float* __restrict__ u,
                               const float* __restrict__ kinds,
                               const float* __restrict__ ct,
                               float* __restrict__ gx, long long cells,
                               int s, int w, float tau) {
  const long long cell = (long long)blockIdx.x * (256 / G) + threadIdx.x / G;
  const int t = threadIdx.x % G;
  const bool in = cell < cells, live = in && t < w;
  const long long i = cell * w + t;
  const float xv = live ? x[i] : -INFINITY;
  const float uv = live ? u[i] : 0.5f;
  const float cv = live ? ct[i] : 0.0f;
  const int span = cells <= 0x7fffffff ? (int)cell % s  // 32-bit rem
                                       : (int)(cell % s);
  const bool tanh_span = in && kinds[span * w] > 0.5f;
  const bool soft = !tanh_span && xv != -INFINITY;   // a real softmax lane
  const float z = soft ? scaled_logit(xv, uv, tau) : -INFINITY;
  float m = z;
  for (int off = G / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float e = soft ? expf(z - m) : 0.0f;
  float sum = e;
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float y = soft ? e / sum : 0.0f;
  float dot = cv * y;
  for (int off = G / 2; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (!live) return;
  float g = 0.0f;
  if (soft) {
    g = y * (cv - dot) / tau;
  } else if (tanh_span && xv != -INFINITY) {
    const float th = tanhf(xv);
    g = cv * (1.0f - th * th);
  }
  gx[i] = g;
}

// Spans wider than 32 lanes: a warp per (row, span), lane t taking lanes t,
// t + 32, ... of the span; each thread sums its lanes in order, then the
// warp's shuffle tree.  kStaged: the warp's 2 * Wmax floats of shared memory
// hold the scaled logits, then their exponentials, then y, and ct, so that
// x, u and ct are read once (each thread reads back only the lanes it
// wrote); otherwise (a span wider than a block's shared memory) each pass
// recomputes the scaled logits and ct is read twice.
template <bool kStaged>
__global__ void __launch_bounds__(256)
segment_activations_bwd_warp(const float* __restrict__ x,
                             const float* __restrict__ u,
                             const float* __restrict__ kinds,
                             const float* __restrict__ ct,
                             float* __restrict__ gx, long long cells, int s,
                             int w, float tau) {
  extern __shared__ float stage[];
  const int warps = blockDim.x / 32;
  const long long cell = (long long)blockIdx.x * warps + threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  if (cell >= cells) return;                      // whole warps
  const long long base = cell * w;
  const float* xs = x + base;
  const float* us = u + base;
  const float* cs = ct + base;
  float* o = gx + base;
  if (kinds[(int)(cell % s) * w] > 0.5f) {
    for (int l = t; l < w; l += 32) {
      const float xl = xs[l];
      const float th = tanhf(xl);
      o[l] = xl == -INFINITY ? 0.0f : cs[l] * (1.0f - th * th);
    }
    return;
  }
  float* zs = stage + (long long)(threadIdx.x / 32) * 2 * w;
  float* cst = zs + w;
  auto logit = [&](int l) {
    const float xl = xs[l];
    return xl == -INFINITY ? -INFINITY : scaled_logit(xl, us[l], tau);
  };
  float m = -INFINITY;
  for (int l = t; l < w; l += 32) {
    const float zl = logit(l);
    if (kStaged) zs[l] = zl;
    m = fmaxf(m, zl);
  }
  m = warp_max(m);
  auto exp_at = [&](float zl) {
    return zl == -INFINITY ? 0.0f : expf(zl - m);
  };
  float sum = 0.0f;
  for (int l = t; l < w; l += 32) {
    const float e = exp_at(kStaged ? zs[l] : logit(l));
    if (kStaged) zs[l] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  float dot = 0.0f;
  for (int l = t; l < w; l += 32) {
    const float y = (kStaged ? zs[l] : exp_at(logit(l))) / sum;
    const float c = cs[l];
    if (kStaged) {
      zs[l] = y;
      cst[l] = c;
    }
    dot += c * y;
  }
  dot = warp_sum(dot);
  for (int l = t; l < w; l += 32) {
    const float y = kStaged ? zs[l] : exp_at(logit(l)) / sum;
    o[l] = y == 0.0f ? 0.0f : y * ((kStaged ? cst[l] : cs[l]) - dot) / tau;
  }
}

// Up to kTileMaxWidth lanes the tile takes a span, wider spans the warp:
// at 4,096 rows of softmax spans of W lanes (chip_smoke.py's layout sweep,
// H100; PERF.md) the tile ran 0.19-0.93x the warp's time from W 8 to 44,
// the warp 0.96x the tile's at W 48 and 0.56x at W 64.
constexpr int kTileMaxWidth = 44;

// Shared memory above the default 48 KB, where the kernel needs it.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// layout 0 picks by Wmax (kTileMaxWidth); 1 forces the tile, 2 the staged
// warp, 3 the warp that recomputes (for tests and the layout sweep).  A
// forced layout whose stage does not fit returns cudaErrorInvalidValue.
extern "C" int segment_activations_f32(const float* x, const float* u,
                                       const float* kinds, float* out,
                                       long long n, int s, int w, float tau,
                                       int hard, int layout, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, optin = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return (int)e;
  const int tspans = tile_spans(w);
  const size_t tile_smem = sizeof(float) * 2 * kTileRows * tspans * (w | 1);
  const size_t lane_bytes = sizeof(float) * (size_t)w;   // a warp's stage
  if (layout == 0)
    layout = w <= kTileMaxWidth ? 1 : lane_bytes <= (size_t)optin ? 2 : 3;
  if (layout == 1) {
    if (tile_smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    if (int e = allow_smem(segment_activations_tile, tile_smem)) return e;
    const dim3 grid((unsigned)((n + kTileRows - 1) / kTileRows),
                    (unsigned)((s + tspans - 1) / tspans));
    segment_activations_tile<<<grid, kTileRows * tspans, tile_smem, st>>>(
        x, u, kinds, out, n, s, w, tau, hard);
    return (int)cudaGetLastError();
  }
  const long long cells = n * s;
  if (layout == 2) {
    // 8 warps a block, fewer where their stages pass 48 KB
    const size_t fit = 48 * 1024 / lane_bytes;
    const int warps = fit < 1 ? 1 : fit > 8 ? 8 : (int)fit;
    const size_t smem = warps * lane_bytes;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    if (int e = allow_smem(segment_activations_warp<true>, smem)) return e;
    segment_activations_warp<true>
        <<<(unsigned)((cells + warps - 1) / warps), 32 * warps, smem, st>>>(
            x, u, kinds, out, n, s, w, tau, hard);
    return (int)cudaGetLastError();
  }
  if (layout != 3) return (int)cudaErrorInvalidValue;
  segment_activations_warp<false><<<(unsigned)((cells + 7) / 8), 256, 0, st>>>(
      x, u, kinds, out, n, s, w, tau, hard);
  return (int)cudaGetLastError();
}

// Up to 32 lanes the groups take a span, wider spans the warp: layout 0
// and 1 the staged warp (layout 0 the warp that recomputes where the stage
// does not fit), 2 the warp that recomputes (for tests and the layout
// line).  A forced layout whose stage does not fit returns
// cudaErrorInvalidValue.
extern "C" int segment_activations_bwd_layout_f32(
    const float* x, const float* u, const float* kinds, const float* ct,
    float* gx, long long n, int s, int w, float tau, int layout,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, optin = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return (int)e;
  const long long cells = n * s;
  const size_t lane_bytes = 2 * sizeof(float) * (size_t)w;  // a warp's stage
  if (layout == 0) layout = lane_bytes <= (size_t)optin ? 1 : 2;
  if (layout != 1 && layout != 2) return (int)cudaErrorInvalidValue;
  if (w <= 32) {
    const int g = w <= 1 ? 1 : 1 << (32 - __builtin_clz(w - 1));
    const unsigned blocks = (unsigned)((cells * g + 255) / 256);
    switch (g) {
      case 1: segment_activations_bwd_groups<1><<<blocks, 256, 0, st>>>(
                  x, u, kinds, ct, gx, cells, s, w, tau); break;
      case 2: segment_activations_bwd_groups<2><<<blocks, 256, 0, st>>>(
                  x, u, kinds, ct, gx, cells, s, w, tau); break;
      case 4: segment_activations_bwd_groups<4><<<blocks, 256, 0, st>>>(
                  x, u, kinds, ct, gx, cells, s, w, tau); break;
      case 8: segment_activations_bwd_groups<8><<<blocks, 256, 0, st>>>(
                  x, u, kinds, ct, gx, cells, s, w, tau); break;
      case 16: segment_activations_bwd_groups<16><<<blocks, 256, 0, st>>>(
                   x, u, kinds, ct, gx, cells, s, w, tau); break;
      default: segment_activations_bwd_groups<32><<<blocks, 256, 0, st>>>(
                   x, u, kinds, ct, gx, cells, s, w, tau);
    }
    return (int)cudaGetLastError();
  }
  if (layout == 1) {
    // 8 warps a block, fewer where their stages pass 48 KB
    const size_t fit = 48 * 1024 / lane_bytes;
    const int warps = fit < 1 ? 1 : fit > 8 ? 8 : (int)fit;
    const size_t smem = warps * lane_bytes;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    if (int e = allow_smem(segment_activations_bwd_warp<true>, smem))
      return e;
    segment_activations_bwd_warp<true>
        <<<(unsigned)((cells + warps - 1) / warps), 32 * warps, smem, st>>>(
            x, u, kinds, ct, gx, cells, s, w, tau);
    return (int)cudaGetLastError();
  }
  segment_activations_bwd_warp<false>
      <<<(unsigned)((cells + 7) / 8), 256, 0, st>>>(x, u, kinds, ct, gx,
                                                    cells, s, w, tau);
  return (int)cudaGetLastError();
}

extern "C" int segment_activations_bwd_f32(const float* x, const float* u,
                                           const float* kinds,
                                           const float* ct, float* gx,
                                           long long n, int s, int w,
                                           float tau, void* stream) {
  return segment_activations_bwd_layout_f32(x, u, kinds, ct, gx, n, s, w,
                                            tau, 0, stream);
}

extern "C" const char* segment_activations_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
