// VGM mode-specific normalization (CTGAN encode), sm_90a: the table-wide
// kernel and the single-column one.
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
// writes 1+Kmax floats, against ~8 Kmax flops, far below the card's
// ~20 flop/B balance point.  Design: one thread per (row, column), columns
// fastest, so a warp reads neighbouring x values and writes one contiguous
// stretch of slots.  The block stages all columns' means, stds, log(stds)
// and log-weights in shared memory once, so the mode loop reads no
// parameter from device memory and log(std) is not recomputed per cell.
//
// The single-column kernel is the same walk with one column: one thread
// per row, the column's K params staged in shared memory; a warp writes
// 32 neighbouring alphas and one stretch of 32 K one-hot rows.
//
// Numerics: built with --fmad=false and no fast math, so every product and
// sum rounds as in the plain PyTorch version (kernels/ref.py) and logf is
// IEEE-accurate.  Ties go to the first mode (strict >), as jnp.argmax.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// 0.5 * log(2 pi), rounded to float as the plain version's scalar is.
constexpr float kHalfLog2Pi = 0.9189385332046727f;

// Stage n mode params as four float tables in shared memory: means, stds,
// log(stds) (so no cell recomputes it) and log-weights.
__device__ __forceinline__ void stage_params(float* smem,
                                             const float* __restrict__ means,
                                             const float* __restrict__ stds,
                                             const float* __restrict__ logw,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float sd = stds[i];
    smem[i] = means[i];
    smem[n + i] = sd;
    smem[2 * n + i] = logf(sd);
    smem[3 * n + i] = logw[i];
  }
  __syncthreads();
}

// The mode of the largest score log N(x; mu, sd) + log w + g (the first
// on ties).
__device__ __forceinline__ int pick_mode(float xv, const float* mu,
                                         const float* sd, const float* lsd,
                                         const float* lw, const float* g,
                                         int k) {
  int best = 0;
  float best_v = 0.0f;
  for (int m = 0; m < k; ++m) {
    const float z = (xv - mu[m]) / sd[m];
    const float v = -0.5f * z * z - lsd[m] - kHalfLog2Pi + lw[m] + g[m];
    if (m == 0 || v > best_v) {
      best_v = v;
      best = m;
    }
  }
  return best;
}

__global__ void vgm_encode_table_kernel(const float* __restrict__ x,
                                        const float* __restrict__ means,
                                        const float* __restrict__ stds,
                                        const float* __restrict__ logw,
                                        const float* __restrict__ gumbel,
                                        float* __restrict__ out,
                                        long long n, int q, int k) {
  extern __shared__ float smem[];
  const int qk = q * k;
  stage_params(smem, means, stds, logw, qk);
  const float* s_mean = smem;
  const float* s_std = s_mean + qk;
  const float* s_logstd = s_std + qk;
  const float* s_logw = s_logstd + qk;

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * q) return;
  const int col = (int)(idx % q);
  const float xv = x[idx];                        // x is (N, Q) row-major
  const float* g = gumbel + idx * k;              // (N, Q*K): lanes of (row, col)
  const float* mu = s_mean + col * k;
  const float* sd = s_std + col * k;
  const float* lsd = s_logstd + col * k;
  const float* lw = s_logw + col * k;

  const int best = pick_mode(xv, mu, sd, lsd, lw, g, k);
  const float a = (xv - mu[best]) / (4.0f * sd[best]);
  float* o = out + idx * (1 + k);                 // (N, Q*(1+K)) slot of (row, col)
  o[0] = fminf(fmaxf(a, -1.0f), 1.0f);
  for (int m = 0; m < k; ++m) o[1 + m] = (m == best) ? 1.0f : 0.0f;
}

__global__ void vgm_encode_column_kernel(const float* __restrict__ x,
                                         const float* __restrict__ means,
                                         const float* __restrict__ stds,
                                         const float* __restrict__ logw,
                                         const float* __restrict__ gumbel,
                                         float* __restrict__ alpha,
                                         float* __restrict__ beta,
                                         long long n, int k) {
  extern __shared__ float smem[];
  stage_params(smem, means, stds, logw, k);
  const float* s_mean = smem;
  const float* s_std = s_mean + k;
  const float* s_logstd = s_std + k;
  const float* s_logw = s_logstd + k;

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float xv = x[row];
  const int best = pick_mode(xv, s_mean, s_std, s_logstd, s_logw,
                             gumbel + row * k, k);
  const float a = (xv - s_mean[best]) / (4.0f * s_std[best]);
  alpha[row] = fminf(fmaxf(a, -1.0f), 1.0f);
  float* b = beta + row * k;
  for (int m = 0; m < k; ++m) b[m] = (m == best) ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int vgm_encode_column_f32(const float* x, const float* means,
                                     const float* stds, const float* logw,
                                     const float* gumbel, float* alpha,
                                     float* beta, long long n, int k,
                                     void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const size_t smem = 4 * (size_t)k * sizeof(float);
  vgm_encode_column_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      x, means, stds, logw, gumbel, alpha, beta, n, k);
  return (int)cudaGetLastError();
}

extern "C" int vgm_encode_table_f32(const float* x, const float* means,
                                    const float* stds, const float* logw,
                                    const float* gumbel, float* out,
                                    long long n, int q, int k, void* stream) {
  const int threads = 256;
  const long long cells = n * q;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  const size_t smem = 4 * (size_t)q * k * sizeof(float);
  vgm_encode_table_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      x, means, stds, logw, gumbel, out, n, q, k);
  return (int)cudaGetLastError();
}

extern "C" const char* vgm_encode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
