// Table-wide VGM mode-specific normalization (CTGAN encode), sm_90a.
//
// Replaces the Pallas kernel `vgm_encode_table` of the JAX package
// (src/repro/kernels/vgm_encode.py:137, body `_mode_normalize` :63).  For
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
// Numerics: built with --fmad=false and no fast math, so every product and
// sum rounds as in the plain PyTorch version (kernels/ref.py) and logf is
// IEEE-accurate.  Ties go to the first mode (strict >), as jnp.argmax.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// 0.5 * log(2 pi), rounded to float as the plain version's scalar is.
constexpr float kHalfLog2Pi = 0.9189385332046727f;

__global__ void vgm_encode_table_kernel(const float* __restrict__ x,
                                        const float* __restrict__ means,
                                        const float* __restrict__ stds,
                                        const float* __restrict__ logw,
                                        const float* __restrict__ gumbel,
                                        float* __restrict__ out,
                                        long long n, int q, int k) {
  extern __shared__ float smem[];
  const int qk = q * k;
  float* s_mean = smem;
  float* s_std = s_mean + qk;
  float* s_logstd = s_std + qk;
  float* s_logw = s_logstd + qk;
  for (int i = threadIdx.x; i < qk; i += blockDim.x) {
    const float sd = stds[i];
    s_mean[i] = means[i];
    s_std[i] = sd;
    s_logstd[i] = logf(sd);
    s_logw[i] = logw[i];
  }
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * q) return;
  const int col = (int)(idx % q);
  const float xv = x[idx];                        // x is (N, Q) row-major
  const float* g = gumbel + idx * k;              // (N, Q*K): lanes of (row, col)
  const float* mu = s_mean + col * k;
  const float* sd = s_std + col * k;
  const float* lsd = s_logstd + col * k;
  const float* lw = s_logw + col * k;

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
  const float a = (xv - mu[best]) / (4.0f * sd[best]);
  float* o = out + idx * (1 + k);                 // (N, Q*(1+K)) slot of (row, col)
  o[0] = fminf(fmaxf(a, -1.0f), 1.0f);
  for (int m = 0; m < k; ++m) o[1 + m] = (m == best) ? 1.0f : 0.0f;
}

}  // namespace

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
