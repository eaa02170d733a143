// Table-wide VGM mode-specific decode (CTGAN output -> raw columns), sm_90a.
//
// Replaces the Pallas kernel `vgm_decode_table` of the JAX package
// (src/repro/kernels/vgm_decode.py:62, body `_mode_denormalize` :40).  For
// every (row, continuous column) it takes the first maximum over the
// column's Kmax beta lanes (padded lanes hold -1e30) and writes
// clip(alpha, -1, 1) * 4 * sd_k + mu_k.
//
// What bounds it: bytes, and at serving sizes the launch itself.  It reads
// the (N, Q*(1+Kmax)) slots once and writes (N, Q) floats, a few flops per
// byte; at N = 4096 rows that is about a megabyte, which the card moves in
// well under the time a launch takes.  Design: one thread per (row,
// column), columns fastest, so a warp reads one contiguous stretch of
// slots; the (Q, Kmax) means/stds are a few hundred bytes and stay in L1.
//
// Numerics: built with --fmad=false, so clip(alpha) * 4 * sd is rounded
// before + mu, exactly as the plain PyTorch version (kernels/ref.py).  The
// JAX reference lets XLA contract that multiply-add, so the two differ by
// at most one rounding of the result.  Ties go to the first mode (strict >).
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void vgm_decode_table_kernel(const float* __restrict__ slots,
                                        const float* __restrict__ means,
                                        const float* __restrict__ stds,
                                        float* __restrict__ out,
                                        long long n, int q, int k) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * q) return;
  const int col = (int)(idx % q);
  const float* s = slots + idx * (1 + k);         // slot of (row, col)
  int best = 0;
  float best_v = s[1];
  for (int m = 1; m < k; ++m) {
    const float v = s[1 + m];
    if (v > best_v) {
      best_v = v;
      best = m;
    }
  }
  const float a = fminf(fmaxf(s[0], -1.0f), 1.0f);
  out[idx] = a * 4.0f * stds[col * k + best] + means[col * k + best];
}

}  // namespace

extern "C" int vgm_decode_table_f32(const float* slots, const float* means,
                                    const float* stds, float* out,
                                    long long n, int q, int k, void* stream) {
  const int threads = 256;
  const long long cells = n * q;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  vgm_decode_table_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      slots, means, stds, out, n, q, k);
  return (int)cudaGetLastError();
}

extern "C" const char* vgm_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
