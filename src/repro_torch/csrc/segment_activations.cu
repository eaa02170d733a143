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
// expf and a few flops per lane.  Design: one thread per (row, span), spans
// fastest, so a warp works on one contiguous stretch of lanes.  The thread
// walks its Wmax lanes in passes (scaled logits and their max, then exp and
// sum, then y and its argmax, then the straight-through value) and keeps the
// intermediate values in its own lanes of the output, which stay in L1/L2
// between passes, so there is no cap on the span width and no logf is
// evaluated twice.
//
// Numerics: built with --fmad=false and no fast math: expf, logf and tanhf
// are the IEEE-accurate versions (1/tau = 5 amplifies their error).  The sum
// runs in lane order, so y can differ from the plain version's reduction
// order by an ulp.  Ties go to the first lane (strict >), as jnp.argmax.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kGumbelEps = 1e-20f;

__global__ void segment_activations_kernel(const float* __restrict__ x,
                                           const float* __restrict__ u,
                                           const float* __restrict__ kinds,
                                           float* __restrict__ out,
                                           long long n, int s, int w,
                                           float tau, int hard) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * s) return;
  const int span = (int)(idx % s);
  const long long base = idx * w;                 // (N, S*W): lanes of (row, span)
  const float* xs = x + base;
  const float* us = u + base;
  float* o = out + base;

  if (kinds[span * w] > 0.5f) {                   // kinds rows are uniform
    for (int l = 0; l < w; ++l) o[l] = tanhf(xs[l]);
    return;
  }
  float m = -INFINITY;
  for (int l = 0; l < w; ++l) {
    const float g = -logf(-logf(us[l] + kGumbelEps) + kGumbelEps);
    const float z = (xs[l] + g) / tau;
    o[l] = z;
    m = fmaxf(m, z);
  }
  float sum = 0.0f;
  for (int l = 0; l < w; ++l) {
    const float e = expf(o[l] - m);
    o[l] = e;
    sum += e;
  }
  int best = 0;
  float best_v = 0.0f;
  for (int l = 0; l < w; ++l) {
    const float y = o[l] / sum;
    o[l] = y;
    if (l == 0 || y > best_v) {
      best_v = y;
      best = l;
    }
  }
  if (!hard) return;
  for (int l = 0; l < w; ++l) {
    const float y = o[l];
    o[l] = ((l == best ? 1.0f : 0.0f) - y) + y;
  }
}

// Backward: the gradient w.r.t. the packed logits for the upstream
// gradient ct.  Tanh lanes give ct * (1 - tanh(x)^2).  Softmax lanes
// recompute the soft sample y from x and u (in hard mode the forward's
// output is the one-hot, so it cannot be reused) and give
// y * (ct - sum_lanes(ct * y)) / tau; hard mode passes this soft gradient
// (straight-through).  Padded lanes (x = -inf) get y = 0, so 0.  u and
// kinds take no gradient.
//
// What bounds it: bytes (x, u and ct read, the gradient written: 16 bytes a
// lane), and at the training shape (500 rows) the launch itself.  The
// layout and the lane passes are the forward's: one thread per (row,
// span), intermediates kept in the thread's own lanes of the output.
__global__ void segment_activations_bwd_kernel(const float* __restrict__ x,
                                               const float* __restrict__ u,
                                               const float* __restrict__ kinds,
                                               const float* __restrict__ ct,
                                               float* __restrict__ gx,
                                               long long n, int s, int w,
                                               float tau) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * s) return;
  const int span = (int)(idx % s);
  const long long base = idx * w;
  const float* xs = x + base;
  const float* us = u + base;
  const float* cs = ct + base;
  float* o = gx + base;

  if (kinds[span * w] > 0.5f) {
    for (int l = 0; l < w; ++l) {
      const float t = tanhf(xs[l]);
      o[l] = cs[l] * (1.0f - t * t);
    }
    return;
  }
  float m = -INFINITY;
  for (int l = 0; l < w; ++l) {
    const float g = -logf(-logf(us[l] + kGumbelEps) + kGumbelEps);
    const float z = (xs[l] + g) / tau;
    o[l] = z;
    m = fmaxf(m, z);
  }
  float sum = 0.0f;
  for (int l = 0; l < w; ++l) {
    const float e = expf(o[l] - m);
    o[l] = e;
    sum += e;
  }
  float dot = 0.0f;
  for (int l = 0; l < w; ++l) {
    const float y = o[l] / sum;
    o[l] = y;
    dot += cs[l] * y;
  }
  for (int l = 0; l < w; ++l) o[l] = o[l] * (cs[l] - dot) / tau;
}

}  // namespace

extern "C" int segment_activations_f32(const float* x, const float* u,
                                       const float* kinds, float* out,
                                       long long n, int s, int w, float tau,
                                       int hard, void* stream) {
  const int threads = 256;
  const long long cells = n * s;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  segment_activations_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, u, kinds, out, n, s, w, tau, hard);
  return (int)cudaGetLastError();
}

extern "C" int segment_activations_bwd_f32(const float* x, const float* u,
                                           const float* kinds,
                                           const float* ct, float* gx,
                                           long long n, int s, int w,
                                           float tau, void* stream) {
  const int threads = 256;
  const long long cells = n * s;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  segment_activations_bwd_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      x, u, kinds, ct, gx, n, s, w, tau);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_activations_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
