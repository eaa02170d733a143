// Weighted federator merge of client parameter vectors, sm_90a.
//
// Replaces the Pallas kernel `weighted_agg` of the JAX package
// (src/repro/kernels/weighted_agg.py:47, body `_agg_kernel` :38) and its
// vmapped edge twin `weighted_average_edges` (src/repro/kernels/ops.py:235).
// One entry serves both: E edges, each a (C, D) stack of client vectors and
// a (C,) weight row, give the (E, D) merged vectors
//   out[e, d] = sum_p s[e, p, d] * (w[e, p] / max(sum_p w[e, p], 1e-12));
// the flat merge of P clients is E = 1, C = P.  An edge whose weights are
// all 0 normalizes to weights of exactly 0 and, for finite values, merges
// to +0.0 (the sum starts at +0.0 and +0.0 + -0.0 is +0.0).
//
// What bounds it: bytes.  Each client value is read once and each merged
// value written once, one multiply and one add per value read: at the
// main path's (5, 1,238,401) that is 29.7 MB against 12 MFLOP.  Design:
// each block normalizes its edge's weights once into shared memory (the
// sum in client order by one thread), then walks D with a grid-stride loop,
// one value of d per thread and step, so a warp reads 128 contiguous bytes
// of each client row and writes 128 contiguous bytes.  D need not be a
// multiple of anything: the loop bound is the tail guard.  Rows are not
// 16-byte aligned when D is odd, so loads stay scalar; the C loads of one
// step are independent and in flight together.
//
// Numerics: built with --fmad=false, so each product is rounded before it
// is added, in client order, as the plain PyTorch version (kernels/ref.py)
// sums a (P, D) product over its client axis.
#include <cuda_runtime.h>

namespace {

__global__ void weighted_agg_kernel(const float* __restrict__ stacked,
                                    const float* __restrict__ weights,
                                    float* __restrict__ out, int c,
                                    long long d) {
  extern __shared__ float wn[];               // (c,) normalized weights
  __shared__ float denom;
  const int e = blockIdx.y;
  const float* we = weights + (long long)e * c;
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int p = 0; p < c; ++p) sum += we[p];
    denom = sum < 1e-12f ? 1e-12f : sum;      // a NaN sum stays NaN
  }
  __syncthreads();
  for (int p = threadIdx.x; p < c; p += blockDim.x) wn[p] = we[p] / denom;
  __syncthreads();

  const float* se = stacked + (long long)e * c * d;
  float* oe = out + (long long)e * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < d;
       i += stride) {
    float acc = 0.0f;
    for (int p = 0; p < c; ++p) acc += se[(long long)p * d + i] * wn[p];
    oe[i] = acc;
  }
}

}  // namespace

extern "C" int weighted_agg_f32(const float* stacked, const float* weights,
                                float* out, int e, int c, long long d,
                                void* stream) {
  const int threads = 256;
  long long blocks = (d + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;           // ~8 blocks per SM, grid-stride
  const dim3 grid((unsigned)blocks, (unsigned)e);
  weighted_agg_kernel<<<grid, threads, c * sizeof(float),
                        (cudaStream_t)stream>>>(stacked, weights, out, c, d);
  return (int)cudaGetLastError();
}

extern "C" const char* weighted_agg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
