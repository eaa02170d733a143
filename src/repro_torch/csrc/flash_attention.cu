// Flash attention, forward and backward, sm_90a, for float32 inputs.
//
// Replaces the three Pallas calls of `flash_attention` in the JAX package
// (src/repro/kernels/flash_attention.py:269): the forward `_fwd_call`
// (:167, body `_flash_kernel` :35), the backward dq call (:199, body
// `_flash_bwd_dq_kernel` :82) and the backward dk/dv call (:216, body
// `_flash_bwd_dkv_kernel` :118) for float32 q, k, v; bfloat16 inputs go
// to the tensor-core kernels of flash_attention_sm90.cu (bf16 tensor cores
// would need a three-way split of each float32 operand here).  Inputs are
// padded and head-matched by the caller (kernels/flash_attention.py): q,
// k, v (B*H, S, hd) float32 rows, keys at or past `kv_len` are padding,
// with an optional causal mask and sliding window.
//
// What bounds it: operations.  At the training path's (4, 9, 2048, 64)
// the forward's two products take 19.3 GFLOP (causal) against 38 MB of
// inputs and outputs, about 500 flop per byte, far above the card's
// balance point; the backward recomputes the scores in both of its
// kernels (7 products).  Design, the simple form: every product runs on
// the CUDA cores in float32 (explicit fmaf).  A block of 256 threads owns
// one 64-row tile of one (batch, head); the tiles it meets stream
// through shared memory as float32 rows padded to hd+1 floats, so the
// column reads of the products hit 16 different banks.  Thread (ty, tx)
// of the 16 x 16 grid owns rows ty*4..ty*4+3 of the tile and columns tx,
// tx+16, ... of the score and output tiles, so each row's statistics
// reduce over 16 lanes of one warp with shuffles.  Causal tiles above the
// diagonal, tiles wholly left of the window and tiles of padding keys are
// skipped: each would add exactly nothing.  Heavy causal query tiles are
// scheduled first.
//
// Numerics follow the Pallas bodies: the forward and dq scale q before
// the product, dk/dv scales the scores after it; masked scores are the
// finite -1e30, so a row whose first tiles are wholly masked takes
// exp(0) = 1 there and the next real tile's exp(-1e30 - m) = 0 wipes it;
// `out = acc / max(l, 1e-30)`, `lse = m + log(max(l, 1e-30))`; dq/dk/dv
// are float32.  Sums run in another order than the plain PyTorch
// versions (kernels/ref.py), and the products are fused multiply-adds,
// so the two agree to rounding, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;        // query or key rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid
constexpr int kLdP = kTile + 1;  // padded row of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;

// Rows [row0, row0 + kTile) of an (s, HD) slab into a (kTile, HD + 1)
// float32 tile, each value times `mul`; rows past s are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* tile,
                                          const T* __restrict__ src,
                                          int row0, int s, float mul) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = row0 + r;
    tile[r * (HD + 1) + c] =
        row < s ? src[(long long)row * HD + c] * mul : 0.0f;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int kv_len,
                                        int causal, int window) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// A key tile starting at k0 adds nothing to query rows [q0, q0 + kTile).
__device__ __forceinline__ bool tile_masked(int q0, int k0, int kv_len,
                                            int causal, int window) {
  return k0 >= kv_len || (causal && k0 > q0 + kTile - 1) ||
         (window > 0 && k0 + kTile - 1 <= q0 - window);
}

__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- forward -------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int kv_len,
                     int causal, int window, float scale) {
  constexpr int LD = HD + 1, CW = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heavy tiles first
  const T* qb = q + bh * sq * HD;
  const T* kb = k + bh * sk * HD;
  const T* vb = v + bh * sk * HD;

  load_tile<T, HD>(sQ, qb, q0, sq, scale);
  float acc[4][CW], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (tile_masked(q0, k0, kv_len, causal, window)) continue;
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    load_tile<T, HD>(sK, kb, k0, sk, 1.0f);
    load_tile<T, HD>(sV, vb, k0, sk, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(qp, k0 + tx + 16 * j, kv_len, causal, window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < CW; ++c) vv[c] = sV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + (bh * sq + row) * HD;
#pragma unroll
    for (int c = 0; c < CW; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
    if (tx == 0) lse[bh * sq + row] = m[i] + logf(denom);
  }
}

// ---- backward: dq over query tiles, looping key tiles ----------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int sq, int sk, int kv_len,
                        int causal, int window, float scale) {
  constexpr int LD = HD + 1, CW = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const T* kb = k + bh * sk * HD;
  const T* vb = v + bh * sk * HD;

  load_tile<T, HD>(sQ, q + bh * sq * HD, q0, sq, scale);
  load_tile<T, HD>(sDO, dout + bh * sq * HD, q0, sq, 1.0f);
  float lse_r[4], delta_r[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < sq ? lse[bh * sq + row] : 0.0f;
    delta_r[i] = row < sq ? delta[bh * sq + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (tile_masked(q0, k0, kv_len, causal, window)) continue;
    __syncthreads();
    load_tile<T, HD>(sK, kb, k0, sk, 1.0f);
    load_tile<T, HD>(sV, vb, k0, sk, 1.0f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * LD + d];
        dov[i] = sDO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = visible(qp, k0 + tx + 16 * j, kv_len, causal, window)
                             ? s[i][j] : kNegInf;
        const float p = expf(sc - lse_r[i]);
        sDS[(ty * 4 + i) * kLdP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < CW; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    float* drow = dq + (bh * sq + row) * HD;
#pragma unroll
    for (int c = 0; c < CW; ++c) drow[tx + 16 * c] = acc[i][c] * scale;
  }
}

// ---- backward: dk and dv over key tiles, looping query tiles ---------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int kv_len, int causal, int window,
                         float scale) {
  constexpr int LD = HD + 1, CW = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;   // (key row, query row)
  float* sDS = sP + kTile * kLdP;
  float* sL = sDS + kTile * kLdP;
  float* sD = sL + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;  // heavy causal tiles (small k0) first
  const T* qb = q + bh * sq * HD;
  const T* dob = dout + bh * sq * HD;

  load_tile<T, HD>(sK, k + bh * sk * HD, k0, sk, 1.0f);
  load_tile<T, HD>(sV, v + bh * sk * HD, k0, sk, 1.0f);
  float acc_k[4][CW], acc_v[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int q0 = 0; q0 < sq; q0 += kTile) {
    if (tile_masked(q0, k0, kv_len, causal, window)) continue;
    __syncthreads();
    load_tile<T, HD>(sQ, qb, q0, sq, 1.0f);
    load_tile<T, HD>(sDO, dob, q0, sq, 1.0f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = q0 + r;
      sL[r] = row < sq ? lse[bh * sq + row] : 0.0f;
      sD[r] = row < sq ? delta[bh * sq + row] : 0.0f;
    }
    __syncthreads();

    // transposed scores: rows are this block's keys, columns the queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty * 4 + i) * LD + d];
        vv[i] = sV[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + d];
        dov[j] = sDO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const float sc = visible(q0 + qc, kp, kv_len, causal, window)
                             ? s[i][j] * scale : kNegInf;
        const float p = expf(sc - sL[qc]);
        sP[(ty * 4 + i) * kLdP + qc] = p;
        sDS[(ty * 4 + i) * kLdP + qc] = p * (dp[i][j] - sD[qc]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], dov[CW], qv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(ty * 4 + i) * kLdP + qq];
        dsv[i] = sDS[(ty * 4 + i) * kLdP + qq];
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        dov[c] = sDO[qq * LD + tx + 16 * c];
        qv[c] = sQ[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          acc_v[i][c] = fmaf(pv[i], dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
    float* krow = dk + (bh * sk + row) * HD;
    float* vrow = dv + (bh * sk + row) * HD;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      krow[tx + 16 * c] = acc_k[i][c] * scale;
      vrow[tx + 16 * c] = acc_v[i][c];
    }
  }
}

// ---- launchers -------------------------------------------------------------

template <int HD>
constexpr size_t fwd_smem() { return sizeof(float) * (3 * kTile * (HD + 1) + kTile * kLdP); }
template <int HD>
constexpr size_t dq_smem() { return sizeof(float) * (4 * kTile * (HD + 1) + kTile * kLdP); }
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (HD + 1) + 2 * kTile * kLdP + 2 * kTile);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Shape {
  int bh, sq, sk, kv_len, causal, window;
  float scale;
};

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        Shape a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const size_t smem = fwd_smem<HD>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((a.sq + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, a.sq, a.sk,
      a.kv_len, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, Shape a,
           cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, HD>;
  const size_t smem = dq_smem<HD>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((a.sq + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dq,
      a.sq, a.sk, a.kv_len, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, float* dk, float* dv,
            Shape a, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, HD>;
  const size_t smem = dkv_smem<HD>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((a.sk + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dk,
      dv, a.sq, a.sk, a.kv_len, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// Calls F<float, HD>(args...) for float32 inputs (bf16 = 0) of head dim
// 32, 64, 80 (hubert-xlarge's 1280 / 16) or 128; cudaErrorInvalidValue
// for bfloat16 (flash_attention_sm90.cu takes those) or another head dim.
// The tiles need only HD % 16 == 0 (CW = HD / 16 columns a thread); at
// HD 80 the dk/dv kernel's shared memory is 116,736 bytes.
#define FLASH_DISPATCH(F, ...)                                            \
  switch (bf16 ? 0 : hd) {                                                \
    case 32: return F<float, 32>(__VA_ARGS__);                            \
    case 64: return F<float, 64>(__VA_ARGS__);                            \
    case 80: return F<float, 80>(__VA_ARGS__);                            \
    case 128: return F<float, 128>(__VA_ARGS__);                          \
    default: return (int)cudaErrorInvalidValue;                           \
  }

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int bh, int sq, int sk, int kv_len,
                                   int causal, int window, float scale,
                                   int hd, int bf16, void* stream) {
  const Shape a{bh, sq, sk, kv_len, causal, window, scale};
  FLASH_DISPATCH(fwd, q, k, v, out, lse, a, (cudaStream_t)stream)
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dq, int bh,
                                  int sq, int sk, int kv_len, int causal,
                                  int window, float scale, int hd, int bf16,
                                  void* stream) {
  const Shape a{bh, sq, sk, kv_len, causal, window, scale};
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, a,
                 (cudaStream_t)stream)
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   float* dk, float* dv, int bh, int sq,
                                   int sk, int kv_len, int causal, int window,
                                   float scale, int hd, int bf16,
                                   void* stream) {
  const Shape a{bh, sq, sk, kv_len, causal, window, scale};
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, a,
                 (cudaStream_t)stream)
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
