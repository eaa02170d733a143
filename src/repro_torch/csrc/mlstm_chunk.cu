// Chunkwise mLSTM forward (xLSTM's matrix-memory cell), sm_90a.
//
// Replaces the Pallas kernel `mlstm_chunk` of the JAX package
// (src/repro/kernels/mlstm_chunk.py:79, call :90, body `_mlstm_kernel`
// :28).  Inputs: q (pre-scaled by 1/sqrt(hd)), k, v (BH, S, hd) and the
// log forget and input gates log_f, log_i (BH, S), float32 rows.  Per
// chunk of L steps, with b = cumsum(log_f) over the chunk and the state
// (C, n, m) carried from the previous chunk (zeros before the first):
//   m_pos[i]  = max(b[i] + m, max_{j<=i} (b[i] - b[j] + li[j]))
//   num[i, :] = (q[i] C) * exp(b[i] + m - m_pos[i])
//             + sum_{j<=i} (q[i] . k[j]) exp(b[i] - b[j] + li[j] - m_pos[i]) v[j]
//   den[i]    = max(|(q[i] . n) exp(b[i] + m - m_pos[i]) + sum_j scores[i, j]|,
//                   exp(-m_pos[i]))
//   h[i, :]   = num[i, :] / den[i]
// and the carry to the end of the chunk, with kv_w[j] = exp(b[L-1] - b[j]
// + li[j] - m') and m' = max(b[L-1] + m, max_j (b[L-1] - b[j] + li[j])):
//   C' = exp(b[L-1] + m - m') C + sum_j (k[j] kv_w[j])^T v[j],
//   n' = exp(b[L-1] + m - m') n + sum_j k[j] kv_w[j].
// Unlike the Pallas kernel it also writes the final (C, n, m): the state
// that `mlstm_block(return_state=True)` hands to decoding.
//
// What bounds it: operations.  Per (bh, chunk) q C and the C update take
// 2 L hd^2 flop each, q k^T and scores v 2 L^2 hd each: at the prefill's
// (16, 2048, 1024), L 256 that is 171.8 GFLOP per call against ~0.6 GB
// moved, ~280 flop per byte.
//
// Design.  The Pallas kernel keeps all of C (hd x hd float32, 4 MB at
// hd 1024) in VMEM across a sequential chunk axis; a Hopper block has 227
// KB of shared memory.  But value columns are independent: num[:, e] and
// the update of C[:, e] need only C[:, e] and v[:, e], while the
// stabilizers, n, the denominators and the gated L x L scores depend on q,
// k and the gates alone.  So the grid is (bh, column tile of TE = 128
// value columns, fewer when hd is small) and each block walks the chunks
// in order.  Its slice of C (hd x TE) lives in the output C itself, in
// device memory (L2 at these sizes), read as the B operand of q C and
// rewritten once per chunk by the update; a block is the only reader and
// writer of its columns, so __syncthreads orders it (no read-only cache
// path on C).  Each block recomputes the scores of its (bh, chunk), one
// 64-row tile of queries at a time into shared memory (j-major, causal
// tiles only): ~1.5x the least work at the prefill shape in exchange for
// no second pass and no cross-block dependence.  Every product is a
// 64 x TE register-tiled loop on the CUDA cores in float32 (explicit
// fmaf; 256 threads, 4 rows x TE/16 columns each), fed through shared
// memory in depth-32 steps; tensor cores (TF32) would round the inputs to
// 10 mantissa bits.  A simple, right kernel first: no double buffering,
// no wgmma.  One launch per call.
//
// Numerics follow the plain version (kernels/ref.py:mlstm_chunk_plain):
// the cumulative sum in step order, masked (query, key) pairs add exact
// zeros (the stabilizer's max starts from the finite -1e30), the
// exponentials are expf, products are rounded as the plain version rounds
// them (built with --fmad=false; fmaf only inside the dot products).  Sums
// run in another order, so the two agree to rounding, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kRows = 64;         // rows of an output tile
constexpr int kBK = 32;           // contraction depth staged per step
constexpr int kLdA = kRows + 4;   // k-major A tile row: float4-aligned, padded
constexpr float kNegInf = -1e30f;

// acc[r][c] += sum_kk A[kk][ty*4 + r] * B[kk][tx*TN + c] over kk < kc; A is
// a k-major (kc, 64) tile with row stride kLdA, B a (kc, 16*TN) tile with
// row stride ldb.
template <int TN>
__device__ __forceinline__ void mac(const float* As, const float* Bs, int ldb,
                                    int kc, int ty, int tx,
                                    float (&acc)[4][TN]) {
#pragma unroll 4
  for (int kk = 0; kk < kc; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(As + kk * kLdA + ty * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[TN];
    const float* bp = Bs + kk * ldb + tx * TN;
    if constexpr (TN % 4 == 0) {
#pragma unroll
      for (int c = 0; c < TN; c += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bp + c);
        b[c] = b4.x; b[c + 1] = b4.y; b[c + 2] = b4.z; b[c + 3] = b4.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = bp[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Transposing load: dst[kk * ld + r] = src[r * stride + kk] for the NC rows
// r of a row-major source and kk < kBK; zero where r >= nvalid or
// kk >= kc.  kc is a multiple of 4 and src 16-byte aligned.
template <int NC>
__device__ __forceinline__ void load_t(float* dst, int ld, const float* src,
                                       long long stride, int nvalid, int kc,
                                       int tid) {
  for (int idx = tid; idx < NC * (kBK / 4); idx += kThreads) {
    const int r = idx >> 3, k4 = (idx & 7) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < nvalid && k4 < kc)
      val = *reinterpret_cast<const float4*>(src + r * stride + k4);
    dst[(k4 + 0) * ld + r] = val.x;
    dst[(k4 + 1) * ld + r] = val.y;
    dst[(k4 + 2) * ld + r] = val.z;
    dst[(k4 + 3) * ld + r] = val.w;
  }
}

// Direct load: dst[kk * ld + c] = src[kk * stride + c] (times scale[kk]
// when given) for kk < kBK, c < NC; zero where kk >= kc or c >= cvalid
// (a multiple of 4).
template <int NC>
__device__ __forceinline__ void load_d(float* dst, int ld, const float* src,
                                       long long stride, int kc, int cvalid,
                                       const float* scale, int tid) {
  constexpr int kPerRow = NC / 4;
  for (int idx = tid; idx < kBK * kPerRow; idx += kThreads) {
    const int kk = idx / kPerRow, c4 = (idx % kPerRow) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kk < kc && c4 < cvalid) {
      val = *reinterpret_cast<const float4*>(src + kk * stride + c4);
      if (scale != nullptr) {
        const float s = scale[kk];
        val.x *= s; val.y *= s; val.z *= s; val.w *= s;
      }
    }
    *reinterpret_cast<float4*>(dst + kk * ld + c4) = val;
  }
}

template <int TE>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lf,
                   const float* __restrict__ li, float* __restrict__ h,
                   float* C, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int hd, int L) {
  constexpr int TN = TE / 16;
  constexpr int kLdB = TE + 4;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                     // (kBK, kLdA)
  float* Bs = As + kBK * kLdA;          // (kBK, kLdB)
  float* St = Bs + kBK * kLdB;          // (L, kLdA): one row tile's scores
  float* ns = St + L * kLdA;            // (hd,) n
  float* g_b = ns + hd;                 // (L,) each: cumsum(log_f),
  float* g_li = g_b + L;                //   log_i,
  float* g_mpos = g_li + L;             //   m_pos,
  float* g_iw = g_mpos + L;             //   the inter-chunk weight,
  float* g_den = g_iw + L;              //   the denominator,
  float* g_kvw = g_den + L;             //   kv_w,
  float* g_qn = g_kvw + L;              //   q . n_prev

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * TE;
  const long long row0 = (long long)bh * S;
  const float* qb = q + row0 * hd;
  const float* kb = k + row0 * hd;
  const float* vb = v + row0 * hd;
  float* Cb = C + (long long)bh * hd * hd;

  for (int d = tid; d < hd; d += kThreads) ns[d] = 0.0f;
  float m_prev = 0.0f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const float* qc = qb + (long long)t0 * hd;
    const float* kc_rows = kb + (long long)t0 * hd;
    const float* vc = vb + (long long)t0 * hd;
    const bool first = t0 == 0;

    // ---- gates and stabilizers of the chunk ----
    if (tid < L) {
      g_b[tid] = lf[row0 + t0 + tid];
      g_li[tid] = li[row0 + t0 + tid];
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int i = 0; i < L; ++i) { s += g_b[i]; g_b[i] = s; }
    }
    __syncthreads();
    const float b_last = g_b[L - 1];
    float mx_last = kNegInf;
    for (int j = 0; j < L; ++j)
      mx_last = fmaxf(mx_last, (b_last - g_b[j]) + g_li[j]);
    const float m_new = fmaxf(b_last + m_prev, mx_last);
    const float carry_w = expf((b_last + m_prev) - m_new);
    if (tid < L) {
      const float bi = g_b[tid];
      float mx = kNegInf;
      for (int j = 0; j <= tid; ++j) mx = fmaxf(mx, (bi - g_b[j]) + g_li[j]);
      const float mpos = fmaxf(bi + m_prev, mx);
      g_mpos[tid] = mpos;
      g_iw[tid] = expf((bi + m_prev) - mpos);
      g_kvw[tid] = expf(((b_last - bi) + g_li[tid]) - m_new);
    }
    // q . n_prev, one warp per row
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int i = warp; i < L; i += kThreads / 32) {
        const float* qr = qc + (long long)i * hd;
        float s = 0.0f;
        for (int d = lane; d < hd; d += 32) s = fmaf(qr[d], ns[d], s);
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) g_qn[i] = s;
      }
    }
    __syncthreads();

    // ---- outputs, one tile of 64 query rows at a time ----
    for (int i0 = 0; i0 < L; i0 += kRows) {
      const int rows = min(kRows, L - i0);
      const int jend = min(L, i0 + kRows);      // causal: keys j < jend
      const float* qt = qc + (long long)i0 * hd;

      // gated scores S[i, j] = (q[i] . k[j]) w[i, j], j-major into St
      for (int j0 = 0; j0 < jend; j0 += TE) {
        float acc[4][TN] = {};
        for (int d0 = 0; d0 < hd; d0 += kBK) {
          const int kd = min(kBK, hd - d0);
          load_t<kRows>(As, kLdA, qt + d0, hd, rows, kd, tid);
          load_t<TE>(Bs, kLdB, kc_rows + (long long)j0 * hd + d0, hd,
                     min(TE, jend - j0), kd, tid);
          __syncthreads();
          mac<TN>(As, Bs, kLdB, kd, ty, tx, acc);
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            const int j = j0 + tx * TN + c;
            if (j < jend) {
              float val = 0.0f;
              if (i < L && j <= i)
                val = acc[r][c] *
                      expf(((g_b[i] - g_b[j]) + g_li[j]) - g_mpos[i]);
              St[j * kLdA + ty * 4 + r] = val;
            }
          }
        }
      }
      __syncthreads();
      if (tid < rows) {
        const int i = i0 + tid;
        float s = 0.0f;
        for (int j = 0; j <= i; ++j) s += St[j * kLdA + tid];
        g_den[i] = fmaxf(fabsf(g_qn[i] * g_iw[i] + s), expf(-g_mpos[i]));
      }
      __syncthreads();

      float acc[4][TN] = {};
      if (!first) {          // the inter-chunk term (q C) * inter_w
        for (int d0 = 0; d0 < hd; d0 += kBK) {
          const int kd = min(kBK, hd - d0);
          load_t<kRows>(As, kLdA, qt + d0, hd, rows, kd, tid);
          load_d<TE>(Bs, kLdB, Cb + (long long)d0 * hd + e0, hd, kd, TE,
                     nullptr, tid);
          __syncthreads();
          mac<TN>(As, Bs, kLdB, kd, ty, tx, acc);
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          const float w = i < L ? g_iw[i] : 0.0f;
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] *= w;
        }
      }
      for (int j0 = 0; j0 < jend; j0 += kBK) {   // + scores v
        const int kj = min(kBK, jend - j0);
        load_d<TE>(Bs, kLdB, vc + (long long)j0 * hd + e0, hd, kj, TE,
                   nullptr, tid);
        __syncthreads();
        mac<TN>(St + j0 * kLdA, Bs, kLdB, kj, ty, tx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i < L) {
          const float den = g_den[i];
          float* hp = h + (row0 + t0 + i) * hd + e0 + tx * TN;
#pragma unroll
          for (int c = 0; c < TN; ++c) hp[c] = acc[r][c] / den;
        }
      }
    }

    // ---- carry the state to the end of the chunk ----
    for (int d0 = 0; d0 < hd; d0 += kRows) {
      const int dv = min(kRows, hd - d0);
      float acc[4][TN] = {};
      for (int j0 = 0; j0 < L; j0 += kBK) {
        const int kj = min(kBK, L - j0);
        load_d<kRows>(As, kLdA, kc_rows + (long long)j0 * hd + d0, hd, kj,
                      dv, g_kvw + j0, tid);
        load_d<TE>(Bs, kLdB, vc + (long long)j0 * hd + e0, hd, kj, TE,
                   nullptr, tid);
        __syncthreads();
        mac<TN>(As, Bs, kLdB, kj, ty, tx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = d0 + ty * 4 + r;
        if (d < hd) {
          float* cp = Cb + (long long)d * hd + e0 + tx * TN;
#pragma unroll
          for (int c = 0; c < TN; ++c)
            cp[c] = first ? acc[r][c] : carry_w * cp[c] + acc[r][c];
        }
      }
    }
    for (int d = tid; d < hd; d += kThreads) {
      float s = 0.0f;
      for (int j = 0; j < L; ++j) s += kc_rows[(long long)j * hd + d] * g_kvw[j];
      ns[d] = carry_w * ns[d] + s;
    }
    m_prev = m_new;
    __syncthreads();
  }

  if (blockIdx.y == 0) {
    for (int d = tid; d < hd; d += kThreads) n_out[(long long)bh * hd + d] = ns[d];
    if (tid == 0) m_out[bh] = m_prev;
  }
}

template <int TE>
int launch(const float* q, const float* k, const float* v, const float* lf,
           const float* li, float* h, float* C, float* n, float* m, int bh,
           int s, int hd, int l, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBK * kLdA + kBK * (TE + 4) +
                                       (size_t)l * kLdA + hd + 7 * (size_t)l);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<TE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)(hd / TE));
  mlstm_chunk_kernel<TE><<<grid, kThreads, smem, stream>>>(
      q, k, v, lf, li, h, C, n, m, s, hd, l);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, h (bh, s, hd); lf, li (bh, s); C (bh, hd, hd), n (bh, hd),
// m (bh,) are written (C is also the kernel's working state); s a multiple
// of the chunk l, 1 <= l <= 256, hd a multiple of 16, all float32,
// contiguous and 16-byte aligned.
extern "C" int mlstm_chunk_f32(const float* q, const float* k, const float* v,
                               const float* lf, const float* li, float* h,
                               float* C, float* n, float* m, int bh, int s,
                               int hd, int l, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd % 128 == 0) return launch<128>(q, k, v, lf, li, h, C, n, m, bh, s, hd, l, st);
  if (hd % 64 == 0) return launch<64>(q, k, v, lf, li, h, C, n, m, bh, s, hd, l, st);
  if (hd % 32 == 0) return launch<32>(q, k, v, lf, li, h, C, n, m, bh, s, hd, l, st);
  return launch<16>(q, k, v, lf, li, h, C, n, m, bh, s, hd, l, st);
}

extern "C" const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
