// Chunkwise mLSTM backward (xLSTM's matrix-memory cell), sm_90a, float32
// on the CUDA cores.
//
// Replaces no Pallas kernel: the JAX package's `mlstm_chunk` kernel
// (src/repro/kernels/mlstm_chunk.py) has no backward, and the reference
// trains xLSTM by differentiating its jnp chunk scan with jax.grad
// (src/repro/models/ssm.py:198-264).  The port's forward is the kernel of
// mlstm_chunk_sm90.cu; a plain version may not run on the card's training
// path, so the gradient is this kernel.
//
// It computes the gradient of kernels/ref.py:mlstm_chunk_plain's h for an
// upstream gradient dh (BH, S, hd), w.r.t. q, k, v, log_f and log_i, as
// kernels/ref.py:mlstm_chunk_bwd_plain writes it out (the formulas are in
// its docstring).  In unstabilized terms h_i = N_i / max(|D_i|, 1), so h
// depends on no stabilizer and every stabilizer (the rows' m_pos, the
// carried m) is a constant of the backward; a clamped denominator passes
// no gradient.  The final state (C, n, m) is not differentiated.
//
// What bounds it: operations.  Per chunk past the first, five state
// products of 2 L hd^2 flop (the chunk-start C recomputed, X = dh C^T, the
// state gradient's (iw q / den)^T dh, and the keys' and values' state
// terms v dC^T and k dC), and per chunk five causal halves of L(L+1) hd
// (q k^T, dh v^T, ds k, ds^T q, s^T dh): at the training shape (16, 512,
// 1024), L 256, 53.7 GFLOP against 235 MB of inputs and outputs, 0.80 ms
// at 67 TFLOP/s and 0.07 ms at 3.35 TB/s.  Design, for a first kernel that
// is right: every product is one 128x128 output tile a block of 256
// threads, 8x8 outputs a thread in registers (four 4x4 quadrants 64 apart,
// so a warp's shared reads hit distinct banks), the operands staged
// through shared memory 16 deep, each product an fmaf; no tensor cores
// yet.  C of one head (4 MiB at hd 1,024) fits no shared memory, so the
// state walks go per 128x128 tile of C (or of dC), each tile independent
// of the others and carried in registers from chunk to chunk.
//
// Nine grids per call, on the caller's stream (one launch counted):
// 1. gates, one block per bh walking the chunks: b = cumsum(log_f) (in
//    order, by one thread), m_pos, the state term's weight iw, the key
//    weights kvw, the carry weight and the state update's stabilizer, each
//    with the plain version's expression.
// 2. states, grid (128x128 tile of C, bh) walking the chunks forward: the
//    chunk-start C (and n, in the tiles of column 0) into scratch.
// 3. xproj, grid (128-column tile, 128-row tile x chunk, bh): X = dh C^T.
// 4. scores, grid (128x128 (query, key) tile at or below the diagonal,
//    chunk, bh): the raw scores q k^T and A = dh v^T.
// 5. rows, a warp per (bh, query row): the gated scores s, den, the
//    clamp, g, and each row's ds = dscores w, P = dscores s (written over
//    the raw scores), d log iw and the row sums of P.
// 6. intra, grid (128-column tile, 128-row tile x chunk, 3 x bh): dq = ds k
//    + iw (X / den + g n), dk = ds^T q, dv = s^T (dh / den).
// 7. dstates, grid (128x128 tile of dC, bh) walking the chunks backward: the
//    gradient into each chunk-start state, dC <- carry dC + (iw q /
//    den)^T dh (dn in the tiles of column 0), and the carry weight's
//    <C, dC> and <n, dn> as per-tile partial sums.
// 8. stateterms, grid (128-column tile, 128-row tile x chunk, 2 x bh): dk +=
//    kvw (v dC^T + dn), dv += kvw (k dC), and k . (dk's state term) as
//    per-tile partial sums.
// 9. finish, one block per bh: the column sums of P, the partial sums in a
//    fixed order, d log_i, and d log_f as the reverse cumulative sum of the
//    cumulative log forget's gradient within each chunk (in order, by one
//    thread).
// No atomics: every sum is a fixed tree or a fixed order, so two calls on
// the same inputs give the same bits.
//
// Numerics: built with --fmad=false; every product in the tiles is an
// explicit fmaf, every other product of two float32 values is rounded
// before it is added, and the gates use expf, as the plain version rounds
// them.  Sums run in another order, so the two agree to rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxChunk = 256;
constexpr int kT = 128;       // output tile edge
constexpr int kM = kT / 16;   // outputs a thread holds per row and column
constexpr int kK = 16;        // contraction depth staged per step
constexpr int kLd = kT + 4;   // shared row stride (floats), 16-byte rows
constexpr int kThreads = 256;

struct Dims {
  int bh, s, hd, l, nc;
  __host__ __device__ int th() const { return (hd + kT - 1) / kT; }
  __host__ __device__ int tl() const { return (l + kT - 1) / kT; }
};

// Scratch, float32 throughout: offsets from one base.
struct Scratch {
  float *b, *mpos, *iw, *kvw, *carry;   // gates
  float *cs, *ns;                       // chunk-start C (bh, nc, hd, hd), n
  float *x;                             // X = dh C^T (bh, s, hd)
  float *sm, *am, *pm;                  // (bh, nc, l, l): s, ds, P
  float *inv, *g, *r, *rowp;            // per row: 1 / den, g, d log iw, sum P
  float *dcs, *dns;                     // gradient into chunk-start C, n
  float *up, *tp;                       // partial sums: <C, dC>, k . dk
  size_t bytes;
  Scratch(const Dims& d, void* base) {
    float* p = static_cast<float*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      float* q = p ? p + off : nullptr;
      off += (n + 63) & ~size_t(63);    // 256-byte aligned pieces
      return q;
    };
    const size_t bs = (size_t)d.bh * d.s, bc = (size_t)d.bh * d.nc,
                 hh = (size_t)d.hd * d.hd, ll = (size_t)d.l * d.l;
    b = take(bs), mpos = take(bs), iw = take(bs), kvw = take(bs),
    carry = take(bc);
    cs = take(bc * hh), ns = take(bc * d.hd);
    x = take(bs * d.hd);
    sm = take(bc * ll), am = take(bc * ll), pm = take(bc * ll);
    inv = take(bs), g = take(bs), r = take(bs), rowp = take(bs);
    dcs = take(bc * hh), dns = take(bc * d.hd);
    up = take(bc * (size_t)(d.th() * d.th() + d.th()));
    tp = take(bs * d.th());
    bytes = off * sizeof(float);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// acc += A (kT rows x [k_lo, k_hi)) B ([k_lo, k_hi) x kT columns), the
// thread's outputs at rows mrow(i), columns mcol(j).  fa(r, k) and fb(k, c)
// give the operands (0 outside the
// tile's rows or columns); kA / kB say the operand's contraction index is
// the contiguous one in memory, so the loads walk it across threads.
template <bool kA, bool kB, class FA, class FB>
__device__ __forceinline__ void tile_mm(float (&acc)[kM][kM], const FA& fa,
                                        const FB& fb, int k_lo, int k_hi,
                                        float* sa, float* sb) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_lo; k0 < k_hi; k0 += kK) {
#pragma unroll
    for (int u = 0; u < kT * kK / kThreads; ++u) {
      const int idx = tid + kThreads * u;
      int kk = kA ? idx % kK : idx / kT, rr = kA ? idx / kK : idx % kT;
      sa[kk * kLd + rr] = k0 + kk < k_hi ? fa(rr, k0 + kk) : 0.0f;
      kk = kB ? idx % kK : idx / kT;
      rr = kB ? idx / kK : idx % kT;
      sb[kk * kLd + rr] = k0 + kk < k_hi ? fb(k0 + kk, rr) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float a[kM], b[kM];
#pragma unroll
      for (int h = 0; h < kM / 4; ++h) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            sa + kk * kLd + h * 64 + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(
            sb + kk * kLd + h * 64 + tx * 4);
        a[4 * h] = a4.x, a[4 * h + 1] = a4.y, a[4 * h + 2] = a4.z,
        a[4 * h + 3] = a4.w;
        b[4 * h] = b4.x, b[4 * h + 1] = b4.y, b[4 * h + 2] = b4.z,
        b[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int j = 0; j < kM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The thread's output row i and column j of a tile: kM / 4 quadrants of
// 4 x 4, 64 rows (columns) apart, so that a warp's shared reads of one
// k slice hit distinct banks.
__device__ __forceinline__ int mrow(int i) {
  return (i >> 2) * 64 + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int mcol(int j) {
  return (j >> 2) * 64 + (threadIdx.x % 16) * 4 + (j & 3);
}

__device__ __forceinline__ void zero(float (&acc)[kM][kM]) {
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kM; ++j) acc[i][j] = 0.0f;
}

// The sum of every thread's `x` over the block (256 threads), in a fixed
// order: each warp's tree, then the warps in order by thread 0.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// ---- 1. gates --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_gates(const float* __restrict__ lf, const float* __restrict__ li,
          Scratch sc, Dims d) {
  __shared__ float sbv[kMaxChunk], sli[kMaxChunk];
  __shared__ float s_mnew;
  const int bh = blockIdx.x, tid = threadIdx.x, L = d.l;
  float m = 0.0f;
  for (int c = 0; c < d.nc; ++c) {
    const long long base = (long long)bh * d.s + (long long)c * L;
    if (tid < L) {
      sbv[tid] = lf[base + tid];
      sli[tid] = li[base + tid];
    }
    __syncthreads();
    if (tid == 0) {                       // cumsum in order
      float acc = 0.0f;
      for (int i = 0; i < L; ++i) sbv[i] = acc = acc + sbv[i];
      const float bl = sbv[L - 1];
      float mx = kNegInf;
      for (int j = 0; j < L; ++j) mx = fmaxf(mx, (bl - sbv[j]) + sli[j]);
      s_mnew = fmaxf(bl + m, mx);
    }
    __syncthreads();
    const float bl = sbv[L - 1], m_new = s_mnew;
    if (tid < L) {
      const float bi = sbv[tid];
      float mx = kNegInf;
      for (int j = 0; j <= tid; ++j) mx = fmaxf(mx, (bi - sbv[j]) + sli[j]);
      const float mp = fmaxf(bi + m, mx);
      sc.b[base + tid] = bi;
      sc.mpos[base + tid] = mp;
      sc.iw[base + tid] = expf((bi + m) - mp);
      sc.kvw[base + tid] = expf(((bl - bi) + sli[tid]) - m_new);
    }
    if (tid == 0) sc.carry[(long long)bh * d.nc + c] = expf((bl + m) - m_new);
    m = m_new;
    __syncthreads();
  }
}

// ---- 2. the chunk-start states ---------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_states(const float* __restrict__ k, const float* __restrict__ v,
           Scratch sc, Dims d) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  const int bh = blockIdx.y, th = d.th();
  const int d0 = (blockIdx.x / th) * kT, e0 = (blockIdx.x % th) * kT;
  const int tid = threadIdx.x, hd = d.hd;
  const float* kb = k + (long long)bh * d.s * hd;
  const float* vb = v + (long long)bh * d.s * hd;
  const float* kvw = sc.kvw + (long long)bh * d.s;
  float C[kM][kM];
  zero(C);
  float n = 0.0f;                         // n[d0 + tid] in the column-0 tiles
  const bool has_n = e0 == 0 && tid < kT && d0 + tid < hd;
  for (int c = 0; c < d.nc; ++c) {
    const long long cb = (long long)bh * d.nc + c;
    float* cs = sc.cs + cb * hd * hd;
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int r = d0 + mrow(i), col = e0 + mcol(j);
        if (r < hd && col < hd) cs[(long long)r * hd + col] = C[i][j];
      }
    if (has_n) sc.ns[cb * hd + d0 + tid] = n;
    if (c == d.nc - 1) break;
    const long long row0 = (long long)c * d.l;
    const float cw = sc.carry[cb];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) C[i][j] = cw * C[i][j];
    tile_mm<false, false>(
        C,
        [&](int r, int j) {
          return d0 + r < hd ? kb[(row0 + j) * hd + d0 + r] * kvw[row0 + j]
                             : 0.0f;
        },
        [&](int j, int col) {
          return e0 + col < hd ? vb[(row0 + j) * hd + e0 + col] : 0.0f;
        },
        0, d.l, sa, sb);
    if (has_n) {
      float s = 0.0f;
      for (int j = 0; j < d.l; ++j)
        s += kb[(row0 + j) * hd + d0 + tid] * kvw[row0 + j];
      n = cw * n + s;
    }
  }
}

// ---- 3. X = dh C^T -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_xproj(const float* __restrict__ dh, Scratch sc, Dims d) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  const int tl = d.tl(), c = blockIdx.y / tl, i0 = (blockIdx.y % tl) * kT,
            d0 = blockIdx.x * kT, bh = blockIdx.z, hd = d.hd;
  const long long row0 = (long long)bh * d.s + (long long)c * d.l;
  float acc[kM][kM];
  zero(acc);
  if (c > 0) {                            // the first chunk starts from C = 0
    const float* cs = sc.cs + ((long long)bh * d.nc + c) * hd * hd;
    tile_mm<true, true>(
        acc,
        [&](int r, int e) {
          return i0 + r < d.l ? dh[(row0 + i0 + r) * hd + e] : 0.0f;
        },
        [&](int e, int col) {
          return d0 + col < hd ? cs[(long long)(d0 + col) * hd + e] : 0.0f;
        },
        0, hd, sa, sb);
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      const int r = i0 + mrow(i), col = d0 + mcol(j);
      if (r < d.l && col < hd) sc.x[(row0 + r) * hd + col] = acc[i][j];
    }
}

// ---- 4. raw scores q k^T and A = dh v^T ------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_scores(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dh,
           Scratch sc, Dims d) {
  const int tl = d.tl(), ti = blockIdx.x / tl, tj = blockIdx.x % tl;
  if (tj > ti) return;                    // above the diagonal: never read
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  const int c = blockIdx.y, bh = blockIdx.z, hd = d.hd, L = d.l;
  const int i0 = ti * kT, j0 = tj * kT;
  const long long row0 = (long long)bh * d.s + (long long)c * L;
  const long long mb = ((long long)bh * d.nc + c) * L * L;
  for (int which = 0; which < 2; ++which) {
    const float* a = which ? dh : q;
    const float* b = which ? v : k;
    float acc[kM][kM];
    zero(acc);
    tile_mm<true, true>(
        acc,
        [&](int r, int e) {
          return i0 + r < L ? a[(row0 + i0 + r) * hd + e] : 0.0f;
        },
        [&](int e, int col) {
          return j0 + col < L ? b[(row0 + j0 + col) * hd + e] : 0.0f;
        },
        0, hd, sa, sb);
    float* out = (which ? sc.am : sc.sm) + mb;
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int r = i0 + mrow(i), col = j0 + mcol(j);
        if (r < L && col < L) out[(long long)r * L + col] = acc[i][j];
      }
  }
}

// ---- 5. the rows' statistics -----------------------------------------------

constexpr int kRowWarps = kThreads / 32;
constexpr int kPerLane = kMaxChunk / 32;

__global__ void __launch_bounds__(kThreads)
bwd_rows(const float* __restrict__ q, const float* __restrict__ li,
         Scratch sc, Dims d) {
  const int lane = threadIdx.x & 31, L = d.l, hd = d.hd;
  const int i = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int c = blockIdx.y, bh = blockIdx.z;
  if (i >= L) return;
  const long long row0 = (long long)bh * d.s + (long long)c * L;
  const long long gi = row0 + i;
  const float* nc = sc.ns + ((long long)bh * d.nc + c) * hd;
  const float* qi = q + gi * hd;
  const float* xi = sc.x + gi * hd;
  float qn = 0.0f, qx = 0.0f;
  for (int e = lane; e < hd; e += 32) {
    qn += qi[e] * nc[e];
    qx += qi[e] * xi[e];
  }
  qn = warp_sum(qn);
  qx = warp_sum(qx);
  const long long mrow = ((long long)bh * d.nc + c) * L * L + (long long)i * L;
  float* srow = sc.sm + mrow;
  float* arow = sc.am + mrow;
  float* prow = sc.pm + mrow;
  const float bi = sc.b[gi], mp = sc.mpos[gi], iw = sc.iw[gi];
  float w[kPerLane], s[kPerLane], a[kPerLane];
  float rs = 0.0f, rsa = 0.0f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int j = lane + 32 * u;
    w[u] = s[u] = a[u] = 0.0f;
    if (j <= i) {
      w[u] = expf(((bi - sc.b[row0 + j]) + li[row0 + j]) - mp);
      s[u] = srow[j] * w[u];
      a[u] = arow[j];
      rs += s[u];
      rsa += s[u] * a[u];
    }
  }
  rs = warp_sum(rs);
  rsa = warp_sum(rsa);
  const float den_pre = iw * qn + rs, floor_ = expf(-mp);
  const float den = fmaxf(fabsf(den_pre), floor_);
  const float hnum = iw * qx + rsa;
  const float g = fabsf(den_pre) > floor_
                      ? -(hnum * sgn(den_pre)) / (den * den) : 0.0f;
  const float inv = 1.0f / den;
  float rp = 0.0f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j < L) {
      float dsc = 0.0f, p = 0.0f, ds = 0.0f;
      if (j <= i) {
        dsc = a[u] * inv + g;
        ds = dsc * w[u];
        p = dsc * s[u];
        rp += p;
      }
      srow[j] = s[u];
      arow[j] = ds;
      prow[j] = p;
    }
  }
  rp = warp_sum(rp);
  if (lane == 0) {
    sc.inv[gi] = inv;
    sc.g[gi] = g;
    sc.r[gi] = iw * (qx * inv + g * qn);
    sc.rowp[gi] = rp;
  }
}

// ---- 6. the intra-chunk terms ----------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_intra(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ dh, float* __restrict__ dq,
          float* __restrict__ dk, float* __restrict__ dv, Scratch sc,
          Dims d) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  const int tl = d.tl(), c = blockIdx.y / tl, r0 = (blockIdx.y % tl) * kT,
            c0 = blockIdx.x * kT, bh = blockIdx.z / 3, which = blockIdx.z % 3;
  const int hd = d.hd, L = d.l;
  const long long row0 = (long long)bh * d.s + (long long)c * L;
  const long long mb = ((long long)bh * d.nc + c) * L * L;
  const float* ds = sc.am + mb;
  const float* sm = sc.sm + mb;
  float acc[kM][kM];
  zero(acc);
  if (which == 0) {          // dq[i] = sum_{j <= i} ds[i, j] k[j]
    tile_mm<true, false>(
        acc,
        [&](int r, int j) {
          return r0 + r < L ? ds[(long long)(r0 + r) * L + j] : 0.0f;
        },
        [&](int j, int col) {
          return c0 + col < hd ? k[(row0 + j) * hd + c0 + col] : 0.0f;
        },
        0, min(L, r0 + kT), sa, sb);
  } else if (which == 1) {   // dk[j] = sum_{i >= j} ds[i, j] q[i]
    tile_mm<false, false>(
        acc,
        [&](int r, int i) {
          return r0 + r < L ? ds[(long long)i * L + r0 + r] : 0.0f;
        },
        [&](int i, int col) {
          return c0 + col < hd ? q[(row0 + i) * hd + c0 + col] : 0.0f;
        },
        r0, L, sa, sb);
  } else {                   // dv[j] = sum_{i >= j} s[i, j] dh[i] / den[i]
    tile_mm<false, false>(
        acc,
        [&](int r, int i) {
          return r0 + r < L ? sm[(long long)i * L + r0 + r] : 0.0f;
        },
        [&](int i, int col) {
          return c0 + col < hd ? dh[(row0 + i) * hd + c0 + col] * sc.inv[row0 + i]
                               : 0.0f;
        },
        r0, L, sa, sb);
  }
  float* out = which == 0 ? dq : (which == 1 ? dk : dv);
  const float* nc = sc.ns + ((long long)bh * d.nc + c) * hd;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    const int r = r0 + mrow(i);
    if (r >= L) continue;
    const long long gr = row0 + r;
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      const int col = c0 + mcol(j);
      if (col >= hd) continue;
      float val = acc[i][j];
      if (which == 0)
        val = val + sc.iw[gr] * (sc.x[gr * hd + col] * sc.inv[gr] +
                                 sc.g[gr] * nc[col]);
      out[gr * hd + col] = val;
    }
  }
}

// ---- 7. the state gradients, walking back ----------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_dstates(const float* __restrict__ q, const float* __restrict__ dh,
            Scratch sc, Dims d) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.y, th = d.th(), tile = blockIdx.x;
  const int d0 = (tile / th) * kT, e0 = (tile % th) * kT;
  const int tid = threadIdx.x, hd = d.hd, L = d.l;
  const long long qb = (long long)bh * d.s;
  const int nup = th * th + th;
  float G[kM][kM];
  zero(G);                                // into the state after the last chunk
  float dn = 0.0f;                        // dn[d0 + tid] in the column-0 tiles
  const bool has_n = e0 == 0 && tid < kT && d0 + tid < hd;
  for (int c = d.nc - 1; c >= 1; --c) {
    const long long cb = (long long)bh * d.nc + c;
    const float cw = sc.carry[cb];
    if (c < d.nc - 1) {                   // <C_c, dC_{c+1}>, <n_c, dn_{c+1}>
      const float* cs = sc.cs + cb * hd * hd;
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          const int r = d0 + mrow(i), col = e0 + mcol(j);
          if (r < hd && col < hd) part += cs[(long long)r * hd + col] * G[i][j];
        }
      part = block_sum(part, red);
      if (tid == 0) sc.up[cb * nup + tile] = part;
      if (e0 == 0) {
        float pn = has_n ? sc.ns[cb * hd + d0 + tid] * dn : 0.0f;
        pn = block_sum(pn, red);
        if (tid == 0) sc.up[cb * nup + th * th + d0 / kT] = pn;
      }
    }
    const long long row0 = qb + (long long)c * L;
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) G[i][j] = cw * G[i][j];
    tile_mm<false, false>(
        G,
        [&](int r, int i) {
          return d0 + r < hd ? q[(row0 + i) * hd + d0 + r] *
                                   (sc.iw[row0 + i] * sc.inv[row0 + i])
                             : 0.0f;
        },
        [&](int i, int col) {
          return e0 + col < hd ? dh[(row0 + i) * hd + e0 + col] : 0.0f;
        },
        0, L, sa, sb);
    float* dcs = sc.dcs + cb * hd * hd;
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int r = d0 + mrow(i), col = e0 + mcol(j);
        if (r < hd && col < hd) dcs[(long long)r * hd + col] = G[i][j];
      }
    if (has_n) {
      float s = 0.0f;
      for (int i = 0; i < L; ++i)
        s += (sc.iw[row0 + i] * sc.g[row0 + i]) * q[(row0 + i) * hd + d0 + tid];
      dn = cw * dn + s;
      sc.dns[cb * hd + d0 + tid] = dn;
    }
  }
}

// ---- 8. the keys' and values' state terms ----------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_stateterms(const float* __restrict__ k, const float* __restrict__ v,
               float* __restrict__ dk, float* __restrict__ dv, Scratch sc,
               Dims d) {
  __shared__ __align__(16) float sa[kK * kLd], sb[kK * kLd];
  __shared__ float tpart[kT][17];
  const int tl = d.tl(), c = blockIdx.y / tl, r0 = (blockIdx.y % tl) * kT,
            c0 = blockIdx.x * kT, bh = blockIdx.z / 2, which = blockIdx.z % 2;
  const int tid = threadIdx.x, tx = tid % 16, hd = d.hd, L = d.l;
  const long long row0 = (long long)bh * d.s + (long long)c * L;
  const long long nb = (long long)bh * d.nc + c + 1;   // the state after c
  const float* dC = sc.dcs + nb * hd * hd;
  const float* dn = sc.dns + nb * hd;
  float acc[kM][kM];
  zero(acc);
  if (which == 0) {          // dk[j] += kvw[j] (v[j] dC^T + dn)
    tile_mm<true, true>(
        acc,
        [&](int r, int e) {
          return r0 + r < L ? v[(row0 + r0 + r) * hd + e] : 0.0f;
        },
        [&](int e, int col) {
          return c0 + col < hd ? dC[(long long)(c0 + col) * hd + e] : 0.0f;
        },
        0, hd, sa, sb);
  } else {                   // dv[j] += kvw[j] (k[j] dC)
    tile_mm<true, false>(
        acc,
        [&](int r, int e) {
          return r0 + r < L ? k[(row0 + r0 + r) * hd + e] : 0.0f;
        },
        [&](int e, int col) {
          return c0 + col < hd ? dC[(long long)e * hd + c0 + col] : 0.0f;
        },
        0, hd, sa, sb);
  }
  float* out = which == 0 ? dk : dv;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    const int r = r0 + mrow(i);
    float t = 0.0f;
    if (r < L) {
      const long long gr = row0 + r;
      const float kw = sc.kvw[gr];
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int col = c0 + mcol(j);
        if (col >= hd) continue;
        const float val = which == 0 ? kw * (acc[i][j] + dn[col])
                                     : kw * acc[i][j];
        out[gr * hd + col] = out[gr * hd + col] + val;
        if (which == 0) t += k[gr * hd + col] * val;
      }
    }
    if (which == 0) tpart[mrow(i)][tx] = t;
  }
  if (which == 0) {
    __syncthreads();
    if (tid < kT && r0 + tid < L) {
      float t = 0.0f;
      for (int x = 0; x < 16; ++x) t += tpart[tid][x];
      sc.tp[(row0 + r0 + tid) * d.th() + blockIdx.x] = t;
    }
  }
}

// ---- 9. the gates' gradients -------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_finish(float* __restrict__ dlf, float* __restrict__ dli, Scratch sc,
           Dims d) {
  __shared__ float sdb[kMaxChunk], st[kMaxChunk];
  const int bh = blockIdx.x, tid = threadIdx.x, L = d.l, th = d.th();
  const int nup = th * th + th;
  for (int c = 0; c < d.nc; ++c) {
    const long long cb = (long long)bh * d.nc + c;
    const long long row0 = (long long)bh * d.s + (long long)c * L;
    const bool carried = c < d.nc - 1;    // a gradient reaches the state after c
    if (tid < L) {
      const float* pm = sc.pm + cb * L * L;
      float col = 0.0f;
      for (int i = tid; i < L; ++i) col += pm[(long long)i * L + tid];
      float t = 0.0f;
      if (carried)
        for (int x = 0; x < th; ++x) t += sc.tp[(row0 + tid) * th + x];
      const float db = ((sc.r[row0 + tid] + sc.rowp[row0 + tid]) - col) - t;
      sdb[tid] = db;
      st[tid] = t;
      dli[row0 + tid] = col + t;
    }
    __syncthreads();
    if (tid == 0) {
      if (carried) {
        float ts = 0.0f;
        for (int j = 0; j < L; ++j) ts += st[j];
        float uc = 0.0f, un = 0.0f;
        if (c > 0) {                      // the first chunk starts from zeros
          for (int x = 0; x < th * th; ++x) uc += sc.up[cb * nup + x];
          for (int x = 0; x < th; ++x) un += sc.up[cb * nup + th * th + x];
        }
        sdb[L - 1] += ts + sc.carry[cb] * (uc + un);
      }
      float acc = 0.0f;
      for (int j = L - 1; j >= 0; --j) dlf[row0 + j] = acc = acc + sdb[j];
    }
    __syncthreads();
  }
}

inline Dims dims(int bh, int s, int hd, int l) {
  return Dims{bh, s, hd, l, s / l};
}

}  // namespace

extern "C" long long mlstm_chunk_bwd_scratch_bytes(int bh, int s, int hd,
                                                   int l) {
  return (long long)Scratch(dims(bh, s, hd, l), nullptr).bytes;
}

// q, k, v, dh (bh, s, hd), lf, li (bh, s) in; dq, dk, dv (bh, s, hd), dlf,
// dli (bh, s) out; scratch holds mlstm_chunk_bwd_scratch_bytes.  s a
// multiple of the chunk l, 1 <= l <= 256, hd a multiple of 16, bh >= 1, all
// float32, contiguous, 16-byte aligned.  Nine grids on `stream`.
extern "C" int mlstm_chunk_bwd(const float* q, const float* k, const float* v,
                               const float* lf, const float* li,
                               const float* dh, float* dq, float* dk,
                               float* dv, float* dlf, float* dli,
                               void* scratch, int bh, int s, int hd, int l,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Dims d = dims(bh, s, hd, l);
  const Scratch sc(d, scratch);
  const int th = d.th(), tl = d.tl();
  bwd_gates<<<d.bh, kThreads, 0, st>>>(lf, li, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_states<<<dim3(th * th, d.bh), kThreads, 0, st>>>(k, v, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_xproj<<<dim3(th, tl * d.nc, d.bh), kThreads, 0, st>>>(dh, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_scores<<<dim3(tl * tl, d.nc, d.bh), kThreads, 0, st>>>(q, k, v, dh, sc,
                                                             d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_rows<<<dim3((d.l + kRowWarps - 1) / kRowWarps, d.nc, d.bh), kThreads, 0,
             st>>>(q, li, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_intra<<<dim3(th, tl * d.nc, 3 * d.bh), kThreads, 0, st>>>(q, k, dh, dq,
                                                                dk, dv, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (d.nc > 1) {
    bwd_dstates<<<dim3(th * th, d.bh), kThreads, 0, st>>>(q, dh, sc, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    bwd_stateterms<<<dim3(th, tl * (d.nc - 1), 2 * d.bh), kThreads, 0, st>>>(
        k, v, dk, dv, sc, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  bwd_finish<<<d.bh, kThreads, 0, st>>>(dlf, dli, sc, d);
  return (int)cudaGetLastError();
}

extern "C" const char* mlstm_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
