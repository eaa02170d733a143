// Chunkwise mLSTM forward (xLSTM's matrix-memory cell) on Hopper's tensor
// cores, sm_90a, for float32 inputs.
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
// It also writes the final (C, n, m), which decoding reads.
//
// What bounds it: operations.  Per (bh, chunk) q C and the C update take
// 2 L hd^2 flop each, the causal halves of q k^T and scores v L^2 hd each:
// at the prefill's (16, 2048, 1024), L 256, 146 GFLOP of least work (no
// q C on the first chunk) against ~0.6 GB of inputs and outputs.
//
// Products on the tensor cores, float32 kept by splitting.  One bf16
// rounding of the float32 operands misses the h and C gates (rtol 1e-4,
// atol 2e-4) tens of times over, and TF32 keeps no more bits.  So every
// operand is split into two bf16 terms, x = hi + lo with hi = bf16(x) and
// lo = bf16(x - hi) (~16 bits of x), and each product takes the three
// cross products hi.hi + hi.lo + lo.hi into one float32 accumulator: 3x
// the least work at the bf16 rate, 0.44 ms of bound.  A CPU emulation of
// this rounding (tests/test_torch_mlstm_tc.py) keeps every gate at the
// card-test shapes that fit the CPU, two heads of the full-width prefill
// among them; one term misses.  At the prefill's full shape (16 heads) it
// comes to 0.77 of h's gate and 0.57 of C's (largest |err| over atol +
// rtol |want|); a third term (six cross products, twice the work) would
// take them to 0.22 and 0.19.  bf16, not TF32: `wgmma` reads TF32 only
// K-major, and three of the operands (C in q C, v, and k kv_w in the
// update) are MN-major as stored, which bf16 reads through the
// descriptor's transpose bit.
//
// Four grids per call, on the caller's stream (one launch counted):
// 1. gates, one block (32 warps) per bh walking the chunks: cumsum(log_f)
//    as a warp scan (each lane sums its consecutive steps in order, then a
//    shuffle scan of the lane totals), the stabilizers as warp max
//    reductions (a warp per row), the weights inter_w, kv_w and the carry
//    weight into scratch; m out.
// 2. prep, grid (64-column tile, bh) walking the chunks: q, k, v and
//    kw = k kv_w split into bf16 planes (padded to LP = L rounded up to 64
//    rows a chunk and HP = hd rounded up to 64 columns, zeros in the
//    padding, so every tile below is whole); n carried per column tile, n
//    out; q . n_prev in per-tile partial sums.
// 3. scores, grid (64-row query tile, chunk, bh), one warpgroup: the gated
//    scores S[i, j] = (q[i] . k[j]) w[i, j] of key tiles j <= i, computed
//    once per (bh, chunk) and written as bf16 planes; the tiles above the
//    diagonal as zeros; the denominators.
// 4. main, grid (TE = 128 value columns (64 when HP is not a multiple of
//    128), bh), two warpgroups, walking the chunks in order.  Value columns
//    are independent, so a block owns C[:, e0:e0 + TE] for the whole walk.
//    Per chunk: num = (q C) inter_w + S v over all L rows at once (two
//    64-row tiles a warpgroup: C's slice is read once per chunk, not once
//    per query tile), h = num / den; then C' = carry C + kw^T v in d-blocks
//    of 256 rows, the accumulator started from carry C in float32 and
//    written back as float32 and as the bf16 planes the next chunk's q C
//    reads.  The float32 C lives in scratch in the order the threads hold
//    it, so that each reload is a whole line per warp instruction (a
//    row-major reload, 32-byte pieces of 8 rows per instruction, held the
//    grid back more than its products did); the last chunk writes the
//    output C.  Operands come through a ring of two 96 KB stages
//    filled by TMA (`cp.async.bulk.tensor`, 128-byte swizzle) and signalled
//    by mbarriers; the last warp done with a stage refills it, so one load
//    runs under the other stage's products.  The ring drains at the end of
//    a chunk: the next chunk's first loads read the C planes just written.
//
// Numerics follow the plain version (kernels/ref.py:mlstm_chunk_plain):
// masked (query, key) pairs add exact zeros (the stabilizer's max starts
// from the finite -1e30), the gates are expf, every product of two float32
// values outside the tensor cores is rounded as the plain version rounds
// it (built with --fmad=false).  Sums run in another order (the cumsum
// too), so the two agree to rounding, not bit for bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTerms = 2;        // bf16 terms of each float32 operand
constexpr int kMaxChunk = 256;
constexpr uint32_t kPanel = 64 * 128;  // 64 rows x 64 bf16 columns

struct Dims {
  int bh, s, hd, l, lp, hp, nc;
  __host__ __device__ int nd() const { return hp / 64; }   // column tiles
  __host__ __device__ int nj() const { return lp / 64; }   // row tiles of a chunk
  // first row of (term t, bh, chunk c) in the (kTerms, BH, nc, LP, .) planes
  __host__ __device__ int row(int t, int b, int c) const {
    return ((t * bh + b) * nc + c) * lp;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Two bf16 terms of a pair of float32 values, packed low word first.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(hi) : "f"(x1), "f"(x0));
  const float r0 = x0 - __uint_as_float(hi << 16);
  const float r1 = x1 - __uint_as_float(hi & 0xffff0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(lo) : "f"(r1), "f"(r0));
}

// A ring of S shared-memory stages filled by TMA: the 1024-aligned start
// of the tiles (for the swizzle), then one mbarrier per stage and the
// count of warps done with each stage.
template <int S, int kWarps>
struct Ring {
  uint32_t base, bars;
  unsigned* done;
  __device__ Ring(unsigned char* raw, uint32_t tile_bytes) {
    const uint32_t s = smem_u32(raw);
    base = (s + 1023) & ~1023u;
    bars = base + tile_bytes;
    done = reinterpret_cast<unsigned*>(raw + (base - s) + tile_bytes + 8 * S);
    if (threadIdx.x == 0) {
      for (int b = 0; b < S; ++b) bar_init(bars + 8 * b, 1);
      for (int b = 0; b < S; ++b) done[b] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  __device__ uint32_t full(int st) const { return bars + 8 * st; }
  // Lane 0 of each warp, once its products on stage st are done: true for
  // the last of the block's warps, which then refills the stage.
  __device__ bool release(int st) {
    return atomicAdd(done + st, 1u) % kWarps == kWarps - 1;
  }
  static constexpr size_t slack() { return 1024 + 12 * S; }
};

// ---- 1. gates --------------------------------------------------------------

constexpr int kGateWarps = 32;  // a warp per row of the stabilizers' max

__global__ void __launch_bounds__(32 * kGateWarps)
mlstm_gates(const float* __restrict__ lf, const float* __restrict__ li,
            float* __restrict__ g_b, float* __restrict__ g_mpos,
            float* __restrict__ g_iw, float* __restrict__ g_kvw,
            float* __restrict__ g_carry, float* __restrict__ m_out, Dims dm) {
  __shared__ float sb[kMaxChunk], sli[kMaxChunk], swarp[kGateWarps];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31, L = dm.l;
  float m_prev = 0.0f;
  for (int c = 0; c < dm.nc; ++c) {
    const long long base = (long long)b * dm.s + (long long)c * L;
    if (tid < L) {
      sb[tid] = lf[base + tid];
      sli[tid] = li[base + tid];
    }
    __syncthreads();
    if (warp == 0) {  // cumsum: lane sums its steps in order, then a scan
      const int per = (L + 31) / 32;
      float loc[kMaxChunk / 32], s = 0.0f;
#pragma unroll
      for (int u = 0; u < kMaxChunk / 32; ++u) {
        const int i = lane * per + u;
        if (u < per && i < L) s += sb[i];
        loc[u] = s;
      }
      float x = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      const float pre = __shfl_up_sync(0xffffffffu, x, 1);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kMaxChunk / 32; ++u) {
        const int i = lane * per + u;
        if (u < per && i < L) sb[i] = lane > 0 ? pre + loc[u] : loc[u];
      }
    }
    __syncthreads();
    const float b_last = sb[L - 1];
    float mx = kNegInf;
    for (int j = tid; j < L; j += 32 * kGateWarps)
      mx = fmaxf(mx, (b_last - sb[j]) + sli[j]);
    mx = warp_max(mx);
    if (lane == 0) swarp[warp] = mx;
    __syncthreads();
    float mx_last = swarp[0];
#pragma unroll
    for (int w = 1; w < kGateWarps; ++w) mx_last = fmaxf(mx_last, swarp[w]);
    const float m_new = fmaxf(b_last + m_prev, mx_last);
    for (int i = warp; i < L; i += kGateWarps) {  // a warp per row
      const float bi = sb[i];
      float mi = kNegInf;
      for (int j = lane; j <= i; j += 32) mi = fmaxf(mi, (bi - sb[j]) + sli[j]);
      mi = warp_max(mi);
      if (lane == 0) {
        const float mpos = fmaxf(bi + m_prev, mi);
        g_b[base + i] = bi;
        g_mpos[base + i] = mpos;
        g_iw[base + i] = expf((bi + m_prev) - mpos);
        g_kvw[base + i] = expf(((b_last - bi) + sli[i]) - m_new);
      }
    }
    if (tid == 0) g_carry[b * dm.nc + c] = expf((b_last + m_prev) - m_new);
    m_prev = m_new;
    __syncthreads();
  }
  if (tid == 0) m_out[b] = m_prev;
}

// ---- 2. prep: bf16 planes, n, q . n_prev ------------------------------------

// Four consecutive values as two terms into planes p (term 0) and p + plane.
__device__ __forceinline__ void store_terms(__nv_bfloat16* p, long long plane,
                                            float4 x) {
  uint2 hi, lo;
  split2(x.x, x.y, hi.x, lo.x);
  split2(x.z, x.w, hi.y, lo.y);
  *reinterpret_cast<uint2*>(p) = hi;
  *reinterpret_cast<uint2*>(p + plane) = lo;
}

// 16 threads a row (4 columns each), 16 rows at a time, 64 columns a block.
__global__ void __launch_bounds__(256)
mlstm_prep(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ g_kvw,
           const float* __restrict__ g_carry, __nv_bfloat16* __restrict__ pq,
           __nv_bfloat16* __restrict__ pk, __nv_bfloat16* __restrict__ pv,
           __nv_bfloat16* __restrict__ pkw, float* __restrict__ g_qn,
           float* __restrict__ n_out, Dims dm) {
  __shared__ float sn[64], ssum[16][64];
  const int ct = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rg = tid >> 4, c4 = (tid & 15) * 4, d = ct * 64 + c4;
  const bool col_ok = d < dm.hd;  // hd % 16 == 0: all four or none
  const long long plane = (long long)dm.bh * dm.nc * dm.lp * dm.hp;
  if (tid < 64) sn[tid] = 0.0f;
  __syncthreads();
  for (int c = 0; c < dm.nc; ++c) {
    const float n0 = sn[c4], n1 = sn[c4 + 1], n2 = sn[c4 + 2], n3 = sn[c4 + 3];
    float4 ks = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = rg; j < dm.lp; j += 16) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 xq = z, xk = z, xv = z, xw = z;
      const long long pos = (long long)b * dm.s + (long long)c * dm.l + j;
      if (j < dm.l && col_ok) {
        const long long src = pos * dm.hd + d;
        xq = *reinterpret_cast<const float4*>(q + src);
        xk = *reinterpret_cast<const float4*>(k + src);
        xv = *reinterpret_cast<const float4*>(v + src);
        const float w = g_kvw[pos];
        xw = make_float4(xk.x * w, xk.y * w, xk.z * w, xk.w * w);
        ks.x += xw.x; ks.y += xw.y; ks.z += xw.z; ks.w += xw.w;
      }
      float dot = ((xq.x * n0 + xq.y * n1) + xq.z * n2) + xq.w * n3;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if ((tid & 15) == 0 && j < dm.l) g_qn[pos * dm.nd() + ct] = dot;
      const long long dst = (long long)(dm.row(0, b, c) + j) * dm.hp + d;
      store_terms(pq + dst, plane, xq);
      store_terms(pk + dst, plane, xk);
      store_terms(pv + dst, plane, xv);
      store_terms(pkw + dst, plane, xw);
    }
    ssum[rg][c4] = ks.x; ssum[rg][c4 + 1] = ks.y;
    ssum[rg][c4 + 2] = ks.z; ssum[rg][c4 + 3] = ks.w;
    __syncthreads();
    if (tid < 64) {
      float s = 0.0f;
      for (int r = 0; r < 16; ++r) s += ssum[r][tid];
      sn[tid] = g_carry[b * dm.nc + c] * sn[tid] + s;
    }
    __syncthreads();
  }
  if (tid < 64 && ct * 64 + tid < dm.hd)
    n_out[(long long)b * dm.hd + ct * 64 + tid] = sn[tid];
}

// ---- 3. gated scores and denominators ---------------------------------------

constexpr int kScoreStages = 3;
constexpr uint32_t kScoreStage = 2 * kTerms * kPanel;  // q and k tiles

__global__ void __launch_bounds__(128)
mlstm_scores(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const float* __restrict__ g_b, const float* __restrict__ li,
             const float* __restrict__ g_mpos, const float* __restrict__ g_iw,
             const float* __restrict__ g_qn, __nv_bfloat16* __restrict__ ps,
             float* __restrict__ g_den, Dims dm) {
  extern __shared__ unsigned char smem_raw[];
  Ring<kScoreStages, 4> ring(smem_raw, kScoreStages * kScoreStage);
  const int it = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nd = dm.nd(), n = (it + 1) * nd;  // (key tile, d-slab) steps
  auto tile = [&](int slot, int ab, int t) {   // ab 0: q, 1: k
    return ring.base + slot * kScoreStage + (ab * kTerms + t) * kPanel;
  };
  auto issue = [&](int s) {
    const int slot = s % kScoreStages, kt = s / nd, ds = s % nd;
    bar_expect(ring.full(slot), kScoreStage);
    for (int t = 0; t < kTerms; ++t) {
      tma_2d(tile(slot, 0, t), &tq, 64 * ds, dm.row(t, b, c) + 64 * it,
             ring.full(slot));
      tma_2d(tile(slot, 1, t), &tk, 64 * ds, dm.row(t, b, c) + 64 * kt,
             ring.full(slot));
    }
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kScoreStages && s < n; ++s) issue(s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long pos0 = (long long)b * dm.s + (long long)c * dm.l;
  const long long plane = (long long)dm.bh * dm.nc * dm.lp * dm.lp;
  __nv_bfloat16* prow = ps + (long long)dm.row(0, b, c) * dm.lp;
  int ri[2];
  float bi[2], mpos[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    ri[rr] = 64 * it + 16 * warp + lane / 4 + 8 * rr;
    const bool ok = ri[rr] < dm.l;
    bi[rr] = ok ? g_b[pos0 + ri[rr]] : 0.0f;
    mpos[rr] = ok ? g_mpos[pos0 + ri[rr]] : 0.0f;
  }
  float acc[32];
  for (int s = 0; s < n; ++s) {
    const int slot = s % kScoreStages, kt = s / nd, ds = s % nd;
    bar_wait(ring.full(slot), (s / kScoreStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a0 = desc_k<64>(tile(slot, 0, 0), 64, 0, kk),
                     a1 = desc_k<64>(tile(slot, 0, 1), 64, 0, kk),
                     b0 = desc_k<64>(tile(slot, 1, 0), 64, 0, kk),
                     b1 = desc_k<64>(tile(slot, 1, 1), 64, 0, kk);
      wgmma_ss<64>(acc, a0, b0, (ds | kk) != 0);
      wgmma_ss<64>(acc, a0, b1, 1);
      wgmma_ss<64>(acc, a1, b0, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0 && ring.release(slot) && s + kScoreStages < n) {
      fence_async();
      issue(s + kScoreStages);
    }
    if (ds != nd - 1) continue;
    // key tile kt done: gate, sum, split, store
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int rr = frag_rr(e), i = ri[rr];
      const int j = 64 * kt + frag_col(e, lane);
      float val = 0.0f;
      if (j <= i && i < dm.l)
        val = acc[e] *
              expf(((bi[rr] - g_b[pos0 + j]) + li[pos0 + j]) - mpos[rr]);
      acc[e] = val;
      rsum[rr] += val;
    }
    uint32_t terms[kTerms][16];
    split<64, kTerms>(acc, terms);
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const long long off =
          (long long)ri[frag_rr(2 * g)] * dm.lp + 64 * kt + frag_col(2 * g, lane);
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        *reinterpret_cast<uint32_t*>(prow + t * plane + off) = terms[t][g];
    }
  }
  // tiles above the diagonal: zeros (the main grid multiplies whole rows)
  for (int kt = it + 1; kt < dm.nj(); ++kt)
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const long long off =
          (long long)ri[frag_rr(2 * g)] * dm.lp + 64 * kt + frag_col(2 * g, lane);
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        *reinterpret_cast<uint32_t*>(prow + t * plane + off) = 0u;
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float rs = quad_sum(rsum[rr]);
    const int i = ri[rr];
    if ((lane & 3) == 0 && i < dm.l) {
      float qn = 0.0f;
      for (int t = 0; t < nd; ++t) qn += g_qn[(pos0 + i) * nd + t];
      g_den[pos0 + i] =
          fmaxf(fabsf(qn * g_iw[pos0 + i] + rs), expf(-mpos[rr]));
    }
  }
}

// ---- 4. main: h and the C walk ----------------------------------------------

constexpr int kMainThreads = 256;  // two warpgroups
constexpr uint32_t kPlaneA = 4 * kPanel;  // LP <= 256 rows, or 4 panels

template <int TE>
struct MainGeo {
  static constexpr uint32_t kPlaneB = (TE / 64) * kPanel;  // 64 rows x TE
  static constexpr uint32_t kStage = kTerms * (kPlaneA + kPlaneB);
  static constexpr size_t smem() { return Ring<2, 8>::slack() + 2 * kStage; }
};

template <int TE>
__global__ void __launch_bounds__(kMainThreads, 1)
mlstm_main(const __grid_constant__ CUtensorMap tq,   // q, boxes LP x 64
           const __grid_constant__ CUtensorMap tsc,  // scores, LP x 64
           const __grid_constant__ CUtensorMap tv,   // v, 64 x 64
           const __grid_constant__ CUtensorMap tkw,  // k kv_w, 64 x 64
           const __grid_constant__ CUtensorMap tc,   // C planes, 64 x 64
           const float* __restrict__ g_iw, const float* __restrict__ g_den,
           const float* __restrict__ g_carry, float* __restrict__ h,
           float* __restrict__ C, float* __restrict__ cw,
           __nv_bfloat16* __restrict__ pc, Dims dm) {
  using G = MainGeo<TE>;
  extern __shared__ unsigned char smem_raw[];
  Ring<2, 8> ring(smem_raw, 2 * G::kStage);
  const int b = blockIdx.y, e0 = blockIdx.x * TE;
  const int nd = dm.nd(), nj = dm.nj(), ndb = (dm.hp + 255) / 256;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int r16 = 16 * ((tid % 128) / 32) + lane / 4;  // row in a 64-row tile
  const long long cplane = (long long)dm.bh * dm.hp * dm.hp;
  // this block's float32 C between chunks, in the order its threads hold
  // it: per (d-block, row tile, 4 columns of the fragment) 256 float4, one
  // a thread, so that every load and store of it is a whole line a warp
  float4* cwb = reinterpret_cast<float4*>(cw) +
                ((long long)b * gridDim.x + blockIdx.x) * ndb * 64 * TE + tid;
  auto sa = [&](int slot, int t) {
    return ring.base + slot * G::kStage + t * kPlaneA;
  };
  auto sb = [&](int slot, int t) {
    return ring.base + slot * G::kStage + kTerms * kPlaneA + t * G::kPlaneB;
  };

  float acc[2][TE / 2];
  uint32_t gstep = 0;  // steps consumed so far: stage g & 1, phase g >> 1
  for (int c = 0; c < dm.nc; ++c) {
    const int n1 = c > 0 ? nd : 0, n2 = nj, n = n1 + n2 + ndb * nj;
    const long long pos0 = (long long)b * dm.s + (long long)c * dm.l;
    // step i of the chunk: q C d-slab i, then S v key tile i - n1, then
    // the update's (d-block, key tile)
    auto issue = [&](int i) {
      const int slot = (gstep + i) & 1;
      const uint32_t bar = ring.full(slot);
      int jt = i - n1, db = 0;
      if (i >= n1 + n2) {
        db = (i - n1 - n2) / nj;
        jt = (i - n1 - n2) % nj;
      }
      const int np = i < n1 + n2 ? 1 : min(4, (dm.hp - 256 * db) / 64);
      const uint32_t abytes = i < n1 + n2 ? dm.lp * 128u : np * kPanel;
      bar_expect(bar, kTerms * (abytes + G::kPlaneB));
      for (int t = 0; t < kTerms; ++t) {
        const int r = dm.row(t, b, c);
        if (i < n1)
          tma_2d(sa(slot, t), &tq, 64 * i, r, bar);
        else if (i < n1 + n2)
          tma_2d(sa(slot, t), &tsc, 64 * jt, r, bar);
        else
          for (int p = 0; p < np; ++p)
            tma_2d(sa(slot, t) + p * kPanel, &tkw, 256 * db + 64 * p,
                   r + 64 * jt, bar);
        for (int p = 0; p < TE / 64; ++p) {
          if (i < n1)
            tma_2d(sb(slot, t) + p * kPanel, &tc, e0 + 64 * p,
                   (t * dm.bh + b) * dm.hp + 64 * i, bar);
          else
            tma_2d(sb(slot, t) + p * kPanel, &tv, e0 + 64 * p, r + 64 * jt,
                   bar);
        }
      }
    };
    if (tid == 0) {
      fence_async();
      for (int i = 0; i < 2 && i < n; ++i) issue(i);
    }
    auto wait = [&](int i) {
      const int slot = (gstep + i) & 1;
      bar_wait(ring.full(slot), ((gstep + i) >> 1) & 1);
      return slot;
    };
    auto release = [&](int i, int slot) {
      __syncwarp();
      if (lane == 0 && ring.release(slot) && i + 2 < n) {
        fence_async();
        issue(i + 2);
      }
    };

    // num = (q C) inter_w + S v, rows 128 wg + 64 mt + r16 (+ 8)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < TE / 2; ++e) acc[mt][e] = 0.0f;
    for (int i = 0; i < n1 + n2; ++i) {
      if (i == n1 && n1 > 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = 128 * wg + 64 * mt + r16 + 8 * rr;
            const float w = row < dm.l ? g_iw[pos0 + row] : 0.0f;
#pragma unroll
            for (int e = 0; e < TE / 2; ++e)
              if (frag_rr(e) == rr) acc[mt][e] *= w;
          }
      }
      const int slot = wait(i);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b0 = desc_mn<TE>(sb(slot, 0), 64, kk),
                       b1 = desc_mn<TE>(sb(slot, 1), 64, kk);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row0 = 128 * wg + 64 * mt;
          const uint64_t a0 = desc_k<64>(sa(slot, 0), dm.lp, row0, kk),
                         a1 = desc_k<64>(sa(slot, 1), dm.lp, row0, kk);
          wgmma_ss<TE, 0, 1>(acc[mt], a0, b0, 1);
          wgmma_ss<TE, 0, 1>(acc[mt], a0, b1, 1);
          wgmma_ss<TE, 0, 1>(acc[mt], a1, b0, 1);
        }
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      release(i, slot);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 128 * wg + 64 * mt + r16 + 8 * rr;
        if (row >= dm.l) continue;
        const float den = g_den[pos0 + row];
        float* hrow = h + (pos0 + row) * dm.hd;
#pragma unroll
        for (int j = 0; j < TE / 8; ++j) {
          const int col = e0 + 8 * j + 2 * (lane & 3);
          if (col < dm.hd)
            *reinterpret_cast<float2*>(hrow + col) =
                make_float2(acc[mt][4 * j + 2 * rr] / den,
                            acc[mt][4 * j + 2 * rr + 1] / den);
        }
      }

    // C' = carry C + kw^T v, d-blocks of 256 rows: d = 256 db + 128 wg +
    // 64 mt + r16 (+ 8)
    const float carry = g_carry[b * dm.nc + c];
    const bool last = c + 1 == dm.nc;
    for (int db = 0; db < ndb; ++db) {
      float4* cwd = cwb + db * 2 * (TE / 8) * 256;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int g = 0; g < TE / 8; ++g) {
          float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (c > 0) x = cwd[(mt * (TE / 8) + g) * 256];
          acc[mt][4 * g] = carry * x.x;
          acc[mt][4 * g + 1] = carry * x.y;
          acc[mt][4 * g + 2] = carry * x.z;
          acc[mt][4 * g + 3] = carry * x.w;
        }
      for (int jt = 0; jt < nj; ++jt) {
        const int i = n1 + n2 + db * nj + jt;
        const int slot = wait(i);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t b0 = desc_mn<TE>(sb(slot, 0), 64, kk),
                         b1 = desc_mn<TE>(sb(slot, 1), 64, kk);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const uint32_t pa = (2 * wg + mt) * kPanel;
            const uint64_t a0 = desc_mn<64>(sa(slot, 0) + pa, 64, kk),
                           a1 = desc_mn<64>(sa(slot, 1) + pa, 64, kk);
            wgmma_ss<TE, 1, 1>(acc[mt], a0, b0, 1);
            wgmma_ss<TE, 1, 1>(acc[mt], a0, b1, 1);
            wgmma_ss<TE, 1, 1>(acc[mt], a1, b0, 1);
          }
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        release(i, slot);
      }
      if (!last)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int g = 0; g < TE / 8; ++g)
            cwd[(mt * (TE / 8) + g) * 256] =
                make_float4(acc[mt][4 * g], acc[mt][4 * g + 1],
                            acc[mt][4 * g + 2], acc[mt][4 * g + 3]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int d = 256 * db + 128 * wg + 64 * mt + r16 + 8 * rr;
          if (d >= dm.hp) continue;
          float* crow = C + ((long long)b * dm.hd + d) * dm.hd;
          __nv_bfloat16* prow = pc + ((long long)b * dm.hp + d) * dm.hp;
#pragma unroll
          for (int j = 0; j < TE / 8; ++j) {
            const int col = e0 + 8 * j + 2 * (lane & 3);
            const float x0 = acc[mt][4 * j + 2 * rr],
                        x1 = acc[mt][4 * j + 2 * rr + 1];
            if (last && d < dm.hd && col < dm.hd)
              *reinterpret_cast<float2*>(crow + col) = make_float2(x0, x1);
            if (!last) {
              uint32_t hi, lo;
              split2(x0, x1, hi, lo);
              *reinterpret_cast<uint32_t*>(prow + col) = hi;
              *reinterpret_cast<uint32_t*>(prow + cplane + col) = lo;
            }
          }
        }
    }
    gstep += n;
    // the next chunk's copies read the C planes just written
    asm volatile("fence.proxy.async.global;" ::: "memory");
    __syncthreads();
  }
}

// ---- launcher ----------------------------------------------------------------

Dims dims(int bh, int s, int hd, int l) {
  return Dims{bh, s, hd, l, (l + 63) / 64 * 64, (hd + 63) / 64 * 64, s / l};
}

// Scratch, in order: float32 b, m_pos, inter_w, kv_w, den (BH x S each),
// carry (BH x nc), q . n partials (BH x S x HP/64), the main grid's
// float32 C (BH x 256 x HP per 256-row d-block); bf16 planes of q, k,
// v, kw (kTerms x BH x nc x LP x HP each), scores (kTerms x BH x nc x LP x
// LP), C (kTerms x BH x HP x HP); each part 256-byte aligned.
struct Scratch {
  float *b, *mpos, *iw, *kvw, *den, *carry, *qn, *cw;
  __nv_bfloat16 *q, *k, *v, *kw, *s, *c;
  size_t bytes;
  Scratch(const Dims& d, void* base) {
    char* p = static_cast<char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      char* at = p + off;
      off += (n + 255) / 256 * 256;
      return at;
    };
    const size_t bs = (size_t)d.bh * d.s * 4;
    b = (float*)take(bs); mpos = (float*)take(bs); iw = (float*)take(bs);
    kvw = (float*)take(bs); den = (float*)take(bs);
    carry = (float*)take((size_t)d.bh * d.nc * 4);
    qn = (float*)take(bs * d.nd());
    cw = (float*)take((size_t)d.bh * ((d.hp + 255) / 256) * 256 * d.hp * 4);
    const size_t pl = (size_t)kTerms * d.bh * d.nc * d.lp * d.hp * 2;
    q = (__nv_bfloat16*)take(pl); k = (__nv_bfloat16*)take(pl);
    v = (__nv_bfloat16*)take(pl); kw = (__nv_bfloat16*)take(pl);
    s = (__nv_bfloat16*)take((size_t)kTerms * d.bh * d.nc * d.lp * d.lp * 2);
    c = (__nv_bfloat16*)take((size_t)kTerms * d.bh * d.hp * d.hp * 2);
    bytes = off;
  }
};

template <int TE>
int launch_main(const CUtensorMap* maps, const Scratch& sc, float* h,
                float* C, const Dims& d, cudaStream_t st) {
  auto kernel = mlstm_main<TE>;
  const size_t smem = MainGeo<TE>::smem();
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<dim3(d.hp / TE, d.bh), kMainThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], sc.iw, sc.den, sc.carry,
      h, C, sc.cw, sc.c, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch that mlstm_chunk_sm90 needs for these sizes.
extern "C" long long mlstm_chunk_sm90_scratch_bytes(int bh, int s, int hd,
                                                    int l) {
  return (long long)Scratch(dims(bh, s, hd, l), nullptr).bytes;
}

// q, k, v, h (bh, s, hd); lf, li (bh, s); C (bh, hd, hd), n (bh, hd),
// m (bh,) are written; scratch holds mlstm_chunk_sm90_scratch_bytes.  s a
// multiple of the chunk l, 1 <= l <= 256, hd a multiple of 16, bh >= 1,
// all float32, contiguous and 16-byte aligned.  Four grids on `stream`.
extern "C" int mlstm_chunk_sm90(const float* q, const float* k,
                                const float* v, const float* lf,
                                const float* li, float* h, float* C, float* n,
                                float* m, void* scratch, int bh, int s, int hd,
                                int l, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Dims d = dims(bh, s, hd, l);
  const Scratch sc(d, scratch);
  const long long rows = (long long)kTerms * d.bh * d.nc * d.lp;
  CUtensorMap tq64, tk64, maps[5];  // main: q, scores, v, kw, C
  if (int e = map_bf16_2d(&tq64, sc.q, rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&tk64, sc.k, rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&maps[0], sc.q, rows, d.hp, d.lp)) return e;
  if (int e = map_bf16_2d(&maps[1], sc.s, rows, d.lp, d.lp)) return e;
  if (int e = map_bf16_2d(&maps[2], sc.v, rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&maps[3], sc.kw, rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&maps[4], sc.c, (long long)kTerms * d.bh * d.hp,
                          d.hp, 64))
    return e;

  mlstm_gates<<<d.bh, 32 * kGateWarps, 0, st>>>(lf, li, sc.b, sc.mpos, sc.iw, sc.kvw,
                                    sc.carry, m, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  mlstm_prep<<<dim3(d.nd(), d.bh), 256, 0, st>>>(
      q, k, v, sc.kvw, sc.carry, sc.q, sc.k, sc.v, sc.kw, sc.qn, n, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const size_t smem3 = Ring<kScoreStages, 4>::slack() +
                       kScoreStages * kScoreStage;
  if (int e = prepare(mlstm_scores, smem3)) return e;
  mlstm_scores<<<dim3(d.nj(), d.nc, d.bh), 128, smem3, st>>>(
      tq64, tk64, sc.b, li, sc.mpos, sc.iw, sc.qn, sc.s, sc.den, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return d.hp % 128 == 0 ? launch_main<128>(maps, sc, h, C, d, st)
                         : launch_main<64>(maps, sc, h, C, d, st);
}

extern "C" const char* mlstm_chunk_sm90_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
