// Chunkwise mLSTM backward (xLSTM's matrix-memory cell) on Hopper's tensor
// cores, sm_90a, for float32 inputs.
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
// What bounds it: operations, by the count.  Per chunk past the first,
// five state products of 2 L hd^2 flop (the chunk-start C recomputed,
// X = dh C^T, the state gradient's (iw q / den)^T dh, and the keys' and
// values' state terms v dC^T and k dC), and per chunk five causal halves of
// L(L+1) hd (q k^T, dh v^T, ds k, ds^T q, s^T dh): at the training shape
// (16, 512, 1024), L 256, 53.7 GFLOP of least work against 235 MB of
// inputs and outputs.  On the tensor cores each float32 product takes three
// bf16 products (six for q k^T, below): 167.6 GFLOP done, 0.17 ms at 989
// TFLOP/s.  On the card the product grids are held by moving their
// operands instead: the bf16 planes (2 bytes a term, as many bytes as the
// float32 value for two terms) are written once and read by every tile
// that needs them: ~2.1 GB of stage loads a call at the training shape
// (each product block reads its two operand strips whole), and a copy
// with the products taken out keeps 87-93% of those grids' time
// (730.79 against 787.81 / 790.59 us in one call on an H100 80GB HBM3 at
// 700 W, each tree timed as chip_smoke.py --ab mlstm-bwd --tree times it).
//
// Products on the tensor cores, float32 kept by splitting, as the forward
// does: every float32 operand is written once as bf16 planes, x = hi + lo
// with hi = bf16(x) and lo = bf16(x - hi), and each product takes the
// three cross products hi.hi + hi.lo + lo.hi into one float32 accumulator.
// The raw scores q k^T take a third term of q and k (hi, lo, and bf16 of
// what they leave) and the six cross products of terms t, u with t + u <
// 3: the gates' exponentials carry their error into every gradient.  A CPU
// emulation of this rounding (tests/test_torch_mlstm_bwd_tc.py) keeps the
// card gate (each gradient within 1e-4 of the largest |plain gradient|
// entry, dlog_f of dlog_i's) at every card-test shape that fits the CPU:
// 0.27 of it at worst (L 1), 0.12 for two heads of the training shape and
// 0.40 for all sixteen (0.34 with three terms everywhere: the rest is
// summation order); one term misses it at every shape, its worst gradient
// 61 to 3,582 times over, and with two terms in q k^T the emulation misses
// the reference oracle's 2e-5 by up to 3.7x.  On the card (chip_smoke.py's
// draws) the kernel comes to 0.30 of the gate at the training shape and
// 0.29 at the prefill's (16, 2048, 1024).
// bf16, not TF32: `wgmma` reads TF32 only K-major, and most operands here
// are MN-major as stored (k kv_w and v in the C walk, q iw / den and dh in
// the dC walk, ds and s and q and dh / den in ds^T q and s^T dh, dC in
// k dC), which bf16 reads through the descriptor's transpose bit.
//
// Eleven grids per call, on the caller's stream (one launch counted); the
// first two are the forward's (mlstm_sm90.cuh).  LP and HP are L and hd
// rounded up to 128 (zeros in the padding), so every 128-row product tile
// is whole.  The product grids stream both operands through a ring of
// TMA stages (64 x 64 boxes, 128-byte swizzle) signalled by mbarriers; the
// last warp done with a stage refills it, so the next loads run under the
// products.  A product block is two warpgroups, a 128 x 128 output tile
// (each warpgroup 64 rows), three stages of 64 KB.
// 1. gates, one block per bh: cumsum(log_f) as a warp scan, the
//    stabilizers, iw, kv_w and the carry weights.
// 2. prep, grid (64-column tile, bh): bf16 planes of q and k (three terms),
//    v, dh and kw = k kv_w (two); each chunk's starting n; q . n partials.
// 3. states, grid (128x128 tile of C, group of heads), walking the chunks
//    forward: C <- carry C + kw^T v, the accumulator carried in registers;
//    each chunk-start C past the first written as the bf16 planes its
//    consumers read (C_0 = 0 is not stored).  A block takes several heads
//    in turn where that still leaves two waves of blocks.
// 4. xproj, grid (128-column tile, 128-row tile x chunk past the first,
//    bh): X = dh C^T in float32, and q . X in per-tile partial sums.
// 5. scores, grid ((query, key) 64 x 64 tile at or below the diagonal,
//    chunk, bh), one warpgroup: the raw scores q k^T and A = dh v^T over
//    the head dim, gated by w and kept in float32 scratch; the tile's row
//    sums of s and s A.
// 6. rows, a thread per row: den, the clamp, g and d log iw.
// 7. tiles, grid (64 x 64 tile, chunk, bh): ds = (A / den + g) w and s as
//    bf16 planes (zeros above the diagonal), the row and column sums of P =
//    dscores s per tile (a warp tree; each thread's rows, then the warps).
// 8. scale, grid (64-column tile, 64-row tile, chunk x bh): dh / den and
//    q iw / den as bf16 planes, and dn's column partials (iw g q).
// 9. dstates, grid (128x128 tile of dC, group of heads), walking the
//    chunks back: dC <- carry dC + (q iw / den)^T dh, written as bf16
//    planes; <C, dC> (C read back from its planes) and, in the tiles of
//    column 0, dn and <n, dn> as per-tile block sums.
// 10. dgrad, grid (128-column tile, 128-row tile x chunk, 3 x bh): dq = ds k
//    + iw (X / den + g n); dk = kv_w (v dC^T + dn) + ds^T q with k . (its
//    state term) in per-tile partial sums; dv = kv_w (k dC) + s^T (dh /
//    den).  The state product runs first and is scaled in registers; the
//    intra-chunk product accumulates onto it.  dk's and dv's blocks (the
//    longest) are scheduled first.
// 11. finish, one block per bh: the row and column sums of P and the
//    partial sums in a fixed order, d log_i, and d log_f as the reverse
//    cumulative sum of the cumulative log forget's gradient within each
//    chunk (a Hillis-Steele scan in shared memory).
// No atomics on values: every sum is a fixed tree or a fixed order, so two
// calls on the same inputs give the same bits (the ring counts its warps
// with a shared-memory atomic, which orders no sum).
//
// Numerics: built with --fmad=false; the gates use expf, and every product
// of two float32 values outside the tensor cores is rounded before it is
// added, as the plain version rounds them.  Sums run in another order, so
// the two agree to rounding and the split's error above.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"
#include "mlstm_sm90.cuh"

namespace {

constexpr int kThreads = 256;            // two warpgroups: a 128-row tile
constexpr uint32_t kTile = 2 * kPanel;   // 128 x 64 bf16 of one term: 16 KB
constexpr uint32_t kStage = 4 * kTile;   // A and B, two terms each
constexpr int kStages = 3;
constexpr size_t kSmem = Ring<kStages, 8>::slack() + kStages * kStage;
// the scores grid: one warpgroup, 64 x 64 tiles of q and k (three terms)
// and of dh and v (two)
constexpr int kScStages = 2;
constexpr uint32_t kScStage = 10 * kPanel;
constexpr size_t kScSmem = Ring<kScStages, 4>::slack() + kScStages * kScStage;

__host__ __device__ inline int ntiles(const Dims& d) { return d.hp / 128; }

// Scratch, each part 256-byte aligned: float32 gates b, m_pos, iw, kv_w
// (BH x S), carry (BH x nc), m (BH), q . n partials (BH x S x HP/64), each
// chunk's starting n (BH x nc x HP), X (BH x S x hd), q . X partials (BH x
// S x HP/128), the gated scores and A (BH x nc x LP x LP), the row sums of
// s and s A per 64-column tile (BH x S x LP/64), per row 1/den, g, d log
// iw, P's row partials (BH x S x LP/64), P's column partials (BH x nc x
// LP/64 x LP),
// dn's column partials (BH x nc x LP/64 x HP), dn (BH x nc x HP), <C, dC>
// and <n, dn> partials (BH x nc x (HP/128)^2 + HP/128), k . dk's state
// term partials (BH x S x HP/128); bf16 planes (terms x BH x nc x LP x HP)
// of q and k (three terms), v, dh, kw, q iw / den, dh / den (two), of s and
// ds (two terms of BH x nc x LP x LP), of the chunk-start C past the first
// and the state gradients dC (two terms of BH x (nc - 1) x HP x HP).
struct Scratch {
  float *b, *mpos, *iw, *kvw, *carry, *m, *qn, *ns, *x, *qxp, *ssc, *asc,
      *rsp, *rsap, *inv, *g, *r, *rpp, *cpp, *dnp, *dns, *up, *tp;
  __nv_bfloat16 *q, *k, *v, *dh, *kw, *qs, *dhi, *s, *ds, *c, *dc;
  size_t bytes;
  Scratch(const Dims& d, void* base) {
    char* p = static_cast<char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      char* at = p + off;
      off += (n + 255) / 256 * 256;
      return at;
    };
    auto f32 = [&](size_t n) { return (float*)take(n * 4); };
    auto b16 = [&](size_t n) { return (__nv_bfloat16*)take(n * 2); };
    const size_t bs = (size_t)d.bh * d.s, bc = (size_t)d.bh * d.nc;
    const size_t nt = ntiles(d), nj = d.nj();
    const size_t pl = bc * d.lp * d.hp, ll = bc * d.lp * d.lp;
    b = f32(bs); mpos = f32(bs); iw = f32(bs); kvw = f32(bs);
    carry = f32(bc); m = f32(d.bh); qn = f32(bs * d.nd());
    ns = f32(bc * d.hp); x = f32(bs * d.hd); qxp = f32(bs * nt);
    ssc = f32(ll); asc = f32(ll);
    rsp = f32(bs * nj); rsap = f32(bs * nj);
    inv = f32(bs); g = f32(bs); r = f32(bs); rpp = f32(bs * nj);
    cpp = f32(bc * nj * d.lp); dnp = f32(bc * nj * d.hp);
    dns = f32(bc * d.hp); up = f32(bc * (nt * nt + nt)); tp = f32(bs * nt);
    q = b16(3 * pl); k = b16(3 * pl);
    v = b16(2 * pl); dh = b16(2 * pl); kw = b16(2 * pl);
    qs = b16(2 * pl); dhi = b16(2 * pl);
    s = b16(2 * ll); ds = b16(2 * ll);
    const size_t cs = 2 * (size_t)d.bh * (d.nc - 1) * d.hp * d.hp;
    c = b16(cs); dc = b16(cs);
    bytes = off;
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

// The sum of every thread's `x` over a block of 256 threads, in a fixed
// order (each warp's tree, then the warps in order), in every thread.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// The row of a 128-row tile that this thread's accumulator values rr (0
// or 1) sit in: warpgroup wg holds rows 64 wg.., as sm90.cuh's fragment.
__device__ __forceinline__ int frow(int rr) {
  const int t = threadIdx.x;
  return 64 * (t >> 7) + 16 * ((t & 127) >> 5) + ((t & 31) >> 2) + 8 * rr;
}

// One 128 x 64 operand tile of two bf16 terms (two 64 x 64 panels each)
// into dst: K-major (the plane's rows are the tile's 128 rows from `row`,
// its columns the 64-deep contraction from `col`) or MN-major (kMN: the
// plane's rows are the contraction from `row`, its columns the tile's
// from `col`).  Term t lies trow rows below term 0.
template <bool kMN>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int col, int row, int trow,
                                          uint32_t bar) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      tma_2d(dst + t * kTile + p * kPanel, map, col + (kMN ? 64 * p : 0),
             row + t * trow + (kMN ? 0 : 64 * p), bar);
}

// acc (this warpgroup's 64 x 128) += A B over one 64-deep stage: A's rows
// 64 wg.. from sa, B's 128 columns from sb, each of two terms; MN-major
// where TA / TB is 1.  The three cross products hi.hi, hi.lo, lo.hi.
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&acc)[64], uint32_t sa,
                                    uint32_t sb, int wg) {
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint64_t a[2], b[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint32_t pa = sa + t * kTile + wg * kPanel, pb = sb + t * kTile;
      a[t] = TA ? desc_mn<64>(pa, 64, kk) : desc_k<64>(pa, 64, 0, kk);
      b[t] = TB ? desc_mn<128>(pb, 64, kk) : desc_k<64>(pb, 128, 0, kk);
    }
    wgmma_ss<128, TA, TB>(acc, a[0], b[0], 1);
    wgmma_ss<128, TA, TB>(acc, a[0], b[1], 1);
    wgmma_ss<128, TA, TB>(acc, a[1], b[0], 1);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
}

// A 128 x 128 accumulator tile as two bf16 planes at p (its first row and
// column), rows ld apart, the second plane `plane` after the first.
__device__ __forceinline__ void store_planes(const float (&acc)[64],
                                             __nv_bfloat16* p,
                                             long long plane, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    __nv_bfloat16* row = p + (long long)frow(rr) * ld + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t hi, lo;
      split2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(row + 8 * j) = hi;
      *reinterpret_cast<uint32_t*>(row + plane + 8 * j) = lo;
    }
  }
}

// ---- 3. / 6. the state walks -------------------------------------------------

// Forward (kBack false): C_{c+1} = carry_c C_c + kw_c^T v_c for c = 0 ..
// nc - 2, each written to C slot c.  Back: G = carry_c G + (q iw / den)_c^T
// dh_c for c = nc - 1 .. 1, the gradient into the state before chunk c,
// written to dC slot c - 1; with <C_{c-1}, G>, dn and <n_{c-1}, dn>.
template <bool kBack>
__global__ void __launch_bounds__(kThreads, 1)
bwd_walk(const __grid_constant__ CUtensorMap ta,
         const __grid_constant__ CUtensorMap tb, __nv_bfloat16* out,
         int heads, Scratch sc, Dims dm) {
  extern __shared__ unsigned char smem_raw[];
  Ring<kStages, 8> ring(smem_raw, kStages * kStage);
  __shared__ float red[kThreads / 32];
  const int nt = ntiles(dm), tile = blockIdx.x, b0 = blockIdx.y * heads;
  const int d0 = (tile / nt) * 128, e0 = (tile % nt) * 128;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int nj = dm.nj(), per = (dm.nc - 1) * nj, prow = dm.prow();
  const int n = min(heads, dm.bh - b0) * per;
  const long long cplane = (long long)dm.bh * (dm.nc - 1) * dm.hp * dm.hp;
  // step s: head b0 + s / per, its (s % per) / nj-th chunk of the walk, the
  // chunk's 64-row tile s % nj
  auto chunk = [&](int s) {
    const int w = (s % per) / nj;
    return kBack ? dm.nc - 1 - w : w;
  };
  auto issue = [&](int s) {
    const int slot = s % kStages;
    const int row = dm.row(0, b0 + s / per, chunk(s)) + 64 * (s % nj);
    const uint32_t at = ring.base + slot * kStage, bar = ring.full(slot);
    bar_expect(bar, kStage);
    load_tile<true>(at, &ta, d0, row, prow, bar);
    load_tile<true>(at + 2 * kTile, &tb, e0, row, prow, bar);
  };
  if (tid == 0)
    for (int s = 0; s < kStages && s < n; ++s) issue(s);

  float acc[64];
  float dn = 0.0f;  // back, tiles of column 0: dn[d0 + tid]
  for (int s = 0; s < n; ++s) {
    const int slot = s % kStages, b = b0 + s / per, c = chunk(s);
    if (s % per == 0) {       // a new head: the walk starts from zeros
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
      dn = 0.0f;
    }
    if (s % nj == 0) {
      const float cw = sc.carry[b * dm.nc + c];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = cw * acc[e];
    }
    bar_wait(ring.full(slot), (s / kStages) & 1);
    const uint32_t at = ring.base + slot * kStage;
    mma<1, 1>(acc, at, at + 2 * kTile, wg);
    __syncwarp();
    if (lane == 0 && ring.release(slot) && s + kStages < n) {
      fence_async();
      issue(s + kStages);
    }
    if (s % nj != nj - 1) continue;
    const int oslot = kBack ? c - 1 : c;
    const long long orow = ((long long)b * (dm.nc - 1) + oslot) * dm.hp;
    store_planes(acc, out + (orow + d0) * dm.hp + e0, cplane, dm.hp);
    if (!kBack) continue;
    const long long cb = (long long)b * dm.nc + (c - 1);
    const int nup = nt * nt + nt;
    if (c >= 2) {  // <C_{c-1}, G>, C_{c-1} from its planes (slot c - 2)
      const __nv_bfloat16* cp =
          sc.c + (((long long)b * (dm.nc - 1) + (c - 2)) * dm.hp + d0) * dm.hp
          + e0 + 2 * (lane & 3);
      float part = 0.0f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const long long o = (long long)frow(rr) * dm.hp + 8 * j;
          const uint32_t h = *reinterpret_cast<const uint32_t*>(cp + o);
          const uint32_t l = *reinterpret_cast<const uint32_t*>(cp + cplane + o);
          const float x0 = __uint_as_float(h << 16) + __uint_as_float(l << 16);
          const float x1 = __uint_as_float(h & 0xffff0000u) +
                           __uint_as_float(l & 0xffff0000u);
          part += x0 * acc[4 * j + 2 * rr];
          part += x1 * acc[4 * j + 2 * rr + 1];
        }
      part = block_sum(part, red);
      if (tid == 0) sc.up[cb * nup + tile] = part;
    }
    if (e0 == 0) {  // dn <- carry dn + the scores grid's column partials
      float pn = 0.0f;
      if (tid < 128) {
        const int dd = d0 + tid;
        float s2 = 0.0f;
        for (int it = 0; it < nj; ++it)
          s2 += sc.dnp[(((long long)b * dm.nc + c) * nj + it) * dm.hp + dd];
        dn = sc.carry[b * dm.nc + c] * dn + s2;
        sc.dns[cb * dm.hp + dd] = dn;
        pn = sc.ns[cb * dm.hp + dd] * dn;
      }
      pn = block_sum(pn, red);
      if (tid == 0) sc.up[cb * nup + nt * nt + d0 / 128] = pn;
    }
  }
}

// ---- 4. X = dh C^T -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
bwd_xproj(const __grid_constant__ CUtensorMap tdh,
          const __grid_constant__ CUtensorMap tc,
          const float* __restrict__ q, Scratch sc, Dims dm) {
  extern __shared__ unsigned char smem_raw[];
  Ring<kStages, 8> ring(smem_raw, kStages * kStage);
  const int nr = dm.lp / 128, nt = ntiles(dm);
  const int c = 1 + blockIdx.y / nr, i0 = (blockIdx.y % nr) * 128,
            d0 = blockIdx.x * 128, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int n = dm.hp / 64, prow = dm.prow();
  const int ctrow = dm.bh * (dm.nc - 1) * dm.hp;
  const int arow = dm.row(0, b, c) + i0;
  const int brow = (b * (dm.nc - 1) + c - 1) * dm.hp + d0;
  auto issue = [&](int s) {
    const int slot = s % kStages;
    const uint32_t at = ring.base + slot * kStage, bar = ring.full(slot);
    bar_expect(bar, kStage);
    load_tile<false>(at, &tdh, 64 * s, arow, prow, bar);
    load_tile<false>(at + 2 * kTile, &tc, 64 * s, brow, ctrow, bar);
  };
  if (tid == 0)
    for (int s = 0; s < kStages && s < n; ++s) issue(s);
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  for (int s = 0; s < n; ++s) {
    const int slot = s % kStages;
    bar_wait(ring.full(slot), (s / kStages) & 1);
    const uint32_t at = ring.base + slot * kStage;
    mma<0, 0>(acc, at, at + 2 * kTile, wg);
    __syncwarp();
    if (lane == 0 && ring.release(slot) && s + kStages < n) {
      fence_async();
      issue(s + kStages);
    }
  }
  const long long pos0 = (long long)b * dm.s + (long long)c * dm.l;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + frow(rr);
    const bool ok = i < dm.l;
    const long long pos = pos0 + i;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = d0 + 8 * j + 2 * (lane & 3);
      if (!ok || col >= dm.hd) continue;
      const float2 xv = make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      *reinterpret_cast<float2*>(sc.x + pos * dm.hd + col) = xv;
      const float2 qv = *reinterpret_cast<const float2*>(q + pos * dm.hd + col);
      part += qv.x * xv.x;
      part += qv.y * xv.y;
    }
    part = quad_sum(part);
    if (ok && (lane & 3) == 0) sc.qxp[pos * nt + blockIdx.x] = part;
  }
}

// ---- 5. the raw scores, the rows, the score tiles, the scaled planes ----------

// Grid ((query tile, key tile) pair with key tile <= query tile, chunk, bh),
// one warpgroup: the raw scores q k^T and A = dh v^T of one 64 x 64 tile
// over the head dim, gated by w (zeros above the diagonal and past L) and
// kept in float32 scratch; the tile's row sums of s and s A.
__global__ void __launch_bounds__(128, 1)
bwd_scores(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tdh,
           const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ li, Scratch sc, Dims dm) {
  extern __shared__ unsigned char smem_raw[];
  Ring<kScStages, 4> ring(smem_raw, kScStages * kScStage);
  const int nj = dm.nj(), c = blockIdx.y, b = blockIdx.z;
  int it = 0, kt = blockIdx.x;
  while (kt > it) kt -= ++it;
  const int n = dm.nd(), L = dm.l;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int prow = dm.prow(), base = dm.row(0, b, c);
  // tiles of a stage: q and k (three terms), then dh and v (two)
  auto tile = [&](int slot, int which, int t) {
    const int idx = which < 2 ? 3 * which + t : 6 + 2 * (which - 2) + t;
    return ring.base + slot * kScStage + idx * kPanel;
  };
  auto issue = [&](int s) {
    const int slot = s % kScStages, col = 64 * s;
    const uint32_t bar = ring.full(slot);
    const int qrow = base + 64 * it, krow = base + 64 * kt;
    bar_expect(bar, kScStage);
    for (int t = 0; t < 3; ++t) {
      tma_2d(tile(slot, 0, t), &tq, col, qrow + t * prow, bar);
      tma_2d(tile(slot, 1, t), &tk, col, krow + t * prow, bar);
    }
    for (int t = 0; t < 2; ++t) {
      tma_2d(tile(slot, 2, t), &tdh, col, qrow + t * prow, bar);
      tma_2d(tile(slot, 3, t), &tv, col, krow + t * prow, bar);
    }
  };
  if (tid == 0)
    for (int s = 0; s < kScStages && s < n; ++s) issue(s);

  float sacc[32], aacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = aacc[e] = 0.0f;
  for (int s = 0; s < n; ++s) {
    const int slot = s % kScStages;
    bar_wait(ring.full(slot), (s / kScStages) & 1);
    fence_regs(sacc);
    fence_regs(aacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint64_t qd[3], kd[3], hd2[2], vd[2];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        qd[t] = desc_k<64>(tile(slot, 0, t), 64, 0, kk);
        kd[t] = desc_k<64>(tile(slot, 1, t), 64, 0, kk);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        hd2[t] = desc_k<64>(tile(slot, 2, t), 64, 0, kk);
        vd[t] = desc_k<64>(tile(slot, 3, t), 64, 0, kk);
      }
      wgmma_ss<64>(sacc, qd[0], kd[0], 1);
      wgmma_ss<64>(sacc, qd[0], kd[1], 1);
      wgmma_ss<64>(sacc, qd[1], kd[0], 1);
      wgmma_ss<64>(sacc, qd[0], kd[2], 1);
      wgmma_ss<64>(sacc, qd[1], kd[1], 1);
      wgmma_ss<64>(sacc, qd[2], kd[0], 1);
      wgmma_ss<64>(aacc, hd2[0], vd[0], 1);
      wgmma_ss<64>(aacc, hd2[0], vd[1], 1);
      wgmma_ss<64>(aacc, hd2[1], vd[0], 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sacc);
    fence_regs(aacc);
    __syncwarp();
    if (lane == 0 && ring.release(slot) && s + kScStages < n) {
      fence_async();
      issue(s + kScStages);
    }
  }
  const long long pos0 = (long long)b * dm.s + (long long)c * L;
  const long long mrow = ((long long)b * dm.nc + c) * dm.lp;  // in ssc, asc
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = 64 * it + 16 * warp + lane / 4 + 8 * rr;
    const bool ok = i < L;
    const float bi = ok ? sc.b[pos0 + i] : 0.0f;
    const float mpos = ok ? sc.mpos[pos0 + i] : 0.0f;
    float rs = 0.0f, rsa = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * kt + 8 * j + 2 * (lane & 3);
      float sv[2] = {0.0f, 0.0f}, av[2] = {0.0f, 0.0f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = col + u, e = 4 * j + 2 * rr + u;
        if (jj <= i && ok) {
          sv[u] = sacc[e] *
                  expf(((bi - sc.b[pos0 + jj]) + li[pos0 + jj]) - mpos);
          av[u] = aacc[e];
        }
        rs += sv[u];
        rsa += sv[u] * av[u];
      }
      const long long off = (mrow + i) * dm.lp + col;
      *reinterpret_cast<float2*>(sc.ssc + off) = make_float2(sv[0], sv[1]);
      *reinterpret_cast<float2*>(sc.asc + off) = make_float2(av[0], av[1]);
    }
    rs = quad_sum(rs);
    rsa = quad_sum(rsa);
    if (ok && (lane & 3) == 0) {
      sc.rsp[(pos0 + i) * nj + kt] = rs;
      sc.rsap[(pos0 + i) * nj + kt] = rsa;
    }
  }
}

// Grid (chunk, bh), a thread per row: den, the clamp, g and d log iw from
// the rows' partial sums, each in a fixed order.
__global__ void __launch_bounds__(kMaxChunk)
bwd_rows(Scratch sc, Dims dm) {
  const int c = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  if (i >= dm.l) return;
  const int nj = dm.nj(), nd = dm.nd(), nt = ntiles(dm);
  const long long pos = (long long)b * dm.s + (long long)c * dm.l + i;
  float rs = 0.0f, rsa = 0.0f, qn = 0.0f, qx = 0.0f;
  for (int kt = 0; kt <= i / 64; ++kt) {
    rs += sc.rsp[pos * nj + kt];
    rsa += sc.rsap[pos * nj + kt];
  }
  for (int t = 0; t < nd; ++t) qn += sc.qn[pos * nd + t];
  if (c > 0)
    for (int t = 0; t < nt; ++t) qx += sc.qxp[pos * nt + t];
  const float iw = sc.iw[pos], mpos = sc.mpos[pos];
  const float den_pre = iw * qn + rs, floor_ = expf(-mpos);
  const float den = fmaxf(fabsf(den_pre), floor_);
  const float hnum = iw * qx + rsa;
  const float g = fabsf(den_pre) > floor_
                      ? -(hnum * sgn(den_pre)) / (den * den) : 0.0f;
  const float inv = 1.0f / den;
  sc.inv[pos] = inv;
  sc.g[pos] = g;
  sc.r[pos] = iw * (qx * inv + g * qn);
}

// Grid (64 x 64 tile of the chunk's scores, chunk, bh), 4 warps: each lane
// two columns, each warp every fourth row.  ds = (A / den + g) w and s as
// bf16 planes (zeros above the diagonal and past L); P = dscores s summed
// over each row of the tile (a warp tree) and over each column (each
// thread its rows in order, then the warps in order).
__global__ void __launch_bounds__(128)
bwd_tiles(const float* __restrict__ li, Scratch sc, Dims dm) {
  __shared__ float red[4][64];
  const int nj = dm.nj(), it = blockIdx.x / nj, kt = blockIdx.x % nj;
  const int c = blockIdx.y, b = blockIdx.z, L = dm.l;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long pos0 = (long long)b * dm.s + (long long)c * L;
  const long long mrow = ((long long)b * dm.nc + c) * dm.lp;
  const long long base = dm.row(0, b, c);
  const long long splane = (long long)dm.prow() * dm.lp;
  const int col = 64 * kt + 2 * lane;
  float bj[2], lj[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool ok = col + u < L;
    bj[u] = ok ? sc.b[pos0 + col + u] : 0.0f;
    lj[u] = ok ? li[pos0 + col + u] : 0.0f;
  }
  float cs[2] = {0.0f, 0.0f};
  for (int r = warp; r < 64; r += 4) {
    const int i = 64 * it + r;
    const bool live = kt <= it && i < L;
    float sv[2] = {0.0f, 0.0f}, dv[2] = {0.0f, 0.0f}, rp = 0.0f;
    if (live) {
      const long long pos = pos0 + i;
      const float bi = sc.b[pos], mp = sc.mpos[pos], inv = sc.inv[pos],
                  g = sc.g[pos];
      const long long off = (mrow + i) * dm.lp + col;
      const float2 s2 = *reinterpret_cast<const float2*>(sc.ssc + off);
      const float2 a2 = *reinterpret_cast<const float2*>(sc.asc + off);
      sv[0] = s2.x, sv[1] = s2.y;
      const float av[2] = {a2.x, a2.y};
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (col + u <= i) {
          const float w = expf(((bi - bj[u]) + lj[u]) - mp);
          const float dsc = av[u] * inv + g;
          dv[u] = dsc * w;
          const float p = dsc * sv[u];
          rp += p;
          cs[u] += p;
        }
    }
    rp = warp_sum(rp);
    if (lane == 0 && i < L) sc.rpp[(pos0 + i) * nj + kt] = rp;
    const long long o = (base + i) * dm.lp + col;
    uint32_t hi, lo;
    split2(sv[0], sv[1], hi, lo);
    *reinterpret_cast<uint32_t*>(sc.s + o) = hi;
    *reinterpret_cast<uint32_t*>(sc.s + splane + o) = lo;
    split2(dv[0], dv[1], hi, lo);
    *reinterpret_cast<uint32_t*>(sc.ds + o) = hi;
    *reinterpret_cast<uint32_t*>(sc.ds + splane + o) = lo;
  }
  red[warp][2 * lane] = cs[0];
  red[warp][2 * lane + 1] = cs[1];
  __syncthreads();
  if (tid < 64)
    sc.cpp[(((long long)b * dm.nc + c) * nj + it) * dm.lp + 64 * kt + tid] =
        ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
}

// Grid (64-column tile, 64-row tile, chunk x bh), 16 threads a row (4
// columns each), 8 rows at a time: dh / den and q iw / den as bf16 planes;
// dn's column partials, the sums of iw g q over the tile's rows (each
// thread its rows in order, then the 8 row groups in order).
__global__ void __launch_bounds__(128)
bwd_scale(const float* __restrict__ q, const float* __restrict__ dh,
          Scratch sc, Dims dm) {
  __shared__ float s_inv[64], s_qw[64], s_ig[64], ssum[8][64];
  const int ct = blockIdx.x, it = blockIdx.y, c = blockIdx.z % dm.nc,
            b = blockIdx.z / dm.nc, L = dm.l, tid = threadIdx.x;
  const long long pos0 = (long long)b * dm.s + (long long)c * L;
  if (tid < 64) {
    const int i = 64 * it + tid;
    const bool ok = i < L;
    const float inv = ok ? sc.inv[pos0 + i] : 0.0f;
    const float iw = ok ? sc.iw[pos0 + i] : 0.0f;
    const float g = ok ? sc.g[pos0 + i] : 0.0f;
    s_inv[tid] = inv;
    s_qw[tid] = iw * inv;
    s_ig[tid] = iw * g;
  }
  __syncthreads();
  const long long plane = (long long)dm.prow() * dm.hp;
  const int rg = tid >> 4, c4 = (tid & 15) * 4, d = 64 * ct + c4;
  const bool col_ok = d < dm.hd;
  float4 acc4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = rg; r < 64; r += 8) {
    const int i = 64 * it + r;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 xq = z, xd = z;
    if (i < L && col_ok) {
      const long long src = (pos0 + i) * dm.hd + d;
      xq = *reinterpret_cast<const float4*>(q + src);
      xd = *reinterpret_cast<const float4*>(dh + src);
    }
    const float iv = s_inv[r], qw = s_qw[r], ig = s_ig[r];
    const long long dst = (long long)(dm.row(0, b, c) + i) * dm.hp + d;
    store_terms<2>(sc.dhi + dst, plane,
                   make_float4(xd.x * iv, xd.y * iv, xd.z * iv, xd.w * iv));
    store_terms<2>(sc.qs + dst, plane,
                   make_float4(xq.x * qw, xq.y * qw, xq.z * qw, xq.w * qw));
    acc4.x += ig * xq.x; acc4.y += ig * xq.y;
    acc4.z += ig * xq.z; acc4.w += ig * xq.w;
  }
  ssum[rg][c4] = acc4.x; ssum[rg][c4 + 1] = acc4.y;
  ssum[rg][c4 + 2] = acc4.z; ssum[rg][c4 + 3] = acc4.w;
  __syncthreads();
  if (tid < 64) {
    float s = 0.0f;
    for (int r = 0; r < 8; ++r) s += ssum[r][tid];
    sc.dnp[(((long long)b * dm.nc + c) * dm.nj() + it) * dm.hp + 64 * ct + tid] = s;
  }
}

// ---- 7. dq, dk, dv -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
bwd_dgrad(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tds,
          const __grid_constant__ CUtensorMap ts,
          const __grid_constant__ CUtensorMap tdhi,
          const __grid_constant__ CUtensorMap tdc,
          const float* __restrict__ k, float* __restrict__ dq,
          float* __restrict__ dk, float* __restrict__ dv, Scratch sc,
          Dims dm) {
  extern __shared__ unsigned char smem_raw[];
  Ring<kStages, 8> ring(smem_raw, kStages * kStage);
  const int nr = dm.lp / 128, nt = ntiles(dm);
  const int c = blockIdx.y / nr, r0 = (blockIdx.y % nr) * 128,
            c0 = blockIdx.x * 128;
  // kind 0 dq, 1 dk, 2 dv; the blocks of dk and dv (with the state terms,
  // the longest) are scheduled first, dq's last
  const int b = blockIdx.z % dm.bh, kind = (blockIdx.z / dm.bh + 1) % 3;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int n1 = kind > 0 && c < dm.nc - 1 ? dm.hp / 64 : 0;  // state steps
  const int k0 = kind == 0 ? 0 : r0 / 64;  // first 64-row tile of the chunk
  const int n = n1 + (kind == 0 ? (r0 + 128) / 64 : dm.nj() - r0 / 64);
  const int prow = dm.prow(), base = dm.row(0, b, c);
  const int crow = dm.bh * (dm.nc - 1) * dm.hp;
  const int dcrow = (b * (dm.nc - 1) + c) * dm.hp;  // dC into the state after c
  auto issue = [&](int s) {
    const int slot = s % kStages;
    const uint32_t at = ring.base + slot * kStage, bt = at + 2 * kTile,
                   bar = ring.full(slot);
    bar_expect(bar, kStage);
    if (s < n1) {
      if (kind == 1) {         // v dC^T
        load_tile<false>(at, &tv, 64 * s, base + r0, prow, bar);
        load_tile<false>(bt, &tdc, 64 * s, dcrow + c0, crow, bar);
      } else {                 // k dC
        load_tile<false>(at, &tk, 64 * s, base + r0, prow, bar);
        load_tile<true>(bt, &tdc, c0, dcrow + 64 * s, crow, bar);
      }
    } else {
      const int u = k0 + s - n1;
      if (kind == 0) {         // ds k
        load_tile<false>(at, &tds, 64 * u, base + r0, prow, bar);
        load_tile<true>(bt, &tk, c0, base + 64 * u, prow, bar);
      } else {                 // ds^T q, s^T (dh / den)
        load_tile<true>(at, kind == 1 ? &tds : &ts, r0, base + 64 * u, prow,
                        bar);
        load_tile<true>(bt, kind == 1 ? &tq : &tdhi, c0, base + 64 * u, prow,
                        bar);
      }
    }
  };
  if (tid == 0)
    for (int s = 0; s < kStages && s < n; ++s) issue(s);

  const long long pos0 = (long long)b * dm.s + (long long)c * dm.l;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  for (int s = 0; s < n; ++s) {
    if (s == n1 && n1 > 0) {   // the state term done: scale, k . dk's term
      const float* dn = sc.dns + ((long long)b * dm.nc + c) * dm.hp;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = r0 + frow(rr);
        const bool ok = j < dm.l;
        const long long pos = pos0 + j;
        const float kw = ok ? sc.kvw[pos] : 0.0f;
        float t = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = c0 + 8 * jj + 2 * (lane & 3);
          float& a0 = acc[4 * jj + 2 * rr];
          float& a1 = acc[4 * jj + 2 * rr + 1];
          if (kind == 1) {
            a0 = kw * (a0 + dn[col]);
            a1 = kw * (a1 + dn[col + 1]);
            if (ok && col < dm.hd) {
              const float2 kv =
                  *reinterpret_cast<const float2*>(k + pos * dm.hd + col);
              t += kv.x * a0;
              t += kv.y * a1;
            }
          } else {
            a0 = kw * a0;
            a1 = kw * a1;
          }
        }
        if (kind == 1) {
          t = quad_sum(t);
          if (ok && (lane & 3) == 0) sc.tp[pos * nt + blockIdx.x] = t;
        }
      }
    }
    const int slot = s % kStages;
    bar_wait(ring.full(slot), (s / kStages) & 1);
    const uint32_t at = ring.base + slot * kStage;
    if (s < n1) {
      if (kind == 1) mma<0, 0>(acc, at, at + 2 * kTile, wg);
      else mma<0, 1>(acc, at, at + 2 * kTile, wg);
    } else {
      if (kind == 0) mma<0, 1>(acc, at, at + 2 * kTile, wg);
      else mma<1, 1>(acc, at, at + 2 * kTile, wg);
    }
    __syncwarp();
    if (lane == 0 && ring.release(slot) && s + kStages < n) {
      fence_async();
      issue(s + kStages);
    }
  }
  float* out = kind == 0 ? dq : (kind == 1 ? dk : dv);
  const float* nc = sc.ns + ((long long)b * dm.nc + c) * dm.hp;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = r0 + frow(rr);
    if (j >= dm.l) continue;
    const long long pos = pos0 + j;
    float iw = 0.0f, inv = 0.0f, g = 0.0f;
    if (kind == 0) iw = sc.iw[pos], inv = sc.inv[pos], g = sc.g[pos];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int col = c0 + 8 * jj + 2 * (lane & 3);
      if (col >= dm.hd) continue;
      float2 val = make_float2(acc[4 * jj + 2 * rr], acc[4 * jj + 2 * rr + 1]);
      if (kind == 0) {
        float2 xv = make_float2(0.0f, 0.0f);
        if (c > 0) xv = *reinterpret_cast<const float2*>(sc.x + pos * dm.hd + col);
        val.x = val.x + iw * (xv.x * inv + g * nc[col]);
        val.y = val.y + iw * (xv.y * inv + g * nc[col + 1]);
      }
      *reinterpret_cast<float2*>(out + pos * dm.hd + col) = val;
    }
  }
}

// ---- 8. the gates' gradients ---------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_finish(float* __restrict__ dlf, float* __restrict__ dli, Scratch sc,
           Dims dm) {
  __shared__ float sdb[kMaxChunk], red[kThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, L = dm.l, nt = ntiles(dm),
            nj = dm.nj();
  const int nup = nt * nt + nt;
  for (int c = 0; c < dm.nc; ++c) {
    const long long cb = (long long)b * dm.nc + c;
    const long long pos0 = (long long)b * dm.s + (long long)c * L;
    const bool carried = c < dm.nc - 1;   // a gradient reaches the state after c
    float db = 0.0f, t = 0.0f;
    if (tid < L) {
      const long long pos = pos0 + tid;
      float col = 0.0f;
      for (int it = 0; it < nj; ++it) col += sc.cpp[(cb * nj + it) * dm.lp + tid];
      if (carried)
        for (int x = 0; x < nt; ++x) t += sc.tp[pos * nt + x];
      float rp = 0.0f;
      for (int kt = 0; kt < nj; ++kt) rp += sc.rpp[pos * nj + kt];
      db = ((sc.r[pos] + rp) - col) - t;
      dli[pos] = col + t;
    }
    if (carried) {
      const float ts = block_sum(t, red);
      float uc = 0.0f, un = 0.0f;
      if (c > 0) {                        // the first chunk starts from zeros
        for (int x = tid; x < nt * nt; x += kThreads) uc += sc.up[cb * nup + x];
        if (tid < nt) un = sc.up[cb * nup + nt * nt + tid];
      }
      uc = block_sum(uc, red);
      un = block_sum(un, red);
      if (tid == L - 1) db += ts + sc.carry[cb] * (uc + un);
    }
    sdb[tid] = db;                        // L <= 256 = the block
    __syncthreads();
    for (int off = 1; off < L; off <<= 1) {   // reverse inclusive scan
      const float y = tid + off < L ? sdb[tid + off] : 0.0f;
      __syncthreads();
      sdb[tid] += y;
      __syncthreads();
    }
    if (tid < L) dlf[pos0 + tid] = sdb[tid];
    __syncthreads();
  }
}

// ---- launcher ----------------------------------------------------------------

Dims dims(int bh, int s, int hd, int l) {
  return Dims{bh, s, hd, l, (l + 127) / 128 * 128, (hd + 127) / 128 * 128,
              s / l};
}

}  // namespace

extern "C" long long mlstm_chunk_bwd_scratch_bytes(int bh, int s, int hd,
                                                   int l) {
  return (long long)Scratch(dims(bh, s, hd, l), nullptr).bytes;
}

// q, k, v, dh (bh, s, hd), lf, li (bh, s) in; dq, dk, dv (bh, s, hd), dlf,
// dli (bh, s) out; scratch holds mlstm_chunk_bwd_scratch_bytes.  s a
// multiple of the chunk l, 1 <= l <= 256, hd a multiple of 16, bh >= 1, all
// float32, contiguous, 16-byte aligned.  Eleven grids on `stream` (eight
// when s == l: no state walks and no X).
extern "C" int mlstm_chunk_bwd(const float* q, const float* k, const float* v,
                               const float* lf, const float* li,
                               const float* dh, float* dq, float* dk,
                               float* dv, float* dlf, float* dli,
                               void* scratch, int bh, int s, int hd, int l,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Dims d = dims(bh, s, hd, l);
  const Scratch sc(d, scratch);
  const long long rows = d.prow();
  const int nt = ntiles(d), nr = d.lp / 128;
  // the walks take several heads a block where that leaves two waves of
  // blocks, so fewer blocks pay the ring's first loads
  const int heads = std::max(1, std::min(d.bh, nt * nt * d.bh / 256));
  const int nh = (d.bh + heads - 1) / heads;
  CUtensorMap mq, mk, mv, mdh, mkw, mqs, mdhi, ms, mds, mc{}, mdc{};
  if (int e = map_bf16_2d(&mq, sc.q, 3 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&mk, sc.k, 3 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&mv, sc.v, 2 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&mdh, sc.dh, 2 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&mkw, sc.kw, 2 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&mqs, sc.qs, 2 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&mdhi, sc.dhi, 2 * rows, d.hp, 64)) return e;
  if (int e = map_bf16_2d(&ms, sc.s, 2 * rows, d.lp, 64)) return e;
  if (int e = map_bf16_2d(&mds, sc.ds, 2 * rows, d.lp, 64)) return e;
  if (d.nc > 1) {
    const long long crows = 2LL * d.bh * (d.nc - 1) * d.hp;
    if (int e = map_bf16_2d(&mc, sc.c, crows, d.hp, 64)) return e;
    if (int e = map_bf16_2d(&mdc, sc.dc, crows, d.hp, 64)) return e;
  }

  mlstm_gates<<<d.bh, 32 * kGateWarps, 0, st>>>(
      lf, li, sc.b, sc.mpos, sc.iw, sc.kvw, sc.carry, sc.m, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  mlstm_prep<true><<<dim3(d.nd(), d.bh), 256, 0, st>>>(
      q, k, v, dh, sc.kvw, sc.carry, sc.q, sc.k, sc.v, sc.kw, sc.dh, sc.qn,
      sc.ns, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (d.nc > 1) {
    if (int e = prepare(bwd_walk<false>, kSmem)) return e;
    bwd_walk<false><<<dim3(nt * nt, nh), kThreads, kSmem, st>>>(
        mkw, mv, sc.c, heads, sc, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    if (int e = prepare(bwd_xproj, kSmem)) return e;
    bwd_xproj<<<dim3(nt, nr * (d.nc - 1), d.bh), kThreads, kSmem, st>>>(
        mdh, mc, q, sc, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (int e = prepare(bwd_scores, kScSmem)) return e;
  bwd_scores<<<dim3(d.nj() * (d.nj() + 1) / 2, d.nc, d.bh), 128, kScSmem,
               st>>>(mq, mk, mdh, mv, li, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_rows<<<dim3(d.nc, d.bh), kMaxChunk, 0, st>>>(sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_tiles<<<dim3(d.nj() * d.nj(), d.nc, d.bh), 128, 0, st>>>(li, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_scale<<<dim3(d.nd(), d.nj(), d.nc * d.bh), 128, 0, st>>>(q, dh, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (d.nc > 1) {
    if (int e = prepare(bwd_walk<true>, kSmem)) return e;
    bwd_walk<true><<<dim3(nt * nt, nh), kThreads, kSmem, st>>>(
        mqs, mdh, sc.dc, heads, sc, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (int e = prepare(bwd_dgrad, kSmem)) return e;
  bwd_dgrad<<<dim3(nt, nr * d.nc, 3 * d.bh), kThreads, kSmem, st>>>(
      mq, mk, mv, mds, ms, mdhi, mdc, k, dq, dk, dv, sc, d);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_finish<<<d.bh, kThreads, 0, st>>>(dlf, dli, sc, d);
  return (int)cudaGetLastError();
}

extern "C" const char* mlstm_chunk_bwd_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
