// Flash attention on Hopper's tensor cores, forward and backward, sm_90a,
// for bfloat16 inputs.
//
// Replaces the three Pallas calls of `flash_attention` in the JAX package
// (src/repro/kernels/flash_attention.py:269) for bf16 q, k, v: the forward
// `_fwd_call` (:167, body `_flash_kernel` :35), the backward dq call (:199,
// body `_flash_bwd_dq_kernel` :82) and the backward dk/dv call (:216, body
// `_flash_bwd_dkv_kernel` :118).  float32 inputs stay on the CUDA-core
// kernels of flash_attention.cu.  Inputs are padded and head-matched by the
// caller (kernels/flash_attention.py): q, k, v (B*H, S, hd) bf16 rows, keys
// at or past `kv_len` are padding, with an optional causal mask and
// sliding window.
//
// What bounds it: operations.  At the training path's (4, 9, 2048, 64) the
// forward's two products take 19.3 GFLOP (causal) against 38 MB of inputs
// and outputs, far above the card's balance point.  So every product runs
// on the tensor cores as `wgmma`, fed by TMA:
//
// - A block owns 128 rows of one (batch, head) -- query rows in the forward
//   and dq, key rows in dk/dv -- split over two warpgroups of 64 rows.  It
//   loads its own tile once and streams the tiles of the other axis
//   through a ring of 2 shared-memory stages with `cp.async.bulk.tensor`,
//   each stage's arrival signalled by an `mbarrier`.  There is no producer
//   warp: at 256 threads a thread may hold up to 255 registers, and the
//   forward's scores and split P and the dk/dv kernel's two accumulators
//   need ~200 (a producer warp capped them at 168: spills, and ptxas
//   serialized the dk/dv products; `setmaxnreg` did not lift the cap).
//   Instead the last warp to finish with a stage refills it with the tile
//   two ahead, so the copy runs under the other stage's products.  The
//   tensor maps are 3-D over (hd, S, B*H), so a tile past a head's S is
//   zero-filled by the hardware, and swizzled by the row's bytes (64 B at
//   hd 32, 128 B at hd 64 and 128, where a tile is two panels of 64
//   columns).
// - The first products (S = Q K^T, dP = dO V^T, and in dk/dv S^T = K Q^T,
//   dP^T = V dO^T) read both operands from shared memory.  Their bf16
//   products are exact, so only the order of the float32 sums differs from
//   the plain versions (kernels/ref.py).
// - The second products take P or dS from registers, where the first
//   product's accumulator already sits in the operand's layout.  The plain
//   versions and the Pallas bodies keep P and dS in float32; one bf16
//   rounding of them misses the one-ulp output and 1e-4 gradient gates
//   several times over.  So each is split into bf16 terms, hi = bf16(x),
//   then the rounded remainders, and every term goes through the tensor
//   cores into one float32 accumulator (P and dS exist in registers
//   only).  dS, and P in dk/dv, take two terms (~16 bits of x; the
//   gradients land well inside their gate).  The forward's P takes three
//   (~24 bits): with two, an output whose row sum cancels to near zero
//   can sit a few bf16 ulps from the plain version's (rare elements, in
//   an emulation on the CPU).  So 4 products where the forward's least is
//   2, 4 for dq (least 3), 6 for dk/dv (least 4).  The second operand (V,
//   K, dO or Q) is read MN-major through the descriptor's transpose bit.
//
// - The exponentials of P run on the special function unit's exp2 after a
//   multiply by log2 e (2 ulp against expf's 1, where expf spends five more
//   instructions on each of 64 elements per thread and tile); the online
//   softmax's rescale factor keeps expf.
//
// Numerics follow the Pallas bodies otherwise: the scale multiplies the
// float32 scores after the product (the forward and dq scale q before it
// there: the same at hd 64, where 1/8 is a power of two; float32 rounding
// apart at hd 32 and 128); masked scores are the finite -1e30, so a row
// whose first tiles are wholly masked takes exp(0) = 1 there and the next
// real tile's exp(-1e30 - m) = 0 wipes it; `out = acc / max(l, 1e-30)`,
// `lse = m + log(max(l, 1e-30))`; dq/dk/dv are float32.  dq and dk/dv are
// two kernels with no atomics, deterministic.  Tiles wholly masked for a
// warpgroup (causal, window, padding keys) are skipped; heavy causal tiles
// are scheduled first.
//
// Each product group is waited for at once; the two warpgroups interleave
// on their own.  Overlapping a tile's softmax with the next tile's scores
// (three stages, the scores one tile ahead) ran slower: ptxas serialized
// the products for want of registers at 128 keys (C7511) or for the
// accumulator reads between them (C7514); issuing the next scores in the
// same group as P V ran slower than a group of their own.  Left for
// later: that overlap done so ptxas keeps it, a persistent tile loop.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = 128;     // a block's own rows
constexpr int kThreads = 256;  // two warpgroups of 64 rows each
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

// Rows [row, row + R) of head bh, every panel, into the tile at dst.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int R, int row, int bh,
                                          uint32_t bar) {
#pragma unroll
  for (int p = 0; p < HD / Geo<HD>::PW; ++p)
    tma_3d(dst + p * R * Geo<HD>::SW, map, p * Geo<HD>::PW, row, bh, bar);
}

// ---- softmax pieces --------------------------------------------------------

// Bitwise, not short-circuit: the per-element mask compiles to predicated
// selects, with no branch per element.
__device__ __forceinline__ bool visible(int qp, int kp, int kv_len,
                                        int causal, int window) {
  return (kp < kv_len) & (!causal | (kp <= qp)) &
         ((window <= 0) | (kp > qp - window));
}

// No pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is visible.
__device__ __forceinline__ bool tile_masked(int q0, int nq, int k0, int nk,
                                            int kv_len, int causal,
                                            int window) {
  return k0 >= kv_len || (causal && k0 > q0 + nq - 1) ||
         (window > 0 && k0 + nk - 1 <= q0 - window);
}

// Every pair of those rows and keys is visible.
__device__ __forceinline__ bool tile_open(int q0, int nq, int k0, int nk,
                                          int kv_len, int causal, int window) {
  return k0 + nk <= kv_len && (!causal || k0 + nk - 1 <= q0) &&
         (window <= 0 || k0 > q0 + nq - 1 - window);
}

// e^x as 2^(x log2 e): a multiply and the special function unit's exp2
// (2 ulp; results under 2^-126 flush to 0, far below what a softmax row
// can resolve), where expf reduces the argument in five more
// instructions.  x <= 0 here (a score minus its row's max or log-sum-exp),
// so the multiply's rounding stays under an ulp of x.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.44269504088896341f));
  return y;
}

// One of four chains of a row's elements: its column parity and that of
// its 8-column block.
__device__ __forceinline__ int chain(int e) {
  return (e & 1) | ((e >> 2) & 1) << 1;
}

// A block's shared memory: the 1024-aligned start of its tiles (for the
// swizzle), then its barriers (the own tile's, full[kStages]) and the
// counts of warps done with each stage.
struct Block {
  uint32_t base, bars;
  unsigned char* generic;
  unsigned* done;
  __device__ Block(unsigned char* raw, uint32_t tile_bytes) {
    const uint32_t s = smem_u32(raw);
    base = (s + 1023) & ~1023u;
    generic = raw + (base - s);
    bars = base + tile_bytes;
    done = reinterpret_cast<unsigned*>(generic + tile_bytes +
                                       8 * (1 + kStages));
    if (threadIdx.x == 0) {
      for (int b = 0; b <= kStages; ++b) bar_init(bars + 8 * b, 1);
      for (int st = 0; st < kStages; ++st) done[st] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  __device__ uint32_t own() const { return bars; }
  __device__ uint32_t full(int st) const { return bars + 8 + 8 * st; }
  __device__ const float* floats(uint32_t addr) const {
    return reinterpret_cast<const float*>(generic + (addr - base));
  }
  // Lane 0 of each warp, once its products on stage st are done: true for
  // the last of the block's warps, which then refills the stage.
  __device__ bool release(int st) {
    constexpr unsigned warps = kThreads / 32;
    return atomicAdd(done + st, 1u) % warps == warps - 1;
  }
};

// Shared memory past the tiles: alignment, barriers, counts.
constexpr size_t kSlack = 1024 + 8 * (1 + kStages) + 4 * kStages;

// ---- forward ---------------------------------------------------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int sq, int kv_len, int causal, int window, float scale) {
  constexpr uint32_t OWN = Geo<HD>::bytes(kRows), TILE = Geo<HD>::bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  Block blk(smem_raw, OWN + 2 * kStages * TILE);
  const uint32_t sQ = blk.base, sK = sQ + OWN, sV = sK + kStages * TILE;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy tiles first
  // the key tiles t0.. t0 + n - 1 hold every key some row of the block sees
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(kv_len, min(q0 + kRows, sq)) : kv_len;
  const int t0 = lo / BN, n = hi > lo ? (hi + BN - 1) / BN - t0 : 0;
  auto issue = [&](int i) {  // key tile t0 + i into stage i % kStages
    const int slot = i % kStages, k0 = (t0 + i) * BN;
    bar_expect(blk.full(slot), 2 * TILE);
    load_tile<HD>(sK + slot * TILE, &tk, BN, k0, bh, blk.full(slot));
    load_tile<HD>(sV + slot * TILE, &tv, BN, k0, bh, blk.full(slot));
  };
  if (threadIdx.x == 0) {
    bar_expect(blk.own(), OWN);
    load_tile<HD>(sQ, &tq, kRows, q0, bh, blk.own());
    for (int i = 0; i < kStages && i < n; ++i) issue(i);
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int qw = q0 + 64 * wg;  // the warpgroup's first row
  const int r0 = qw + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  bar_wait(blk.own(), 0);

  for (int i = 0; i < n; ++i) {
    const int slot = i % kStages, k0 = (t0 + i) * BN;
    bar_wait(blk.full(slot), (i / kStages) & 1);
    if (!tile_masked(qw, 64, k0, BN, kv_len, causal, window)) {
      float sc[BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BN>(sc, desc_k<HD>(sQ, kRows, 64 * wg, kk),
                     desc_k<HD>(sK + slot * TILE, BN, 0, kk), kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      if (tile_open(qw, 64, k0, BN, kv_len, causal, window)) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          sc[e] = visible(r0 + 8 * frag_rr(e), k0 + frag_col(e, lane),
                          kv_len, causal, window)
                      ? sc[e] * scale : kNegInf;
      }
      // each row's max and sum in four independent chains, so their
      // latencies overlap
      float mx[2][4], sum[2][4], alpha[2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mx[0][c] = mx[1][c] = kNegInf;
        sum[0][c] = sum[1][c] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        mx[frag_rr(e)][chain(e)] = fmaxf(mx[frag_rr(e)][chain(e)], sc[e]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float m_new = fmaxf(
            m[rr], quad_max(fmaxf(fmaxf(mx[rr][0], mx[rr][1]),
                                  fmaxf(mx[rr][2], mx[rr][3]))));
        alpha[rr] = expf(m[rr] - m_new);
        m[rr] = m_new;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        sc[e] = exp_sfu(sc[e] - m[frag_rr(e)]);
        sum[frag_rr(e)][chain(e)] += sc[e];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        l[rr] = l[rr] * alpha[rr] + quad_sum((sum[rr][0] + sum[rr][1]) +
                                             (sum[rr][2] + sum[rr][3]));
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] *= alpha[frag_rr(e)];

      uint32_t p[3][BN / 4];
      split<BN, 3>(sc, p);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc_mn<HD>(sV + slot * TILE, BN, kk);
#pragma unroll
        for (int t = 0; t < 3; ++t) wgmma_rs<HD>(acc, p[t] + 4 * kk, dv);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0 && blk.release(slot) && i + kStages < n) {
      fence_async();
      issue(i + kStages);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= sq) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)bh * sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr] / denom,
                                acc[4 * j + 2 * rr + 1] / denom);
    if ((lane & 3) == 0) lse[(size_t)bh * sq + row] = m[rr] + logf(denom);
  }
}

// ---- backward: dq over query tiles, looping key tiles ----------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int sq, int kv_len, int causal, int window, float scale) {
  constexpr uint32_t OWN = Geo<HD>::bytes(kRows), TILE = Geo<HD>::bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  Block blk(smem_raw, 2 * OWN + 2 * kStages * TILE);
  const uint32_t sQ = blk.base, sDO = sQ + OWN, sK = sDO + OWN,
                 sV = sK + kStages * TILE;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(kv_len, min(q0 + kRows, sq)) : kv_len;
  const int t0 = lo / BN, n = hi > lo ? (hi + BN - 1) / BN - t0 : 0;
  auto issue = [&](int i) {
    const int slot = i % kStages, k0 = (t0 + i) * BN;
    bar_expect(blk.full(slot), 2 * TILE);
    load_tile<HD>(sK + slot * TILE, &tk, BN, k0, bh, blk.full(slot));
    load_tile<HD>(sV + slot * TILE, &tv, BN, k0, bh, blk.full(slot));
  };
  if (threadIdx.x == 0) {
    bar_expect(blk.own(), 2 * OWN);
    load_tile<HD>(sQ, &tq, kRows, q0, bh, blk.own());
    load_tile<HD>(sDO, &tdo, kRows, q0, bh, blk.own());
    for (int i = 0; i < kStages && i < n; ++i) issue(i);
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  float lse_r[2], delta_r[2], acc[HD / 2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    lse_r[rr] = row < sq ? lse[(size_t)bh * sq + row] : 0.0f;
    delta_r[rr] = row < sq ? delta[(size_t)bh * sq + row] : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  bar_wait(blk.own(), 0);

  for (int i = 0; i < n; ++i) {
    const int slot = i % kStages, k0 = (t0 + i) * BN;
    bar_wait(blk.full(slot), (i / kStages) & 1);
    if (!tile_masked(qw, 64, k0, BN, kv_len, causal, window)) {
      const bool open = tile_open(qw, 64, k0, BN, kv_len, causal, window);
      float sc[BN / 2], dp[BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BN>(sc, desc_k<HD>(sQ, kRows, 64 * wg, kk),
                     desc_k<HD>(sK + slot * TILE, BN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BN>(dp, desc_k<HD>(sDO, kRows, 64 * wg, kk),
                     desc_k<HD>(sV + slot * TILE, BN, 0, kk), kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (open) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          sc[e] = visible(r0 + 8 * frag_rr(e), k0 + frag_col(e, lane), kv_len,
                          causal, window)
                      ? sc[e] * scale : kNegInf;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {  // sc becomes dS
        const int rr = frag_rr(e);
        sc[e] = exp_sfu(sc[e] - lse_r[rr]) * (dp[e] - delta_r[rr]);
      }
      uint32_t ds[2][BN / 4];
      split<BN, 2>(sc, ds);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dk = desc_mn<HD>(sK + slot * TILE, BN, kk);
        wgmma_rs<HD>(acc, ds[0] + 4 * kk, dk);
        wgmma_rs<HD>(acc, ds[1] + 4 * kk, dk);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0 && blk.release(slot) && i + kStages < n) {
      fence_async();
      issue(i + kStages);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= sq) continue;
    float* drow = dq + ((size_t)bh * sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(drow + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * rr] * scale,
                      acc[4 * j + 2 * rr + 1] * scale);
  }
}

// ---- backward: dk and dv over key tiles, looping query tiles ---------------

template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tlse,
                   const __grid_constant__ CUtensorMap tdelta,
                   float* __restrict__ dk, float* __restrict__ dv, int sq,
                   int sk, int kv_len, int causal, int window, float scale) {
  constexpr uint32_t OWN = Geo<HD>::bytes(kRows), TILE = Geo<HD>::bytes(BQ),
                     VEC = BQ * 4;
  extern __shared__ unsigned char smem_raw[];
  Block blk(smem_raw, 2 * OWN + kStages * (2 * TILE + 2 * VEC));
  const uint32_t sK = blk.base, sV = sK + OWN, sQ = sV + OWN,
                 sDO = sQ + kStages * TILE, sL = sDO + kStages * TILE,
                 sD = sL + kStages * VEC;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;  // heavy causal tiles (small k0) first
  // the query tiles t0.. t0 + n - 1 hold every query that sees a key of
  // the block
  const int lo = causal ? k0 : 0;
  const int hi = k0 >= kv_len ? lo
                 : window > 0 ? min(sq, k0 + kRows - 1 + window) : sq;
  const int t0 = lo / BQ, n = hi > lo ? (hi + BQ - 1) / BQ - t0 : 0;
  auto issue = [&](int i) {
    const int slot = i % kStages, q0 = (t0 + i) * BQ;
    bar_expect(blk.full(slot), 2 * TILE + 2 * VEC);
    load_tile<HD>(sQ + slot * TILE, &tq, BQ, q0, bh, blk.full(slot));
    load_tile<HD>(sDO + slot * TILE, &tdo, BQ, q0, bh, blk.full(slot));
    tma_1d(sL + slot * VEC, &tlse, bh * sq + q0, blk.full(slot));
    tma_1d(sD + slot * VEC, &tdelta, bh * sq + q0, blk.full(slot));
  };
  if (threadIdx.x == 0) {
    bar_expect(blk.own(), 2 * OWN);
    load_tile<HD>(sK, &tk, kRows, k0, bh, blk.own());
    load_tile<HD>(sV, &tv, kRows, k0, bh, blk.own());
    for (int i = 0; i < kStages && i < n; ++i) issue(i);
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int kw = k0 + 64 * wg;  // the warpgroup's first key
  const int r0 = kw + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc_k[e] = acc_v[e] = 0.0f;
  bar_wait(blk.own(), 0);

  for (int i = 0; i < n; ++i) {
    const int slot = i % kStages, qt = (t0 + i) * BQ;
    bar_wait(blk.full(slot), (i / kStages) & 1);
    if (!tile_masked(qt, BQ, kw, 64, kv_len, causal, window)) {
      const bool open =
          tile_open(qt, BQ, kw, 64, kv_len, causal, window) && qt + BQ <= sq;
      const float* L = blk.floats(sL + slot * VEC);
      const float* D = blk.floats(sD + slot * VEC);
      float st[BQ / 2], dpt[BQ / 2];  // transposed: rows keys, cols queries
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BQ>(st, desc_k<HD>(sK, kRows, 64 * wg, kk),
                     desc_k<HD>(sQ + slot * TILE, BQ, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BQ>(dpt, desc_k<HD>(sV, kRows, 64 * wg, kk),
                     desc_k<HD>(sDO + slot * TILE, BQ, 0, kk), kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      if (open) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {  // st becomes P^T, dpt dS^T
          const int c = frag_col(e, lane);
          st[e] = exp_sfu(st[e] * scale - L[c]);
          dpt[e] = st[e] * (dpt[e] - D[c]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {  // queries past sq add nothing
          const int c = frag_col(e, lane), kp = r0 + 8 * frag_rr(e);
          const float x = visible(qt + c, kp, kv_len, causal, window)
                              ? st[e] * scale : kNegInf;
          st[e] = qt + c < sq ? exp_sfu(x - L[c]) : 0.0f;
          dpt[e] = st[e] * (dpt[e] - D[c]);
        }
      }
      uint32_t pt[2][BQ / 4], dst[2][BQ / 4];
      split<BQ, 2>(st, pt);
      split<BQ, 2>(dpt, dst);
      fence_regs(acc_k);
      fence_regs(acc_v);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t ddo = desc_mn<HD>(sDO + slot * TILE, BQ, kk);
        const uint64_t dq_ = desc_mn<HD>(sQ + slot * TILE, BQ, kk);
        wgmma_rs<HD>(acc_v, pt[0] + 4 * kk, ddo);
        wgmma_rs<HD>(acc_v, pt[1] + 4 * kk, ddo);
        wgmma_rs<HD>(acc_k, dst[0] + 4 * kk, dq_);
        wgmma_rs<HD>(acc_k, dst[1] + 4 * kk, dq_);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc_k);
      fence_regs(acc_v);
    }
    __syncwarp();
    if (lane == 0 && blk.release(slot) && i + kStages < n) {
      fence_async();
      issue(i + kStages);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= sk) continue;
    float* krow = dk + ((size_t)bh * sk + row) * HD;
    float* vrow = dv + ((size_t)bh * sk + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3), e = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(krow + c) =
          make_float2(acc_k[e] * scale, acc_k[e + 1] * scale);
      *reinterpret_cast<float2*>(vrow + c) =
          make_float2(acc_v[e], acc_v[e + 1]);
    }
  }
}

// ---- launchers -------------------------------------------------------------

// (B*H, S, hd) bf16 rows, boxes of `rows` rows x one panel of columns.
int map_rows(CUtensorMap* map, const void* p, int bh, int s, int hd,
             int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const int pw = hd < 64 ? hd : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)s * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)pw, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// n float32 values, boxes of `len`.
int map_vec(CUtensorMap* map, const float* p, long long n, int len) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {0};
  const cuuint32_t box[1] = {(cuuint32_t)len}, unit[1] = {1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

struct Shape {
  int bh, sq, sk, kv_len, causal, window;
  float scale;
};

// Tiles: the forward's key tiles of BN (64 at hd 128); dq's key tiles of
// 64; dk/dv's query tiles of BQ (32 at hd 128, to keep its two
// accumulators in registers).
template <int HD>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        Shape a, cudaStream_t stream) {
  constexpr int BN = HD == 128 ? 64 : 128;
  CUtensorMap mq, mk, mv;
  if (int e = map_rows(&mq, q, a.bh, a.sq, HD, kRows)) return e;
  if (int e = map_rows(&mk, k, a.bh, a.sk, HD, BN)) return e;
  if (int e = map_rows(&mv, v, a.bh, a.sk, HD, BN)) return e;
  auto kernel = flash_fwd_sm90<HD, BN>;
  const size_t smem = kSlack + Geo<HD>::bytes(kRows) +
                      2 * kStages * Geo<HD>::bytes(BN);
  if (int e = prepare(kernel, smem)) return e;
  const dim3 grid((a.sq + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, a.sq, a.kv_len, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, Shape a,
           cudaStream_t stream) {
  constexpr int BN = 64;
  CUtensorMap mq, mk, mv, mdo;
  if (int e = map_rows(&mq, q, a.bh, a.sq, HD, kRows)) return e;
  if (int e = map_rows(&mdo, dout, a.bh, a.sq, HD, kRows)) return e;
  if (int e = map_rows(&mk, k, a.bh, a.sk, HD, BN)) return e;
  if (int e = map_rows(&mv, v, a.bh, a.sk, HD, BN)) return e;
  auto kernel = flash_dq_sm90<HD, BN>;
  const size_t smem =
      kSlack + 2 * Geo<HD>::bytes(kRows) +
      2 * kStages * Geo<HD>::bytes(BN);
  if (int e = prepare(kernel, smem)) return e;
  const dim3 grid((a.sq + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, lse, delta, dq, a.sq, a.kv_len, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, float* dk, float* dv,
            Shape a, cudaStream_t stream) {
  constexpr int BQ = HD == 128 ? 32 : 64;
  CUtensorMap mq, mk, mv, mdo, ml, md;
  if (int e = map_rows(&mk, k, a.bh, a.sk, HD, kRows)) return e;
  if (int e = map_rows(&mv, v, a.bh, a.sk, HD, kRows)) return e;
  if (int e = map_rows(&mq, q, a.bh, a.sq, HD, BQ)) return e;
  if (int e = map_rows(&mdo, dout, a.bh, a.sq, HD, BQ)) return e;
  if (int e = map_vec(&ml, lse, (long long)a.bh * a.sq, BQ)) return e;
  if (int e = map_vec(&md, delta, (long long)a.bh * a.sq, BQ)) return e;
  auto kernel = flash_dkv_sm90<HD, BQ>;
  const size_t smem = kSlack + 2 * Geo<HD>::bytes(kRows) +
                      2 * kStages * (Geo<HD>::bytes(BQ) + BQ * 4);
  if (int e = prepare(kernel, smem)) return e;
  const dim3 grid((a.sk + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, ml, md, dk, dv, a.sq, a.sk, a.kv_len, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

Shape shape(int bh, int sq, int sk, int kv_len, int causal, int window,
            float scale) {
  // keys past sk do not exist: the tiles past it are zero-filled
  const int kv = kv_len < sk ? kv_len : sk;
  return Shape{bh, sq, sk, kv > 0 ? kv : 0, causal, window, scale};
}

// Calls F<hd>(args...) for bf16 inputs of head dim 32, 64 or 128;
// cudaErrorInvalidValue for float32 (flash_attention.cu's) or another dim.
#define SM90_DISPATCH(F, ...)                                       \
  if (!bf16) return (int)cudaErrorInvalidValue;                     \
  switch (hd) {                                                     \
    case 32: return F<32>(__VA_ARGS__);                             \
    case 64: return F<64>(__VA_ARGS__);                             \
    case 128: return F<128>(__VA_ARGS__);                           \
    default: return (int)cudaErrorInvalidValue;                     \
  }

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int bh, int sq, int sk, int kv_len,
                                   int causal, int window, float scale,
                                   int hd, int bf16, void* stream) {
  const Shape a = shape(bh, sq, sk, kv_len, causal, window, scale);
  SM90_DISPATCH(fwd, q, k, v, out, lse, a,
                (cudaStream_t)stream)
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dq, int bh,
                                  int sq, int sk, int kv_len, int causal,
                                  int window, float scale, int hd, int bf16,
                                  void* stream) {
  const Shape a = shape(bh, sq, sk, kv_len, causal, window, scale);
  SM90_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, a,
                (cudaStream_t)stream)
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   float* dk, float* dv, int bh, int sq,
                                   int sk, int kv_len, int causal, int window,
                                   float scale, int hd, int bf16,
                                   void* stream) {
  const Shape a = shape(bh, sq, sk, kv_len, causal, window, scale);
  SM90_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, a,
                (cudaStream_t)stream)
}

extern "C" const char* flash_attention_sm90_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
