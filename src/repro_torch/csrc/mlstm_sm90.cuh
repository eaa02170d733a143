// The chunkwise mLSTM's grids shared by its forward (mlstm_chunk_sm90.cu)
// and its backward (mlstm_chunk_bwd.cu): the sizes and plane layout, the
// gates, and the prep grid that splits the float32 operands into the bf16
// planes the tensor-core grids read through TMA.  Included once per
// source after sm90.cuh, inside no namespace; every name is internal to
// the including library.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxChunk = 256;
constexpr uint32_t kPanel = 64 * 128;  // 64 rows x 64 bf16 columns

// LP and HP: the chunk L and the head dim hd rounded up to whole tiles
// (64 in the forward, 128 in the backward), zeros in the padding.
struct Dims {
  int bh, s, hd, l, lp, hp, nc;
  __host__ __device__ int nd() const { return hp / 64; }   // column tiles
  __host__ __device__ int nj() const { return lp / 64; }   // row tiles of a chunk
  // first row of (term t, bh, chunk c) in the (terms, BH, nc, LP, .) planes
  __host__ __device__ int row(int t, int b, int c) const {
    return ((t * bh + b) * nc + c) * lp;
  }
  // rows of one term's plane
  __host__ __device__ int prow() const { return bh * nc * lp; }
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

// Four consecutive values as T bf16 terms into planes p, p + plane, ...:
// term 0 = bf16(x), term t = bf16 of what terms 0..t-1 left.
template <int T>
__device__ __forceinline__ void store_terms(__nv_bfloat16* p, long long plane,
                                            float4 x) {
  float r[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int t = 0; t < T; ++t) {
    uint2 h;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(h.x) : "f"(r[1]), "f"(r[0]));
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(h.y) : "f"(r[3]), "f"(r[2]));
    *reinterpret_cast<uint2*>(p + t * plane) = h;
    r[0] -= __uint_as_float(h.x << 16);
    r[1] -= __uint_as_float(h.x & 0xffff0000u);
    r[2] -= __uint_as_float(h.y << 16);
    r[3] -= __uint_as_float(h.y & 0xffff0000u);
  }
}

// ---- gates -------------------------------------------------------------------

constexpr int kGateWarps = 32;  // a warp per row of the stabilizers' max

// One block (32 warps) per bh walking the chunks: cumsum(log_f) as a warp
// scan (each lane sums its consecutive steps in order, then a shuffle scan
// of the lane totals), the stabilizers as warp max reductions (a warp per
// row), the weights inter_w, kv_w and the carry weight into scratch; m out.
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

// ---- prep: bf16 planes, n, q . n_prev ------------------------------------

// Grid (64-column tile, bh) walking the chunks, 16 threads a row (4
// columns each), 16 rows at a time: q, k, v and kw = k kv_w split into
// bf16 planes (LP rows a chunk, HP columns, zeros in the padding); n
// carried per column (each thread sums its rows in order, then the 16 row
// groups in order); q . n_prev in per-tile partial sums.  The forward
// (kBwd false) takes two terms of each and writes the final n to n_out;
// the backward takes three terms of q and k (its raw scores take a third),
// also splits dh, and writes each chunk's starting n to n_out (BH, nc,
// HP).
template <bool kBwd>
__global__ void __launch_bounds__(256)
mlstm_prep(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dh,
           const float* __restrict__ g_kvw, const float* __restrict__ g_carry,
           __nv_bfloat16* __restrict__ pq, __nv_bfloat16* __restrict__ pk,
           __nv_bfloat16* __restrict__ pv, __nv_bfloat16* __restrict__ pkw,
           __nv_bfloat16* __restrict__ pdh, float* __restrict__ g_qn,
           float* __restrict__ n_out, Dims dm) {
  constexpr int kQK = kBwd ? 3 : 2;
  __shared__ float sn[64], ssum[16][64];
  const int ct = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rg = tid >> 4, c4 = (tid & 15) * 4, d = ct * 64 + c4;
  const bool col_ok = d < dm.hd;  // hd % 16 == 0: all four or none
  const long long plane = (long long)dm.bh * dm.nc * dm.lp * dm.hp;
  if (tid < 64) sn[tid] = 0.0f;
  __syncthreads();
  for (int c = 0; c < dm.nc; ++c) {
    if (kBwd && tid < 64)
      n_out[((long long)b * dm.nc + c) * dm.hp + ct * 64 + tid] = sn[tid];
    const float n0 = sn[c4], n1 = sn[c4 + 1], n2 = sn[c4 + 2], n3 = sn[c4 + 3];
    float4 ks = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = rg; j < dm.lp; j += 16) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 xq = z, xk = z, xv = z, xw = z, xd = z;
      const long long pos = (long long)b * dm.s + (long long)c * dm.l + j;
      if (j < dm.l && col_ok) {
        const long long src = pos * dm.hd + d;
        xq = *reinterpret_cast<const float4*>(q + src);
        xk = *reinterpret_cast<const float4*>(k + src);
        xv = *reinterpret_cast<const float4*>(v + src);
        if (kBwd) xd = *reinterpret_cast<const float4*>(dh + src);
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
      store_terms<kQK>(pq + dst, plane, xq);
      store_terms<kQK>(pk + dst, plane, xk);
      store_terms<2>(pv + dst, plane, xv);
      store_terms<2>(pkw + dst, plane, xw);
      if (kBwd) store_terms<2>(pdh + dst, plane, xd);
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
  if (!kBwd && tid < 64 && ct * 64 + tid < dm.hd)
    n_out[(long long)b * dm.hd + ct * 64 + tid] = sn[tid];
}

}  // namespace
