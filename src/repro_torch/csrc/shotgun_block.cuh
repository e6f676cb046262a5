// Device functions shared by the dense Block-Shotgun kernels
// (shotgun_block.cu).  All accumulation is f32, also for bf16-stored A, and
// every reduction runs in a fixed order, so two runs on the same inputs give
// bit-identical outputs (no float atomics anywhere).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sb {

constexpr int BLOCK = 128;         // coordinate block width (columns)
constexpr int THREADS = 256;       // threads per CUDA block, every kernel
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;   // scatter: rows each warp owns per tile
constexpr int SCATTER_ROWS = WARPS * ROWS_PER_WARP;   // 32 rows per tile
constexpr int UNROLL = 8;          // independent A loads in flight per thread

enum { LOSS_LASSO = 0, LOSS_LOGISTIC = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements of a row as f32 (16 B for f32, 8 B for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Loads of buffers that other blocks rewrite inside the fused launch (r, w,
// the partials, δ, x, the loss partials): cached in L2 only, so a read
// after grid.sync() never sees a stale L1 line.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// max(v, 0) that propagates NaN like jnp.maximum (fmaxf would drop it).
__device__ __forceinline__ float max0(float v) { return v < 0.f ? 0.f : v; }

// sign(v)·max(|v| − t, 0), NaN-propagating.
__device__ __forceinline__ float soft_threshold(float v, float t) {
  return copysignf(max0(fabsf(v) - t), v);
}

// Per-sample loss tile on the margin z (mirrors Loss.residual /
// curvature_weights / data_loss and _stable_logistic_tile):
//   r  = L'(z)·m,  w = L''(z)·m,  ll = per-sample data loss·m
// (lasso ll is e·(e·m); the 1/2 is applied to the sum).
template <int LOSS>
__device__ __forceinline__ void loss_tile(float z, float y, float m, float& r,
                                          float& w, float& ll) {
  if constexpr (LOSS == LOSS_LASSO) {
    const float e = z - y;
    r = e * m;
    w = m;
    ll = e * (e * m);
  } else {
    const float mm = -y * z;
    const float sig = 1.0f / (1.0f + expf(-mm));
    ll = (max0(mm) + log1pf(expf(-fabsf(mm)))) * m;
    r = (-y * sig) * m;
    w = (sig * (1.0f - sig)) * m;
  }
}

// Gather item (k, t): partial sums over row tile t of column block b,
//   gpart[k][t][c] = Σ_{i in tile} A[i, b·128 + c]·r[i]
//   hpart[k][t][c] = Σ_{i in tile} A[i, b·128 + c]²·w[i]     (Newton)
// Thread c (and c + 128) owns column c: every row is one coalesced read of
// the block's 128 contiguous elements.  The two half-blocks take even and
// odd rows, each in index order, and are added half 0 + half 1.
// Requires (row1 − row0) % (2·UNROLL) == 0 (n and rows are multiples of 256).
template <typename TA, bool NEWTON>
__device__ __forceinline__ void gather_item(
    const TA* __restrict__ A, long long n, long long d, const float* r,
    const float* w, int b, int k, int t, int T, int rows, float* gpart,
    float* hpart, float (*s)[THREADS]) {
  const int c = threadIdx.x & (BLOCK - 1);
  const int half = threadIdx.x >> 7;
  const long long row0 = (long long)t * rows;
  const long long row1 = min(row0 + rows, n);
  const TA* col = A + (long long)b * BLOCK + c;
  float acc = 0.f, hacc = 0.f;
  for (long long i = row0 + half; i < row1; i += 2 * UNROLL) {
    float a[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a[u] = to_f32(col[(i + 2 * u) * d]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc = fmaf(a[u], ldcg(r + i + 2 * u), acc);
      if constexpr (NEWTON) hacc = fmaf(a[u] * a[u], ldcg(w + i + 2 * u), hacc);
    }
  }
  s[0][threadIdx.x] = acc;
  if constexpr (NEWTON) s[1][threadIdx.x] = hacc;
  __syncthreads();
  if (half == 0) {
    const long long o = ((long long)k * T + t) * BLOCK + c;
    gpart[o] = s[0][c] + s[0][c + BLOCK];
    if constexpr (NEWTON) hpart[o] = s[1][c] + s[1][c + BLOCK];
  }
  __syncthreads();
}

// Reduce item (k, q): columns c = 32q .. 32q+31 of block slot k, summed
// over the T row tiles.  Warp j sums the contiguous tile range
// [j·ceil(T/8), (j+1)·ceil(T/8)) in index order (lane = column, so each
// load is one coalesced 128 B line); warp 0 then adds the eight warp sums
// in warp order.  The totals are valid in warp 0 only.
template <bool NEWTON>
__device__ __forceinline__ void reduce_item(
    const float* gpart, const float* hpart, int k, int q, int T,
    float (*s)[THREADS], float& g, float& h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (T + WARPS - 1) / WARPS;
  const int t0 = min(warp * chunk, T), t1 = min(t0 + chunk, T);
  const long long base = (long long)k * T * BLOCK + q * 32 + lane;
  float acc = 0.f, hacc = 0.f;
  int t = t0;
  for (; t + UNROLL <= t1; t += UNROLL) {
    float v[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      v[u] = ldcg(gpart + base + (long long)(t + u) * BLOCK);
      if constexpr (NEWTON) hv[u] = ldcg(hpart + base + (long long)(t + u) * BLOCK);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc += v[u];
      if constexpr (NEWTON) hacc += hv[u];
    }
  }
  for (; t < t1; ++t) {
    acc += ldcg(gpart + base + (long long)t * BLOCK);
    if constexpr (NEWTON) hacc += ldcg(hpart + base + (long long)t * BLOCK);
  }
  s[0][threadIdx.x] = acc;
  if constexpr (NEWTON) s[1][threadIdx.x] = hacc;
  __syncthreads();
  g = 0.f;
  h = 0.f;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      g += s[0][j * 32 + lane];
      if constexpr (NEWTON) h += s[1][j * 32 + lane];
    }
  }
}

// Scatter rows i = i0 + j (j < 4) of a 32-row tile (i0 = tile·32 +
// warp·4).  Lane l owns columns 4l..4l+3 of every drawn block, so each row
// of a block is one coalesced 512 B (f32) / 256 B (bf16) read per warp.
// scatter_rows adds the lane's 4 products of each drawn block k in
// [k0, k1), in k order, to its row sums acc (a chain that may be carried
// from one call to the next over consecutive k ranges); row_sum then adds
// the 32 lanes by a fixed xor-shuffle tree.  No atomics: each row has one
// owner.
template <typename TA>
__device__ __forceinline__ void scatter_rows(
    const TA* __restrict__ A, long long d, const int* __restrict__ idx,
    int k0, int k1, const float* delta, long long i0,
    float (&acc)[ROWS_PER_WARP]) {
  const int lane = threadIdx.x & 31;
  for (int k = k0; k < k1; ++k) {
    const long long colo = (long long)idx[k] * BLOCK + 4 * lane;
    const float4 dl = ldcg4(delta + k * BLOCK + 4 * lane);
    float4 a[ROWS_PER_WARP];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) a[j] = load4(A + (i0 + j) * d + colo);
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      acc[j] = fmaf(a[j].x, dl.x, acc[j]);
      acc[j] = fmaf(a[j].y, dl.y, acc[j]);
      acc[j] = fmaf(a[j].z, dl.z, acc[j]);
      acc[j] = fmaf(a[j].w, dl.w, acc[j]);
    }
  }
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace sb
