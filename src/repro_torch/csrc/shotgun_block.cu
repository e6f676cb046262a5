// Dense Block-Shotgun kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (repro_torch/kernels/_build.py).
//
// Every entry returns cudaGetLastError() (0 on success) and launches on the
// caller's stream without synchronising; the caller allocates every buffer.
// All three kernels stream column blocks of A from device memory: per round
// a block of 128 columns costs n·128·sizeof(A) bytes, while the arithmetic
// is one or two FMAs per element read, so HBM bandwidth (3.35 TB/s on an
// H100 SXM) bounds them, not compute.
#include <cooperative_groups.h>

#include "shotgun_block.cuh"

namespace cg = cooperative_groups;
using namespace sb;

// ---------------------------------------------------------------------------
// gather_block_matvec — replaces repro/kernels/shotgun_block.py::
// gather_block_matvec (Pallas, grid (K, T) accumulating over sample tiles).
// Bound: K·n·128·sizeof(A) bytes of A read once; one FMA per element read,
// so bytes bound it, not operations.  Design: ONE launch of K·C CTAs, one
// wave on the card (C row chunks per drawn block, sized by the wrapper from
// the resident CTA slots, kernels/shotgun_block.py::_gather_chunks).  Chunk
// c of block k covers rows [8·⌊u·c/C⌋, 8·⌊u·(c+1)/C⌋) of the n = 8u rows,
// so chunks differ by at most 8 rows and none is empty: m = the chunk's
// rows / 8 rows per warp.  For f32 warp w takes rows w, w + 8, w + 16, ...
// of the chunk, so the CTA's warps read consecutive rows; for bf16 warp w
// takes the w-th eighth of the chunk, m contiguous rows (each the faster of
// the two on the H100: PERF.md §6).  Lane l owns columns 4l..4l+3 (one
// 16 B load a row for f32, 8 B for bf16; a warp reads whole rows) and
// keeps GATHER_U rows' loads in flight (32 KB a CTA for f32), with r
// through the read-only path (nothing rewrites it during the launch).
// The eight warp sums are added in warp order through shared memory and
// written as the chunk's 128 partials; the CTA then takes an integer
// ticket for block k (after a fence), and the CTA that draws the last one
// adds the C partials in chunk order (warp w a contiguous eighth of the
// chunks, then the eight in warp order), writes g[k] and resets the
// ticket to 0 for the next call.  No float atomics: the order of every sum
// depends on (n, C) only, so repeats on a card are bit-identical.  The
// tickets and partials are a workspace the wrapper keeps per (device,
// stream), so two calls on two streams never share a ticket and a
// stream's first call makes the only memset.  (A thread-block cluster
// reducing through distributed shared memory needs no ticket, but holds
// at most 16 CTAs of a block's chunks: too few to fill the card at K = 2.)
// ---------------------------------------------------------------------------
constexpr int GATHER_U = 8;        // rows in flight per warp

template <typename TA>
__global__ void __launch_bounds__(THREADS, 4)
gather_chunk_kernel(const TA* __restrict__ A, long long n, long long d,
                    const float* __restrict__ r, const int* __restrict__ idx,
                    int C, float* part, unsigned* ticket, float* g) {
  __shared__ float4 s[WARPS][32];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x / C, c = blockIdx.x - k * C;
  const long long units = n / WARPS;
  const long long u0 = units * c / C, u1 = units * (c + 1) / C;
  const int m = (int)(u1 - u0);
  constexpr bool SPREAD = sizeof(TA) == 4;   // f32: warps on consecutive rows
  const long long step = SPREAD ? WARPS : 1;
  const long long row0 = u0 * WARPS + (SPREAD ? warp : (long long)warp * m);
  const TA* col = A + row0 * d + (long long)idx[k] * BLOCK + 4 * lane;
  const float* rr = r + row0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < m; j += GATHER_U) {
    float4 a[GATHER_U];
    float rv[GATHER_U];
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      if (j + u < m) {
        a[u] = load4(col + (j + u) * step * d);
        rv[u] = __ldg(rr + (j + u) * step);
      }
    }
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      if (j + u < m) {
        acc.x = fmaf(a[u].x, rv[u], acc.x);
        acc.y = fmaf(a[u].y, rv[u], acc.y);
        acc.z = fmaf(a[u].z, rv[u], acc.z);
        acc.w = fmaf(a[u].w, rv[u], acc.w);
      }
    }
  }
  s[warp][lane] = acc;
  __syncthreads();
  const float* sf = reinterpret_cast<const float*>(s);
  const int t = threadIdx.x;
  if (C == 1) {            // the whole block in one CTA: no partials
    if (t < BLOCK) {
      float v = sf[t];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += sf[w * BLOCK + t];
      g[(long long)k * BLOCK + t] = v;
    }
    return;
  }
  if (t < BLOCK) {
    float v = sf[t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += sf[w * BLOCK + t];
    part[((long long)k * C + c) * BLOCK + t] = v;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) {
    last = atomicAdd(ticket + k, 1u) == (unsigned)C - 1;
    if (last) ticket[k] = 0u;   // every CTA of block k has drawn its ticket
  }
  __syncthreads();
  if (!last) return;
  const int per = (C + WARPS - 1) / WARPS;
  const int c0 = min(warp * per, C), c1 = min(c0 + per, C);
  const float* pk = part + (long long)k * C * BLOCK + 4 * lane;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = c0; q < c1; q += GATHER_U) {
    float4 v[GATHER_U];
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u)
      if (q + u < c1) v[u] = ldcg4(pk + (long long)(q + u) * BLOCK);
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      if (q + u < c1) {
        sum.x += v[u].x;
        sum.y += v[u].y;
        sum.z += v[u].z;
        sum.w += v[u].w;
      }
    }
  }
  s[warp][lane] = sum;
  __syncthreads();
  if (t < BLOCK) {
    float v = sf[t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += sf[w * BLOCK + t];
    g[(long long)k * BLOCK + t] = v;
  }
}

// ---------------------------------------------------------------------------
// scatter_block_update — replaces repro/kernels/shotgun_block.py::
// scatter_block_update (Pallas, grid (T, K) accumulating over blocks).
// Bound: K·n·128·sizeof(A) bytes of A plus z read and written once.
// Design: a persistent grid of the card's resident CTAs (one wave) whose
// warps stride over tasks of ROWS_PER_WARP rows.  Lane l owns columns
// 4l..4l+3 of every drawn block (16 B loads for f32, 8 B for bf16) and adds
// the blocks in k order into its row sums; row_sum's shuffle tree adds the
// lanes, and lane 0 writes z_out[i] = z_in[i] + Σ — per row the order of
// the fused kernels' scatter_rows, so the bits do not depend on the grid.
// Each CTA stages the draws and δ (rounded to A's type in the kernel, as
// the TPU kernel feeds δ) in shared memory once, SCATTER_KS blocks at a
// time (restaged per task group only when K > SCATTER_KS), and each warp
// issues the A loads of two blocks for its rows before their FMAs.  No
// atomics: each row has one owner.
// ---------------------------------------------------------------------------
constexpr int SCATTER_KS = 32;     // drawn blocks staged per pass
constexpr int SCATTER_KU = 2;      // drawn blocks loaded ahead per warp

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename TA>
__global__ void __launch_bounds__(THREADS, 4)
scatter_task_kernel(const TA* __restrict__ A, long long n, long long d,
                    const int* __restrict__ idx, int K,
                    const float* __restrict__ delta,
                    const float* __restrict__ z_in, float* __restrict__ z_out) {
  __shared__ float4 s_dl[SCATTER_KS][32];
  __shared__ long long s_col[SCATTER_KS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tasks = n / ROWS_PER_WARP;
  const bool one_pass = K <= SCATTER_KS;
  auto stage = [&](int k0, int kn) {
    for (int p = threadIdx.x; p < kn * 32; p += THREADS) {
      const int kk = p >> 5, l = p & 31;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          delta + (long long)(k0 + kk) * BLOCK + 4 * l));
      s_dl[kk][l] = make_float4(round_to(v.x, A), round_to(v.y, A),
                                round_to(v.z, A), round_to(v.w, A));
    }
    if (threadIdx.x < kn)
      s_col[threadIdx.x] = (long long)idx[k0 + threadIdx.x] * BLOCK;
  };
  if (one_pass) {
    stage(0, K);
    __syncthreads();
  }
  for (long long base = (long long)blockIdx.x * WARPS; base < tasks;
       base += (long long)gridDim.x * WARPS) {
    const long long task = base + warp;
    const bool live = task < tasks;
    const long long i0 = task * ROWS_PER_WARP;
    float zi = 0.f;
    if (live && lane < ROWS_PER_WARP) zi = __ldg(z_in + i0 + lane);
    const TA* rowp = A + i0 * d + 4 * lane;
    float acc[ROWS_PER_WARP];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += SCATTER_KS) {
      const int kn = min(K - k0, SCATTER_KS);
      if (!one_pass) {
        __syncthreads();
        stage(k0, kn);
        __syncthreads();
      }
      if (!live) continue;
      for (int k = 0; k < kn; k += SCATTER_KU) {
        float4 a[SCATTER_KU][ROWS_PER_WARP];
#pragma unroll
        for (int u = 0; u < SCATTER_KU; ++u) {
          if (k + u < kn) {
            const long long co = s_col[k + u];
#pragma unroll
            for (int j = 0; j < ROWS_PER_WARP; ++j)
              a[u][j] = load4(rowp + j * d + co);
          }
        }
#pragma unroll
        for (int u = 0; u < SCATTER_KU; ++u) {
          if (k + u < kn) {
            const float4 dl = s_dl[k + u][lane];
#pragma unroll
            for (int j = 0; j < ROWS_PER_WARP; ++j) {
              acc[j] = fmaf(a[u][j].x, dl.x, acc[j]);
              acc[j] = fmaf(a[u][j].y, dl.y, acc[j]);
              acc[j] = fmaf(a[u][j].z, dl.z, acc[j]);
              acc[j] = fmaf(a[u][j].w, dl.w, acc[j]);
            }
          }
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const float v = row_sum(acc[j]);
      const float zj = __shfl_sync(0xffffffffu, zi, j);
      if (lane == 0) z_out[i0 + j] = zj + v;
    }
  }
}

// Resident CTAs of `kern` on the current device (SMs × CTAs per SM);
// negative CUDA error on failure.
static int resident_ctas(const void* kern) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  return sms * per_sm;
}

static const void* pair_kernel(int which, int a_bf16) {
  if (which == 0)
    return a_bf16
        ? reinterpret_cast<const void*>(&gather_chunk_kernel<__nv_bfloat16>)
        : reinterpret_cast<const void*>(&gather_chunk_kernel<float>);
  if (which == 1)
    return a_bf16
        ? reinterpret_cast<const void*>(&scatter_task_kernel<__nv_bfloat16>)
        : reinterpret_cast<const void*>(&scatter_task_kernel<float>);
  return nullptr;
}

// ---------------------------------------------------------------------------
// fused_shotgun_rounds — replaces repro/kernels/shotgun_block.py::
// fused_shotgun_rounds (Pallas body _make_fused_kernel, call _fused_call).
// Bound: R·K·n·128·sizeof(A) bytes (each drawn block once per round) plus
// the vectors in and out.  Design: ONE persistent cooperative launch for all
// R rounds (grid = co-resident blocks), no host sync and nothing read back
// to the host.  z, x, r, w stay in device memory (L2-resident at these
// sizes) between phases, separated by grid.sync().
//
// Each round is three grid-wide phases, then the round end:
//   launch start  r = L'(z0)·m (+ w = L''(z0)·m)
//   per round
//     gather      partials of g_B = A_Bᵀ r (+ h_B = (A_B∘A_B)ᵀ w) per
//                 (k, row tile), beside the previous round's round end
//     reduce      fixed-order sums over the row tiles; δ from the pre-round
//                 x, masked for k >= k_eff
//     scatter     each row: z += Σ_k A_B δ_k, r (+ w) refreshed, per-tile
//                 loss partials; beside it x[blk_k] += δ_k
//     round end   F, nnz and the health flag (slot s on block s), beside
//                 the next gather, in which those blocks take no item
// Three barriers a round.  The order of every reduction depends on the item
// decomposition only, never on gridDim.x.  Each scatter row's z, y, m (and
// dz) are loaded with the tile's first A rows, not after its sums.
//
// The TPU kernel reads each drawn block once a round ("single-phase": the
// fetched tile serves g_B and z += A_B δ).  Here a block is n·128·sizeof(A)
// bytes (8 MiB at n = 16384, f32), so a round's drawn blocks overflow the
// 50 MB L2 and the scatter reads them again, which caps the kernel at half
// its bound.  Splitting the round into groups of blocks sized to L2 (the
// scatter of one group beside the gather of the next) measured slower on
// the H100 at every width the repo runs (PERF.md §7).
//
// BATCHED = true is batched_fused_shotgun_rounds — replaces repro/kernels/
// batched.py::batched_fused_shotgun_rounds (a jax.vmap of the same Pallas
// kernel over a leading slot axis, the solver service's step).  S stacked
// slots, each with its own z, x, y, mask, draws and [lam, beta, k_eff,
// guard_f] row, advance R rounds in the SAME cooperative launch: a grid of
// S × 528 blocks could not be co-resident, so every phase's items become
// (slot, item) pairs striding over the one grid — S·K·T gather items,
// S·K·4 reduce items, S·n/32 scatter tiles — and the three grid.sync() of a
// round are shared by all slots.  Slot s's round end runs on block
// s % gridDim.x, so S blocks finish their slots in parallel.  Every
// workspace has a slot stride; A has stride n·d, or 0 when one design is
// shared by every slot (shared_design: a stride, not a copy).  Each slot's
// reductions are ordered by its own item decomposition only, never by the
// grid or by which block ran an item, so slot s is bit-identical to the
// unbatched launch on that slot's state.  k_eff = 0 freezes a slot exactly
// (δ·0); the guard only raises the slot's health, the slot keeps updating.
// Bound: R·(bytes of the distinct live drawn blocks of all slots) + S times
// the vectors of one slot; the barriers, paid once for all slots, are what
// batching shares.
//
// EMIT_DZ = true is fused_shotgun_delta_rounds — replaces repro/kernels/
// shotgun_block.py::fused_shotgun_delta_rounds (the emit_dz variant of the
// same Pallas body), the round engine of the sharded driver.  z0 is a
// read-only margin snapshot; launch start copies it into the live view
// (the z buffer) and zeroes dz; the scatter adds each row's Σ_k A_B δ_k to
// the view and to dz and raises health on a non-finite view row; there are
// no loss partials, F or nnz, so no round end.  Same bound as above with dz
// written once instead of z.
//
// With a non-null `stamps`, the grid's last block (which runs no round
// end) records clock64() at launch start and after every grid.sync():
// 2 + 3·R stamps, the per-phase breakdown of a launch.
// ---------------------------------------------------------------------------
constexpr int SCAN_UNROLL = 16;  // round end: |x| loads in flight per thread

struct FusedArgs {
  const void* A;
  const float* y;
  const float* m;
  const int* idx;     // (R, K)
  const float* scal;  // [lam, beta, k_eff, guard_f]
  float* z;           // (n,)  in: z0, out: z after R rounds
  float* x;           // (d,)  in: x0, out: x after R rounds
  float* r;           // (n,)  round-start residual
  float* w;           // (n,)  round-start curvature weights (Newton)
  float* gpart;       // (K, T, 128)
  float* hpart;       // (K, T, 128) (Newton)
  float* delta;       // (K, 128)
  float* lpart;       // (n / 32,) loss partial per scatter tile
  float* f;           // (R,)
  int* nnz;           // (R,)
  float* health;      // ()  0 → 1 when a round's F is non-finite or > guard
                      //     (EMIT_DZ: when a row of the view is non-finite)
  long long n, d;
  int R, K, rows, T;
  const float* z0;    // (n,)  EMIT_DZ: read-only margin snapshot (z = view)
  float* dz;          // (n,)  EMIT_DZ: out, the launch's own Σ A_B δ
  int S;              // BATCHED: slots; every array above gains a leading
                      //   slot axis (scal (S, 4), health (S,), ...)
  long long a_stride; // BATCHED: elements from one slot's A to the next
                      //   (n·d stacked, 0 for a shared design)
  long long* stamps;  // (2 + 3·R,) clock stamps, or null
};

// Slot s's view for its x update and round end (batched launches): x, δ,
// the loss partials, F, nnz, health and the scalars, each moved by its
// slot stride.
__device__ __forceinline__ FusedArgs at_slot(const FusedArgs& a, int s) {
  FusedArgs b = a;
  const long long ls = s;
  b.scal = a.scal + 4 * ls;
  b.x = a.x + ls * a.d;
  b.delta = a.delta + ls * a.K * BLOCK;
  b.lpart = a.lpart + ls * (a.n / SCATTER_ROWS);
  b.f = a.f + ls * a.R;
  b.nnz = a.nnz + ls * a.R;
  b.health = a.health + ls;
  return b;
}

// x[blk_k] += δ_k for every drawn block, duplicates in k order (Alg. 2's
// multiset semantics): the pair (k, c) at a block's first draw owns
// x[blk·128 + c] and adds the δ of each of the block's draws in k order —
// the sums of a sequential update over k, with every load in flight.
__device__ __forceinline__ void x_update(const FusedArgs& a, const int* idx) {
  for (int p = threadIdx.x; p < a.K * BLOCK; p += THREADS) {
    const int k = p >> 7, c = p & (BLOCK - 1);
    const int b = idx[k];
    bool first = true;
    for (int kk = 0; kk < k; ++kk) first &= idx[kk] != b;
    if (!first) continue;
    const long long o = (long long)b * BLOCK + c;
    float v = ldcg(a.x + o) + ldcg(a.delta + k * BLOCK + c);
    for (int kk = k + 1; kk < a.K; ++kk)
      if (idx[kk] == b) v += ldcg(a.delta + kk * BLOCK + c);
    a.x[o] = v;
  }
}

// A scatter row's inputs, loaded before its tile's sums by lane j for row
// i0 + j and handed to lane 0 by a shuffle, so that their round trip
// overlaps the tile's A loads.  Nothing else writes them during the phase.
struct RowIn {
  float z, y, m, dz;
};

template <bool EMIT_DZ>
__device__ __forceinline__ RowIn row_preload(long long i0, const float* z,
                                             const float* __restrict__ y,
                                             const float* __restrict__ m,
                                             const float* dz) {
  RowIn p{0.f, 0.f, 0.f, 0.f};
  const int lane = threadIdx.x & 31;
  if (lane < ROWS_PER_WARP) {
    const long long i = i0 + lane;
    p.z = ldcg(z + i);
    p.y = y[i];
    p.m = m[i];
    if constexpr (EMIT_DZ) p.dz = ldcg(dz + i);
  }
  return p;
}

// The end of a fused scatter row: lane 0 writes z_out[i] = z[i] + Σ (the
// row_sum of its lane sums), refreshes the residual r (and Newton weights
// w) from the new margin and returns its warp's loss sum over the rows (in
// row order).  EMIT_DZ also adds Σ to dz[i] and sets health[0] = 1 when
// the new margin is not finite (every row is written every round, so this
// checks the whole margin view).
template <int LOSS, bool NEWTON, bool EMIT_DZ>
__device__ __forceinline__ float row_finish(
    const float (&acc)[ROWS_PER_WARP], long long i0, const RowIn& p,
    float* z_out, float* r, float* w, float* dz, float* health) {
  const int lane = threadIdx.x & 31;
  float ll_sum = 0.f;
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const float v = row_sum(acc[j]);
    const float zi = __shfl_sync(0xffffffffu, p.z, j);
    const float yi = __shfl_sync(0xffffffffu, p.y, j);
    const float mi = __shfl_sync(0xffffffffu, p.m, j);
    const float di = EMIT_DZ ? __shfl_sync(0xffffffffu, p.dz, j) : 0.f;
    if (lane == 0) {
      const long long i = i0 + j;
      const float zn = zi + v;
      z_out[i] = zn;
      if constexpr (EMIT_DZ) {
        dz[i] = di + v;
        if (!isfinite(zn)) health[0] = 1.f;   // max-accumulated, no atomics
      }
      float rr, ww, ll;
      loss_tile<LOSS>(zn, yi, mi, rr, ww, ll);
      r[i] = rr;
      if constexpr (NEWTON) w[i] = ww;
      ll_sum += ll;
    }
  }
  return ll_sum;
}

// F, nnz and the health flag of round rd from x (already updated) and the
// loss partials.  One block runs this beside the next round's gather, so
// keep SCAN_UNROLL independent loads in flight per thread; thread tid sums
// x[tid + 256·m] in m order whatever the unroll.
template <int LOSS>
__device__ __forceinline__ void round_end(const FusedArgs& a, int rd,
                                          float lam, float guard,
                                          long long n_tiles,
                                          float (*s)[THREADS], int* s_nnz) {
  const int tid = threadIdx.x;
  float l1 = 0.f, data = 0.f;
  int nz = 0;
  for (long long j0 = tid; j0 < a.d; j0 += (long long)THREADS * SCAN_UNROLL) {
    float v[SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const long long j = j0 + (long long)u * THREADS;
      v[u] = j < a.d ? ldcg(a.x + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      l1 += fabsf(v[u]);
      nz += (v[u] != 0.f);
    }
  }
  for (long long t0 = tid; t0 < n_tiles; t0 += (long long)THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long t = t0 + (long long)u * THREADS;
      v[u] = t < n_tiles ? ldcg(a.lpart + t) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) data += v[u];
  }
  s[0][tid] = l1;
  s[1][tid] = data;
  s_nnz[tid] = nz;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) {
      s[0][tid] += s[0][tid + off];
      s[1][tid] += s[1][tid + off];
      s_nnz[tid] += s_nnz[tid + off];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float loss = LOSS == LOSS_LASSO ? 0.5f * s[1][0] : s[1][0];
    const float f = loss + lam * s[0][0];
    a.f[rd] = f;
    a.nnz[rd] = s_nnz[0];
    if (!isfinite(f) || f > guard) a.health[0] = 1.f;   // max-accumulated
  }
  __syncthreads();
}

template <typename TA, int LOSS, bool NEWTON, bool EMIT_DZ, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 4) fused_rounds_kernel(FusedArgs a) {
  static_assert(!(EMIT_DZ && BATCHED), "no batched delta kernel");
  cg::grid_group grid = cg::this_grid();
  __shared__ float s[2][THREADS];
  __shared__ int s_nnz[THREADS];
  const TA* A = static_cast<const TA*>(a.A);
  const float lam = a.scal[0], beta = a.scal[1], guard = a.scal[3];
  const int k_eff = (int)a.scal[2];
  const int S = BATCHED ? a.S : 1;
  const long long n_tiles = a.n / SCATTER_ROWS;
  const int grid_n = gridDim.x;
  // Blocks 0..S-1 run the round ends; they take no gather item of the next
  // round unless that would leave too few blocks for it.
  const int n_end = EMIT_DZ ? 0 : (S < grid_n ? S : grid_n);
  const int skip = 4 * n_end <= grid_n ? n_end : 0;
  // Slot so's arrays start so strides in (64-bit: S·n·d passes 2^31 at the
  // paper's widths).  Unbatched, so and every slot stride are compile-time
  // zeros, so the offsets fold away.
  const long long kt = BATCHED ? (long long)a.K * a.T * BLOCK : 0;
  const long long kb = BATCHED ? (long long)a.K * BLOCK : 0;
  const long long rk = BATCHED ? (long long)a.R * a.K : 0;
  const long long as = BATCHED ? a.a_stride : 0;
  const bool stamp = a.stamps != nullptr && blockIdx.x == grid_n - 1 &&
                     threadIdx.x == 0;
  int ns = 0;
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
  };
  if (stamp) a.stamps[ns++] = clock64();

  // The (S, n) vectors are contiguous: one flat pass covers every slot.
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < S * a.n; i += (long long)grid_n * THREADS) {
    float rr, ww, ll, zi;
    if constexpr (EMIT_DZ) {
      zi = a.z0[i];
      a.z[i] = zi;
      a.dz[i] = 0.f;
    } else {
      zi = a.z[i];
    }
    loss_tile<LOSS>(zi, a.y[i], a.m[i], rr, ww, ll);
    a.r[i] = rr;
    if constexpr (NEWTON) a.w[i] = ww;
  }
  sync();

  for (int rd = 0; rd < a.R; ++rd) {
    const int* idx = a.idx + (long long)rd * a.K;
    // 1: gather partials from the round-start r (and w), beside the
    // previous round's round ends.
    const int n_gather = a.K * a.T;
    for (int it = (int)blockIdx.x - skip; it >= 0 && it < S * n_gather;
         it += grid_n - skip) {
      const int so = BATCHED ? it / n_gather : 0;
      const int j = it - so * n_gather;
      const int k = j / a.T, t = j - k * a.T;
      gather_item<TA, NEWTON>(A + so * as, a.n, a.d, a.r + so * a.n,
                              a.w + (NEWTON ? so * a.n : 0), (idx + so * rk)[k],
                              k, t, a.T, a.rows, a.gpart + so * kt,
                              a.hpart + (NEWTON ? so * kt : 0), s);
    }
    sync();
    // 2: g (and h) per column, then δ from the pre-round x.
    const int n_reduce = a.K * (BLOCK / 32);
    for (int it = blockIdx.x; it < S * n_reduce; it += grid_n) {
      const int so = BATCHED ? it / n_reduce : 0;
      const int j = it - so * n_reduce;
      const int k = j >> 2, q = j & 3;
      float g, h;
      reduce_item<NEWTON>(a.gpart + so * kt, a.hpart + (NEWTON ? so * kt : 0),
                          k, q, a.T, s, g, h);
      if (threadIdx.x < 32) {
        const float* sc = a.scal + 4 * so;
        const float lm = BATCHED ? sc[0] : lam, bt = BATCHED ? sc[1] : beta;
        const int ke = BATCHED ? (int)sc[2] : k_eff;
        const int c = q * 32 + threadIdx.x;
        const float xs =
            ldcg(a.x + so * a.d + (long long)(idx + so * rk)[k] * BLOCK + c);
        const float hh = NEWTON ? (h < 1e-8f ? 1e-8f : h) : bt;
        const float xn = soft_threshold(xs - g / hh, lm / hh);
        (a.delta + so * kb)[k * BLOCK + c] = (xn - xs) * (k < ke ? 1.f : 0.f);
      }
      __syncthreads();
    }
    sync();
    // 3: z += A_B δ (EMIT_DZ: also dz); refresh r (and w); loss partial
    // per 32-row tile (slot so's tile t is partial it = so·n_tiles + t).
    for (long long it = blockIdx.x; it < S * n_tiles; it += grid_n) {
      const int so = BATCHED ? (int)(it / n_tiles) : 0;
      const long long vo = so * a.n;
      const long long i0 = (it - so * n_tiles) * SCATTER_ROWS +
                           (threadIdx.x >> 5) * ROWS_PER_WARP;
      const RowIn p = row_preload<EMIT_DZ>(i0, a.z + vo, a.y + vo, a.m + vo,
                                           a.dz);
      float acc[ROWS_PER_WARP];
#pragma unroll
      for (int j = 0; j < ROWS_PER_WARP; ++j) acc[j] = 0.f;
      scatter_rows<TA>(A + so * as, a.d, idx + so * rk, 0, a.K,
                       a.delta + so * kb, i0, acc);
      const float ll = row_finish<LOSS, NEWTON, EMIT_DZ>(
          acc, i0, p, a.z + vo, a.r + vo, a.w + (NEWTON ? vo : 0), a.dz,
          a.health);
      if constexpr (EMIT_DZ) continue;
      if ((threadIdx.x & 31) == 0) s[0][threadIdx.x >> 5] = ll;
      __syncthreads();
      if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int j = 0; j < WARPS; ++j) tot += s[0][j];
        a.lpart[it] = tot;
      }
      __syncthreads();
    }
    // beside the scatter: x[blk_k] += δ_k, slot s on CTA grid−1−s (every δ
    // of the round was taken, from the pre-round x, in phase 2)
    for (int sl = grid_n - 1 - (int)blockIdx.x; sl < S; sl += grid_n)
      x_update(BATCHED ? at_slot(a, sl) : a, idx + sl * rk);
    sync();
    // 4: round end, slot s on block s % gridDim.x (unbatched: block 0).
    // The next round's gather reads neither x nor the loss partials, and
    // its barrier orders these reads before the next δ and x update.
    if constexpr (!EMIT_DZ) {
      for (int sl = blockIdx.x; sl < S; sl += grid_n) {
        const FusedArgs b = BATCHED ? at_slot(a, sl) : a;
        round_end<LOSS>(b, rd, BATCHED ? b.scal[0] : lam,
                        BATCHED ? b.scal[3] : guard, n_tiles, s, s_nnz);
      }
    }
  }
}

// Co-resident CUDA blocks for a cooperative launch of `kern` (negative CUDA
// error code on failure).
static int coop_blocks(const void* kern) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

template <typename TA, int LOSS, bool NEWTON, bool EMIT_DZ, bool BATCHED>
static const void* fused_kernel() {
  return reinterpret_cast<const void*>(
      &fused_rounds_kernel<TA, LOSS, NEWTON, EMIT_DZ, BATCHED>);
}

template <typename TA, bool EMIT_DZ, bool BATCHED>
static const void* pick_fused(int loss) {
  switch (loss) {
    case 0: return fused_kernel<TA, LOSS_LASSO, false, EMIT_DZ, BATCHED>();
    case 1: return fused_kernel<TA, LOSS_LOGISTIC, false, EMIT_DZ, BATCHED>();
    case 2: return fused_kernel<TA, LOSS_LASSO, true, EMIT_DZ, BATCHED>();
    case 3: return fused_kernel<TA, LOSS_LOGISTIC, true, EMIT_DZ, BATCHED>();
    default: return nullptr;
  }
}

// Loss code: bit 0 logistic, bit 1 Newton, bit 2 EMIT_DZ (the delta
// kernel), bit 3 BATCHED (the slot kernel); bits 2 and 3 exclude each other.
static const void* pick_fused(int a_bf16, int code) {
  const int loss = code & 3;
  if ((code & ~15) || (code & 12) == 12) return nullptr;
  if (code & 4)
    return a_bf16 ? pick_fused<__nv_bfloat16, true, false>(loss)
                  : pick_fused<float, true, false>(loss);
  if (code & 8)
    return a_bf16 ? pick_fused<__nv_bfloat16, false, true>(loss)
                  : pick_fused<float, false, true>(loss);
  return a_bf16 ? pick_fused<__nv_bfloat16, false, false>(loss)
                : pick_fused<float, false, false>(loss);
}

static int launch_fused(const void* kern, FusedArgs a, void* stream) {
  if (!kern) return (int)cudaErrorInvalidValue;
  const int blocks = coop_blocks(kern);
  if (blocks <= 0) return blocks < 0 ? -blocks : (int)cudaErrorInvalidConfiguration;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(THREADS),
                                              params, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it; the launch never ran
    return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Resident CTAs on the current device of the gather (which = 0) or the
// scatter (1) for this A type: the wrapper sizes their grids from it (and
// asks once per device); negative CUDA error on failure.
int sb_pair_slots(int which, int a_bf16) {
  const void* kern = pair_kernel(which, a_bf16);
  if (!kern) return -(int)cudaErrorInvalidValue;
  return resident_ctas(kern);
}

// C row chunks per drawn block (1 <= C <= n / 8); part: (K, C, 128) f32
// scratch; ticket: (K,) zeros, left zeroed by the launch.
int sb_gather_block_matvec(const void* A, int a_bf16, const float* r,
                           const int* idx, float* part, unsigned* ticket,
                           float* g, long long n, long long d, int K, int C,
                           void* stream) {
  if (K < 1 || C < 1 || C > n / WARPS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)K * (unsigned)C;
  if (a_bf16)
    gather_chunk_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), n, d, r, idx, C, part, ticket,
        g);
  else
    gather_chunk_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(A), n, d, r, idx, C, part, ticket, g);
  return (int)cudaGetLastError();
}

// delta: (K, 128) f32, rounded to A's type by the kernel; grid: CTAs.
int sb_scatter_block_update(const void* A, int a_bf16, const float* z_in,
                            const int* idx, const float* delta, float* z_out,
                            long long n, long long d, int K, int grid,
                            void* stream) {
  if (K < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16)
    scatter_task_kernel<__nv_bfloat16><<<(unsigned)grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), n, d, idx, K, delta, z_in,
        z_out);
  else
    scatter_task_kernel<float><<<(unsigned)grid, THREADS, 0, s>>>(
        static_cast<const float*>(A), n, d, idx, K, delta, z_in, z_out);
  return (int)cudaGetLastError();
}

// Grid size (CUDA blocks) of the fused launch for this A type and loss
// code (bit 0 logistic, bit 1 Newton, bit 2 the delta kernel); negative
// CUDA error on failure.
int sb_fused_grid_blocks(int a_bf16, int loss) {
  if (loss & ~7) return -(int)cudaErrorInvalidValue;
  const void* kern = pick_fused(a_bf16, loss);
  if (!kern) return -(int)cudaErrorInvalidValue;
  return coop_blocks(kern);
}

// stamps: (2 + 3·R,) int64 or null.
int sb_fused_shotgun_rounds(const void* A, int a_bf16, int loss,
                            const float* y, const float* m, const int* idx,
                            const float* scal, float* z, float* x, float* r,
                            float* w, float* gpart, float* hpart,
                            float* delta, float* lpart, float* f, int* nnz,
                            float* health, long long n, long long d, int R,
                            int K, int rows, int T, long long* stamps,
                            void* stream) {
  if (loss & ~3) return (int)cudaErrorInvalidValue;
  FusedArgs a{A, y, m, idx, scal, z, x, r, w, gpart, hpart, delta, lpart,
              f, nnz, health, n, d, R, K, rows, T, nullptr, nullptr, 1, 0,
              stamps};
  return launch_fused(pick_fused(a_bf16, loss), a, stream);
}

// The slot kernel: every array carries a leading slot axis of S (scal
// (S, 4), health (S,), f and nnz (S, R), the workspaces S times one
// slot's); A advances a_stride elements per slot (0: one shared design).
int sb_batched_fused_shotgun_rounds(const void* A, int a_bf16, int loss,
                                    long long a_stride, const float* y,
                                    const float* m, const int* idx,
                                    const float* scal, float* z, float* x,
                                    float* r, float* w, float* gpart,
                                    float* hpart, float* delta, float* lpart,
                                    float* f, int* nnz, float* health,
                                    long long n, long long d, int S, int R,
                                    int K, int rows, int T, void* stream) {
  if ((loss & ~3) || S < 1) return (int)cudaErrorInvalidValue;
  FusedArgs a{A, y, m, idx, scal, z, x, r, w, gpart, hpart, delta, lpart,
              f, nnz, health, n, d, R, K, rows, T, nullptr, nullptr, S,
              a_stride, nullptr};
  return launch_fused(pick_fused(a_bf16, loss | 8), a, stream);
}

// Grid size (CUDA blocks) of the slot kernel for this A type and loss code
// (bit 0 logistic, bit 1 Newton); negative CUDA error on failure.
int sb_batched_grid_blocks(int a_bf16, int loss) {
  if (loss & ~3) return -(int)cudaErrorInvalidValue;
  return coop_blocks(pick_fused(a_bf16, loss | 8));
}

// The delta kernel: z0 read-only, view (n,) scratch, dz (n,) out, x in/out.
int sb_fused_shotgun_delta_rounds(const void* A, int a_bf16, int loss,
                                  const float* y, const float* m,
                                  const int* idx, const float* scal,
                                  const float* z0, float* view, float* dz,
                                  float* x, float* r, float* w, float* gpart,
                                  float* hpart, float* delta, float* health,
                                  long long n, long long d, int R, int K,
                                  int rows, int T, void* stream) {
  if (loss & ~3) return (int)cudaErrorInvalidValue;
  FusedArgs a{A, y, m, idx, scal, view, x, r, w, gpart, hpart, delta,
              nullptr, nullptr, nullptr, health, n, d, R, K, rows, T, z0, dz,
              1, 0, nullptr};
  return launch_fused(pick_fused(a_bf16, loss | 4), a, stream);
}

}  // extern "C"
