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
// Bound: K·n·128·sizeof(A) bytes of A read once.  Design: one CUDA block per
// (k, row tile), 128 threads per column set reading whole 512 B rows
// (coalesced), eight loads in flight per thread; a (K, T, 128) partial,
// then a second small pass reduces over T in fixed order.
// ---------------------------------------------------------------------------
template <typename TA>
__global__ void __launch_bounds__(THREADS, 4)
gather_partial_kernel(const TA* __restrict__ A, long long n, long long d,
                      const float* r, const int* __restrict__ idx, int T,
                      int rows, float* gpart) {
  __shared__ float s[2][THREADS];
  const int k = blockIdx.x / T, t = blockIdx.x - k * T;
  gather_item<TA, false>(A, n, d, r, nullptr, idx[k], k, t, T, rows, gpart,
                         nullptr, s);
}

__global__ void __launch_bounds__(THREADS, 4)
gather_reduce_kernel(const float* gpart, int T, float* g) {
  __shared__ float s[2][THREADS];
  const int k = blockIdx.x >> 2, q = blockIdx.x & 3;
  float gs, hs;
  reduce_item<false>(gpart, nullptr, k, q, T, s, gs, hs);
  if (threadIdx.x < 32) g[k * BLOCK + q * 32 + threadIdx.x] = gs;
}

// ---------------------------------------------------------------------------
// scatter_block_update — replaces repro/kernels/shotgun_block.py::
// scatter_block_update (Pallas, grid (T, K) accumulating over blocks).
// Bound: K·n·128·sizeof(A) bytes of A plus z read and written once.
// Design: one warp per row (4 rows per warp, 32 per CUDA block), 16 B
// vector loads, a fixed shuffle tree per row, no atomics.
// ---------------------------------------------------------------------------
template <typename TA>
__global__ void __launch_bounds__(THREADS, 4)
scatter_kernel(const TA* __restrict__ A, long long d,
               const int* __restrict__ idx, int K, const float* delta,
               const float* z_in, float* z_out) {
  scatter_tile<TA>(A, d, idx, K, delta, blockIdx.x, z_in, z_out);
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

int sb_gather_block_matvec(const void* A, int a_bf16, const float* r,
                           const int* idx, float* gpart, float* g,
                           long long n, long long d, int K, int rows, int T,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16)
    gather_partial_kernel<__nv_bfloat16><<<K * T, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), n, d, r, idx, T, rows, gpart);
  else
    gather_partial_kernel<float><<<K * T, THREADS, 0, s>>>(
        static_cast<const float*>(A), n, d, r, idx, T, rows, gpart);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gather_reduce_kernel<<<K * (BLOCK / 32), THREADS, 0, s>>>(gpart, T, g);
  return (int)cudaGetLastError();
}

int sb_scatter_block_update(const void* A, int a_bf16, const float* z_in,
                            const int* idx, const float* delta, float* z_out,
                            long long n, long long d, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = (unsigned)(n / SCATTER_ROWS);
  if (a_bf16)
    scatter_kernel<__nv_bfloat16><<<tiles, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), d, idx, K, delta, z_in, z_out);
  else
    scatter_kernel<float><<<tiles, THREADS, 0, s>>>(
        static_cast<const float*>(A), d, idx, K, delta, z_in, z_out);
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
