// BlockedCSC sparse Block-Shotgun kernels for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// A is stored as (nblk, tile, 128) rows/vals tiles (data/sparse.py); a
// drawn block costs tile·128·(4 + value bytes) bytes, a few KB, so at the
// sizes users run (n ≈ 2·10⁴, K ≤ 32) every call moves under 1 MB of
// tiles and is bound by launch and memory latency, not by HBM bandwidth.
// The margin-sized vectors (z, r, the fused kernels' (K, n) scatter
// buffer) fit in L2.
//
// Determinism without float atomics: the fused kernels' gather gives each
// (k, column) one owner that sums the tile axis in order (the two-kernel
// gather: fixed slices, added in slice order); the scatter sums each run of
// equal rows of a block in the block's row-sorted slot order (built once
// per problem, data/sparse.py::scatter_order) into its own row of a (K, n)
// buffer, and one pass over n then adds the K rows in k order (the
// two-kernel scatter: the same sums in the same order, with each row
// range's runs staged in shared memory instead of the buffer).  Padding
// slots (row 0, value 0) are left out of the runs; their 0·δ_c (NaN for a
// non-finite δ_c, as in the reference) reaches row 0 through a per-block
// term over the columns that have one.
//
// Every entry returns cudaGetLastError() (0 on success) and launches on the
// caller's stream without synchronising; the caller allocates every buffer.
#include <cooperative_groups.h>

#include "shotgun_block.cuh"

namespace cg = cooperative_groups;
using namespace sb;

namespace {

constexpr int XCHUNK = 4096;      // |x| / nnz partial: elements per item
constexpr int HALF = THREADS / BLOCK;   // (k, column) items per CUDA block
// Two-kernel gather: tile rows in flight per thread and pass.
constexpr int GATHER_U = 16;
// Two-kernel scatter: rows per CTA (data/sparse.py::RANGE_ROWS), drawn
// blocks per chunk, staged slots per window (46 KB of shared memory).
constexpr int RANGE_ROWS = 128;
constexpr int RANGE_KC = 64;
constexpr int RANGE_STAGE = 1024;

// Fixed-order block-wide sum (valid in thread 0).  Every thread calls it.
__device__ __forceinline__ float block_sum(float v, float* s) {
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  const float out = s[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int block_sum_int(int v, int* s) {
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  const int out = s[0];
  __syncthreads();
  return out;
}

// g = Σ_t vals[b, t, c]·r[rows[b, t, c]] (and h = Σ vals²·w[rows] for
// Newton) in t order.  Each t row of a tile is 128 contiguous entries, so
// the 128 threads of a column set read it in one coalesced line.
template <typename TV, bool NEWTON>
__device__ __forceinline__ void gather_col(const int* __restrict__ rows,
                                           const TV* __restrict__ vals,
                                           const float* r, const float* w,
                                           long long b, int c, int tile,
                                           float& g, float& h) {
  const long long base = b * tile * BLOCK + c;
  float acc = 0.f, hacc = 0.f;
  int t = 0;
  for (; t + UNROLL <= tile; t += UNROLL) {
    int ri[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ri[u] = rows[base + (long long)(t + u) * BLOCK];
      v[u] = to_f32(vals[base + (long long)(t + u) * BLOCK]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc = fmaf(v[u], ldcg(r + ri[u]), acc);
      if constexpr (NEWTON) hacc = fmaf(v[u] * v[u], ldcg(w + ri[u]), hacc);
    }
  }
  for (; t < tile; ++t) {
    const int ri = rows[base + (long long)t * BLOCK];
    const float v = to_f32(vals[base + (long long)t * BLOCK]);
    acc = fmaf(v, ldcg(r + ri), acc);
    if constexpr (NEWTON) hacc = fmaf(v * v, ldcg(w + ri), hacc);
  }
  g = acc;
  h = hacc;
}

// Run sums of item (k, q): sorted slots j in [q·256, (q+1)·256) of block
// b = idx[k].  The thread at the head of a run of equal rows sums the run
// in slot order (the sort is stable) and writes buf[k][row]; rows the block
// does not touch keep buf's zero.  Item q == 0 also writes the block's
// padding term (warp 0, a fixed shuffle tree over the 128 columns).
template <typename TV>
__device__ __forceinline__ void scatter_runs(
    const int* __restrict__ rows, const TV* __restrict__ vals,
    const int* __restrict__ order, const int* __restrict__ count,
    const unsigned char* __restrict__ zmask, const int* idx,
    const float* delta, int k, int q, int tile, long long n, float* buf,
    float* padterm) {
  const long long b = idx[k];
  const long long bo = b * tile * BLOCK;
  const int m = count[b];
  const int j = q * THREADS + threadIdx.x;
  const float* dk = delta + (long long)k * BLOCK;
  if (j < m) {
    const int s = order[bo + j];
    const int row = rows[bo + s];
    if (j == 0 || rows[bo + order[bo + j - 1]] != row) {
      float acc = to_f32(vals[bo + s]) * ldcg(dk + (s & (BLOCK - 1)));
      for (int jj = j + 1; jj < m; ++jj) {
        const int s2 = order[bo + jj];
        if (rows[bo + s2] != row) break;
        acc = fmaf(to_f32(vals[bo + s2]), ldcg(dk + (s2 & (BLOCK - 1))), acc);
      }
      buf[(long long)k * n + row] = acc;
    }
  }
  if (q == 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float t = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = lane * 4 + u;
      if (zmask[b * BLOCK + c]) t += 0.f * ldcg(dk + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) padterm[k] = t;
  }
}

// acc + Σ_k buf[k][i] in k order (+ the padding terms on row 0), zeroing
// buf as it is read.
__device__ __forceinline__ float combine_sum(float acc, long long i,
                                             long long n, int K, float* buf,
                                             const float* padterm) {
  int k = 0;
  for (; k + UNROLL <= K; k += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = ldcg(buf + (long long)(k + u) * n + i);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      buf[(long long)(k + u) * n + i] = 0.f;
      acc += v[u];
    }
  }
  for (; k < K; ++k) {
    acc += ldcg(buf + (long long)k * n + i);
    buf[(long long)k * n + i] = 0.f;
  }
  if (i == 0)
    for (int kk = 0; kk < K; ++kk) acc += ldcg(padterm + kk);
  return acc;
}

// Combine tile q (rows q·256 ..): z_out[i] = z_in[i] + Σ_k buf[k][i].  FUSED
// also refreshes r (and w) from the new margin and returns this thread's
// per-sample loss (0 past n).
template <int LOSS, bool NEWTON, bool FUSED>
__device__ __forceinline__ float combine_row(long long i, long long n, int K,
                                             const float* z_in, float* z_out,
                                             float* buf,
                                             const float* padterm,
                                             const float* __restrict__ y,
                                             float* r, float* w) {
  if (i >= n) return 0.f;
  const float acc = combine_sum(ldcg(z_in + i), i, n, K, buf, padterm);
  z_out[i] = acc;
  if constexpr (FUSED) {
    float rr, ww, ll;
    loss_tile<LOSS>(acc, y[i], 1.f, rr, ww, ll);   // no sample mask here
    r[i] = rr;
    if constexpr (NEWTON) w[i] = ww;
    return ll;
  }
  return 0.f;
}

// The delta kernel's combine: c = Σ_k buf[k][i] (+ the padding terms on
// row 0) is added to the live view and to dz; a non-finite view row raises
// health (every row is visited every round); r (and w) from the new view.
template <int LOSS, bool NEWTON>
__device__ __forceinline__ void combine_delta_row(
    long long i, long long n, int K, float* view, float* dz, float* buf,
    const float* padterm, const float* __restrict__ y, float* r, float* w,
    float* health) {
  if (i >= n) return;
  const float c = combine_sum(0.f, i, n, K, buf, padterm);
  const float zn = ldcg(view + i) + c;
  view[i] = zn;
  dz[i] = ldcg(dz + i) + c;
  if (!isfinite(zn)) health[0] = 1.f;   // max-accumulated, no atomics
  float rr, ww, ll;
  loss_tile<LOSS>(zn, y[i], 1.f, rr, ww, ll);
  r[i] = rr;
  if constexpr (NEWTON) w[i] = ww;
}

}  // namespace

// ---------------------------------------------------------------------------
// sparse_gather_block_matvec — replaces repro/kernels/shotgun_sparse.py::
// sparse_gather_block_matvec (Pallas, grid (K,)).  Bound: the K drawn
// tiles (K·tile·128·(4 + value bytes)) plus r; at n ≈ 2·10⁴ that is under
// 1 MB, so the latency of the dependent loads idx → rows → r[rows] bounds
// it.  Design: one CTA per drawn block, its tile axis split in two slices
// (thread = (slice, column)); per pass each thread issues GATHER_U rows/vals
// loads of its slice, then their r[rows] loads, and sums them in t order —
// one pass (two dependent round trips) for tiles up to 32 deep, two up to
// 64.  The two slice sums are added in slice order through shared memory.
// (Measured on the H100 and set aside: one pass of 36 rows, 512- and
// 1024-thread CTAs of 4 and 8 slices, and clusters of 2–8 CTAs per block;
// the extra registers, threads or cluster barriers cost more than the
// round trips they save.)  No atomics: the order depends only on the tile depth, so repeats are
// bit-identical.
// ---------------------------------------------------------------------------
template <typename TV>
__global__ void __launch_bounds__(THREADS)
sparse_gather_split_kernel(const int* __restrict__ rows,
                           const TV* __restrict__ vals,
                           const float* __restrict__ r,
                           const int* __restrict__ idx, int tile,
                           float* __restrict__ g) {
  __shared__ float part[THREADS];
  const int k = blockIdx.x;
  const int c = threadIdx.x & (BLOCK - 1);
  const int per = (tile + HALF - 1) / HALF;
  const int t0 = min((threadIdx.x >> 7) * per, tile);
  const int t1 = min(t0 + per, tile);
  const long long base = (long long)idx[k] * tile * BLOCK + c;
  float acc = 0.f;
  for (int t = t0; t < t1; t += GATHER_U) {
    int ri[GATHER_U];
    float v[GATHER_U], rv[GATHER_U];
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      if (t + u < t1) {
        ri[u] = rows[base + (long long)(t + u) * BLOCK];
        v[u] = to_f32(vals[base + (long long)(t + u) * BLOCK]);
      }
    }
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u)
      if (t + u < t1) rv[u] = __ldg(r + ri[u]);
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u)
      if (t + u < t1) acc = fmaf(v[u], rv[u], acc);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < BLOCK)
    g[(long long)k * BLOCK + c] = part[c] + part[BLOCK + c];
}

// ---------------------------------------------------------------------------
// sparse_scatter_block_update — replaces repro/kernels/shotgun_sparse.py::
// sparse_scatter_block_update (Pallas, grid (K,), a VMEM f32 accumulator).
// Bound: the K drawn tiles plus z read and written once; at n ≈ 2·10⁴
// under 1 MB, so latency bounds it.  Design: ONE launch, no (K, n) buffer.
// CTA q owns rows [q·RANGE_ROWS, (q+1)·RANGE_ROWS) and reads z over them
// once.  For a chunk of up to RANGE_KC drawn blocks it reads each block's
// segment bounds from the cached range-start table (data/sparse.py::
// range_starts), lays the segments end to end (a block-wide prefix sum),
// and every thread loads its slots at once: order → (row, val, δ), staged
// in shared memory (windows of RANGE_STAGE slots).  The head of each run
// of equal rows of a block sums the run in slot order (fmaf, the first
// term a product) into part[k][row]; each row's owner then adds the
// chunk's part[k][row] to its z in k order.  So z_out[i] = ((z[i] + s_0(i))
// + s_1(i)) + … + s_{K−1}(i) with s_k the run sum (0 where block k has no
// slot at row i), the order of the fused kernels' buffer and combine.  A
// padding slot's 0·δ_c is +0 or NaN, so the K padding terms of row 0 add
// up to one +0 or NaN, added last.  No atomics; repeats are bit-identical.
// ---------------------------------------------------------------------------

namespace {

// Exclusive prefix sum over the CUDA block (every thread calls it); the
// block total in `total`.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int sw = wsum[w];
    before += w < warp ? sw : 0;
    tot += sw;
  }
  __syncthreads();
  total = tot;
  return before + x - v;
}

}  // namespace

template <typename TV>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(const int* __restrict__ rows, const TV* __restrict__ vals,
                    const int* __restrict__ order,
                    const int* __restrict__ rstart,
                    const unsigned char* __restrict__ zmask,
                    const float* __restrict__ z_in,
                    const int* __restrict__ idx,
                    const float* __restrict__ delta,
                    float* __restrict__ z_out, long long n, int tile, int K) {
  __shared__ float part[RANGE_KC * RANGE_ROWS];
  __shared__ float sv[RANGE_STAGE], sd[RANGE_STAGE];
  __shared__ int skey[RANGE_STAGE];      // chunk k · RANGE_ROWS + local row
  __shared__ int sblk[RANGE_KC], slo[RANGE_KC], soff[RANGE_KC + 1];
  __shared__ int wsum[WARPS];
  __shared__ int carry;                  // key of the previous window's last
  const int q = blockIdx.x;
  const long long nq1 = (n + RANGE_ROWS - 1) / RANGE_ROWS + 1;
  const long long i = (long long)q * RANGE_ROWS + threadIdx.x;
  const bool owner = threadIdx.x < RANGE_ROWS && i < n;
  const long long tslots = (long long)tile * BLOCK;
  float acc = owner ? z_in[i] : 0.f;
  bool bad = false;                      // CTA 0: a padding term is NaN
  for (int k0 = 0; k0 < K; k0 += RANGE_KC) {
    const int nk = min(RANGE_KC, K - k0);
    int len = 0;
    if (threadIdx.x < nk) {
      const int b = idx[k0 + threadIdx.x];
      const int* rs = rstart + b * nq1 + q;
      const int lo = rs[0];
      len = rs[1] - lo;
      sblk[threadIdx.x] = b;
      slo[threadIdx.x] = lo;
    }
    int total;
    const int off = block_exclusive_scan(len, wsum, total);
    if (threadIdx.x < nk) soff[threadIdx.x] = off;
    if (threadIdx.x == 0) soff[nk] = total;
    for (int j = threadIdx.x; j < nk * RANGE_ROWS; j += THREADS) part[j] = 0.f;
    if (q == 0) {   // warp w checks columns 4·lane.. of blocks w, w + 8, ..
      const int lane = threadIdx.x & 31;
#pragma unroll 4
      for (int kk = threadIdx.x >> 5; kk < nk; kk += WARPS) {
        const unsigned char* zm = zmask + (long long)sblk[kk] * BLOCK + 4 * lane;
        const float* dk = delta + (long long)(k0 + kk) * BLOCK + 4 * lane;
#pragma unroll
        for (int u = 0; u < 4; ++u) bad |= (zm[u] != 0) & !isfinite(dk[u]);
      }
    }
    __syncthreads();
    for (int w0 = 0; w0 < total; w0 += RANGE_STAGE) {
      const int wn = min(RANGE_STAGE, total - w0);
      // stage: slot f of the chunk's segments laid end to end
#pragma unroll
      for (int u = 0; u < RANGE_STAGE / THREADS; ++u) {
        const int e = u * THREADS + threadIdx.x;
        if (e < wn) {
          const int f = w0 + e;
          int lo = 0, hi = nk;           // soff[lo] <= f < soff[hi]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (soff[mid] <= f) lo = mid; else hi = mid;
          }
          const long long bo = sblk[lo] * tslots;
          const int s = order[bo + slo[lo] + (f - soff[lo])];
          const int row = rows[bo + s];
          skey[e] = lo * RANGE_ROWS + (row - q * RANGE_ROWS);
          sv[e] = to_f32(vals[bo + s]);
          sd[e] = delta[(long long)(k0 + lo) * BLOCK + (s & (BLOCK - 1))];
        }
      }
      __syncthreads();
      // run sums: the head of each run of one key walks it in slot order;
      // a run cut by the window edge goes on from its partial sum
      for (int e = threadIdx.x; e < wn; e += THREADS) {
        const int key = skey[e];
        if (e > 0 && skey[e - 1] == key) continue;
        float a = (e == 0 && w0 > 0 && carry == key)
                      ? fmaf(sv[0], sd[0], part[key])
                      : __fmul_rn(sv[e], sd[e]);
        for (int e2 = e + 1; e2 < wn && skey[e2] == key; ++e2)
          a = fmaf(sv[e2], sd[e2], a);
        part[key] = a;
      }
      __syncthreads();
      if (threadIdx.x == 0) carry = skey[wn - 1];
      __syncthreads();
    }
    if (owner)
      for (int kk = 0; kk < nk; ++kk)
        acc = __fadd_rn(acc, part[kk * RANGE_ROWS + threadIdx.x]);
    __syncthreads();
  }
  bad = __syncthreads_or(bad);
  if (owner) {
    if (i == 0 && K > 0) acc = __fadd_rn(acc, bad ? __int_as_float(0x7fffffff) : 0.f);
    z_out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// fused_sparse_shotgun_rounds — replaces repro/kernels/shotgun_sparse.py::
// fused_sparse_shotgun_rounds (Pallas body _make_fused_sparse_kernel, call
// _fused_sparse_call).  Bound per launch: R·K·tile·128·(4 + value bytes)
// (the drawn tiles once per round) + 4·(3n + 2·d_pad) + 8R.  Design: ONE
// persistent cooperative launch for all R rounds; phases separated by
// grid.sync(), three per round:
//   A  g (and h) per (k, column) from the round-start r (and w), δ from
//      the pre-round x, masked for k >= k_eff;  beside it, the |x| / nnz
//      partials of the previous round's x (fixed 4096-element chunks)
//   B  run sums into the (K, n) buffer and the padding terms;  beside it,
//      block 0 finishes the previous round: F, nnz and health from the
//      fixed-order partials
//   C  one pass over n: z += Σ_k buf[k] in k order (zeroing buf), r (and
//      w) refreshed, loss partial per 256-row tile;  beside it,
//      x[blk_k] += δ_k in k order (one owner per distinct drawn block)
// After the last round one more A/B pair finishes it.  Every reduction has
// a fixed owner and order, independent of the grid size, so repeat runs
// are bit-identical.
//
// EMIT_DZ = true is fused_sparse_shotgun_delta_rounds — replaces repro/
// kernels/shotgun_sparse.py::fused_sparse_shotgun_delta_rounds (the
// emit_dz variant of the same Pallas body), the sharded driver's round
// engine.  z0 is read-only; launch start copies it into the live view (the
// z buffer) and zeroes dz; phase A drops the |x| / nnz partials, phase B
// drops block 0's finish, and phase C adds each row's combined value to the
// view and to dz and raises health on a non-finite view row (the padding
// term's NaN reaches row 0 there).  No final A/B pair.  Bound per launch:
// R·K·tile·128·(4 + value bytes) + 4·(3n + 2·d_pad).  With a non-null
// `stamps`, block 0 records clock64() at launch start, after every
// grid.sync() and at the end (3R + 4 stamps): the per-phase breakdown of a
// launch, barrier included.
//
// BATCHED = true is batched_fused_sparse_shotgun_rounds — replaces repro/
// kernels/batched.py::batched_fused_sparse_shotgun_rounds (a jax.vmap of
// the same Pallas kernel over a leading slot axis, the solver service's
// step).  S slots, each with its own tiles (or one shared set), scatter
// order, z, x, y, draws and [lam, beta, k_eff, guard_f] row, share ONE
// cooperative launch and its three barriers a round: each phase's items
// become (slot, item) pairs over the same grid (S·(K/2 + d_pad/4096) in A,
// S·K·⌈tile/2⌉ run sums in B, S·(n/256 + K/2) in C), and slot s's finish
// runs on block s % gridDim.x.  Every workspace — the (K, n) combine
// buffer, padterm, δ, the loss and |x| partials — has a slot stride; the
// tiles and the order advance t_stride elements a slot (0: a shared
// design).  A slot's reductions follow its own items only, never the grid,
// so slot s is bit-identical to the unbatched launch on its state.  The
// latency of the barriers and dependent loads, which bounds one slot's
// rounds (≈ 19 µs against a 0.65 µs byte bound at S1), is paid once for
// all slots.  Bound: R·(bytes of the distinct live drawn tiles of all
// slots) + S times one slot's vectors.
// ---------------------------------------------------------------------------
struct SparseArgs {
  const int* rows;
  const void* vals;
  const int* order;
  const int* count;
  const unsigned char* zmask;
  const float* y;
  const int* idx;     // (R, K)
  const float* scal;  // [lam, beta, k_eff, guard_f]
  float* z;           // (n,)  in: z0, out: z after R rounds
  float* x;           // (d_pad,)  in: x0, out: x after R rounds
  float* r;           // (n,)
  float* w;           // (n,) Newton
  float* buf;         // (K, n) scatter buffer (zeroed at launch start)
  float* padterm;     // (K,)
  float* delta;       // (K, 128)
  float* lpart;       // (ceil(n / 256),)
  float* xl1;         // (ceil(d_pad / 4096),)
  int* xnz;           // (ceil(d_pad / 4096),)
  float* f;           // (R,)
  int* nnz;           // (R,)
  float* health;      // ()  0 → 1 when a round's F is non-finite or > guard
                      //     (EMIT_DZ: when a row of the view is non-finite)
  long long* stamps;  // (3R + 4,) phase clock stamps, or null
  long long n, d_pad;
  int R, K, tile;
  const float* z0;    // (n,)  EMIT_DZ: read-only margin snapshot (z = view)
  float* dz;          // (n,)  EMIT_DZ: out, the launch's own Σ A_B δ
  int S;              // BATCHED: slots; every array above but `stamps`
                      //   gains a leading slot axis
  long long t_stride; // BATCHED: elements from one slot's rows/vals/order
                      //   to the next (nblk·tile·128, 0 for a shared design)
};

// Slot s's view for its |x| partials and round finish (batched launches):
// x, the |x| / nnz and loss partials, F, nnz, health and the scalars, each
// moved by its slot stride.
__device__ __forceinline__ SparseArgs at_slot(const SparseArgs& a, int s) {
  SparseArgs b = a;
  const long long ls = s;
  const long long n_xc = (a.d_pad + XCHUNK - 1) / XCHUNK;
  b.scal = a.scal + 4 * ls;
  b.x = a.x + ls * a.d_pad;
  b.lpart = a.lpart + ls * ((a.n + THREADS - 1) / THREADS);
  b.xl1 = a.xl1 + ls * n_xc;
  b.xnz = a.xnz + ls * n_xc;
  b.f = a.f + ls * a.R;
  b.nnz = a.nnz + ls * a.R;
  b.health = a.health + ls;
  return b;
}

__device__ __forceinline__ void x_partial(const SparseArgs& a, int q,
                                          float* s, int* si) {
  const long long base = (long long)q * XCHUNK;
  float l1 = 0.f;
  int nz = 0;
  float v[XCHUNK / THREADS];
#pragma unroll
  for (int u = 0; u < XCHUNK / THREADS; ++u) {
    const long long j = base + (long long)u * THREADS + threadIdx.x;
    v[u] = j < a.d_pad ? ldcg(a.x + j) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < XCHUNK / THREADS; ++u) {
    l1 += fabsf(v[u]);
    nz += (v[u] != 0.f);
  }
  l1 = block_sum(l1, s);
  nz = block_sum_int(nz, si);
  if (threadIdx.x == 0) {
    a.xl1[q] = l1;
    a.xnz[q] = nz;
  }
}

template <int LOSS>
__device__ __forceinline__ void finish_round(const SparseArgs& a, int rd,
                                             float lam, float guard, int n_xc,
                                             int n_lt, float* s, int* si) {
  float l1 = 0.f, data = 0.f;
  int nz = 0;
  for (int q = threadIdx.x; q < n_xc; q += THREADS) {
    l1 += ldcg(a.xl1 + q);
    nz += __ldcg(a.xnz + q);
  }
  for (int q = threadIdx.x; q < n_lt; q += THREADS) data += ldcg(a.lpart + q);
  l1 = block_sum(l1, s);
  data = block_sum(data, s);
  nz = block_sum_int(nz, si);
  if (threadIdx.x == 0) {
    const float loss = LOSS == LOSS_LASSO ? 0.5f * data : data;
    const float f = loss + lam * l1;
    a.f[rd] = f;
    a.nnz[rd] = nz;
    if (!isfinite(f) || f > guard) a.health[0] = 1.f;   // max-accumulated
  }
}

template <typename TV, int LOSS, bool NEWTON, bool EMIT_DZ, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
fused_sparse_kernel(SparseArgs a) {
  static_assert(!(EMIT_DZ && BATCHED), "no batched delta kernel");
  cg::grid_group grid = cg::this_grid();
  __shared__ float s[THREADS];
  __shared__ int si[THREADS];
  const TV* vals = static_cast<const TV*>(a.vals);
  const float lam = a.scal[0], beta = a.scal[1], guard = a.scal[3];
  const int k_eff = (int)a.scal[2];
  const int S = BATCHED ? a.S : 1;
  const long long n = a.n;
  const int K = a.K, tile = a.tile;
  const int n_pair = (K + HALF - 1) / HALF;       // (k, column) item pairs
  // run-sum items per k: 256 sorted slots each, the last one ragged when
  // tile is odd (scatter_runs skips slots past the block's count)
  const int nq = (tile * BLOCK + THREADS - 1) / THREADS;
  const int n_runs = K * nq;
  const int n_lt = (int)((n + THREADS - 1) / THREADS);
  const int n_xc = EMIT_DZ ? 0 : (int)((a.d_pad + XCHUNK - 1) / XCHUNK);
  const int sub = threadIdx.x >> 7, c = threadIdx.x & (BLOCK - 1);
  // Slot so's arrays start so strides in (64-bit); the tiles, order, count
  // and zmask stride 0 for a shared design.  Unbatched, so and every slot
  // stride are compile-time zeros, so the offsets fold away.
  const long long ts = BATCHED ? a.t_stride : 0;
  const long long cs = ts ? a.d_pad / BLOCK : 0, zs = ts ? a.d_pad : 0;
  const long long rk = BATCHED ? (long long)a.R * K : 0;
  const long long kn = BATCHED ? (long long)K * n : 0;
  const long long kb = BATCHED ? (long long)K * BLOCK : 0;
  const bool stamp = a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int ns = 0;
  if (stamp) a.stamps[ns++] = clock64();

  // launch start: r (and w) from z0; the scatter buffer zeroed.  The
  // (S, n) vectors and the (S, K, n) buffer are contiguous: flat passes.
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < S * n;
       i += (long long)gridDim.x * THREADS) {
    float rr, ww, ll, zi;
    if constexpr (EMIT_DZ) {
      zi = a.z0[i];
      a.z[i] = zi;
      a.dz[i] = 0.f;
    } else {
      zi = a.z[i];
    }
    loss_tile<LOSS>(zi, a.y[i], 1.f, rr, ww, ll);
    a.r[i] = rr;
    if constexpr (NEWTON) a.w[i] = ww;
  }
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < S * (long long)K * n; i += (long long)gridDim.x * THREADS)
    a.buf[i] = 0.f;
  grid.sync();
  if (stamp) a.stamps[ns++] = clock64();

  for (int rd = 0; rd <= a.R; ++rd) {
    if (EMIT_DZ && rd == a.R) break;   // no round end to finish
    const int* idx = a.idx + (long long)min(rd, a.R - 1) * K;
    // A: δ of round rd; |x| / nnz partials of round rd − 1.
    const int n_a = (rd < a.R ? n_pair : 0) + (rd > 0 ? n_xc : 0);
    for (int it = blockIdx.x; it < S * n_a; it += gridDim.x) {
      const int so = BATCHED ? it / n_a : 0;
      const int j = it - so * n_a;
      if (rd < a.R && j < n_pair) {
        const int k = j * HALF + sub;
        if (k < K) {
          const float* sc = a.scal + 4 * so;
          const float lm = BATCHED ? sc[0] : lam, bt = BATCHED ? sc[1] : beta;
          const int ke = BATCHED ? (int)sc[2] : k_eff;
          // ik[k] is read again after the gather loop: held in a register
          // across the loop's ld.global.cg it moved ptxas's allocation of
          // the unbatched kernel, which ran slower; read twice, the
          // unbatched SASS is unchanged by BATCHED (compare_sass.py).
          const int* ik = idx + so * rk;
          float g, h;
          gather_col<TV, NEWTON>(a.rows + so * ts, vals + so * ts,
                                 a.r + so * n, a.w + (NEWTON ? so * n : 0),
                                 ik[k], c, tile, g, h);
          const float xs =
              ldcg(a.x + so * a.d_pad + (long long)ik[k] * BLOCK + c);
          const float hh = NEWTON ? (h < 1e-8f ? 1e-8f : h) : bt;
          const float xn = soft_threshold(xs - g / hh, lm / hh);
          (a.delta + so * kb)[k * BLOCK + c] = (xn - xs) * (k < ke ? 1.f : 0.f);
        }
      } else {
        const int q = j - (rd < a.R ? n_pair : 0);
        if constexpr (BATCHED)
          x_partial(at_slot(a, so), q, s, si);
        else
          x_partial(a, q, s, si);
      }
    }
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
    // B: run sums of round rd; slot s's finish of round rd − 1 on block
    // s % gridDim.x (unbatched: block 0).
    if constexpr (BATCHED) {
      for (int sl = blockIdx.x; rd > 0 && sl < S; sl += gridDim.x) {
        const SparseArgs b = at_slot(a, sl);
        finish_round<LOSS>(b, rd - 1, b.scal[0], b.scal[3], n_xc, n_lt, s,
                           si);
      }
    } else if (!EMIT_DZ && rd > 0 && blockIdx.x == 0) {
      finish_round<LOSS>(a, rd - 1, lam, guard, n_xc, n_lt, s, si);
    }
    if (rd == a.R) {
      if (stamp) a.stamps[ns++] = clock64();
      break;
    }
    for (int it = blockIdx.x; it < S * n_runs; it += gridDim.x) {
      const int so = BATCHED ? it / n_runs : 0;
      const int j = it - so * n_runs;
      const int k = j / nq, q = j - k * nq;
      scatter_runs<TV>(a.rows + so * ts, vals + so * ts, a.order + so * ts,
                       a.count + so * cs, a.zmask + so * zs, idx + so * rk,
                       a.delta + so * kb, k, q, tile, n, a.buf + so * kn,
                       a.padterm + so * K);
    }
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
    // C: the pass over n; x[blk_k] += δ_k for each distinct drawn block.
    const int n_c = n_lt + n_pair;
    for (int it = blockIdx.x; it < S * n_c; it += gridDim.x) {
      const int so = BATCHED ? it / n_c : 0;
      const int j = it - so * n_c;
      if (j < n_lt) {
        const long long i = (long long)j * THREADS + threadIdx.x;
        if constexpr (EMIT_DZ) {
          combine_delta_row<LOSS, NEWTON>(i, n, K, a.z, a.dz, a.buf,
                                          a.padterm, a.y, a.r, a.w, a.health);
        } else {
          const long long vo = so * n;
          const float ll = combine_row<LOSS, NEWTON, true>(
              i, n, K, a.z + vo, a.z + vo, a.buf + so * kn,
              a.padterm + so * K, a.y + vo, a.r + vo,
              a.w + (NEWTON ? vo : 0));
          const float tot = block_sum(ll, s);
          if (threadIdx.x == 0) a.lpart[so * n_lt + j] = tot;
        }
      } else {
        const int k = (j - n_lt) * HALF + sub;
        if (k < K) {
          const int* ik = idx + so * rk;
          const int b = ik[k];
          bool first = true;
          for (int kk = 0; kk < k; ++kk) first &= (ik[kk] != b);
          if (first) {
            const long long o = so * a.d_pad + (long long)b * BLOCK + c;
            float v = ldcg(a.x + o);
            for (int kk = k; kk < K; ++kk)
              if (ik[kk] == b) v += ldcg(a.delta + so * kb + kk * BLOCK + c);
            a.x[o] = v;
          }
        }
      }
    }
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
  }
}

namespace {

// Co-resident CUDA blocks for a cooperative launch of `kern`, at most two
// per SM: each phase has little work, and a smaller grid syncs faster
// (negative CUDA error code on failure).
int sparse_coop_blocks(const void* kern) {
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
  return (per_sm < 2 ? per_sm : 2) * sms;
}

template <typename TV, int LOSS, bool NEWTON, bool EMIT_DZ, bool BATCHED>
const void* sparse_kernel() {
  return reinterpret_cast<const void*>(
      &fused_sparse_kernel<TV, LOSS, NEWTON, EMIT_DZ, BATCHED>);
}

template <typename TV, bool EMIT_DZ, bool BATCHED>
const void* pick_sparse(int loss) {
  switch (loss) {
    case 0: return sparse_kernel<TV, LOSS_LASSO, false, EMIT_DZ, BATCHED>();
    case 1: return sparse_kernel<TV, LOSS_LOGISTIC, false, EMIT_DZ, BATCHED>();
    case 2: return sparse_kernel<TV, LOSS_LASSO, true, EMIT_DZ, BATCHED>();
    case 3: return sparse_kernel<TV, LOSS_LOGISTIC, true, EMIT_DZ, BATCHED>();
    default: return nullptr;
  }
}

// Loss code: bit 0 logistic, bit 1 Newton, bit 2 EMIT_DZ (the delta
// kernel), bit 3 BATCHED (the slot kernel); bits 2 and 3 exclude each other.
const void* pick_sparse(int v_bf16, int code) {
  const int loss = code & 3;
  if ((code & ~15) || (code & 12) == 12) return nullptr;
  if (code & 4)
    return v_bf16 ? pick_sparse<__nv_bfloat16, true, false>(loss)
                  : pick_sparse<float, true, false>(loss);
  if (code & 8)
    return v_bf16 ? pick_sparse<__nv_bfloat16, false, true>(loss)
                  : pick_sparse<float, false, true>(loss);
  return v_bf16 ? pick_sparse<__nv_bfloat16, false, false>(loss)
                : pick_sparse<float, false, false>(loss);
}

int launch_sparse(const void* kern, SparseArgs a, void* stream) {
  if (!kern) return (int)cudaErrorInvalidValue;
  const int blocks = sparse_coop_blocks(kern);
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

}  // namespace

extern "C" {

int sp_gather_block_matvec(const int* rows, const void* vals, int v_bf16,
                           const float* r, const int* idx, float* g, int tile,
                           int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_bf16)
    sparse_gather_split_kernel<__nv_bfloat16><<<(unsigned)K, THREADS, 0, s>>>(
        rows, static_cast<const __nv_bfloat16*>(vals), r, idx, tile, g);
  else
    sparse_gather_split_kernel<float><<<(unsigned)K, THREADS, 0, s>>>(
        rows, static_cast<const float*>(vals), r, idx, tile, g);
  return (int)cudaGetLastError();
}

// Rows per CTA of the scatter: the range-start table's range width.
int sp_range_rows() { return RANGE_ROWS; }

// rstart: (nblk, ceil(n / RANGE_ROWS) + 1) int32 range-start table of the
// row-sorted order (data/sparse.py::range_starts); zmask (nblk, 128).
int sp_scatter_block_update(const int* rows, const void* vals, int v_bf16,
                            const int* order, const int* rstart,
                            const unsigned char* zmask, const float* z_in,
                            const int* idx, const float* delta, float* z_out,
                            long long n, int tile, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + RANGE_ROWS - 1) / RANGE_ROWS);
  if (v_bf16)
    scatter_rows_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        rows, static_cast<const __nv_bfloat16*>(vals), order, rstart, zmask,
        z_in, idx, delta, z_out, n, tile, K);
  else
    scatter_rows_kernel<float><<<blocks, THREADS, 0, s>>>(
        rows, static_cast<const float*>(vals), order, rstart, zmask, z_in,
        idx, delta, z_out, n, tile, K);
  return (int)cudaGetLastError();
}

// Grid size (CUDA blocks) of the fused launch for this value type and loss
// code (bit 0 logistic, bit 1 Newton, bit 2 the delta kernel); negative
// CUDA error on failure.
int sp_fused_grid_blocks(int v_bf16, int loss) {
  if (loss & ~7) return -(int)cudaErrorInvalidValue;
  const void* kern = pick_sparse(v_bf16, loss);
  if (!kern) return -(int)cudaErrorInvalidValue;
  return sparse_coop_blocks(kern);
}

int sp_fused_shotgun_rounds(const int* rows, const void* vals, int v_bf16,
                            int loss, const int* order, const int* count,
                            const unsigned char* zmask, const float* y,
                            const int* idx, const float* scal, float* z,
                            float* x, float* r, float* w, float* buf,
                            float* padterm, float* delta, float* lpart,
                            float* xl1, int* xnz, float* f, int* nnz,
                            float* health, long long* stamps, long long n,
                            long long d_pad, int R, int K, int tile,
                            void* stream) {
  if (loss & ~3) return (int)cudaErrorInvalidValue;
  SparseArgs a{rows, vals, order, count, zmask, y, idx, scal, z, x, r, w,
               buf, padterm, delta, lpart, xl1, xnz, f, nnz, health, stamps,
               n, d_pad, R, K, tile, nullptr, nullptr, 1, 0};
  return launch_sparse(pick_sparse(v_bf16, loss), a, stream);
}

// The slot kernel: every array but the tiles, the order and `stamps`
// carries a leading slot axis of S (scal (S, 4), buf (S, K, n), health
// (S,), ...); rows, vals and order advance t_stride elements per slot,
// count and zmask one slot's worth when t_stride != 0 (0: one shared
// design).  `stamps`, as for the unbatched launch, may be null.
int sp_batched_fused_shotgun_rounds(
    const int* rows, const void* vals, int v_bf16, int loss,
    long long t_stride, const int* order, const int* count,
    const unsigned char* zmask, const float* y, const int* idx,
    const float* scal, float* z, float* x, float* r, float* w, float* buf,
    float* padterm, float* delta, float* lpart, float* xl1, int* xnz,
    float* f, int* nnz, float* health, long long* stamps, long long n,
    long long d_pad, int S, int R, int K, int tile, void* stream) {
  if ((loss & ~3) || S < 1) return (int)cudaErrorInvalidValue;
  SparseArgs a{rows, vals, order, count, zmask, y, idx, scal, z, x, r, w,
               buf, padterm, delta, lpart, xl1, xnz, f, nnz, health, stamps,
               n, d_pad, R, K, tile, nullptr, nullptr, S, t_stride};
  return launch_sparse(pick_sparse(v_bf16, loss | 8), a, stream);
}

// Grid size (CUDA blocks) of the sparse slot kernel for this value type and
// loss code (bit 0 logistic, bit 1 Newton); negative CUDA error on failure.
int sp_batched_grid_blocks(int v_bf16, int loss) {
  if (loss & ~3) return -(int)cudaErrorInvalidValue;
  return sparse_coop_blocks(pick_sparse(v_bf16, loss | 8));
}

// The delta kernel: z0 read-only, view (n,) scratch, dz (n,) out, x in/out;
// buf (K, n) is zeroed by the kernel.
int sp_fused_shotgun_delta_rounds(const int* rows, const void* vals,
                                  int v_bf16, int loss, const int* order,
                                  const int* count, const unsigned char* zmask,
                                  const float* y, const int* idx,
                                  const float* scal, const float* z0,
                                  float* view, float* dz, float* x, float* r,
                                  float* w, float* buf, float* padterm,
                                  float* delta, float* health, long long n,
                                  long long d_pad, int R, int K, int tile,
                                  void* stream) {
  if (loss & ~3) return (int)cudaErrorInvalidValue;
  SparseArgs a{rows, vals, order, count, zmask, y, idx, scal, view, x, r, w,
               buf, padterm, delta, nullptr, nullptr, nullptr, nullptr,
               nullptr, health, nullptr, n, d_pad, R, K, tile, z0, dz, 1, 0};
  return launch_sparse(pick_sparse(v_bf16, loss | 4), a, stream);
}

}  // extern "C"
