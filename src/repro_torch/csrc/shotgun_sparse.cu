// BlockedCSC sparse Block-Shotgun kernels for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// A is stored as (nblk, tile, 128) rows/vals tiles (data/sparse.py); a
// drawn block costs tile·128·(4 + value bytes) bytes, a few KB, so at the
// sizes users run (n ≈ 2·10⁴, K ≤ 32) every call moves under 1 MB of
// tiles and is bound by launch and memory latency, not by HBM bandwidth.
// The margin-sized vectors (z, r) fit in L2.
//
// Determinism without float atomics: the gathers give each (k, column) one
// owner that sums the tile axis in a fixed order; the scatters give each
// row one owner.  A CTA owns a range of rows and, for each drawn block k in
// order, reads the block's slots of that range from its row-sorted slot
// order (built once per problem, data/sparse.py::scatter_order) through the
// cached range-start table (data/sparse.py::range_starts); the head of each
// run of equal rows sums the run in slot order, and the row's owner adds
// the K run sums to its z in k order.  Padding slots (row 0, value 0) are
// left out of the runs; their 0·δ_c (NaN for a non-finite δ_c, as in the
// reference) reaches row 0 last.
//
// Every entry returns cudaGetLastError() (0 on success) and launches on the
// caller's stream without synchronising; the caller allocates every buffer.
#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <utility>

#include "shotgun_block.cuh"

namespace cg = cooperative_groups;
using namespace sb;

namespace {

constexpr int XCHUNK = 4096;      // |x| / nnz partial: elements per item
constexpr int XBLK = XCHUNK / BLOCK;    // column blocks per |x| chunk
constexpr int HALF = THREADS / BLOCK;   // (k, column) items per CUDA block
// Two-kernel gather: tile rows in flight per thread and pass.
constexpr int GATHER_U = 16;
// Two-kernel scatter: rows per CTA (data/sparse.py::RANGE_ROWS), drawn
// blocks per chunk, staged slots per window (46 KB of shared memory).
constexpr int RANGE_ROWS = 128;
constexpr int RANGE_KC = 64;
constexpr int RANGE_STAGE = 1024;
// Fused kernels' scatter: rows per item (two ranges of the table, the loss
// partial's 256-row tile), drawn blocks per chunk and staged slots per
// window, so that the item's shared memory stays under 48 KB.
constexpr int FUSED_ROWS = 2 * RANGE_ROWS;
constexpr int FUSED_KC = 32;
constexpr int FUSED_STAGE = 512;
// Overflow store (data/sparse.py::Overflow): spilled entries per segment
// (data/sparse.py::SEG), entries a lane loads per pass, and the most drawn
// blocks a round of the OVF launch (one prefix slot a thread).
constexpr int SEG = 256;
constexpr int SEG_U = SEG / 32;
constexpr int OVF_KMAX = THREADS;

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
// once; range_sums (below, shared with the fused kernels) adds the K run
// sums.  So z_out[i] = ((z[i] + s_0(i)) + s_1(i)) + … + s_{K−1}(i) with s_k
// the run sum (0 where block k has no slot at row i).  A padding slot's
// 0·δ_c is +0 or NaN, so the K padding terms of row 0 add up to one +0 or
// NaN, added last.  No atomics; repeats are bit-identical.
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

// δ as the two-kernel scatter reads it (written by an earlier launch: a
// plain load) or as the fused kernels do (written in the same launch: L2
// only, after the barrier).
template <bool CG>
__device__ __forceinline__ float load_delta(const float* p) {
  if constexpr (CG) return ldcg(p);
  else return *p;
}

// The shared arrays of one row-range item: part (KC·ROWS), sv/sd/skey
// (STAGE), sblk/slo (KC), soff (KC + 1), wsum (WARPS), carry.
struct RangeBufs {
  float* part;
  float* sv;
  float* sd;
  int* skey;
  int* sblk;
  int* slo;
  int* soff;
  int* wsum;
  int* carry;     // key of the previous window's last slot
};

// A design's overflow store as the scatter reads it: block b's local slots
// tile·128 + e' are its spilled entries ptr[b·128] + e'.
struct OvfStore {
  const int* rows;
  const void* vals;
  const unsigned char* cols;
  const long long* ptr;
};

// acc + s_0(i) + … + s_{K−1}(i) in k order for the owner of row i, where
// the CTA owns rows [row0, row0 + ROWS) (thread t, row row0 + t) and s_k is
// block idx[k]'s run sum at row i (row 0's padding terms are the caller's,
// add_padding).  For
// a chunk of up to KC drawn blocks it reads each block's segment, columns
// c0 .. c0 + dc of its row of the range-start table (nq1 columns), lays the
// segments end to end (a block-wide prefix sum), and every thread loads its
// slots at once: order → (row, val, δ), staged in shared memory (windows of
// STAGE slots).  The head of each run of equal rows of a block sums the run
// in slot order (fmaf, the first term a product) into part[k][row]; each
// row's owner then adds the chunk's part[k][row] to acc in k order.
// `first`: the CTA owns row 0 and sets `bad` (block-wide) when a δ_k,c of
// a column with a padding slot is non-finite: row 0's K padding terms then
// add up to NaN, else to +0.  Every thread of the CTA calls it.  (A design
// with an overflow store takes ovf_rows below, a warp an item.)
template <typename TV, int ROWS, int KC, int STAGE, bool CG>
__device__ __forceinline__ float range_sums(
    const int* __restrict__ rows, const TV* __restrict__ vals,
    const int* __restrict__ order, const int* __restrict__ rstart,
    const unsigned char* __restrict__ zmask, const int* __restrict__ idx,
    const float* __restrict__ delta, long long nq1, long long tslots, int K,
    int c0, int dc, int row0, bool first, bool owner, float acc,
    const RangeBufs& m, bool& bad_out) {
  bool bad = false;                      // first: a padding term is NaN
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int nk = min(KC, K - k0);
    int len = 0;
    if (threadIdx.x < nk) {
      const int b = idx[k0 + threadIdx.x];
      const int* rs = rstart + b * nq1 + c0;
      const int lo = rs[0];
      len = rs[dc] - lo;
      m.sblk[threadIdx.x] = b;
      m.slo[threadIdx.x] = lo;
    }
    int total;
    const int off = block_exclusive_scan(len, m.wsum, total);
    if (threadIdx.x < nk) m.soff[threadIdx.x] = off;
    if (threadIdx.x == 0) m.soff[nk] = total;
    for (int j = threadIdx.x; j < nk * ROWS; j += THREADS) m.part[j] = 0.f;
    if (first) {   // warp w checks columns 4·lane.. of blocks w, w + 8, ..
      const int lane = threadIdx.x & 31;
#pragma unroll 4
      for (int kk = threadIdx.x >> 5; kk < nk; kk += WARPS) {
        const unsigned char* zm = zmask + (long long)m.sblk[kk] * BLOCK + 4 * lane;
        const float* dk = delta + (long long)(k0 + kk) * BLOCK + 4 * lane;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          bad |= (zm[u] != 0) & !isfinite(load_delta<CG>(dk + u));
      }
    }
    __syncthreads();
    for (int w0 = 0; w0 < total; w0 += STAGE) {
      const int wn = min(STAGE, total - w0);
      // stage: slot f of the chunk's segments laid end to end
#pragma unroll
      for (int u = 0; u < STAGE / THREADS; ++u) {
        const int e = u * THREADS + threadIdx.x;
        if (e < wn) {
          const int f = w0 + e;
          int lo = 0, hi = nk;           // soff[lo] <= f < soff[hi]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (m.soff[mid] <= f) lo = mid; else hi = mid;
          }
          const long long bo = m.sblk[lo] * tslots;
          const int s = order[bo + m.slo[lo] + (f - m.soff[lo])];
          const int row = rows[bo + s];
          m.skey[e] = lo * ROWS + (row - row0);
          m.sv[e] = to_f32(vals[bo + s]);
          m.sd[e] = load_delta<CG>(delta + (long long)(k0 + lo) * BLOCK
                                   + (s & (BLOCK - 1)));
        }
      }
      __syncthreads();
      // run sums: the head of each run of one key walks it in slot order;
      // a run cut by the window edge goes on from its partial sum
      for (int e = threadIdx.x; e < wn; e += THREADS) {
        const int key = m.skey[e];
        if (e > 0 && m.skey[e - 1] == key) continue;
        float a = (e == 0 && w0 > 0 && *m.carry == key)
                      ? fmaf(m.sv[0], m.sd[0], m.part[key])
                      : __fmul_rn(m.sv[e], m.sd[e]);
        for (int e2 = e + 1; e2 < wn && m.skey[e2] == key; ++e2)
          a = fmaf(m.sv[e2], m.sd[e2], a);
        m.part[key] = a;
      }
      __syncthreads();
      if (threadIdx.x == 0) *m.carry = m.skey[wn - 1];
      __syncthreads();
    }
    if (owner)
      for (int kk = 0; kk < nk; ++kk)
        acc = __fadd_rn(acc, m.part[kk * ROWS + threadIdx.x]);
    __syncthreads();
  }
  bad_out = __syncthreads_or(bad);
  return acc;
}

// Row 0's padding terms, added last: one +0, or NaN when `bad`.
__device__ __forceinline__ float add_padding(float acc, bool bad) {
  return __fadd_rn(acc, bad ? __int_as_float(0x7fffffff) : 0.f);
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
  __shared__ int skey[RANGE_STAGE];
  __shared__ int sblk[RANGE_KC], slo[RANGE_KC], soff[RANGE_KC + 1];
  __shared__ int wsum[WARPS];
  __shared__ int carry;
  const int q = blockIdx.x;
  const long long nq1 = (n + RANGE_ROWS - 1) / RANGE_ROWS + 1;
  const long long i = (long long)q * RANGE_ROWS + threadIdx.x;
  const bool owner = threadIdx.x < RANGE_ROWS && i < n;
  bool bad;
  float acc = range_sums<TV, RANGE_ROWS, RANGE_KC, RANGE_STAGE, false>(
      rows, vals, order, rstart, zmask, idx, delta, nq1,
      (long long)tile * BLOCK, K, q, 1, q * RANGE_ROWS, q == 0, owner,
      owner ? z_in[i] : 0.f,
      RangeBufs{part, sv, sd, skey, sblk, slo, soff, wsum, &carry}, bad);
  if (owner) {
    if (i == 0 && K > 0) acc = add_padding(acc, bad);
    z_out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// fused_sparse_shotgun_rounds — replaces repro/kernels/shotgun_sparse.py::
// fused_sparse_shotgun_rounds (Pallas body _make_fused_sparse_kernel, call
// _fused_sparse_call).  Bound per launch: R·K·tile·128·(4 + value bytes)
// (the drawn tiles once per round) + 4·(3n + 2·d_pad) + 8R.  What bounds it
// is latency: each round's phases are a few dependent global round trips
// (idx → tiles → r; range table → order → tiles → δ) and a grid barrier.
// Design: ONE persistent cooperative launch for all R rounds, two phases a
// round separated by grid.sync():
//   A   g (and h) per (k, column) from the round-start r (and w), δ from
//       the pre-round x, masked for k >= k_eff;  beside it, the |x| / nnz
//       partials (fixed 4096-element chunks) of the chunks the previous
//       round changed, one item per distinct chunk of its drawn blocks
//       (every other chunk's partial is bit for bit what it was)
//   BC  item j owns rows [j·256, (j+1)·256) — ranges 2j and 2j + 1 of the
//       range-start table, the loss partial's tile — and adds the K run
//       sums to z in k order with no (K, n) buffer (range_sums), refreshes
//       r (and w) and writes its loss partial (two halves by round parity);
//       beside it, x[blk_k] += δ_k in k order (one owner per distinct drawn
//       block), and the last block finishes the previous round: F, nnz and
//       health from the fixed-order partials (the other half of the loss
//       partials)
// The launch start copies z0 and x0 into z and x, computes r (and w) and
// every chunk's |x| partials, and zeroes health; after the last round one
// more A (partials only) and the finish.  Every reduction has a fixed owner
// and order, independent of the grid size, so repeat runs are
// bit-identical, and each sum is the one the buffer form took (z + s_0 + …
// + s_{K−1}, then row 0's padding terms).  With a non-null `stamps`, the
// last block records clock64() at launch start, after every grid.sync() and
// at the end, after the last finish (2R + 4 stamps): the per-phase
// breakdown of a launch, barrier included; and %globaltimer (ns) at launch
// start and at its end in stamps[2R + 4] and stamps[2R + 5], which time the
// launch, and the cycles, on a clock of their own.
//
// EMIT_DZ = true is fused_sparse_shotgun_delta_rounds — replaces repro/
// kernels/shotgun_sparse.py::fused_sparse_shotgun_delta_rounds (the
// emit_dz variant of the same Pallas body), the sharded driver's round
// engine.  z0 is read-only; the launch start copies it into the live view
// (the z buffer) and zeroes dz; phase A has no |x| / nnz partials, BC no
// finish: each row's K run sums, from 0 in k order, are added to the view
// and to dz, and a non-finite view row raises health (the padding terms'
// NaN reaches row 0 there).  No final A, no barrier after the last BC.
// Bound per launch: R·K·tile·128·(4 + value bytes) + 4·(3n + 2·d_pad).
//
// BATCHED = true is batched_fused_sparse_shotgun_rounds — replaces repro/
// kernels/batched.py::batched_fused_sparse_shotgun_rounds (a jax.vmap of
// the same Pallas kernel over a leading slot axis, the solver service's
// step).  S slots, each with its own tiles (or one shared set), scatter
// order, range-start table, z, x, y, draws and scalars, share ONE
// cooperative launch and its two barriers a round: each phase's items
// become (slot, item) pairs over the same grid (S·(K/2 + K) in A,
// S·(n/256 + K/2) in BC), and slot s's finish runs on block G − 1 − s % G.
// Every workspace — δ, the loss and |x| partials — has a slot stride; the
// tiles and the order advance t_stride elements a slot, the table one
// slot's table (0: a shared design).  A slot's reductions follow its own
// items only, never the grid, so slot s is bit-identical to the unbatched
// launch on its state.  Bound: R·(bytes of the distinct live drawn tiles of
// all slots) + S times one slot's vectors.
// ---------------------------------------------------------------------------
// The card's global nanosecond timer, for the launch's stamps.
__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct SparseArgs {
  const int* rows;
  const void* vals;
  const int* order;
  const int* rstart;  // (nblk, ceil(n / 128) + 1) range-start table
  const unsigned char* zmask;
  const float* y;
  const int* idx;     // (R, K)
  const float* sp[4]; // lam, beta, k_eff, guard_f: (S,) device vectors, or
  float sv[4];        //   null for the one value in sv that every slot takes
  const float* z0;    // (n,)  in: the margin (read-only)
  float* z;           // (n,)  out: z after R rounds (EMIT_DZ: the live view)
  const float* x0;    // (d_pad,)  in: the iterate (read-only)
  float* x;           // (d_pad,)  out: x after R rounds
  float* r;           // (n,)
  float* w;           // (n,) Newton
  float* delta;       // (K, 128)
  float* lpart;       // (2, ceil(n / 256)): loss partials by round parity
  float* xl1;         // (ceil(d_pad / 4096),)
  int* xnz;           // (ceil(d_pad / 4096),)
  float* f;           // (R,)
  int* nnz;           // (R,)
  float* health;      // ()  0 → 1 when a round's F is non-finite or > guard
                      //     (EMIT_DZ: when a row of the view is non-finite)
  long long* stamps;  // (2R + 6,) phase clock and ns stamps (OVF: 3R + 6),
                      //   or null
  long long n, d_pad;
  int R, K, tile;
  float* dz;          // (n,)  EMIT_DZ: out, the launch's own Σ A_B δ
  int S;              // BATCHED: slots; every array above but `stamps`
                      //   gains a leading slot axis
  long long t_stride; // BATCHED: elements from one slot's rows/vals/order
                      //   to the next (nblk·tile·128, 0 for a shared design)
  // OVF: the overflow store (data/sparse.py::Overflow) and its workspaces.
  OvfStore ovf;       // spilled rows, vals, columns in block, column ptr
  const int* oseg;    // (d_pad + 1,) column j's segments
  const unsigned char* oseg_col;  // (G,) each segment's column in block
  float* gpart;       // (K, seg_slots) each drawn block's segment sums of g
  float* hpart;       // (K, seg_slots) Newton: of h
  float* gt;          // (K, 128) the tile sums of g
  float* ht;          // (K, 128) Newton: of h
  int seg_slots;      // the most segments a block holds (host-sized)
};

// Scalar j (0 lam, 1 beta, 2 k_eff, 3 guard_f) of slot so.
__device__ __forceinline__ float scal(const SparseArgs& a, int j, long long so) {
  return a.sp[j] ? a.sp[j][so] : a.sv[j];
}

// Slot s's view for its |x| partials and round finish (batched launches):
// x0, x, the |x| / nnz and loss partials, F, nnz and health, each moved by
// its slot stride.
__device__ __forceinline__ SparseArgs at_slot(const SparseArgs& a, int s) {
  SparseArgs b = a;
  const long long ls = s;
  const long long n_xc = (a.d_pad + XCHUNK - 1) / XCHUNK;
  b.x0 = a.x0 + ls * a.d_pad;
  b.x = a.x + ls * a.d_pad;
  b.lpart = a.lpart + ls * 2 * ((a.n + THREADS - 1) / THREADS);
  b.xl1 = a.xl1 + ls * n_xc;
  b.xnz = a.xnz + ls * n_xc;
  b.f = a.f + ls * a.R;
  b.nnz = a.nnz + ls * a.R;
  b.health = a.health + ls;
  return b;
}

// The |x| / nnz partial of chunk q, from x (or, at launch start, from x0,
// which it then copies into x).
__device__ __forceinline__ void x_partial(const SparseArgs& a, int q,
                                          bool from_x0, float* s, int* si) {
  const long long base = (long long)q * XCHUNK;
  const float* src = from_x0 ? a.x0 : a.x;
  float l1 = 0.f;
  int nz = 0;
  float v[XCHUNK / THREADS];
#pragma unroll
  for (int u = 0; u < XCHUNK / THREADS; ++u) {
    const long long j = base + (long long)u * THREADS + threadIdx.x;
    v[u] = j < a.d_pad ? ldcg(src + j) : 0.f;
  }
  if (from_x0) {
#pragma unroll
    for (int u = 0; u < XCHUNK / THREADS; ++u) {
      const long long j = base + (long long)u * THREADS + threadIdx.x;
      if (j < a.d_pad) a.x[j] = v[u];
    }
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

// F, nnz and health of round rd from the |x| / nnz partials and the loss
// partials `lp` (the half of round rd's parity), each summed in order.
template <int LOSS>
__device__ __forceinline__ void finish_round(const SparseArgs& a, int rd,
                                             float lam, float guard, int n_xc,
                                             int n_lt, const float* lp,
                                             float* s, int* si) {
  float l1 = 0.f, data = 0.f;
  int nz = 0;
  for (int q = threadIdx.x; q < n_xc; q += THREADS) {
    l1 += ldcg(a.xl1 + q);
    nz += __ldcg(a.xnz + q);
  }
  for (int q = threadIdx.x; q < n_lt; q += THREADS) data += ldcg(lp + q);
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

// OVF, phase A: warp `warp` of the item takes the round's spilled segment
// f (the K drawn blocks' segments laid end to end, kpre their offsets) and
// sums its ≤ SEG entries' v·r[row] (and v²·w[row]): lane l takes entries
// l, l + 32, …, in order, then a fixed xor tree.  Its partial goes to slot
// s of block k's row of gpart (hpart).
template <typename TV, bool NEWTON>
__device__ __forceinline__ void ovf_segment(const SparseArgs& a,
                                            const int* idx, const int* kpre,
                                            int K, int f) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = K;                   // kpre[lo] <= f < kpre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (kpre[mid] <= f) lo = mid; else hi = mid;
  }
  const int s = f - kpre[lo];
  const long long b = idx[lo];
  const int g = a.oseg[b * BLOCK] + s;
  const long long cj = b * BLOCK + a.oseg_col[g];
  const long long e0 = a.ovf.ptr[cj] + (long long)(g - a.oseg[cj]) * SEG;
  const long long e1 = min(e0 + SEG, a.ovf.ptr[cj + 1]);
  const TV* ov = static_cast<const TV*>(a.ovf.vals);
  int ri[SEG_U];
  float v[SEG_U];
#pragma unroll
  for (int u = 0; u < SEG_U; ++u) {
    const long long e = e0 + u * 32 + lane;
    ri[u] = e < e1 ? a.ovf.rows[e] : -1;
    v[u] = e < e1 ? to_f32(ov[e]) : 0.f;
  }
  float acc = 0.f, hacc = 0.f;
#pragma unroll
  for (int u = 0; u < SEG_U; ++u) {
    if (ri[u] >= 0) {
      acc = fmaf(v[u], ldcg(a.r + ri[u]), acc);
      if constexpr (NEWTON) hacc = fmaf(v[u] * v[u], ldcg(a.w + ri[u]), hacc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if constexpr (NEWTON)
      hacc = __fadd_rn(hacc, __shfl_xor_sync(0xffffffffu, hacc, off));
  }
  if (lane == 0) {
    a.gpart[(long long)lo * a.seg_slots + s] = acc;
    if constexpr (NEWTON) a.hpart[(long long)lo * a.seg_slots + s] = hacc;
  }
}

// OVF, phase A2: warp `warp` of item (k, column group) finishes column c of
// drawn block k: the sum of its segment partials (lane l takes slots l,
// l + 32, … in order, then a fixed xor tree) added to the tile sum, then δ
// as phase A takes it for a column with no spilled entries.
template <int LOSS, bool NEWTON>
__device__ __forceinline__ void ovf_delta(const SparseArgs& a, const int* idx,
                                          int k, int c) {
  const int lane = threadIdx.x & 31;
  const long long b = idx[k];
  const long long cj = b * BLOCK + c;
  const int base = a.oseg[b * BLOCK];
  const int lo = a.oseg[cj] - base, hi = a.oseg[cj + 1] - base;
  const float* gp = a.gpart + (long long)k * a.seg_slots;
  const float* hp = a.hpart + (long long)k * a.seg_slots;
  float g = 0.f, h = 0.f;
  for (int s = lo + lane; s < hi; s += 32) {
    g = __fadd_rn(g, ldcg(gp + s));
    if constexpr (NEWTON) h = __fadd_rn(h, ldcg(hp + s));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    g = __fadd_rn(g, __shfl_xor_sync(0xffffffffu, g, off));
    if constexpr (NEWTON) h = __fadd_rn(h, __shfl_xor_sync(0xffffffffu, h, off));
  }
  if (lane == 0) {
    float gs = ldcg(a.gt + k * BLOCK + c), hs = 0.f;
    if constexpr (NEWTON) hs = ldcg(a.ht + k * BLOCK + c);
    if (lo < hi) {
      gs = __fadd_rn(gs, g);
      if constexpr (NEWTON) hs = __fadd_rn(hs, h);
    }
    const float lm = scal(a, 0, 0), bt = scal(a, 1, 0);
    const int ke = (int)scal(a, 2, 0);
    const float xs = ldcg(a.x + cj);
    const float hh = NEWTON ? (hs < 1e-8f ? 1e-8f : hs) : bt;
    const float xn = soft_threshold(xs - gs / hh, lm / hh);
    a.delta[k * BLOCK + c] = (xn - xs) * (k < ke ? 1.f : 0.f);
  }
}

// The OVF launch's shared array, allocated only in the kernels that call
// it (static shared memory of a device function).
__device__ __forceinline__ int* ovf_kpre() {
  __shared__ int kpre[OVF_KMAX + 1];
  return kpre;
}

// OVF, phase BC: a warp an item.  A design with an overflow store is tall
// (url: 9,360 row items a round, ≈ 35 a CTA), and an item is a chain of
// dependent loads (range table → order → tile or spilled entry → δ) over
// few slots (≈ 37).  So each warp walks its own items, with no CTA barrier,
// and loads its next item's range-start pairs while it sums this one: a
// CTA has 8 chains in flight where it had one.  Each warp's arena (4 KB of
// the CTA's `part`): skey/sv/sd, the window's slots (OVF_WIN), and mask,
// one word a row of the item: bit k says that drawn block k (of the chunk)
// has a complete run at that row in the window.
// Slots a lane stages a window (8 ran BC 17% slower at url's shape).
constexpr int OVF_WU = 4;
constexpr int OVF_WIN = 32 * OVF_WU;
constexpr int OVF_ARENA = FUSED_KC * FUSED_ROWS / WARPS;   // words a warp
static_assert(3 * OVF_WIN + FUSED_ROWS <= OVF_ARENA, "warp arena");
static_assert(FUSED_KC == 32, "a chunk's drawn blocks are a warp's lanes");

// acc ⊕ s, where the row's last folded block was `last` and this one is k:
// the blocks between (no run at the row) each add +0, and k adds s.  Adding
// +0 twice gives what adding it once gives (−0 turns +0, NaN stays NaN), so
// one add stands for them all: the sum is range_sums' z + s_0 + … in k order.
__device__ __forceinline__ float fold_run(float acc, int& last, int k,
                                          float s) {
  if (k > last + 1) acc = __fadd_rn(acc, 0.f);
  last = k;
  return __fadd_rn(acc, s);
}

// Row item j of BC for one warp: rows [j·256, j·256 + 256), lane l owning
// rows j·256 + l + 32u (u < 8).  For each chunk of up to 32 drawn blocks
// (lane k holds block k's id b, where its run of the flat order starts,
// and its segment lo, len of the item's two ranges of the range-start
// table), the segments are laid end to end (a warp scan) and staged in
// windows of OVF_WIN slots: order → (row, val) from the tile or the store
// → δ.  The head of each run of one key sums it in slot order (fmaf, the
// first term a product), a run cut by the window's edge going on from its
// partial in the next window, as in range_sums; the owners then fold the
// window's complete runs into their rows in k order (a run carried over
// and complete comes first: its block precedes the window's).  Then row
// 0's padding terms, the loss tile, and the loss partial's fixed 256-row
// tree (block_sum's: 128, 64, 32 in registers, then the lanes).  `lo0`,
// `len0`, `b0` and `run0` are chunk 0's, loaded by the caller.
template <typename TV, int LOSS, bool NEWTON>
__device__ __forceinline__ void ovf_rows(const SparseArgs& a, const int* idx,
                                         int j, int n_lt, int rd,
                                         long long nq1, int* arena, int b0,
                                         long long run0, int lo0, int len0) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int K = a.K;
  const long long n = a.n;
  const long long tslots = (long long)a.tile * BLOCK;
  const int row0 = j * FUSED_ROWS;
  const TV* vals = static_cast<const TV*>(a.vals);
  const TV* ovals = static_cast<const TV*>(a.ovf.vals);
  int* skey = arena;
  float* sv = reinterpret_cast<float*>(arena + OVF_WIN);
  float* sd = reinterpret_cast<float*>(arena + 2 * OVF_WIN);
  int* mask = arena + 3 * OVF_WIN;
  float acc[FUSED_ROWS / 32], yv[FUSED_ROWS / 32];
  int last[FUSED_ROWS / 32];
#pragma unroll
  for (int u = 0; u < FUSED_ROWS / 32; ++u) {
    const long long i = (long long)row0 + u * 32 + lane;
    acc[u] = i < n ? ldcg(a.z + i) : 0.f;
    yv[u] = i < n ? a.y[i] : 0.f;
    last[u] = -1;
    mask[u * 32 + lane] = 0;
  }
  const int c0 = 2 * j, dc = 2 * j + 2 < nq1 ? 2 : 1;
  bool bad = false;                    // item 0: a padding term is NaN
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int nk = min(32, K - k0);
    int b = b0, lo = lo0, len = len0;
    long long run = run0;
    if (k0 > 0) {
      len = 0;
      if (lane < nk) {
        b = idx[k0 + lane];
        run = b * tslots + a.ovf.ptr[(long long)b * BLOCK];
        const int* rs = a.rstart + b * nq1 + c0;
        lo = rs[0];
        len = rs[dc] - lo;
      }
    }
    int incl = len;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(ALL, incl, off);
      if (lane >= off) incl += v;
    }
    const int off = incl - len, total = __shfl_sync(ALL, incl, 31);
    if (j == 0) {          // lane l checks columns 4l .. 4l + 3 of each block
      for (int kk = 0; kk < nk; ++kk) {
        const long long bk = __shfl_sync(ALL, b, kk);
        const unsigned char* zm = a.zmask + bk * BLOCK + 4 * lane;
        const float* dk = a.delta + (long long)(k0 + kk) * BLOCK + 4 * lane;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          bad |= (zm[u] != 0) & !isfinite(ldcg(dk + u));
      }
    }
    bool cvalid = false;                 // a run cut by the window's edge
    int ckey = 0;
    float csum = 0.f;
    for (int w0 = 0; w0 < total; w0 += OVF_WIN) {
      const int wn = min(OVF_WIN, total - w0);
      // stage: slot f of the chunk's segments, in three waves of loads
      int sk[OVF_WU], ss[OVF_WU], bk[OVF_WU];
      long long rk[OVF_WU];
#pragma unroll
      for (int u = 0; u < OVF_WU; ++u) {
        const int f = w0 + min(u * 32 + lane, wn - 1);
        int kk = 0;                      // off[kk] <= f < off[kk + 1]
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int c = kk + step;
          const int oc = __shfl_sync(ALL, off, c);
          if (c < nk && oc <= f) kk = c;
        }
        sk[u] = kk;
        bk[u] = __shfl_sync(ALL, b, kk);
        rk[u] = __shfl_sync(ALL, run, kk);
        const int lk = __shfl_sync(ALL, lo, kk);
        const int ok = __shfl_sync(ALL, off, kk);
        ss[u] = u * 32 + lane < wn ? a.order[rk[u] + lk + (f - ok)] : 0;
      }
      int row[OVF_WU], col[OVF_WU];
      float v[OVF_WU];
#pragma unroll
      for (int u = 0; u < OVF_WU; ++u) {
        row[u] = row0;
        v[u] = 0.f;
        col[u] = 0;
        if (u * 32 + lane < wn) {
          const long long bo = bk[u] * tslots;
          if (ss[u] < tslots) {
            row[u] = a.rows[bo + ss[u]];
            v[u] = to_f32(vals[bo + ss[u]]);
            col[u] = ss[u] & (BLOCK - 1);
          } else {
            const long long q = rk[u] - bo + (ss[u] - tslots);
            row[u] = a.ovf.rows[q];
            v[u] = to_f32(ovals[q]);
            col[u] = a.ovf.cols[q];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < OVF_WU; ++u) {
        const int e = u * 32 + lane;
        if (e < wn) {
          skey[e] = sk[u] * FUSED_ROWS + (row[u] - row0);
          sv[e] = v[u];
          sd[e] = ldcg(a.delta + (long long)(k0 + sk[u]) * BLOCK + col[u]);
        }
      }
      __syncwarp();
      // run sums: a complete run's sum goes to its head's sv, and its bit
      // to its row's mask; the run at the edge, if the chunk goes on, is
      // carried
      const bool more = w0 + wn < total;
      bool cut = false;
      int cutkey = 0;
      float cutsum = 0.f;
#pragma unroll
      for (int u = 0; u < OVF_WU; ++u) {
        const int e = u * 32 + lane;
        if (e < wn) {
          const int key = skey[e];
          if (e == 0 || skey[e - 1] != key) {
            float s = (e == 0 && cvalid && ckey == key)
                          ? fmaf(sv[0], sd[0], csum)
                          : __fmul_rn(sv[e], sd[e]);
            int e2 = e + 1;
            for (; e2 < wn && skey[e2] == key; ++e2)
              s = fmaf(sv[e2], sd[e2], s);
            if (e2 == wn && more) {
              cut = true;
              cutkey = key;
              cutsum = s;
            } else {
              sv[e] = s;
              atomicOr(reinterpret_cast<unsigned*>(mask)
                           + (key & (FUSED_ROWS - 1)),
                       1u << (key / FUSED_ROWS));
            }
          }
        }
      }
      __syncwarp();
      // owners: a carried run that the window did not continue, then the
      // window's runs, each found at its head (the first slot of its key)
      const bool pend = cvalid && skey[0] != ckey;
#pragma unroll
      for (int u = 0; u < FUSED_ROWS / 32; ++u) {
        const int r = u * 32 + lane;
        if (pend && (ckey & (FUSED_ROWS - 1)) == r)
          acc[u] = fold_run(acc[u], last[u], k0 + ckey / FUSED_ROWS, csum);
        unsigned m = static_cast<unsigned>(mask[r]);
        while (m) {
          const int kk = __ffs(m) - 1;
          m &= m - 1;
          const int key = kk * FUSED_ROWS + r;
          int lo2 = 0, hi2 = wn;
          while (lo2 < hi2) {
            const int mid = (lo2 + hi2) >> 1;
            if (skey[mid] < key) lo2 = mid + 1; else hi2 = mid;
          }
          acc[u] = fold_run(acc[u], last[u], k0 + kk, sv[lo2]);
        }
        mask[r] = 0;
      }
      const unsigned cm = __ballot_sync(ALL, cut);
      cvalid = cm != 0;
      if (cvalid) {
        const int src = __ffs(cm) - 1;
        ckey = __shfl_sync(ALL, cutkey, src);
        csum = __shfl_sync(ALL, cutsum, src);
      }
      __syncwarp();
    }
  }
  bad = __any_sync(ALL, bad);
  float ll[FUSED_ROWS / 32];
#pragma unroll
  for (int u = 0; u < FUSED_ROWS / 32; ++u) {
    const long long i = (long long)row0 + u * 32 + lane;
    if (last[u] < K - 1) acc[u] = __fadd_rn(acc[u], 0.f);
    if (i == 0) acc[u] = add_padding(acc[u], bad);
    ll[u] = 0.f;
    if (i < n) {
      float rr, ww;
      a.z[i] = acc[u];
      loss_tile<LOSS>(acc[u], yv[u], 1.f, rr, ww, ll[u]);
      a.r[i] = rr;
      if constexpr (NEWTON) a.w[i] = ww;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) ll[u] = __fadd_rn(ll[u], ll[u + 4]);
#pragma unroll
  for (int u = 0; u < 2; ++u) ll[u] = __fadd_rn(ll[u], ll[u + 2]);
  float tot = __fadd_rn(ll[0], ll[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    tot = __fadd_rn(tot, __shfl_down_sync(ALL, tot, o));
  if (lane == 0) a.lpart[(rd & 1) * n_lt + j] = tot;
}

// BC of an OVF round: warp w of the grid's W·G takes items w, w + W·G, …:
// the n_lt row items (ovf_rows), then the 4K column items x[b_k, c] +=
// δ_k,c (32 columns of drawn block k an item, on its first k only, the
// duplicates' δ in k order).  A warp loads its next row item's range-start
// pairs (chunk 0's) before it sums the current one.
template <typename TV, int LOSS, bool NEWTON>
__device__ __forceinline__ void ovf_bc(const SparseArgs& a, const int* idx,
                                       int rd, int n_lt, long long nq1,
                                       float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.K, nw = gridDim.x * WARPS;
  int* arena = reinterpret_cast<int*>(part) + warp * OVF_ARENA;
  int b0 = 0, plo = 0, phi = 0;
  long long run0 = 0;
  if (lane < min(32, K)) {
    b0 = idx[lane];
    run0 = (long long)b0 * a.tile * BLOCK + a.ovf.ptr[(long long)b0 * BLOCK];
  }
  const auto fetch = [&](int jj) {
    if (jj < n_lt && lane < min(32, K)) {
      const int* rs = a.rstart + b0 * nq1 + 2 * jj;
      plo = rs[0];
      phi = rs[2 * jj + 2 < nq1 ? 2 : 1];
    }
  };
  const int j0 = blockIdx.x * WARPS + warp;
  fetch(j0);
  for (int j = j0; j < n_lt + 4 * K; j += nw) {
    if (j < n_lt) {
      const int lo = plo, len = phi - plo;
      fetch(j + nw);
      ovf_rows<TV, LOSS, NEWTON>(a, idx, j, n_lt, rd, nq1, arena, b0, run0,
                                 lo, len);
    } else {
      const int p = j - n_lt, k = p >> 2, c = (p & 3) * 32 + lane;
      const int b = idx[k];
      bool first = true;
      for (int kk = 0; kk < k; ++kk) first &= (idx[kk] != b);
      if (first) {
        const long long o = (long long)b * BLOCK + c;
        float v = ldcg(a.x + o);
        for (int kk = k; kk < K; ++kk)
          if (idx[kk] == b) v += ldcg(a.delta + kk * BLOCK + c);
        a.x[o] = v;
      }
    }
  }
}

// The rounds of one launch: every fused sparse kernel below is this body.
// OVF (unbatched, no EMIT_DZ) adds a design's overflow store: phase A also
// sums the drawn blocks' spilled segments (items after the |x| partials,
// one segment a warp) and writes the tile sums instead of δ; a phase A2,
// with a barrier of its own, adds each column's segment sums to its tile
// sum and writes δ; BC (ovf_bc) reads the spilled entries with the tile
// slots, a warp an item.  A round then costs three barriers, and its
// gather work follows the drawn blocks' entries, not their deepest column.
// Its stamps: one more a round, after A's own barrier (3R + 4 clocks, the
// ns times at 3R + 4 and 3R + 5).
template <typename TV, int LOSS, bool NEWTON, bool EMIT_DZ, bool BATCHED,
          bool OVF>
__device__ __forceinline__ void fused_sparse_rounds(SparseArgs a) {
  static_assert(!(EMIT_DZ && BATCHED), "no batched delta kernel");
  static_assert(!(OVF && (EMIT_DZ || BATCHED)), "OVF is unbatched #2 only");
  cg::grid_group grid = cg::this_grid();
  __shared__ float s[THREADS];
  __shared__ int si[THREADS];
  __shared__ float part[FUSED_KC * FUSED_ROWS];
  __shared__ float sv[FUSED_STAGE], sd[FUSED_STAGE];
  __shared__ int skey[FUSED_STAGE];
  __shared__ int sblk[FUSED_KC], slo[FUSED_KC], soff[FUSED_KC + 1];
  __shared__ int wsum[WARPS];
  __shared__ int carry;
  int* kpre = nullptr;
  if constexpr (OVF) kpre = ovf_kpre();
  const RangeBufs rb{part, sv, sd, skey, sblk, slo, soff, wsum, &carry};
  const TV* vals = static_cast<const TV*>(a.vals);
  const int S = BATCHED ? a.S : 1;
  const long long n = a.n;
  const int K = a.K;
  const int n_pair = (K + HALF - 1) / HALF;       // (k, column) item pairs
  const int n_lt = (int)((n + THREADS - 1) / THREADS);   // 256-row tiles
  const int n_xc = EMIT_DZ ? 0 : (int)((a.d_pad + XCHUNK - 1) / XCHUNK);
  const long long nq1 = (n + RANGE_ROWS - 1) / RANGE_ROWS + 1;
  const int sub = threadIdx.x >> 7, c = threadIdx.x & (BLOCK - 1);
  // Slot so's arrays start so strides in (64-bit); the tiles, order, table
  // and zmask stride 0 for a shared design.  Unbatched, so and every slot
  // stride are compile-time zeros, so the offsets fold away.
  const long long ts = BATCHED ? a.t_stride : 0;
  const long long zs = ts ? a.d_pad : 0, qs = ts ? a.d_pad / BLOCK * nq1 : 0;
  const long long rk = BATCHED ? (long long)a.R * K : 0;
  const long long kb = BATCHED ? (long long)K * BLOCK : 0;
  const bool stamp = a.stamps != nullptr && blockIdx.x == gridDim.x - 1 &&
                     threadIdx.x == 0;
  int ns = 0;
  if (stamp) {
    a.stamps[(OVF ? 3 : 2) * a.R + 4] = globaltimer_ns();
    a.stamps[ns++] = clock64();
  }

  // launch start: z and r (and w) from z0; x and every chunk's |x| / nnz
  // partials from x0; health 0.  The (S, n) vectors are contiguous: flat
  // passes.
  if (blockIdx.x == 0)
    for (int sl = threadIdx.x; sl < S; sl += THREADS) a.health[sl] = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < S * n;
       i += (long long)gridDim.x * THREADS) {
    float rr, ww, ll;
    const float zi = a.z0[i];
    a.z[i] = zi;
    if constexpr (EMIT_DZ) a.dz[i] = 0.f;
    loss_tile<LOSS>(zi, a.y[i], 1.f, rr, ww, ll);
    a.r[i] = rr;
    if constexpr (NEWTON) a.w[i] = ww;
  }
  if constexpr (EMIT_DZ) {
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
         i < a.d_pad; i += (long long)gridDim.x * THREADS)
      a.x[i] = a.x0[i];
  } else {
    for (int it = blockIdx.x; it < S * n_xc; it += gridDim.x) {
      const int so = BATCHED ? it / n_xc : 0;
      if constexpr (BATCHED)
        x_partial(at_slot(a, so), it - so * n_xc, true, s, si);
      else
        x_partial(a, it, true, s, si);
    }
  }
  grid.sync();
  if (stamp) a.stamps[ns++] = clock64();

  for (int rd = 0; rd <= a.R; ++rd) {
    const int* idx = a.idx + (long long)min(rd, a.R - 1) * K;
    // A: δ of round rd; the |x| / nnz partials of round rd − 1's chunks.
    const int n_d = rd < a.R ? n_pair : 0;
    const int n_x = !EMIT_DZ && rd > 0 ? K : 0;
    int n_s = 0;      // OVF: items of the drawn blocks' spilled segments
    if constexpr (OVF) {
      if (rd < a.R) {
        int cnt = 0, total;
        if (threadIdx.x < K) {
          const long long b = idx[threadIdx.x];
          cnt = a.oseg[(b + 1) * BLOCK] - a.oseg[b * BLOCK];
        }
        const int off = block_exclusive_scan(cnt, wsum, total);
        if (threadIdx.x < K) kpre[threadIdx.x] = off;
        if (threadIdx.x == 0) kpre[K] = total;
        __syncthreads();
        n_s = (total + WARPS - 1) / WARPS;
      }
    }
    const int n_a = n_d + n_x + n_s;
    for (int it = blockIdx.x; it < S * n_a; it += gridDim.x) {
      const int so = BATCHED ? it / n_a : 0;
      const int j = it - so * n_a;
      if (j < n_d) {
        const int k = j * HALF + sub;
        if (k < K) {
          const float lm = scal(a, 0, so), bt = scal(a, 1, so);
          const int ke = (int)scal(a, 2, so);
          // ik[k] is read again after the gather loop: held in a register
          // across the loop's ld.global.cg it moved ptxas's allocation of
          // the unbatched kernel, which ran slower.
          const int* ik = idx + so * rk;
          float g, h;
          gather_col<TV, NEWTON>(a.rows + so * ts, vals + so * ts,
                                 a.r + so * n, a.w + (NEWTON ? so * n : 0),
                                 ik[k], c, a.tile, g, h);
          if constexpr (OVF) {
            a.gt[k * BLOCK + c] = g;
            if constexpr (NEWTON) a.ht[k * BLOCK + c] = h;
          } else {
            const float xs =
                ldcg(a.x + so * a.d_pad + (long long)ik[k] * BLOCK + c);
            const float hh = NEWTON ? (h < 1e-8f ? 1e-8f : h) : bt;
            const float xn = soft_threshold(xs - g / hh, lm / hh);
            (a.delta + so * kb)[k * BLOCK + c] =
                (xn - xs) * (k < ke ? 1.f : 0.f);
          }
        }
      } else if (OVF && j >= n_d + n_x) {
        if constexpr (OVF) {
          const int f = (j - n_d - n_x) * WARPS + (threadIdx.x >> 5);
          if (f < kpre[K]) ovf_segment<TV, NEWTON>(a, idx, kpre, K, f);
        }
      } else if constexpr (!EMIT_DZ) {
        // chunk of round rd − 1's draw k, on its first k only
        const int k = j - n_d;
        const int* ip = a.idx + so * rk + (long long)(rd - 1) * K;
        const int ch = ip[k] / XBLK;
        bool first = true;
        for (int kk = 0; kk < k; ++kk) first &= (ip[kk] / XBLK != ch);
        if (first) {
          if constexpr (BATCHED)
            x_partial(at_slot(a, so), ch, false, s, si);
          else
            x_partial(a, ch, false, s, si);
        }
      }
    }
    grid.sync();
    if constexpr (OVF) {
      // A2: each drawn column's g (and h) and δ, a warp a column.
      if (rd < a.R) {
        if (stamp) a.stamps[ns++] = clock64();
        constexpr int GROUPS = BLOCK / WARPS;
        for (int it = blockIdx.x; it < K * GROUPS; it += gridDim.x)
          ovf_delta<LOSS, NEWTON>(a, idx, it / GROUPS,
                                  (it % GROUPS) * WARPS + (threadIdx.x >> 5));
        grid.sync();
      }
    }
    if (stamp) a.stamps[ns++] = clock64();
    // Slot s's finish of round rd − 1 on block G − 1 − s % G of the G
    // blocks (unbatched: the last), which BC's items, dealt from block 0
    // up, reach last; from the loss partials of rd − 1's parity.
    const int half = ((rd - 1) & 1) * n_lt;
    const int last = gridDim.x - 1 - blockIdx.x;
    if constexpr (BATCHED) {
      for (int sl = last; rd > 0 && sl < S; sl += gridDim.x) {
        const SparseArgs b = at_slot(a, sl);
        finish_round<LOSS>(b, rd - 1, scal(a, 0, sl), scal(a, 3, sl), n_xc,
                           n_lt, b.lpart + half, s, si);
      }
    } else if (!EMIT_DZ && rd > 0 && last == 0) {
      finish_round<LOSS>(a, rd - 1, scal(a, 0, 0), scal(a, 3, 0), n_xc, n_lt,
                         a.lpart + half, s, si);
    }
    if (rd == a.R) {
      if (stamp) a.stamps[ns++] = clock64();
      break;
    }
    // BC: the row tiles' sums; x[blk_k] += δ_k for each distinct block.
    if constexpr (OVF) {
      ovf_bc<TV, LOSS, NEWTON>(a, idx, rd, n_lt, nq1, part);
    } else {
      const int n_c = n_lt + n_pair;
      for (int it = blockIdx.x; it < S * n_c; it += gridDim.x) {
        const int so = BATCHED ? it / n_c : 0;
        const int j = it - so * n_c;
        const int* ik = idx + so * rk;
        if (j < n_lt) {
          const long long i = (long long)j * THREADS + threadIdx.x;
          const long long vo = so * n;
          const bool owner = i < n;
          bool bad;
          float acc = range_sums<TV, FUSED_ROWS, FUSED_KC, FUSED_STAGE, true>(
              a.rows + so * ts, vals + so * ts, a.order + so * ts,
              a.rstart + so * qs, a.zmask + so * zs, ik, a.delta + so * kb,
              nq1, (long long)a.tile * BLOCK, K, 2 * j,
              2 * j + 2 < nq1 ? 2 : 1, j * FUSED_ROWS, j == 0, owner,
              !EMIT_DZ && owner ? ldcg(a.z + vo + i) : 0.f, rb, bad);
          if (i == 0 && K > 0) acc = add_padding(acc, bad);
          if constexpr (EMIT_DZ) {
            if (owner) {
              const float zn = ldcg(a.z + i) + acc;
              a.z[i] = zn;
              a.dz[i] = ldcg(a.dz + i) + acc;
              if (!isfinite(zn)) a.health[0] = 1.f;   // max-accumulated
              float rr, ww, ll;
              loss_tile<LOSS>(zn, a.y[i], 1.f, rr, ww, ll);
              a.r[i] = rr;
              if constexpr (NEWTON) a.w[i] = ww;
            }
          } else {
            float ll = 0.f;
            if (owner) {
              float rr, ww;
              a.z[vo + i] = acc;
              loss_tile<LOSS>(acc, a.y[vo + i], 1.f, rr, ww, ll);
              a.r[vo + i] = rr;
              if constexpr (NEWTON) a.w[vo + i] = ww;
            }
            const float tot = block_sum(ll, s);
            if (threadIdx.x == 0)
              a.lpart[(so * 2 + (rd & 1)) * n_lt + j] = tot;
          }
        } else {
          const int k = (j - n_lt) * HALF + sub;
          if (k < K) {
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
    }
    if (EMIT_DZ && rd == a.R - 1) break;   // the launch's end is the barrier
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
  }
  if (stamp) a.stamps[(OVF ? 3 : 2) * a.R + 5] = globaltimer_ns();
}

// Two CTAs per SM (the cooperative grid, sparse_coop_blocks): up to 128
// registers a thread.  Without the bound ptxas kept the unbatched
// instantiations at 48–64 registers and spilled in the delta ones.
template <typename TV, int LOSS, bool NEWTON, bool EMIT_DZ, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 2)
fused_sparse_kernel(SparseArgs a) {
  fused_sparse_rounds<TV, LOSS, NEWTON, EMIT_DZ, BATCHED, false>(a);
}

// #2 on a design with an overflow store (sp_fused_shotgun_rounds_ovf).
template <typename TV, int LOSS, bool NEWTON>
__global__ void __launch_bounds__(THREADS, 2)
fused_sparse_ovf_kernel(SparseArgs a) {
  fused_sparse_rounds<TV, LOSS, NEWTON, false, false, true>(a);
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

template <typename TV>
const void* pick_sparse_ovf(int loss) {
  switch (loss) {
    case 0: return reinterpret_cast<const void*>(
        &fused_sparse_ovf_kernel<TV, LOSS_LASSO, false>);
    case 1: return reinterpret_cast<const void*>(
        &fused_sparse_ovf_kernel<TV, LOSS_LOGISTIC, false>);
    case 2: return reinterpret_cast<const void*>(
        &fused_sparse_ovf_kernel<TV, LOSS_LASSO, true>);
    case 3: return reinterpret_cast<const void*>(
        &fused_sparse_ovf_kernel<TV, LOSS_LOGISTIC, true>);
    default: return nullptr;
  }
}

// The arguments every fused entry takes; the rest null (or one slot).
SparseArgs fused_args(const int* rows, const void* vals, const int* order,
                      const int* rstart, const unsigned char* zmask,
                      const float* y, const int* idx, const float* const* sp,
                      const float* sv, const float* z0, float* z,
                      const float* x0, float* x, float* r, float* w,
                      float* delta, long long n, long long d_pad, int R,
                      int K, int tile) {
  SparseArgs a{};
  a.rows = rows;
  a.vals = vals;
  a.order = order;
  a.rstart = rstart;
  a.zmask = zmask;
  a.y = y;
  a.idx = idx;
  for (int j = 0; j < 4; ++j) {
    a.sp[j] = sp[j];
    a.sv[j] = sv[j];
  }
  a.z0 = z0;
  a.z = z;
  a.x0 = x0;
  a.x = x;
  a.r = r;
  a.w = w;
  a.delta = delta;
  a.n = n;
  a.d_pad = d_pad;
  a.R = R;
  a.K = K;
  a.tile = tile;
  a.S = 1;
  return a;
}

// sparse_coop_blocks of `kern` on the current device, queried once per
// (kernel, device): the queries cost host time on every launch otherwise.
int sparse_grid(const void* kern) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> grids;
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = grids.find({kern, dev});
  if (it != grids.end()) return it->second;
  const int blocks = sparse_coop_blocks(kern);
  if (blocks > 0) grids[{kern, dev}] = blocks;
  return blocks;
}

int launch_sparse(const void* kern, SparseArgs a, void* stream) {
  if (!kern) return (int)cudaErrorInvalidValue;
  const int blocks = sparse_grid(kern);
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
// code (bit 0 logistic, bit 1 Newton, bit 2 the delta kernel; bit 4 the
// OVF kernel, the grid its launches take); negative CUDA error on failure.
int sp_fused_grid_blocks(int v_bf16, int loss) {
  if (loss & 16) {
    if (loss & ~19) return -(int)cudaErrorInvalidValue;
    return sparse_grid(v_bf16 ? pick_sparse_ovf<__nv_bfloat16>(loss & 3)
                              : pick_sparse_ovf<float>(loss & 3));
  }
  if (loss & ~7) return -(int)cudaErrorInvalidValue;
  const void* kern = pick_sparse(v_bf16, loss);
  if (!kern) return -(int)cudaErrorInvalidValue;
  return sparse_coop_blocks(kern);
}

// The fused entries' arguments.  sp: a host array of 4 device pointers
// (lam, beta, k_eff, guard_f, each an (S,) f32 vector, one value a slot) or
// nulls; sv: a host array of the 4 values taken where sp[j] is null.
// rstart: (nblk, ceil(n / 128) + 1) int32 range-start table
// (data/sparse.py::range_starts); z0 and x0 are read-only, z and x written.
int sp_fused_shotgun_rounds(const int* rows, const void* vals, int v_bf16,
                            int loss, const int* order, const int* rstart,
                            const unsigned char* zmask, const float* y,
                            const int* idx, const float* const* sp,
                            const float* sv, const float* z0, float* z,
                            const float* x0, float* x, float* r, float* w,
                            float* delta, float* lpart, float* xl1, int* xnz,
                            float* f, int* nnz, float* health,
                            long long* stamps, long long n, long long d_pad,
                            int R, int K, int tile, void* stream) {
  if (loss & ~3) return (int)cudaErrorInvalidValue;
  SparseArgs a = fused_args(rows, vals, order, rstart, zmask, y, idx, sp, sv,
                            z0, z, x0, x, r, w, delta, n, d_pad, R, K, tile);
  a.lpart = lpart;
  a.xl1 = xl1;
  a.xnz = xnz;
  a.f = f;
  a.nnz = nnz;
  a.health = health;
  a.stamps = stamps;
  return launch_sparse(pick_sparse(v_bf16, loss), a, stream);
}

// #2 on a design with an overflow store: the arguments of
// sp_fused_shotgun_rounds, with order and rstart overflow_layouts' (data/
// sparse.py), then the store (orows, ovals, ocols, optr, oseg, oseg_col:
// data/sparse.py::Overflow) and its workspaces: gpart and hpart (K,
// seg_slots), gt and ht (K, 128) f32 (hpart, ht one element unless
// Newton).  K is at most OVF_KMAX.  The grid is the cooperative grid of
// the other fused launches; a round's segment items cover the drawn
// blocks' own segments, at most K·seg_slots of them.
int sp_fused_shotgun_rounds_ovf(
    const int* rows, const void* vals, int v_bf16, int loss, const int* order,
    const int* rstart, const unsigned char* zmask, const float* y,
    const int* idx, const float* const* sp, const float* sv, const float* z0,
    float* z, const float* x0, float* x, float* r, float* w, float* delta,
    float* lpart, float* xl1, int* xnz, float* f, int* nnz, float* health,
    long long* stamps, long long n, long long d_pad, int R, int K, int tile,
    const int* orows, const void* ovals, const unsigned char* ocols,
    const long long* optr, const int* oseg, const unsigned char* oseg_col,
    float* gpart, float* hpart, float* gt, float* ht, int seg_slots,
    void* stream) {
  if ((loss & ~3) || K < 1 || K > OVF_KMAX || seg_slots < 1)
    return (int)cudaErrorInvalidValue;
  SparseArgs a = fused_args(rows, vals, order, rstart, zmask, y, idx, sp, sv,
                            z0, z, x0, x, r, w, delta, n, d_pad, R, K, tile);
  a.lpart = lpart;
  a.xl1 = xl1;
  a.xnz = xnz;
  a.f = f;
  a.nnz = nnz;
  a.health = health;
  a.stamps = stamps;
  a.ovf = OvfStore{orows, ovals, ocols, optr};
  a.oseg = oseg;
  a.oseg_col = oseg_col;
  a.gpart = gpart;
  a.hpart = hpart;
  a.gt = gt;
  a.ht = ht;
  a.seg_slots = seg_slots;
  return launch_sparse(v_bf16 ? pick_sparse_ovf<__nv_bfloat16>(loss)
                              : pick_sparse_ovf<float>(loss),
                       a, stream);
}

// The slot kernel: every array but the tiles, the order, the table and
// `stamps` carries a leading slot axis of S (z (S, n), x (S, d_pad), health
// (S,), ...); rows, vals and order advance t_stride elements per slot,
// rstart and zmask one slot's worth when t_stride != 0 (0: one shared
// design).  `stamps`, as for the unbatched launch, may be null.
int sp_batched_fused_shotgun_rounds(
    const int* rows, const void* vals, int v_bf16, int loss,
    long long t_stride, const int* order, const int* rstart,
    const unsigned char* zmask, const float* y, const int* idx,
    const float* const* sp, const float* sv, const float* z0, float* z,
    const float* x0, float* x, float* r, float* w, float* delta,
    float* lpart, float* xl1, int* xnz, float* f, int* nnz, float* health,
    long long* stamps, long long n, long long d_pad, int S, int R, int K,
    int tile, void* stream) {
  if ((loss & ~3) || S < 1) return (int)cudaErrorInvalidValue;
  SparseArgs a = fused_args(rows, vals, order, rstart, zmask, y, idx, sp, sv,
                            z0, z, x0, x, r, w, delta, n, d_pad, R, K, tile);
  a.lpart = lpart;
  a.xl1 = xl1;
  a.xnz = xnz;
  a.f = f;
  a.nnz = nnz;
  a.health = health;
  a.stamps = stamps;
  a.S = S;
  a.t_stride = t_stride;
  return launch_sparse(pick_sparse(v_bf16, loss | 8), a, stream);
}

// Grid size (CUDA blocks) of the sparse slot kernel for this value type and
// loss code (bit 0 logistic, bit 1 Newton); negative CUDA error on failure.
int sp_batched_grid_blocks(int v_bf16, int loss) {
  if (loss & ~3) return -(int)cudaErrorInvalidValue;
  return sparse_coop_blocks(pick_sparse(v_bf16, loss | 8));
}

// The delta kernel: z0 read-only, view (n,) scratch, dz (n,) out, x0
// read-only, x (d_pad,) out.
int sp_fused_shotgun_delta_rounds(const int* rows, const void* vals,
                                  int v_bf16, int loss, const int* order,
                                  const int* rstart,
                                  const unsigned char* zmask, const float* y,
                                  const int* idx, const float* const* sp,
                                  const float* sv, const float* z0,
                                  float* view, float* dz, const float* x0,
                                  float* x, float* r, float* w, float* delta,
                                  float* health, long long n, long long d_pad,
                                  int R, int K, int tile, void* stream) {
  if (loss & ~3) return (int)cudaErrorInvalidValue;
  SparseArgs a = fused_args(rows, vals, order, rstart, zmask, y, idx, sp, sv,
                            z0, view, x0, x, r, w, delta, n, d_pad, R, K,
                            tile);
  a.health = health;
  a.dz = dz;
  return launch_sparse(pick_sparse(v_bf16, loss | 4), a, stream);
}

}  // extern "C"
