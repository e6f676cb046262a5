// BlockedCSC sparse Block-Shotgun kernels for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// A is stored as (nblk, tile, 128) rows/vals tiles (data/sparse.py); a
// drawn block costs tile·128·(4 + value bytes) bytes, a few KB, so at the
// sizes users run (n ≈ 2·10⁴, K ≤ 32) every call moves under 1 MB of
// tiles and is bound by launch and memory latency, not by HBM bandwidth.
// The margin-sized vectors (z, r, the (K, n) scatter buffer) fit in L2.
//
// Determinism without float atomics: the gather gives each (k, column)
// one owner that sums the tile axis in order; the scatter sums each run of
// equal rows of a block in the block's row-sorted slot order (built once
// per problem, data/sparse.py::scatter_order) into its own row of a (K, n)
// buffer, and one pass over n then adds the K rows in k order.  Padding
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

// Combine tile q (rows q·256 ..): z_out[i] = z_in[i] + Σ_k buf[k][i] in k
// order (+ the padding terms on row 0), zeroing buf as it is read.  FUSED
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
  float acc = ldcg(z_in + i);
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

}  // namespace

// ---------------------------------------------------------------------------
// sparse_gather_block_matvec — replaces repro/kernels/shotgun_sparse.py::
// sparse_gather_block_matvec (Pallas, grid (K,)).  Bound: the K drawn
// tiles (K·tile·128·(4 + value bytes)) plus r; at n ≈ 2·10⁴ that is under
// 1 MB, so launch latency bounds it.  Design: one thread per (k, column),
// two column sets per CUDA block, eight loads in flight per thread.
// ---------------------------------------------------------------------------
template <typename TV>
__global__ void __launch_bounds__(THREADS)
sparse_gather_kernel(const int* __restrict__ rows, const TV* __restrict__ vals,
                     const float* r, const int* __restrict__ idx, int tile,
                     int K, float* g) {
  const int k = blockIdx.x * HALF + (threadIdx.x >> 7);
  const int c = threadIdx.x & (BLOCK - 1);
  if (k >= K) return;
  float gg, hh;
  gather_col<TV, false>(rows, vals, r, nullptr, idx[k], c, tile, gg, hh);
  g[k * BLOCK + c] = gg;
}

// ---------------------------------------------------------------------------
// sparse_scatter_block_update — replaces repro/kernels/shotgun_sparse.py::
// sparse_scatter_block_update (Pallas, grid (K,), a VMEM f32 accumulator).
// Bound: the K drawn tiles plus z read and written once.  Design: run sums
// into a zeroed (K, n) buffer (one launch), then the k-ordered combine
// over n (a second launch).  No atomics; duplicate draws accumulate.
// ---------------------------------------------------------------------------
template <typename TV>
__global__ void __launch_bounds__(THREADS)
scatter_runs_kernel(const int* __restrict__ rows, const TV* __restrict__ vals,
                    const int* __restrict__ order, const int* __restrict__ count,
                    const unsigned char* __restrict__ zmask,
                    const int* __restrict__ idx, const float* delta, int tile,
                    int nq, long long n, float* buf, float* padterm) {
  const int k = blockIdx.x / nq, q = blockIdx.x - k * nq;
  scatter_runs<TV>(rows, vals, order, count, zmask, idx, delta, k, q, tile, n,
                   buf, padterm);
}

__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* z_in, float* z_out, float* buf,
               const float* padterm, long long n, int K) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  combine_row<LOSS_LASSO, false, false>(i, n, K, z_in, z_out, buf, padterm,
                                        nullptr, nullptr, nullptr);
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
// are bit-identical.  With a non-null `stamps`, block 0 records clock64()
// at launch start, after every grid.sync() and at the end (3R + 4 stamps):
// the per-phase breakdown of a launch, barrier included.
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
  long long* stamps;  // (3R + 4,) phase clock stamps, or null
  long long n, d_pad;
  int R, K, tile;
};

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

template <typename TV, int LOSS, bool NEWTON>
__global__ void __launch_bounds__(THREADS)
fused_sparse_kernel(SparseArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float s[THREADS];
  __shared__ int si[THREADS];
  const TV* vals = static_cast<const TV*>(a.vals);
  const float lam = a.scal[0], beta = a.scal[1], guard = a.scal[3];
  const int k_eff = (int)a.scal[2];
  const long long n = a.n;
  const int K = a.K, tile = a.tile;
  const int n_pair = (K + HALF - 1) / HALF;       // (k, column) item pairs
  const int nq = tile * BLOCK / THREADS;          // run-sum items per k
  const int n_runs = K * nq;
  const int n_lt = (int)((n + THREADS - 1) / THREADS);
  const int n_xc = (int)((a.d_pad + XCHUNK - 1) / XCHUNK);
  const int sub = threadIdx.x >> 7, c = threadIdx.x & (BLOCK - 1);
  const bool stamp = a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int ns = 0;
  if (stamp) a.stamps[ns++] = clock64();

  // launch start: r (and w) from z0; the scatter buffer zeroed.
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float rr, ww, ll;
    loss_tile<LOSS>(a.z[i], a.y[i], 1.f, rr, ww, ll);
    a.r[i] = rr;
    if constexpr (NEWTON) a.w[i] = ww;
  }
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < (long long)K * n; i += (long long)gridDim.x * THREADS)
    a.buf[i] = 0.f;
  grid.sync();
  if (stamp) a.stamps[ns++] = clock64();

  for (int rd = 0; rd <= a.R; ++rd) {
    const int* idx = a.idx + (long long)min(rd, a.R - 1) * K;
    // A: δ of round rd; |x| / nnz partials of round rd − 1.
    const int n_a = (rd < a.R ? n_pair : 0) + (rd > 0 ? n_xc : 0);
    for (int it = blockIdx.x; it < n_a; it += gridDim.x) {
      if (rd < a.R && it < n_pair) {
        const int k = it * HALF + sub;
        if (k < K) {
          float g, h;
          gather_col<TV, NEWTON>(a.rows, vals, a.r, a.w, idx[k], c, tile, g, h);
          const float xs = ldcg(a.x + (long long)idx[k] * BLOCK + c);
          const float hh = NEWTON ? (h < 1e-8f ? 1e-8f : h) : beta;
          const float xn = soft_threshold(xs - g / hh, lam / hh);
          a.delta[k * BLOCK + c] = (xn - xs) * (k < k_eff ? 1.f : 0.f);
        }
      } else {
        x_partial(a, it - (rd < a.R ? n_pair : 0), s, si);
      }
    }
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
    // B: run sums of round rd; block 0 finishes round rd − 1.
    if (rd > 0 && blockIdx.x == 0)
      finish_round<LOSS>(a, rd - 1, lam, guard, n_xc, n_lt, s, si);
    if (rd == a.R) {
      if (stamp) a.stamps[ns++] = clock64();
      break;
    }
    for (int it = blockIdx.x; it < n_runs; it += gridDim.x) {
      const int k = it / nq, q = it - k * nq;
      scatter_runs<TV>(a.rows, vals, a.order, a.count, a.zmask, idx, a.delta,
                       k, q, tile, n, a.buf, a.padterm);
    }
    grid.sync();
    if (stamp) a.stamps[ns++] = clock64();
    // C: the pass over n; x[blk_k] += δ_k for each distinct drawn block.
    for (int it = blockIdx.x; it < n_lt + n_pair; it += gridDim.x) {
      if (it < n_lt) {
        const long long i = (long long)it * THREADS + threadIdx.x;
        const float ll = combine_row<LOSS, NEWTON, true>(
            i, n, K, a.z, a.z, a.buf, a.padterm, a.y, a.r, a.w);
        const float tot = block_sum(ll, s);
        if (threadIdx.x == 0) a.lpart[it] = tot;
      } else {
        const int k = (it - n_lt) * HALF + sub;
        if (k < K) {
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

template <typename TV, int LOSS, bool NEWTON>
const void* sparse_kernel() {
  return reinterpret_cast<const void*>(&fused_sparse_kernel<TV, LOSS, NEWTON>);
}

template <typename TV>
const void* pick_sparse(int loss) {
  switch (loss) {
    case 0: return sparse_kernel<TV, LOSS_LASSO, false>();
    case 1: return sparse_kernel<TV, LOSS_LOGISTIC, false>();
    case 2: return sparse_kernel<TV, LOSS_LASSO, true>();
    case 3: return sparse_kernel<TV, LOSS_LOGISTIC, true>();
    default: return nullptr;
  }
}

const void* pick_sparse(int v_bf16, int loss) {
  return v_bf16 ? pick_sparse<__nv_bfloat16>(loss) : pick_sparse<float>(loss);
}

}  // namespace

extern "C" {

int sp_gather_block_matvec(const int* rows, const void* vals, int v_bf16,
                           const float* r, const int* idx, float* g, int tile,
                           int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((K + HALF - 1) / HALF);
  if (v_bf16)
    sparse_gather_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        rows, static_cast<const __nv_bfloat16*>(vals), r, idx, tile, K, g);
  else
    sparse_gather_kernel<float><<<blocks, THREADS, 0, s>>>(
        rows, static_cast<const float*>(vals), r, idx, tile, K, g);
  return (int)cudaGetLastError();
}

int sp_scatter_block_update(const int* rows, const void* vals, int v_bf16,
                            const int* order, const int* count,
                            const unsigned char* zmask, const float* z_in,
                            const int* idx, const float* delta, float* buf,
                            float* padterm, float* z_out, long long n,
                            int tile, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nq = tile * BLOCK / THREADS;
  const unsigned blocks = (unsigned)(K * nq);
  if (v_bf16)
    scatter_runs_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        rows, static_cast<const __nv_bfloat16*>(vals), order, count, zmask,
        idx, delta, tile, nq, n, buf, padterm);
  else
    scatter_runs_kernel<float><<<blocks, THREADS, 0, s>>>(
        rows, static_cast<const float*>(vals), order, count, zmask, idx,
        delta, tile, nq, n, buf, padterm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      z_in, z_out, buf, padterm, n, K);
  return (int)cudaGetLastError();
}

// Grid size (CUDA blocks) of the fused launch for this value type and loss
// code (bit 0 logistic, bit 1 Newton); negative CUDA error on failure.
int sp_fused_grid_blocks(int v_bf16, int loss) {
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
  const void* kern = pick_sparse(v_bf16, loss);
  if (!kern) return (int)cudaErrorInvalidValue;
  const int blocks = sparse_coop_blocks(kern);
  if (blocks <= 0) return blocks < 0 ? -blocks : (int)cudaErrorInvalidConfiguration;
  SparseArgs a{rows, vals, order, count, zmask, y, idx, scal, z, x, r, w,
               buf, padterm, delta, lpart, xl1, xnz, f, nnz, health, stamps,
               n, d_pad, R, K, tile};
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

}  // extern "C"
