// Shared pieces of the batched NMF kernels (cd_nmf.cu, mu_nmf.cu,
// beta_nmf.cu; cnmf.cu takes the reductions, the launcher and the grid
// entries' plan rule, barrier and launch).
//
// One thread block owns one fit: X (N, L), W (N, K) and H (K, L) of its
// trial live in shared memory for the whole solve, so device memory is
// read once and written once per fit, whatever the iteration count.
// Row strides are padded to odd values so that threads walking rows
// (one row each) or columns (one lane per row) hit distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define NMF_THREADS 128
#define NMF_KMAX 16
// Shared memory one block may use on sm_90 (227 KB).
#define NMF_SMEM_LIMIT (227 * 1024)

struct NmfBlock {
  int n, l, k;
  int ldx, ldw;
  float* x;      // (n, ldx)
  float* w;      // (n, ldw)
  float* h;      // (k, l)
  float* gram;   // (k, k): H H^T in the W half-step, W^T W in the H half
  float* cross;  // (k, l): W^T X
  float* red;    // 33 floats of block-reduction scratch
};

// sklearn's dimension-scaled L1/L2 penalties of W and H (all 0 without
// regularization, which leaves every update bit for bit unchanged).
struct NmfPenalty {
  float l1_w, l2_w, l1_h, l2_h;
};

__host__ __device__ inline int nmf_odd(int v) { return v | 1; }

__host__ __device__ inline size_t nmf_smem_floats(int n, int l, int k) {
  return (size_t)n * (nmf_odd(l) + nmf_odd(k)) + 2 * (size_t)k * l +
         (size_t)k * k + 33;
}

__device__ inline NmfBlock nmf_block(float* smem, int n, int l, int k) {
  NmfBlock b;
  b.n = n;
  b.l = l;
  b.k = k;
  b.ldx = nmf_odd(l);
  b.ldw = nmf_odd(k);
  b.x = smem;
  b.w = b.x + (size_t)n * b.ldx;
  b.h = b.w + (size_t)n * b.ldw;
  b.gram = b.h + k * l;
  b.cross = b.gram + k * k;
  b.red = b.cross + k * l;
  return b;
}

// Copy one fit's X, W and H from device memory (row-major, unpadded).
__device__ inline void nmf_load(const NmfBlock& b, const float* x,
                                const float* w, const float* h) {
  for (int i = threadIdx.x; i < b.n * b.l; i += blockDim.x) {
    b.x[(i / b.l) * b.ldx + i % b.l] = x[i];
  }
  for (int i = threadIdx.x; i < b.n * b.k; i += blockDim.x) {
    b.w[(i / b.k) * b.ldw + i % b.k] = w[i];
  }
  for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) b.h[i] = h[i];
  __syncthreads();
}

__device__ inline void nmf_store(const NmfBlock& b, float* w, float* h) {
  for (int i = threadIdx.x; i < b.n * b.k; i += blockDim.x) {
    w[i] = b.w[(i / b.k) * b.ldw + i % b.k];
  }
  for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) h[i] = b.h[i];
}

__device__ inline float nmf_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of `v` over the block, returned to every thread.
__device__ inline float nmf_block_sum(const NmfBlock& b, float v) {
  v = nmf_warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) b.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? b.red[lane] : 0.0f;
    v = nmf_warp_sum(v);
    if (lane == 0) b.red[32] = v;
  }
  __syncthreads();
  const float total = b.red[32];
  __syncthreads();
  return total;
}

// Sum of `v` over the block in float64, returned to every thread;
// `red` is 33 doubles of scratch.  The stopping statistics of the
// beta and convolutive kernels use it.
__device__ inline double nmf_block_sum_d(double* red, double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const double total = red[32];
  __syncthreads();
  return total;
}

// gram <- H H^T: K*K sums over L, one thread per entry.
__device__ inline void nmf_hht(const NmfBlock& b) {
  for (int q = threadIdx.x; q < b.k * b.k; q += blockDim.x) {
    const float* hi = b.h + (q / b.k) * b.l;
    const float* hj = b.h + (q % b.k) * b.l;
    float s = 0.0f;
    for (int m = 0; m < b.l; ++m) s += hi[m] * hj[m];
    b.gram[q] = s;
  }
  __syncthreads();
}

// W^T W into gram and W^T X into cross, or added to them (ADD): K*K +
// K*L sums over N, one warp per entry with its lanes striding over the
// rows, so entry q is always written by the same warp.
template <bool ADD>
__device__ inline void nmf_wtw_wtx(const NmfBlock& b, float* gram,
                                   float* cross) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int kk = b.k * b.k;
  for (int q = threadIdx.x >> 5; q < kk + b.k * b.l; q += n_warps) {
    const float* a;
    const float* c;
    int ldc;
    if (q < kk) {
      a = b.w + q / b.k;
      c = b.w + q % b.k;
      ldc = b.ldw;
    } else {
      a = b.w + (q - kk) / b.l;
      c = b.x + (q - kk) % b.l;
      ldc = b.ldx;
    }
    float s = 0.0f;
    for (int r = lane; r < b.n; r += 32) s += a[r * b.ldw] * c[r * ldc];
    s = nmf_warp_sum(s);
    if (lane == 0) {
      float* d = q < kk ? gram + q : cross + (q - kk);
      *d = ADD ? *d + s : s;
    }
  }
  __syncthreads();
}

// gram <- W^T W and cross <- W^T X.
__device__ inline void nmf_wtw_wtx(const NmfBlock& b) {
  nmf_wtw_wtx<false>(b, b.gram, b.cross);
}

// Row n of X H^T into xr[0..K).
template <int KMAX>
__device__ inline void nmf_xht_row(const NmfBlock& b, int n, float* xr) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) xr[i] = 0.0f;
  const float* xn = b.x + n * b.ldx;
  for (int m = 0; m < b.l; ++m) {
    const float v = xn[m];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) xr[i] += v * b.h[i * b.l + m];
    }
  }
}

// ---- the warp entries (cd_nmf.cu, mu_nmf.cu, beta_nmf.cu) ----
//
// One warp per fit, NMF_WARP_FITS fits a block, no __syncthreads on the
// iteration path.  Lane i owns rows i, i + 32, ... (NMF_WARP_ROWS of
// them) with their X and W in registers; the fit's small matrices sit in
// a per-warp shared slab read as broadcasts.  Every loop runs over the
// padded extents (KMAX components, LMAX columns, all the lane's rows),
// whose exact zeros change no sum, so nothing branches on the fit's own
// N, L or k inside an iteration.  The limits are mirrored by
// models/kernels/mu_cuda.py: WARP_NMAX, WARP_LMAX, WARP_KMAX.

#define NMF_WARP_FITS 4   // fits (warps) per block
#define NMF_WARP_ROWS 7   // rows a lane owns
#define NMF_WARP_NMAX (32 * NMF_WARP_ROWS)
#define NMF_WARP_LMAX 16
#define NMF_WARP_KMAX 8
#define NMF_FULL_MASK 0xffffffffu

// Reduce-scatter by recursive halving: after the steps O = 16, 8, .., 1
// lane i holds in a[0] the warp's sum of a[i].  Each step sends half of
// what is left to the partner lane, 31 shuffles in all.
template <int O>
__device__ __forceinline__ void nmf_warp_halve(float (&a)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? a[i] : a[i + O];
    const float keep = up ? a[i + O] : a[i];
    a[i] = keep + __shfl_xor_sync(NMF_FULL_MASK, send, O);
  }
  if constexpr (O > 1) nmf_warp_halve<O / 2>(a, lane);
}

// One fit's small matrices (K2's and K1's warp entries), row strides
// KMAX and LMAX, zero-padded.
template <int KMAX, int LMAX>
struct __align__(16) NmfWarpSlab {
  float h[KMAX * LMAX];    // H
  float hht[KMAX * KMAX];  // H H^T
  float wtw[KMAX * KMAX];  // W^T W
  float wtx[KMAX * LMAX];  // W^T X
};

// slab.hht <- H H^T, K*K sums over L, one lane per entry.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_hht(NmfWarpSlab<KMAX, LMAX>& sl,
                                             int lane) {
  for (int q = lane; q < KMAX * KMAX; q += 32) {
    const float* hi = sl.h + (q / KMAX) * LMAX;
    const float* hj = sl.h + (q % KMAX) * LMAX;
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < LMAX; ++m) s += hi[m] * hj[m];
    sl.hht[q] = s;
  }
}

// One row of X H^T from the row of X in registers and the slab's H.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_xht_row(
    const NmfWarpSlab<KMAX, LMAX>& sl, const float (&xrow)[LMAX],
    float (&xh)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) xh[i] = 0.0f;
#pragma unroll
  for (int m = 0; m < LMAX; ++m) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) xh[i] += xrow[m] * sl.h[i * LMAX + m];
  }
}

// Every lane's a[v] summed over the warp, for every v, each by the
// butterfly of nmf_warp_sum: every lane ends with every sum, and each sum
// associates exactly as the block entries' one-warp-per-entry reductions
// (nmf_wtw_wtx, beta_step) associate theirs.
template <int NV>
__device__ __forceinline__ void nmf_warp_allsum(float (&a)[NV]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v) a[v] += __shfl_xor_sync(NMF_FULL_MASK, a[v], off);
  }
}

// slab.wtw <- W^T W and slab.wtx <- W^T X: each lane's partial sums over
// its rows, then per group of 32 entries either a reduce-scatter (K2: 31
// shuffles, one sum per lane) or, with BLOCK_ORDER (K1), butterflies
// that add the partial sums in the block entry's order (160 shuffles),
// so that the warp entry computes the block entry's iterates bit for
// bit.  A lane's rows i, i + 32, ... are the rows a lane of the block
// entry's reduction walks, in the same order.
template <int KMAX, int LMAX, bool BLOCK_ORDER = false>
__device__ __forceinline__ void nmf_warp_wtw_wtx(
    NmfWarpSlab<KMAX, LMAX>& sl, const float (&xr)[NMF_WARP_ROWS][LMAX],
    const float (&wr)[NMF_WARP_ROWS][KMAX], int lane) {
  constexpr int NWW = KMAX * KMAX;
  constexpr int NV = NWW + KMAX * LMAX;
#pragma unroll
  for (int g = 0; g < (NV + 31) / 32; ++g) {
    float a[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int q = 32 * g + v;
      float s = 0.0f;
      if (q < NWW) {
#pragma unroll
        for (int r = 0; r < NMF_WARP_ROWS; ++r) s += wr[r][q / KMAX] * wr[r][q % KMAX];
      } else if (q < NV) {
        const int u = q - NWW;
#pragma unroll
        for (int r = 0; r < NMF_WARP_ROWS; ++r) s += wr[r][u / LMAX] * xr[r][u % LMAX];
      }
      a[v] = s;
    }
    if constexpr (BLOCK_ORDER) {
      nmf_warp_allsum(a);
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int q = 32 * g + v;
        if (q < NWW) {
          sl.wtw[q] = a[v];
        } else if (q < NV) {
          sl.wtx[q - NWW] = a[v];
        }
      }
    } else {
      nmf_warp_halve<16>(a, lane);
      const int q = 32 * g + lane;
      if (q < NWW) {
        sl.wtw[q] = a[0];
      } else if (q < NV) {
        sl.wtx[q - NWW] = a[0];
      }
    }
  }
}

// Load one fit's X and W rows (lane's rows, zero-padded to LMAX columns
// and KMAX components, rows past n zero) into registers and H into the
// slab's (KMAX, LMAX) plane `hs`; ends with a __syncwarp.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_load(
    const float* xf, const float* wf, const float* hf, int n, int l, int k,
    int lane, float (&xr)[NMF_WARP_ROWS][LMAX],
    float (&wr)[NMF_WARP_ROWS][KMAX], float* hs) {
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    const int row = lane + 32 * r;
#pragma unroll
    for (int m = 0; m < LMAX; ++m) {
      xr[r][m] = row < n && m < l ? xf[row * l + m] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      wr[r][i] = row < n && i < k ? wf[row * k + i] : 0.0f;
    }
  }
  for (int q = lane; q < KMAX * LMAX; q += 32) {
    const int i = q / LMAX, m = q % LMAX;
    hs[q] = i < k && m < l ? hf[i * l + m] : 0.0f;
  }
  __syncwarp();
}

// Store the lane's rows of W and the slab's H back, unpadded.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_store(
    float* wo, float* ho, int n, int l, int k, int lane,
    const float (&wr)[NMF_WARP_ROWS][KMAX], const float* hs) {
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    const int row = lane + 32 * r;
    if (row < n) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) wo[row * k + i] = wr[r][i];
      }
    }
  }
  for (int q = lane; q < k * l; q += 32) ho[q] = hs[(q / l) * LMAX + q % l];
}

// Launch `kernel` with one block per fit, raising the dynamic shared
// memory limit first when the fit needs more than the default 48 KB.
template <typename Kernel, typename... Args>
inline int nmf_launch(Kernel kernel, int batch, size_t smem,
                      cudaStream_t stream, Args... args) {
  if (smem > NMF_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<batch, NMF_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The KMAX a large-frame (grid) kernel runs a rank-k fit at, as the block
// entries'.
#define NMF_CLUSTER_DISPATCH(k, CALL) \
  ((k) <= 4 ? CALL(4) : (k) <= 8 ? CALL(8) : CALL(16))

// ---- the grid entries (the cluster entries of mu_nmf.cu, cd_nmf.cu,
// beta_nmf.cu and cnmf.cu: the one design for frames over one block) ----
//
// One fit spread over P blocks of the whole card: P from the batch and
// the SM count (nmf_grid_rule), one block a SM, so a lone
// capture-length fit runs on every SM.  Block r of a fit owns rows
// [r * rows, (r + 1) * rows) (rows = ceil(N / P), the last block
// shorter, a block past N none) and keeps H, the Gram matrices and its
// partial sums in its own shared memory.  Where the batch's rows fit
// the card's shared memory (resident) a block holds its rows there for
// the whole solve, column-major: y(r, j) at j * rows + r, W's k columns
// then X's l, so the lanes of a warp, one row each, read neighbouring
// words.  Otherwise (streamed) W lives in device memory and a block
// passes over its rows in tiles of the same layout, each copied in by
// 16-byte loads and W's columns written back by 16-byte stores.
//
// One iteration: every block forms H H^T; updates its rows of W
// (row-local); adds its rows' W^T [W X] into a partial set (4 x 8 tiles
// of the k x (k + l) product: each thread's rows summed in registers,
// the warp's lanes by a reduce-scatter, the warps in order) with one
// scalar (CD's W-pass violation); writes the set to the fit's workspace
// in device memory, double-buffered by the iteration's parity; meets the
// fit's other blocks at a barrier in device memory (an arrive counter a
// fit, release and acquire); adds the P sets in block order 0..P-1, a
// thread an entry with NMF_GRID_LOADS loads in flight, so every block
// holds the same bits; and updates H from them.  A block
// writes parity p again only after a barrier that every block of its fit
// passes only after reading parity p, so one barrier an iteration
// suffices.  Every branch is taken on values that are the same in every
// block of a fit, so a fit's blocks leave together and its counter is
// its own: a converged fit holds up no other.  The barrier needs every
// block of a fit resident at once: the plan gives a batch at most one
// block a SM, and the launch is cooperative, which the runtime refuses
// where the blocks could not all be resident.  models/kernels/mu_cuda.py
// mirrors the plan (grid_plan) and the least state (cluster_smem_bytes).
// K4 (beta_nmf.cu) and K5 (cnmf.cu) take the same plan rule with their
// own small state and row width (nmf_grid_rule_sized), their own partial
// sets and workspace layout, and the same barrier, launch and row
// helpers; their Python mirrors are beta_cuda.grid_plan and
// cnmf_cuda.grid_plan.

#define NMF_GRID_THREADS 256
#define NMF_GRID_WARPS (NMF_GRID_THREADS / 32)
#define NMF_GRID_MIN_ROWS 256  // rows a block, at least, where the fit has them
#define NMF_GRID_MIN_TILE 128  // rows of a streamed tile, at least
#define NMF_GRID_LOADS 32      // loads in flight a thread while summing the sets
#define NMF_GRID_PLAN_INTS 7   // blocks, rows, resident, tile, smem, SMs, blocks a SM

// Entries of a partial set: W^T [W X] in 4 x 8 tiles of 32 floats.
__host__ __device__ inline int nmf_grid_nq(int l, int k) {
  return 32 * ((k + 3) / 4) * ((k + l + 7) / 8);
}

// Floats of a block's state besides its rows: H, the Gram matrix (H H^T
// in the W pass, then W^T W), W^T X, 33 of block-reduction scratch, the
// block's partial set and its scalar, and the warps' sums of two tiles.
__host__ __device__ inline size_t nmf_grid_small_floats(int l, int k) {
  return 2 * (size_t)k * l + (size_t)k * k + 33 + nmf_grid_nq(l, k) + 1 +
         NMF_GRID_WARPS * 64;
}

__host__ __device__ inline long long nmf_cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline size_t nmf_r4(size_t v) { return (v + 3) & ~(size_t)3; }

// How a grid entry runs a batch of (n, l) fits at rank k; the kernels
// take it as their first argument.
struct NmfGridPlan {
  int n, l, k;   // the fit
  int blocks;    // P, blocks a fit
  int rows;      // rows a block, ceil(n / P)
  int tile;      // rows a pass holds in shared memory (resident: = rows)
  int resident;  // 1: rows in shared memory; 0: streamed tiles
  int nq;        // entries of a partial set
  int pstride;   // floats of a partial set in the workspace
  size_t smem;   // dynamic shared memory a block, bytes
};

// The plan rule for a kernel that keeps `small` floats a block besides its
// rows and `row` floats a row (models/kernels/mu_cuda.py: grid_rule): P at
// most SMs / batch (so the batch's blocks are resident together, one a SM)
// and at most ceil(n / NMF_GRID_MIN_ROWS); resident at the least P whose
// rows fit a block, where that is within SMs / batch; else streamed at P =
// SMs / batch in tiles of as many rows as fit.  Fills everything but nq and
// pstride.  Returns 0, or cudaErrorInvalidValue when not even
// NMF_GRID_MIN_TILE rows fit.
inline int nmf_grid_rule_sized(int batch, int n, int l, int k, int sms, size_t small,
                               long long row, NmfGridPlan* plan) {
  const long long room = NMF_SMEM_LIMIT / (long long)sizeof(float) - (long long)small;
  const long long p_max = sms / batch > 1 ? sms / batch : 1;
  const long long want = nmf_cdiv(n, NMF_GRID_MIN_ROWS);
  long long p = want < p_max ? want : p_max;
  const long long fit = room > 0 ? room / row : 0;
  long long rows, tile;
  int resident;
  if (fit >= 1 && nmf_cdiv(n, fit) <= p_max) {
    if (nmf_cdiv(n, fit) > p) p = nmf_cdiv(n, fit);
    rows = nmf_cdiv(n, p);
    tile = rows;
    resident = 1;
  } else {
    p = p_max;
    rows = nmf_cdiv(n, p);
    tile = fit < rows ? fit : rows;
    resident = 0;
    if (tile < NMF_GRID_MIN_TILE && tile < rows) return (int)cudaErrorInvalidValue;
  }
  plan->n = n;
  plan->l = l;
  plan->k = k;
  plan->blocks = (int)p;
  plan->rows = (int)rows;
  plan->tile = (int)tile;
  plan->resident = resident;
  plan->nq = 0;
  plan->pstride = 0;
  plan->smem = (small + (size_t)tile * row) * sizeof(float);
  return 0;
}

// K1's and K2's plan (models/kernels/mu_cuda.py: grid_plan): their small
// state, rows of k + l floats, partial sets of nq entries and a scalar.
inline int nmf_grid_rule(int batch, int n, int l, int k, int sms,
                         NmfGridPlan* plan) {
  const int r = nmf_grid_rule_sized(batch, n, l, k, sms, nmf_grid_small_floats(l, k),
                                    (long long)k + l, plan);
  if (r != 0) return r;
  plan->nq = nmf_grid_nq(l, k);
  plan->pstride = (int)nmf_r4(plan->nq + 1);
  return 0;
}

// Floats of the workspace a batch needs: the fits' arrive counters, the
// stopping statistic's slots (one a block) and the partial sets (two
// parities of one a block).  The wrapper allocates it zeroed.
inline size_t nmf_grid_workspace_floats(const NmfGridPlan& p, int batch) {
  const size_t blocks = (size_t)batch * p.blocks;
  return nmf_r4(batch) + nmf_r4(blocks) + 2 * blocks * p.pstride;
}

struct NmfGrid {
  NmfBlock b;         // k, l, h, gram, cross, red (x, w unused)
  float* bpart;       // the block's partial set, nq entries and the scalar
  float* wred;        // NMF_GRID_WARPS x 64: the warps' sums of two tiles
  float* y;           // the rows: tile rows, column-major
  int rank;           // the block's rank in its fit
  int rows;           // the block's rows
  size_t r0;          // its first row in the fit
  int tile, nq, pstride, blocks;
  bool resident;
  unsigned* counter;  // the fit's arrive counter
  float* err;         // the fit's stopping-statistic slots, one a block
  float* part;        // the fit's partial sets, [2][blocks][pstride]
};

__device__ inline NmfGrid nmf_grid(float* smem, const NmfGridPlan& p, float* ws,
                                   int batch, size_t fit, int rank) {
  NmfGrid g;
  NmfBlock& b = g.b;
  b.n = p.tile;
  b.l = p.l;
  b.k = p.k;
  b.ldx = b.ldw = 0;
  b.x = b.w = nullptr;
  b.h = smem;
  b.gram = b.h + p.k * p.l;
  b.cross = b.gram + p.k * p.k;
  b.red = b.cross + p.k * p.l;
  g.bpart = b.red + 33;
  g.wred = g.bpart + p.nq + 1;
  g.y = g.wred + NMF_GRID_WARPS * 64;
  const long long first = (long long)rank * p.rows;
  const long long last = min((long long)p.n, first + p.rows);
  g.r0 = (size_t)min(first, (long long)p.n);
  g.rows = (int)max(0LL, last - first);
  g.rank = rank;
  g.tile = p.tile;
  g.nq = p.nq;
  g.pstride = p.pstride;
  g.blocks = p.blocks;
  g.resident = p.resident != 0;
  g.counter = reinterpret_cast<unsigned*>(ws) + fit;
  g.err = ws + nmf_r4(batch) + fit * p.blocks;
  g.part = ws + nmf_r4(batch) + nmf_r4((size_t)batch * p.blocks) +
           fit * 2 * p.blocks * p.pstride;
  return g;
}

// `cnt` rows of `cols` floats, contiguous at src in device memory, into
// dst column-major (element (r, c) at c * ld + r): the 16-byte-aligned
// body by 16-byte loads, at most 3 elements before it and 3 after one by
// one.
__device__ inline void nmf_grid_gather(float* dst, int ld, const float* src, int cnt,
                                       int cols) {
  const int total = cnt * cols;
  const int head = min(total, (int)(((16 - ((size_t)src & 15)) & 15) >> 2));
  const int quads = (total - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int f = threadIdx.x; f < quads; f += blockDim.x) {
    const float4 v = __ldcg(s4 + f);
    const float vals[4] = {v.x, v.y, v.z, v.w};
    const int e = head + 4 * f;
    int r = e / cols, c = e - r * cols;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      dst[(size_t)c * ld + r] = vals[u];
      if (++c == cols) {
        c = 0;
        ++r;
      }
    }
  }
  const int tail = head + 4 * quads;
  if (threadIdx.x < head + (total - tail)) {
    const int e = threadIdx.x < head ? threadIdx.x : tail + threadIdx.x - head;
    dst[(size_t)(e % cols) * ld + e / cols] = __ldcg(src + e);
  }
}

// The inverse of nmf_grid_gather: `cnt` column-major rows of `cols`
// floats (stride ld) to dst in device memory, row-major.
__device__ inline void nmf_grid_scatter(float* dst, const float* src, int ld, int cnt,
                                        int cols) {
  const int total = cnt * cols;
  const int head = min(total, (int)(((16 - ((size_t)dst & 15)) & 15) >> 2));
  const int quads = (total - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int f = threadIdx.x; f < quads; f += blockDim.x) {
    float vals[4];
    const int e = head + 4 * f;
    int r = e / cols, c = e - r * cols;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      vals[u] = src[(size_t)c * ld + r];
      if (++c == cols) {
        c = 0;
        ++r;
      }
    }
    __stcg(d4 + f, make_float4(vals[0], vals[1], vals[2], vals[3]));
  }
  const int tail = head + 4 * quads;
  if (threadIdx.x < head + (total - tail)) {
    const int e = threadIdx.x < head ? threadIdx.x : tail + threadIdx.x - head;
    __stcg(dst + e, src[(size_t)(e % cols) * ld + e / cols]);
  }
}

// A pass's rows: n rows of the buffer y, column stride ld.
struct NmfGridRows {
  float* y;
  int ld;
  int n;
};

// body(c) on the block's rows: resident, once on the rows in shared
// memory; streamed, on each tile in turn, its X and W (from wf) copied in
// before and, with STORE_W, its W written back to wf after; barriers
// before and after each tile.
template <bool STORE_W, typename Body>
__device__ void nmf_grid_chunks(const NmfGrid& g, const float* xf, float* wf,
                                Body body) {
  if (g.resident) {
    body(NmfGridRows{g.y, g.tile, g.rows});
    return;
  }
  const int k = g.b.k, l = g.b.l;
  for (int i = 0; i * g.tile < g.rows; ++i) {
    const size_t row = g.r0 + (size_t)i * g.tile;
    const NmfGridRows c{g.y, g.tile, min(g.tile, g.rows - i * g.tile)};
    nmf_grid_gather(c.y + (size_t)k * c.ld, c.ld, xf + row * l, c.n, l);
    nmf_grid_gather(c.y, c.ld, wf + row * k, c.n, k);
    __syncthreads();
    body(c);
    __syncthreads();
    if (STORE_W) {
      nmf_grid_scatter(wf + row * k, c.y, c.ld, c.n, k);
      __syncthreads();  // before the next tile's copy refills the buffer
    }
  }
}

// The W pass on a pass's rows, one thread a row: the row's X H^T in
// registers (b.gram holds H H^T), `rows(wr, xh, b)` updates the row of W
// and returns what it adds to the thread's violation.  Returns the
// thread's summed violation.  Threads own the same rows in the Gram pass.
template <int KMAX, typename Rows>
__device__ float nmf_grid_w_pass(const NmfBlock& b, const NmfGridRows& c,
                                 const Rows& rows) {
  const int k = b.k, l = b.l, ld = c.ld, n = c.n;
  float* __restrict__ y = c.y;
  const float* __restrict__ h = b.h;
  float viol = 0.0f;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float wr[KMAX], xh[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) xh[i] = 0.0f;
#pragma unroll 8
    for (int m = 0; m < l; ++m) {
      const float v = y[(k + m) * ld + r];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) xh[i] += v * h[i * l + m];
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) wr[i] = i < k ? y[i * ld + r] : 0.0f;
    viol += rows(wr, xh, b);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) y[i * ld + r] = wr[i];
    }
  }
  return viol;
}

// Adds a pass's share of W^T [W X] to g.bpart.  Tile t of the k x (k + l)
// product is entries 32 t .. 32 t + 31 (row 4 (t / tj) + v / 8, column
// 8 (t % tj) + v % 8 of [W X], v = 0..31): each thread sums its rows in
// order in 32 registers, each warp's lanes combine by a reduce-scatter
// (lane v ends with entry v), and the warps' sums are added in warp
// order, two tiles a round.
__device__ inline void nmf_grid_gram_pass(const NmfGrid& g, const NmfGridRows& c) {
  const int k = g.b.k, kl = g.b.k + g.b.l;
  const int tj = (kl + 7) / 8, nt = ((k + 3) / 4) * tj;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < nt; t0 += 2) {
    for (int u = 0; u < 2 && t0 + u < nt; ++u) {
      const int i0 = 4 * ((t0 + u) / tj), j0 = 8 * ((t0 + u) % tj);
      float a[32];
#pragma unroll
      for (int v = 0; v < 32; ++v) a[v] = 0.0f;
      for (int r = threadIdx.x; r < c.n; r += blockDim.x) {
        float p[4], q[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = i0 + i < k ? c.y[(size_t)(i0 + i) * c.ld + r] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          q[j] = j0 + j < kl ? c.y[(size_t)(j0 + j) * c.ld + r] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[8 * i + j] += p[i] * q[j];
        }
      }
      nmf_warp_halve<16>(a, lane);
      g.wred[warp * 64 + 32 * u + lane] = a[0];
    }
    __syncthreads();
    const int q = 32 * t0 + threadIdx.x;
    if (threadIdx.x < 64 && q < g.nq) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NMF_GRID_WARPS; ++w) s += g.wred[w * 64 + threadIdx.x];
      g.bpart[q] += s;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned nmf_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A release store of a flag that another block reads with nmf_ld_acquire.
__device__ __forceinline__ void nmf_st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The fit's barrier in device memory: each block arrives (a fence, then
// the counter's add: release) and waits until the counter reaches
// `target` (acquire), so every write a block of the fit made before
// arriving is visible to every block after.
__device__ inline void nmf_grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (nmf_ld_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The sum of `count` floats at src, src + stride, ..., added one after
// another from 0: rounds of NMF_GRID_LOADS loads in flight, then the
// rest one by one.
__device__ __forceinline__ float nmf_grid_ordered_sum(const float* src, int count,
                                                      int stride) {
  float s = 0.0f;
  int r = 0;
  for (; r + NMF_GRID_LOADS <= count; r += NMF_GRID_LOADS) {
    float v[NMF_GRID_LOADS];
#pragma unroll
    for (int u = 0; u < NMF_GRID_LOADS; ++u) v[u] = __ldcg(src + (size_t)(r + u) * stride);
#pragma unroll
    for (int u = 0; u < NMF_GRID_LOADS; ++u) s += v[u];
  }
  for (; r < count; ++r) s += __ldcg(src + (size_t)r * stride);
  return s;
}

// Entry q of the fit's sums (or of a lone block's set) to its place:
// b.gram (W^T W), b.cross (W^T X), or, for the scalar, g.bpart[nq].
__device__ __forceinline__ void nmf_grid_place(const NmfGrid& g, int q, float s) {
  const NmfBlock& b = g.b;
  if (q == g.nq) {
    g.bpart[q] = s;
    return;
  }
  const int kl = b.k + b.l, tj = (kl + 7) / 8;
  const int t = q >> 5, v = q & 31;
  const int i = 4 * (t / tj) + (v >> 3), j = 8 * (t % tj) + (v & 7);
  if (i < b.k && j < b.k) {
    b.gram[i * b.k + j] = s;
  } else if (i < b.k && j < kl) {
    b.cross[i * b.l + (j - b.k)] = s;
  }
}

// After a pass: the fit's sums of every block's partial set into b.gram
// (W^T W) and b.cross (W^T X), and the sum of the scalars returned, the
// same bits in every block: the block's set to the workspace at
// `parity`, the fit's barrier, then each entry's P values added in block
// order 0..P-1 (a lone block: its own set).  `syncs` counts the fit's
// barriers.
__device__ inline float nmf_grid_sum(const NmfGrid& g, int parity, unsigned& syncs) {
  __syncthreads();
  if (g.blocks > 1) {
    const float* sets = g.part + (size_t)parity * g.blocks * g.pstride;
    float* mine = g.part + ((size_t)parity * g.blocks + g.rank) * g.pstride;
    for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) __stcg(mine + q, g.bpart[q]);
    syncs += 1;
    nmf_grid_barrier(g.counter, syncs * g.blocks);
    for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) {
      nmf_grid_place(g, q, nmf_grid_ordered_sum(sets + q, g.blocks, g.pstride));
    }
  } else {
    for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) nmf_grid_place(g, q, g.bpart[q]);
  }
  __syncthreads();
  return g.bpart[g.nq];
}

// The fit's sum of every block's `mine` (one value, the same in every
// thread of the block), in block order: the stopping statistics.  One
// slot a block: a barrier of an iteration lies between two calls.
__device__ inline float nmf_grid_scalar_sum(const NmfGrid& g, float mine,
                                            unsigned& syncs) {
  if (g.blocks == 1) return mine;
  if (threadIdx.x == 0) __stcg(g.err + g.rank, mine);
  syncs += 1;
  nmf_grid_barrier(g.counter, syncs * g.blocks);
  if (threadIdx.x == 0) g.b.red[32] = nmf_grid_ordered_sum(g.err, g.blocks, 1);
  __syncthreads();
  const float total = g.b.red[32];
  __syncthreads();
  return total;
}

// The float64 form of nmf_grid_scalar_sum, for the stops of K4 and K5:
// the fit's sum of every block's `mine` in block order, the same bits in
// every thread of every block.  `slots` holds one double a block (a
// barrier of an iteration lies between two calls), `red` is the block's
// float64 scratch.  K1 and K2 keep their own inline code.
__device__ __forceinline__ double nmf_grid_total_d(unsigned* counter, double* slots, int rank,
                                                   int blocks, unsigned& syncs, double* red,
                                                   double mine) {
  if (blocks == 1) return mine;
  if (threadIdx.x == 0) __stcg(slots + rank, mine);
  syncs += 1;
  nmf_grid_barrier(counter, syncs * blocks);
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int r = 0; r < blocks; ++r) s += __ldcg(slots + r);
    red[32] = s;
  }
  __syncthreads();
  const double total = red[32];
  __syncthreads();
  return total;
}

// Load one fit: H into every block; resident, the block's rows of X and
// W0 into its shared memory; streamed, its rows of W0 copied to W in
// device memory (W is then updated in place there).
__device__ inline void nmf_grid_load(const NmfGrid& g, const float* xf,
                                     const float* w0f, float* wf, const float* h0f) {
  const NmfBlock& b = g.b;
  for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) b.h[i] = h0f[i];
  if (g.resident) {
    nmf_grid_gather(g.y + (size_t)b.k * g.tile, g.tile, xf + g.r0 * b.l, g.rows, b.l);
    nmf_grid_gather(g.y, g.tile, w0f + g.r0 * b.k, g.rows, b.k);
  } else {
    const float* ws = w0f + g.r0 * b.k;
    float* wd = wf + g.r0 * b.k;
    for (size_t i = threadIdx.x; i < (size_t)g.rows * b.k; i += blockDim.x) wd[i] = ws[i];
  }
  __syncthreads();
}

// Store one fit: the block's rows of W (resident; streamed rows are
// already there) and, from rank 0, H.
__device__ inline void nmf_grid_store(const NmfGrid& g, float* wf, float* hf) {
  const NmfBlock& b = g.b;
  if (g.resident) nmf_grid_scatter(wf + g.r0 * b.k, g.y, g.tile, g.rows, b.k);
  if (g.rank == 0) {
    for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) hf[i] = b.h[i];
  }
}

// The current device's SM count.
inline int nmf_grid_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// Settle a plan from a rule for `kernel` on a card of `sms` SMs: raise
// the kernel's shared memory limit to the plan's, write the plan to `out`
// (host ints, when given: blocks a fit, rows a block, resident, tile,
// shared memory a block, SMs, blocks a SM can hold) and refuse a plan
// whose blocks could not all be resident at once.
template <typename Kernel>
inline int nmf_grid_settle(Kernel kernel, int batch, int sms, const NmfGridPlan& plan,
                           int* out) {
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)plan.smem);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NMF_GRID_THREADS,
                                                      plan.smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (out != nullptr) {
    const int vals[NMF_GRID_PLAN_INTS] = {plan.blocks, plan.rows, plan.resident,
                                          plan.tile, (int)plan.smem, sms, per_sm};
    for (int i = 0; i < NMF_GRID_PLAN_INTS; ++i) out[i] = vals[i];
  }
  if (plan.blocks > 1 && (long long)batch * plan.blocks > (long long)per_sm * sms) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  return 0;
}

// Launch `kernel` on batch * P blocks as `plan` says, cooperatively when P
// > 1, the plan its first argument; `ws_floats` (the workspace's size)
// must be at least `need`.  Returns cudaGetLastError().
template <typename... Params, typename... Args>
inline int nmf_grid_launch(void (*kernel)(NmfGridPlan, Params...), int batch,
                           const NmfGridPlan& plan, size_t need, long long ws_floats,
                           cudaStream_t stream, Args... args) {
  if ((long long)need > ws_floats) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * plan.blocks, 1, 1);
  cfg.blockDim = dim3(NMF_GRID_THREADS, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = plan.blocks > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, plan, args...);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// Plan (nmf_grid_rule) and launch K1's or K2's `kernel` on batch * P
// blocks; `ws` must hold nmf_grid_workspace_floats, zeroed.  Returns
// cudaGetLastError(), or the error that refused the plan.
template <typename... Params, typename... Args>
inline int nmf_grid_run(void (*kernel)(NmfGridPlan, Params...), int batch, int n,
                        int l, int k, long long ws_floats, int* plan_out,
                        cudaStream_t stream, Args... args) {
  int sms = 0;
  int e = nmf_grid_sms(&sms);
  if (e != 0) return e;
  NmfGridPlan plan;
  e = nmf_grid_rule(batch, n, l, k, sms, &plan);
  if (e == 0) e = nmf_grid_settle(kernel, batch, sms, plan, plan_out);
  if (e != 0) return e;
  return nmf_grid_launch(kernel, batch, plan, nmf_grid_workspace_floats(plan, batch),
                         ws_floats, stream, args...);
}
