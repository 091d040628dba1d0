// Batched HALS / coordinate-descent NMF: a warp-per-fit entry for the
// time-normalised frames of the main paths, the cluster (grid) entry, one
// fit spread over many blocks of the card (at the end of this file), for
// every larger frame, and a block-per-fit entry for batches of frames
// within one block's shared memory at rank 9-10 that fill the card with
// waves of fits (models/kernels/cd_cuda.py: route).
//
// Replaces the TPU kernels `cd_iterations_pallas` and `fit_cd_pallas`
// (muscle_synergies_tpu/models/kernels/cd_pallas.py: _cd_kernel,
// _fit_cd_kernel, _cd_iteration).  Both entries compute the same
// iteration:
//   - W pass: H H^T first; then the cyclic component loop on each row of
//     W in registers (the rows are independent given H H^T and X H^T);
//   - H pass: W^T W and W^T X, then the cyclic component loop on each
//     column of H;
//   - the stopping rule inside the fit (WITH_STOP): a fit ends when it
//     converges, the frozen-trial semantics of the batched reference.
// Numerics follow models/hals.py (sklearn's _update_cdnmf_fast with
// shuffle=False): gradient W H H^T - X H^T per component, the projected
// gradient taken from the column *before* its update, the L2 penalty on
// the Gram diagonal and the L1 penalty subtracted from X H^T (or W^T X),
// a Newton step grad / hess clipped at 0, the column left unchanged when
// hess == 0 (which keeps zero-padded rank components exactly 0), and
// sklearn's stop: the summed |projected gradient| of iteration 1 is the
// reference, and a fit stops once violation / violation_init <= tol (or
// the reference is 0).  The two entries sum in different orders, so
// their float32 results differ by rounding.
//
// Block entry (cd_nmf_f32, any frame whose X, W and H fit one block's
// shared memory; the route gives it only batches at rank 9-10 that would
// take the grid entry 4 or more waves of one block a SM): one block of
// 128 threads per fit, everything in shared memory.  Against the grid
// entry (H100 80GB HBM3, 700 W, us an iteration,
// scripts/torch_cluster_timing.py): one fit of 2,400 x 8 at rank 4 23.7
// against 5.8 on 10 blocks, 1,024 fits 179.9 against 88.2 on one block
// each (two a SM); at rank 9-16, whose grid kernel holds one block a SM,
// 1,024 x 200 x 16 at rank 9 100.4 against 108.6, at rank 12 131.9
// against 115.8.  What bounds it: a fit is ~36 KFLOP an iteration at
// 200 x 8, rank 4, and the block spends its iteration on a chain of
// seven __syncthreads (H H^T, the W pass, W^T W and W^T X as 48 warp
// reductions over 4 warps, the H pass on 8 of 128 threads, a 3-barrier
// block sum for the violation), so the CD path's rank-1 fits, which run
// all 100,000 iterations, ran at 7.6 us an iteration alone on an H100
// (scripts/torch_ab_parent_kernels.py).
//
// Warp entry (cd_nmf_warp_f32, N <= NMF_WARP_NMAX, L <= NMF_WARP_LMAX,
// k <= NMF_WARP_KMAX): one warp per fit, NMF_WARP_FITS fits per block, no
// __syncthreads on the iteration path.  Lane i owns rows i, i + 32, ...
// (7 a lane at N = 200, the last partly masked) with their X and W in
// registers; H, H H^T, W^T W and W^T X sit in a per-warp shared slab
// read as broadcasts, and three __syncwarp order the passes.  Inside an
// iteration nothing branches on the fit's N, L or k: every loop runs
// over the padded extents, whose exact zeros change no sum.  W^T W and
// W^T X are each lane's partial sums over its rows, combined by a
// reduce-scatter by recursive halving (31 shuffles for 32 values, one
// value per lane at the end), and the violation is a warp sum.  What
// bounds it: the dependent chain of one iteration (the cyclic loops,
// five shuffle rounds per group of 32 values) and, across the ~1,000
// fits of a main path, the SM's issue rate; device memory is touched
// only at the start and the end of the solve.

#include "nmf_common.cuh"

// ---------------------------- block entry ----------------------------

// One outer iteration, W pass then H pass.  Returns the summed
// |projected gradient| of both passes to every thread when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
__device__ float cd_iteration(const NmfBlock& b, const NmfPenalty& pen) {
  float part = 0.0f;

  // ---- W pass, H fixed ----
  nmf_hht(b);
  for (int n = threadIdx.x; n < b.n; n += blockDim.x) {
    float xr[KMAX], wr[KMAX];
    nmf_xht_row<KMAX>(b, n, xr);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) wr[i] = i < b.k ? b.w[n * b.ldw + i] : 0.0f;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < b.k) {
        float grad = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < b.k) {
            grad += (b.gram[j * b.k + s] + (j == s ? pen.l2_w : 0.0f)) * wr[j];
          }
        }
        grad -= xr[s] - pen.l1_w;
        if (WITH_VIOL) part += fabsf(wr[s] == 0.0f ? fminf(grad, 0.0f) : grad);
        const float hess = b.gram[s * b.k + s] + pen.l2_w;
        if (hess != 0.0f) wr[s] = fmaxf(wr[s] - grad / hess, 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) b.w[n * b.ldw + i] = wr[i];
    }
  }
  __syncthreads();

  // ---- H pass, W fixed ----
  nmf_wtw_wtx(b);
  for (int m = threadIdx.x; m < b.l; m += blockDim.x) {
    float hr[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) hr[i] = i < b.k ? b.h[i * b.l + m] : 0.0f;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < b.k) {
        float grad = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < b.k) {
            grad += (b.gram[j * b.k + s] + (j == s ? pen.l2_h : 0.0f)) * hr[j];
          }
        }
        grad -= b.cross[s * b.l + m] - pen.l1_h;
        if (WITH_VIOL) part += fabsf(hr[s] == 0.0f ? fminf(grad, 0.0f) : grad);
        const float hess = b.gram[s * b.k + s] + pen.l2_h;
        if (hess != 0.0f) hr[s] = fmaxf(hr[s] - grad / hess, 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) b.h[i * b.l + m] = hr[i];
    }
  }
  __syncthreads();
  return WITH_VIOL ? nmf_block_sum(b, part) : 0.0f;
}

template <int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_THREADS) cd_nmf_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ viol_init_out, int* __restrict__ converged_out,
    int n, int l, int k, int iters, float tol, NmfPenalty pen) {
  extern __shared__ float smem[];
  const NmfBlock b = nmf_block(smem, n, l, k);
  const size_t fit = blockIdx.x;
  nmf_load(b, x + fit * n * l, w0 + fit * n * k, h0 + fit * k * l);
  if (WITH_STOP) {
    int n_iter = 0;
    float viol_init = 0.0f;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const float viol = cd_iteration<KMAX, true>(b, pen);
      n_iter += 1;
      if (n_iter == 1) viol_init = viol;
      converged = viol_init == 0.0f || viol / viol_init <= tol;
    }
    if (threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      viol_init_out[fit] = viol_init;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) cd_iteration<KMAX, false>(b, pen);
  }
  nmf_store(b, w + fit * n * k, h + fit * k * l);
}

template <int KMAX>
static int cd_dispatch(bool with_stop, const float* x, const float* w0,
                       const float* h0, float* w, float* h, int* n_iter,
                       float* viol_init, int* converged, int batch, int n,
                       int l, int k, int iters, float tol, NmfPenalty pen,
                       cudaStream_t stream) {
  const size_t smem = nmf_smem_floats(n, l, k) * sizeof(float);
  if (with_stop) {
    return nmf_launch(cd_nmf_kernel<KMAX, true>, batch, smem, stream, x, w0,
                      h0, w, h, n_iter, viol_init, converged, n, l, k, iters,
                      tol, pen);
  }
  return nmf_launch(cd_nmf_kernel<KMAX, false>, batch, smem, stream, x, w0,
                    h0, w, h, n_iter, viol_init, converged, n, l, k, iters,
                    tol, pen);
}

// x (B, N, L), w0/w (B, N, K), h0/h (B, K, L) float32; n_iter,
// viol_init, converged (B,) written only when with_stop.  `iters` is
// max_iter with the stop and the fixed iteration count without it;
// l1_w .. l2_h are the penalties (0 for none).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int cd_nmf_f32(const float* x, const float* w0, const float* h0,
                          float* w, float* h, int* n_iter, float* viol_init,
                          int* converged, int batch, int n, int l, int k,
                          int iters, float tol, float l1_w, float l2_w,
                          float l1_h, float l2_h, int with_stop,
                          void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  if (k <= 4) {
    return cd_dispatch<4>(with_stop, x, w0, h0, w, h, n_iter, viol_init,
                          converged, batch, n, l, k, iters, tol, pen, s);
  }
  if (k <= 8) {
    return cd_dispatch<8>(with_stop, x, w0, h0, w, h, n_iter, viol_init,
                          converged, batch, n, l, k, iters, tol, pen, s);
  }
  return cd_dispatch<16>(with_stop, x, w0, h0, w, h, n_iter, viol_init,
                         converged, batch, n, l, k, iters, tol, pen, s);
}

// ---------------------------- warp entry -----------------------------

// sklearn's cyclic component loop on one row of W (or column of H):
// for each component s in order, the gradient sum_j G[j, s] v[j] - c[s]
// with the penalties, its projected value added to `part`, and the
// Newton step clipped at 0 unless the Hessian G[s, s] + l2 is 0.  G is
// in shared memory (KMAX x KMAX), v and c in registers.
template <int KMAX, bool WITH_VIOL>
__device__ __forceinline__ void cd_warp_cyclic(float (&v)[KMAX], const float* g,
                                               const float (&c)[KMAX], float l1,
                                               float l2, float& part) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    float grad = 0.0f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      grad += (g[j * KMAX + s] + (j == s ? l2 : 0.0f)) * v[j];
    }
    grad -= c[s] - l1;
    if (WITH_VIOL) part += fabsf(v[s] == 0.0f ? fminf(grad, 0.0f) : grad);
    const float hess = g[s * KMAX + s] + l2;
    const float step = fmaxf(v[s] - grad / hess, 0.0f);
    v[s] = hess != 0.0f ? step : v[s];
  }
}

// One outer iteration of one fit on one warp, W pass then H pass.
// Returns the summed |projected gradient| to every lane when WITH_VIOL.
//
// Every loop runs over KMAX components, LMAX columns and all the lane's
// rows, with no branch on the fit's own k, L or N: the padding (masked
// rows, columns past L, components past k) holds exact zeros in X, W
// and H, so it adds exact zeros to every sum, its gradient is the L1
// penalty (>= 0) on a zero entry, and so it stays 0 and adds 0 to the
// violation.  The real components sum in the block entry's order, and
// the compiler schedules the rows' loops together.
template <int KMAX, int LMAX, bool WITH_VIOL>
__device__ __forceinline__ float cd_warp_iteration(
    NmfWarpSlab<KMAX, LMAX>& sl, float (&xr)[NMF_WARP_ROWS][LMAX],
    float (&wr)[NMF_WARP_ROWS][KMAX], int lane, const NmfPenalty& pen) {
  float part = 0.0f;

  // ---- H H^T, K*K sums over L ----
  nmf_warp_hht(sl, lane);
  __syncwarp();

  // ---- W pass on the lane's rows, H fixed ----
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    float xh[KMAX];
    nmf_warp_xht_row(sl, xr[r], xh);
    cd_warp_cyclic<KMAX, WITH_VIOL>(wr[r], sl.hht, xh, pen.l1_w, pen.l2_w, part);
  }

  // ---- W^T W and W^T X: partial sums over the lane's rows, then a
  // reduce-scatter per group of 32 entries ----
  nmf_warp_wtw_wtx(sl, xr, wr, lane);
  __syncwarp();

  // ---- H pass on the LMAX columns, W fixed ----
  if (lane < LMAX) {
    float hc[KMAX], cc[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      hc[i] = sl.h[i * LMAX + lane];
      cc[i] = sl.wtx[i * LMAX + lane];
    }
    cd_warp_cyclic<KMAX, WITH_VIOL>(hc, sl.wtw, cc, pen.l1_h, pen.l2_h, part);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) sl.h[i * LMAX + lane] = hc[i];
  }
  __syncwarp();
  return WITH_VIOL ? nmf_warp_sum(part) : 0.0f;
}

template <int KMAX, int LMAX, bool WITH_STOP>
__global__ void __launch_bounds__(32 * NMF_WARP_FITS) cd_warp_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ viol_init_out, int* __restrict__ converged_out,
    int batch, int n, int l, int k, int iters, float tol, NmfPenalty pen) {
  __shared__ NmfWarpSlab<KMAX, LMAX> slabs[NMF_WARP_FITS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t fit = (size_t)blockIdx.x * NMF_WARP_FITS + warp;
  if (fit >= (size_t)batch) return;  // whole warps only: no block barrier
  NmfWarpSlab<KMAX, LMAX>& sl = slabs[warp];
  float xr[NMF_WARP_ROWS][LMAX], wr[NMF_WARP_ROWS][KMAX];
  nmf_warp_load<KMAX, LMAX>(x + fit * n * l, w0 + fit * n * k,
                            h0 + fit * k * l, n, l, k, lane, xr, wr, sl.h);

  if (WITH_STOP) {
    int n_iter = 0;
    float viol_init = 0.0f;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const float viol =
          cd_warp_iteration<KMAX, LMAX, true>(sl, xr, wr, lane, pen);
      n_iter += 1;
      if (n_iter == 1) viol_init = viol;
      converged = viol_init == 0.0f || viol / viol_init <= tol;
    }
    if (lane == 0) {
      n_iter_out[fit] = n_iter;
      viol_init_out[fit] = viol_init;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) {
      cd_warp_iteration<KMAX, LMAX, false>(sl, xr, wr, lane, pen);
    }
  }

  nmf_warp_store<KMAX, LMAX>(w + fit * n * k, h + fit * k * l, n, l, k, lane,
                             wr, sl.h);
}

template <int KMAX, int LMAX>
static int cd_warp_dispatch(bool with_stop, const float* x, const float* w0,
                            const float* h0, float* w, float* h, int* n_iter,
                            float* viol_init, int* converged, int batch, int n,
                            int l, int k, int iters, float tol, NmfPenalty pen,
                            cudaStream_t stream) {
  const int blocks = (batch + NMF_WARP_FITS - 1) / NMF_WARP_FITS;
  if (with_stop) {
    cd_warp_kernel<KMAX, LMAX, true><<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
        x, w0, h0, w, h, n_iter, viol_init, converged, batch, n, l, k, iters,
        tol, pen);
  } else {
    cd_warp_kernel<KMAX, LMAX, false><<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
        x, w0, h0, w, h, n_iter, viol_init, converged, batch, n, l, k, iters,
        tol, pen);
  }
  return (int)cudaGetLastError();
}

// The warp entry: cd_nmf_f32's arguments and results, for frames with
// n <= NMF_WARP_NMAX, l <= NMF_WARP_LMAX and k <= NMF_WARP_KMAX
// (models/kernels/cd_cuda.py: route); anything else is refused.
extern "C" int cd_nmf_warp_f32(const float* x, const float* w0,
                               const float* h0, float* w, float* h,
                               int* n_iter, float* viol_init, int* converged,
                               int batch, int n, int l, int k, int iters,
                               float tol, float l1_w, float l2_w, float l1_h,
                               float l2_h, int with_stop, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || n > NMF_WARP_NMAX ||
      l > NMF_WARP_LMAX || k > NMF_WARP_KMAX || iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const bool st = with_stop != 0;
  if (k <= 4) {
    return l <= 8 ? cd_warp_dispatch<4, 8>(st, x, w0, h0, w, h, n_iter,
                                           viol_init, converged, batch, n, l,
                                           k, iters, tol, pen, s)
                  : cd_warp_dispatch<4, 16>(st, x, w0, h0, w, h, n_iter,
                                            viol_init, converged, batch, n, l,
                                            k, iters, tol, pen, s);
  }
  return l <= 8 ? cd_warp_dispatch<8, 8>(st, x, w0, h0, w, h, n_iter,
                                         viol_init, converged, batch, n, l, k,
                                         iters, tol, pen, s)
                : cd_warp_dispatch<8, 16>(st, x, w0, h0, w, h, n_iter,
                                          viol_init, converged, batch, n, l, k,
                                          iters, tol, pen, s);
}

// --------------------------- cluster entry ---------------------------
//
// cd_nmf_cluster_f32: the entry for frames past the warp entry, from 225
// rows (a subject's concatenated cycles, a trial resampled longer) to a
// whole capture's envelope for find_synergies or `analyze --reduce-to
// 0`, replacing `fit_cd_pallas` / `cd_iterations_pallas` there; above one
// block's shared memory at any batch, within it at every batch but the
// block entry's.  One fit is spread over P blocks of the whole card
// (nmf_common.cuh: the grid entries), at most SMs / batch, as K1's
// cluster entry (mu_nmf.cu).  An iteration follows the block entry's
// order: H H^T in every block; sklearn's cyclic component loop on the
// block's rows of W (row-local given H H^T and the row's X H^T), each
// row's |projected gradient| added to the block's violation; the block's
// share of W^T W and W^T X summed in registers; the fit's one barrier in
// device memory; the P partial sets (and W-pass violations) added in
// block order; the H pass on the same numbers in every block, so H and
// its violation are the same bits everywhere.  The stopping ratio
// violation / violation_init is thus the same value in every block of a
// fit and every block takes the same branch.  What bounds it: as K1's,
// the latency of an iteration's chain (the barrier's round trip through
// L2, the P sets read back, the block's barriers around the H pass), not
// its bytes or operations; the rank-1 fits of a capture sweep, which run
// all 100,000 iterations, pay it each time.

// sklearn's cyclic component loop on one row of W against its row of
// X H^T and t.gram = H H^T; returns the row's summed |projected
// gradient| when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
struct CdClusterRows {
  NmfPenalty pen;
  __device__ float operator()(float (&wr)[KMAX], const float (&xh)[KMAX],
                              const NmfBlock& t) const {
    float part = 0.0f;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < t.k) {
        float grad = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < t.k) {
            grad += (t.gram[j * t.k + s] + (j == s ? pen.l2_w : 0.0f)) * wr[j];
          }
        }
        grad -= xh[s] - pen.l1_w;
        if (WITH_VIOL) part += fabsf(wr[s] == 0.0f ? fminf(grad, 0.0f) : grad);
        const float hess = t.gram[s * t.k + s] + pen.l2_w;
        if (hess != 0.0f) wr[s] = fmaxf(wr[s] - grad / hess, 0.0f);
      }
    }
    return part;
  }
};

// sklearn's cyclic loop on each column of H, one thread a column (b.gram
// holds W^T W and b.cross W^T X, the fit's sums); returns the
// block's summed |projected gradient| when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
__device__ float cd_cluster_cols(const NmfBlock& b, const NmfPenalty& pen) {
  float part = 0.0f;
  for (int m = threadIdx.x; m < b.l; m += blockDim.x) {
    float hr[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) hr[i] = i < b.k ? b.h[i * b.l + m] : 0.0f;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < b.k) {
        float grad = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < b.k) {
            grad += (b.gram[j * b.k + s] + (j == s ? pen.l2_h : 0.0f)) * hr[j];
          }
        }
        grad -= b.cross[s * b.l + m] - pen.l1_h;
        if (WITH_VIOL) part += fabsf(hr[s] == 0.0f ? fminf(grad, 0.0f) : grad);
        const float hess = b.gram[s * b.k + s] + pen.l2_h;
        if (hess != 0.0f) hr[s] = fmaxf(hr[s] - grad / hess, 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) b.h[i * b.l + m] = hr[i];
    }
  }
  __syncthreads();
  return WITH_VIOL ? nmf_block_sum(b, part) : 0.0f;
}

// One outer CD iteration of the fit, W pass then H pass; `parity` picks
// the partial-set buffer.  Returns the fit's violation (every block's
// W-pass share in block order, then the H pass's) to every thread of
// every block when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
__device__ float cd_grid_iteration(const NmfGrid& g, const float* xf, float* wf,
                                   int parity, unsigned& syncs, const NmfPenalty& pen) {
  const NmfBlock& b = g.b;
  for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) g.bpart[q] = 0.0f;
  nmf_hht(b);  // its closing barrier also orders the zeroing
  float viol = 0.0f;
  nmf_grid_chunks<true>(g, xf, wf, [&](const NmfGridRows& c) {
    viol += nmf_grid_w_pass<KMAX>(b, c, CdClusterRows<KMAX, WITH_VIOL>{pen});
    nmf_grid_gram_pass(g, c);
  });
  if (WITH_VIOL) {
    const float mine = nmf_block_sum(b, viol);
    if (threadIdx.x == 0) g.bpart[g.nq] = mine;
  }
  const float viol_w = nmf_grid_sum(g, parity, syncs);
  const float viol_h = cd_cluster_cols<KMAX, WITH_VIOL>(b, pen);
  return viol_w + viol_h;
}

template <int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_GRID_THREADS) cd_cluster_kernel(
    NmfGridPlan p, const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w, float* __restrict__ h,
    int* __restrict__ n_iter_out, float* __restrict__ viol_init_out,
    int* __restrict__ converged_out, float* __restrict__ ws, int batch, int iters,
    float tol, NmfPenalty pen) {
  extern __shared__ float smem[];
  const size_t fit = blockIdx.x / p.blocks;
  const NmfGrid g = nmf_grid(smem, p, ws, batch, fit, (int)(blockIdx.x % p.blocks));
  const float* xf = x + fit * p.n * p.l;
  float* wf = w + fit * p.n * p.k;
  nmf_grid_load(g, xf, w0 + fit * p.n * p.k, wf, h0 + fit * p.k * p.l);
  unsigned syncs = 0;
  int parity = 0;
  if (WITH_STOP) {
    int n_iter = 0;
    float viol_init = 0.0f;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const float viol = cd_grid_iteration<KMAX, true>(g, xf, wf, parity, syncs, pen);
      parity ^= 1;
      n_iter += 1;
      if (n_iter == 1) viol_init = viol;
      converged = viol_init == 0.0f || viol / viol_init <= tol;
    }
    if (g.rank == 0 && threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      viol_init_out[fit] = viol_init;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) {
      cd_grid_iteration<KMAX, false>(g, xf, wf, parity, syncs, pen);
      parity ^= 1;
    }
  }
  nmf_grid_store(g, wf, h + fit * p.k * p.l);
}

// The cluster entry: cd_nmf_f32's arguments and results, for frames over
// one block's shared memory and for small batches of smaller frames
// (models/kernels/cd_cuda.py: route), and
// `ws`, a zeroed workspace of `ws_floats` floats (at least
// nmf_grid_workspace_floats).  Writes the plan it took to `plan_out`
// (NMF_GRID_PLAN_INTS host ints), launches once on `stream` and returns
// cudaGetLastError(), or the error that refused the plan.
extern "C" int cd_nmf_cluster_f32(const float* x, const float* w0,
                                  const float* h0, float* w, float* h,
                                  int* n_iter, float* viol_init,
                                  int* converged, int batch, int n, int l,
                                  int k, int iters, float tol, float l1_w,
                                  float l2_w, float l1_h, float l2_h,
                                  int with_stop, float* ws, long long ws_floats,
                                  int* plan_out, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const cudaStream_t s = (cudaStream_t)stream;
#define CD_CLUSTER_RUN(KM, ST)                                                   \
  nmf_grid_run(cd_cluster_kernel<KM, ST>, batch, n, l, k, ws_floats, plan_out, s, \
               x, w0, h0, w, h, n_iter, viol_init, converged, ws, batch, iters,  \
               tol, pen)
#define CD_CLUSTER_CALL(KM) \
  (with_stop ? CD_CLUSTER_RUN(KM, true) : CD_CLUSTER_RUN(KM, false))
  return NMF_CLUSTER_DISPATCH(k, CD_CLUSTER_CALL);
#undef CD_CLUSTER_CALL
#undef CD_CLUSTER_RUN
}
