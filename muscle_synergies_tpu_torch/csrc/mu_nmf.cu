// Batched Frobenius multiplicative-update NMF: a warp-per-fit entry for
// the time-normalised frames of the main paths, the cluster (grid)
// entry, one fit spread over many blocks of the card (at the end of this
// file), for every larger frame, and a block-per-fit entry for batches
// of frames within one block's shared memory at rank 9-16 that fill the
// card with waves of fits (models/kernels/mu_cuda.py: route).
//
// Replaces the TPU kernels `mu_iterations_pallas` and `fit_mu_pallas`
// (muscle_synergies_tpu/models/kernels/mu_pallas.py: _mu_kernel,
// _fit_mu_kernel, _mu_step, _lane_error).  The Pallas kernels laid 128
// trials across the vector lanes and unrolled the tiny per-trial
// products as lane-parallel FMAs.  Both entries here compute the same
// iteration:
//   - W half-step: H H^T (K*K) first, then each row of W computes its
//     row of X H^T in registers and updates the row;
//   - H half-step: W^T W and W^T X, then each column of H is updated;
//   - the stopping rule runs inside the fit (WITH_STOP), so a fit simply
//     ends when it converges: that is exactly the frozen-trial semantics
//     of the batched reference.
// Numerics follow models/mu.py: sklearn's update order, the L1/L2
// penalties added to the denominators (l1 + l2 * factor), the float32-eps
// denominator guard (den == 0 -> EPSILON), `inner_iter` repetitions
// reusing X H^T / H H^T and W^T X / W^T W, and sklearn's stopping test
// every `check_every` iterations on ||X - WH||_F in float32,
// (prev_err - err) / err0 < tol, with tol <= 0 disabling it.  Zero-padded
// rank components stay exactly 0: their numerator is 0 and their
// denominator becomes EPSILON.
//
// Block entry (mu_nmf_f32, any frame whose X, W and H fit one block's
// shared memory; the route gives it only batches at rank 9-16 that would
// take the grid entry 4 or more waves of one block a SM): one block of
// 128 threads per fit with X, W and H in shared memory (about 13 KB at
// N=200, L=8, K=4).  Against the grid entry (H100 80GB HBM3, 700 W, us an
// iteration, scripts/torch_cluster_timing.py): one fit of 2,400 x 8 at
// rank 4 23.1 against 5.7 on 10 blocks, 51 fits 22.2 against 8.6 on 2
// blocks each, 1,024 fits 178.5 against 85.8 on one block each (two a
// SM), 1,024 x 225 x 8 16.3 against 15.9; at rank 9, whose grid kernel
// holds one block a SM, 1,024 x 200 x 8 63.1 against 85.8.  What bounds it: about
// 38 KFLOP per fit and iteration on CUDA cores, spent on a chain of four
// __syncthreads (H H^T, the W half-step, W^T W and W^T X as 48 warp
// reductions over 4 warps, the H half-step on 8 of 128 threads) and,
// every 10 iterations, a rebuild of WH from shared memory with a
// 3-barrier block sum; device memory is touched only at the start and
// the end of the solve.
//
// Warp entry (mu_nmf_warp_f32, N <= NMF_WARP_NMAX, L <= NMF_WARP_LMAX,
// k <= NMF_WARP_KMAX): K2's warp layout (nmf_common.cuh).  One warp per
// fit with no __syncthreads; lane i owns rows i, i + 32, ... with their
// X and W in registers, forms X H^T for them and updates them against
// H H^T from the slab; lanes 0..LMAX-1 update H's columns.  W^T W, W^T X
// and the Frobenius error are the lanes' partial sums over their rows,
// combined by butterflies that add them in the block entry's order, so
// the warp entry computes the block entry's iterates and stopping
// statistic bit for bit, and a fit stops at the same iteration on
// either entry.  Every loop runs over the padded extents, whose exact
// zeros stay zero under MU (numerator 0, guarded denominator nonzero)
// and change no sum.  What bounds it: the dependent chain of one
// iteration (the divides, five shuffle rounds per group of 32 sums), so
// a lone fit's latency, which sets a main path's tail; across the
// ~1,000 fits of a path, the SMs' issue rate.

#include "nmf_common.cuh"

#define EPSILON 1.1920929e-07f

// ---------------------------- block entry ----------------------------

template <int KMAX>
__device__ void mu_step(const NmfBlock& b, int inner_iter,
                        const NmfPenalty& pen) {
  // ---- W: X H^T and H H^T are fixed while H is ----
  nmf_hht(b);
  for (int n = threadIdx.x; n < b.n; n += blockDim.x) {
    float xr[KMAX], wr[KMAX], wn[KMAX];
    nmf_xht_row<KMAX>(b, n, xr);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) wr[i] = i < b.k ? b.w[n * b.ldw + i] : 0.0f;
    for (int it = 0; it < inner_iter; ++it) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) {
          float den = 0.0f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < b.k) den += wr[j] * b.gram[j * b.k + i];
          }
          den = (den + pen.l1_w) + pen.l2_w * wr[i];
          den = den == 0.0f ? EPSILON : den;
          wn[i] = wr[i] * (xr[i] / den);
        }
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) wr[i] = wn[i];
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) b.w[n * b.ldw + i] = wr[i];
    }
  }
  __syncthreads();

  // ---- H: W^T X and W^T W are fixed while W is ----
  nmf_wtw_wtx(b);
  for (int m = threadIdx.x; m < b.l; m += blockDim.x) {
    float hr[KMAX], hn[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) hr[i] = i < b.k ? b.h[i * b.l + m] : 0.0f;
    for (int it = 0; it < inner_iter; ++it) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) {
          float den = 0.0f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < b.k) den += b.gram[i * b.k + j] * hr[j];
          }
          den = (den + pen.l1_h) + pen.l2_h * hr[i];
          den = den == 0.0f ? EPSILON : den;
          hn[i] = hr[i] * (b.cross[i * b.l + m] / den);
        }
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) hr[i] = hn[i];
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) b.h[i * b.l + m] = hr[i];
    }
  }
  __syncthreads();
}

// ||X - W H||_F of the block's fit, returned to every thread.
__device__ float mu_error(const NmfBlock& b) {
  float part = 0.0f;
  for (int n = threadIdx.x; n < b.n; n += blockDim.x) {
    for (int m = 0; m < b.l; ++m) {
      float rec = 0.0f;
      for (int j = 0; j < b.k; ++j) rec += b.w[n * b.ldw + j] * b.h[j * b.l + m];
      const float d = b.x[n * b.ldx + m] - rec;
      part += d * d;
    }
  }
  return sqrtf(nmf_block_sum(b, part));
}

template <int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_THREADS) mu_nmf_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int n, int l, int k, int iters, float tol, int check_every,
    int inner_iter, NmfPenalty pen) {
  extern __shared__ float smem[];
  const NmfBlock b = nmf_block(smem, n, l, k);
  const size_t fit = blockIdx.x;
  nmf_load(b, x + fit * n * l, w0 + fit * n * k, h0 + fit * k * l);
  if (WITH_STOP) {
    // sklearn's loop: chunks of check_every updates, the counter
    // stopping at max_iter (= iters), a test only at exact multiples
    const float err0 = mu_error(b);
    float prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const int steps = min(check_every, iters - n_iter);
      for (int t = 0; t < steps; ++t) mu_step<KMAX>(b, inner_iter, pen);
      n_iter += steps;
      if (tol > 0.0f) {
        const float err = mu_error(b);
        converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
        prev_err = err;
      }
    }
    if (threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) mu_step<KMAX>(b, inner_iter, pen);
  }
  nmf_store(b, w + fit * n * k, h + fit * k * l);
}

template <int KMAX>
static int mu_dispatch(bool with_stop, const float* x, const float* w0,
                       const float* h0, float* w, float* h, int* n_iter,
                       float* prev_err, int* converged, int batch, int n,
                       int l, int k, int iters, float tol, int check_every,
                       int inner_iter, NmfPenalty pen, cudaStream_t stream) {
  const size_t smem = nmf_smem_floats(n, l, k) * sizeof(float);
  if (with_stop) {
    return nmf_launch(mu_nmf_kernel<KMAX, true>, batch, smem, stream, x, w0,
                      h0, w, h, n_iter, prev_err, converged, n, l, k, iters,
                      tol, check_every, inner_iter, pen);
  }
  return nmf_launch(mu_nmf_kernel<KMAX, false>, batch, smem, stream, x, w0,
                    h0, w, h, n_iter, prev_err, converged, n, l, k, iters,
                    tol, check_every, inner_iter, pen);
}

// x (B, N, L), w0/w (B, N, K), h0/h (B, K, L) float32; n_iter,
// prev_err, converged (B,) written only when with_stop.  `iters` is
// max_iter with the stop and the fixed iteration count without it;
// l1_w .. l2_h are the penalties (0 for none).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int mu_nmf_f32(const float* x, const float* w0, const float* h0,
                          float* w, float* h, int* n_iter, float* prev_err,
                          int* converged, int batch, int n, int l, int k,
                          int iters, float tol, int check_every,
                          int inner_iter, float l1_w, float l2_w, float l1_h,
                          float l2_h, int with_stop, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0 ||
      inner_iter < 1 || (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  if (k <= 4) {
    return mu_dispatch<4>(with_stop, x, w0, h0, w, h, n_iter, prev_err,
                          converged, batch, n, l, k, iters, tol, check_every,
                          inner_iter, pen, s);
  }
  if (k <= 8) {
    return mu_dispatch<8>(with_stop, x, w0, h0, w, h, n_iter, prev_err,
                          converged, batch, n, l, k, iters, tol, check_every,
                          inner_iter, pen, s);
  }
  return mu_dispatch<16>(with_stop, x, w0, h0, w, h, n_iter, prev_err,
                         converged, batch, n, l, k, iters, tol, check_every,
                         inner_iter, pen, s);
}

// ---------------------------- warp entry -----------------------------

// sklearn's multiplicative update of one row of W (or column of H),
// `inner_iter` times against the same numerator c and Gram matrix G
// (KMAX x KMAX in the slab): den_i = sum_j v_j G[j, i] (W) or
// sum_j G[i, j] v_j (H), plus l1 + l2 v_i, guarded at 0.
template <int KMAX, bool ROWS_OF_W>
__device__ __forceinline__ void mu_warp_update(float (&v)[KMAX], const float* g,
                                               const float (&c)[KMAX], float l1,
                                               float l2, int inner_iter) {
  for (int it = 0; it < inner_iter; ++it) {
    float vn[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      float den = 0.0f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        den += v[j] * g[ROWS_OF_W ? j * KMAX + i : i * KMAX + j];
      }
      den = (den + l1) + l2 * v[i];
      den = den == 0.0f ? EPSILON : den;
      vn[i] = v[i] * (c[i] / den);
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) v[i] = vn[i];
  }
}

// One MU iteration of one fit on one warp, W half-step then H half-step;
// three __syncwarp order the passes through the slab.
template <int KMAX, int LMAX>
__device__ __forceinline__ void mu_warp_step(
    NmfWarpSlab<KMAX, LMAX>& sl, const float (&xr)[NMF_WARP_ROWS][LMAX],
    float (&wr)[NMF_WARP_ROWS][KMAX], int lane, int inner_iter,
    const NmfPenalty& pen) {
  // ---- W: X H^T and H H^T are fixed while H is ----
  nmf_warp_hht(sl, lane);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    float xh[KMAX];
    nmf_warp_xht_row(sl, xr[r], xh);
    mu_warp_update<KMAX, true>(wr[r], sl.hht, xh, pen.l1_w, pen.l2_w, inner_iter);
  }

  // ---- H: W^T X and W^T W are fixed while W is ----
  nmf_warp_wtw_wtx<KMAX, LMAX, true>(sl, xr, wr, lane);
  __syncwarp();
  if (lane < LMAX) {
    float hc[KMAX], cc[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      hc[i] = sl.h[i * LMAX + lane];
      cc[i] = sl.wtx[i * LMAX + lane];
    }
    mu_warp_update<KMAX, false>(hc, sl.wtw, cc, pen.l1_h, pen.l2_h, inner_iter);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) sl.h[i * LMAX + lane] = hc[i];
  }
  __syncwarp();
}

// ||X - W H||_F of the warp's fit, returned to every lane, summed in
// the block entry's order (mu_error over 128 threads): block thread
// 32 w + i walks rows 32 w + i, + 128, ..., which are this lane's rows
// r = w, w + 4 (padding adds exact zeros), then each of the 4 warps'
// sums is a butterfly and the block adds them as (T0 + T2) + (T1 + T3).
template <int KMAX, int LMAX>
__device__ __forceinline__ float mu_warp_error(
    const NmfWarpSlab<KMAX, LMAX>& sl, const float (&xr)[NMF_WARP_ROWS][LMAX],
    const float (&wr)[NMF_WARP_ROWS][KMAX]) {
  constexpr int WARPS = NMF_THREADS / 32;
  float part[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    part[w] = 0.0f;
#pragma unroll
    for (int r = w; r < NMF_WARP_ROWS; r += WARPS) {
#pragma unroll
      for (int m = 0; m < LMAX; ++m) {
        float rec = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) rec += wr[r][j] * sl.h[j * LMAX + m];
        const float d = xr[r][m] - rec;
        part[w] += d * d;
      }
    }
  }
  nmf_warp_allsum(part);
  static_assert(WARPS == 4, "the block entry's final sum is over 4 warps");
  return sqrtf((part[0] + part[2]) + (part[1] + part[3]));
}

template <int KMAX, int LMAX, bool WITH_STOP>
__global__ void __launch_bounds__(32 * NMF_WARP_FITS) mu_warp_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int batch, int n, int l, int k, int iters, float tol, int check_every,
    int inner_iter, NmfPenalty pen) {
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
    // sklearn's loop: chunks of check_every updates, the counter
    // stopping at max_iter (= iters), a test only at exact multiples
    const float err0 = mu_warp_error(sl, xr, wr);
    float prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const int steps = min(check_every, iters - n_iter);
      for (int t = 0; t < steps; ++t) mu_warp_step(sl, xr, wr, lane, inner_iter, pen);
      n_iter += steps;
      if (tol > 0.0f) {
        const float err = mu_warp_error(sl, xr, wr);
        converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
        prev_err = err;
      }
    }
    if (lane == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) mu_warp_step(sl, xr, wr, lane, inner_iter, pen);
  }
  nmf_warp_store<KMAX, LMAX>(w + fit * n * k, h + fit * k * l, n, l, k, lane,
                             wr, sl.h);
}

template <int KMAX, int LMAX>
static int mu_warp_dispatch(bool with_stop, const float* x, const float* w0,
                            const float* h0, float* w, float* h, int* n_iter,
                            float* prev_err, int* converged, int batch, int n,
                            int l, int k, int iters, float tol, int check_every,
                            int inner_iter, NmfPenalty pen, cudaStream_t stream) {
  const int blocks = (batch + NMF_WARP_FITS - 1) / NMF_WARP_FITS;
  if (with_stop) {
    mu_warp_kernel<KMAX, LMAX, true><<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
        x, w0, h0, w, h, n_iter, prev_err, converged, batch, n, l, k, iters,
        tol, check_every, inner_iter, pen);
  } else {
    mu_warp_kernel<KMAX, LMAX, false><<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
        x, w0, h0, w, h, n_iter, prev_err, converged, batch, n, l, k, iters,
        tol, check_every, inner_iter, pen);
  }
  return (int)cudaGetLastError();
}

// The warp entry: mu_nmf_f32's arguments and results, for frames with
// n <= NMF_WARP_NMAX, l <= NMF_WARP_LMAX and k <= NMF_WARP_KMAX
// (models/kernels/mu_cuda.py: route); anything else is refused.
extern "C" int mu_nmf_warp_f32(const float* x, const float* w0,
                               const float* h0, float* w, float* h,
                               int* n_iter, float* prev_err, int* converged,
                               int batch, int n, int l, int k, int iters,
                               float tol, int check_every, int inner_iter,
                               float l1_w, float l2_w, float l1_h, float l2_h,
                               int with_stop, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || n > NMF_WARP_NMAX ||
      l > NMF_WARP_LMAX || k > NMF_WARP_KMAX || iters < 0 || inner_iter < 1 ||
      (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const bool st = with_stop != 0;
  if (k <= 4) {
    return l <= 8 ? mu_warp_dispatch<4, 8>(st, x, w0, h0, w, h, n_iter,
                                           prev_err, converged, batch, n, l,
                                           k, iters, tol, check_every,
                                           inner_iter, pen, s)
                  : mu_warp_dispatch<4, 16>(st, x, w0, h0, w, h, n_iter,
                                            prev_err, converged, batch, n, l,
                                            k, iters, tol, check_every,
                                            inner_iter, pen, s);
  }
  return l <= 8 ? mu_warp_dispatch<8, 8>(st, x, w0, h0, w, h, n_iter,
                                         prev_err, converged, batch, n, l, k,
                                         iters, tol, check_every, inner_iter,
                                         pen, s)
                : mu_warp_dispatch<8, 16>(st, x, w0, h0, w, h, n_iter,
                                          prev_err, converged, batch, n, l, k,
                                          iters, tol, check_every, inner_iter,
                                          pen, s);
}

// --------------------------- cluster entry ---------------------------
//
// mu_nmf_cluster_f32: the entry for frames past the warp entry, from
// 225 rows (a time-normalised frame resampled longer, a subject's
// concatenated cycles) to a whole capture, replacing `fit_mu_pallas` /
// `mu_iterations_pallas` there; above one block's shared memory at any
// batch, within it at ranks 1-8 at any batch and at ranks 9-16 below the
// block entry's batches.  One fit is spread over P blocks of the whole
// card (nmf_common.cuh: the grid entries), at most SMs / batch: a lone
// 124,460 x 8 fit over all 132 SMs, 943 rows a block resident in shared
// memory; a bootstrap's 51 fits of 2,400 x 8 on 2 blocks each; more fits
// than SMs one block each, in waves, without the cooperative launch.  An iteration follows the block entry's
// order: H H^T in every block; the block's rows of W updated against it
// (row-local: the row's X H^T and W H H^T); the block's share of W^T W
// and W^T X summed in registers; the fit's one barrier in device memory;
// the P partial sets added in block order; H updated from them, the same
// bits in every block.  The stopping statistic is sum (X - WH)^2 over
// each block's own rows, summed in block order the same way (one more
// barrier every check_every iterations) and square-rooted, never formed
// from the Grams (in float32 ||X||^2 - 2 <W^T X, H> + <W^T W, H H^T>
// cancels to ~1e-5 of the error at a VAF of 0.99, and the 1e-6
// relative-improvement test would fire on noise).  What bounds it: not
// the bytes (X is read once from device memory) nor the operations
// (~6 k (l + k) flops a row an iteration, a few hundred a thread), but
// the latency of an iteration's chain: the barrier's round trip through
// L2 and the P sets read back from it, then the block's barriers around
// the H update.  The design answers with one device-memory barrier an
// iteration and every row's arithmetic on every SM, in registers.

// sklearn's multiplicative update of one row of W, `inner_iter` times
// against its row of X H^T and t.gram = H H^T.
template <int KMAX>
struct MuClusterRows {
  int inner_iter;
  NmfPenalty pen;
  __device__ float operator()(float (&wr)[KMAX], const float (&xh)[KMAX],
                              const NmfBlock& t) const {
    for (int it = 0; it < inner_iter; ++it) {
      float wn[KMAX];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < t.k) {
          float den = 0.0f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < t.k) den += wr[j] * t.gram[j * t.k + i];
          }
          den = (den + pen.l1_w) + pen.l2_w * wr[i];
          den = den == 0.0f ? EPSILON : den;
          wn[i] = wr[i] * (xh[i] / den);
        }
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < t.k) wr[i] = wn[i];
      }
    }
    return 0.0f;
  }
};

// H <- H * (W^T X) / (W^T W H), `inner_iter` times, one thread a column
// (b.gram holds W^T W and b.cross W^T X, the fit's sums).
template <int KMAX>
__device__ void mu_cluster_cols(const NmfBlock& b, int inner_iter,
                                const NmfPenalty& pen) {
  for (int m = threadIdx.x; m < b.l; m += blockDim.x) {
    float hr[KMAX], hn[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) hr[i] = i < b.k ? b.h[i * b.l + m] : 0.0f;
    for (int it = 0; it < inner_iter; ++it) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) {
          float den = 0.0f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < b.k) den += b.gram[i * b.k + j] * hr[j];
          }
          den = (den + pen.l1_h) + pen.l2_h * hr[i];
          den = den == 0.0f ? EPSILON : den;
          hn[i] = hr[i] * (b.cross[i * b.l + m] / den);
        }
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) hr[i] = hn[i];
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) b.h[i * b.l + m] = hr[i];
    }
  }
  __syncthreads();
}

// One MU iteration of the fit; `parity` picks the partial-set buffer.
// xf / wf: the fit's X and W in device memory (read and written there
// only when streamed).
template <int KMAX>
__device__ void mu_grid_step(const NmfGrid& g, const float* xf, float* wf, int parity,
                             unsigned& syncs, int inner_iter, const NmfPenalty& pen) {
  const NmfBlock& b = g.b;
  for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) g.bpart[q] = 0.0f;
  nmf_hht(b);  // its closing barrier also orders the zeroing
  nmf_grid_chunks<true>(g, xf, wf, [&](const NmfGridRows& c) {
    nmf_grid_w_pass<KMAX>(b, c, MuClusterRows<KMAX>{inner_iter, pen});
    nmf_grid_gram_pass(g, c);
  });
  nmf_grid_sum(g, parity, syncs);
  mu_cluster_cols<KMAX>(b, inner_iter, pen);
}

// ||X - W H||_F of the fit, returned to every thread of every block: each
// block's sum over its rows (the block entry's order within a row), then
// the blocks' sums in block order.
__device__ float mu_grid_error(const NmfGrid& g, const float* xf, float* wf,
                               unsigned& syncs) {
  const NmfBlock& b = g.b;
  float part = 0.0f;
  nmf_grid_chunks<false>(g, xf, wf, [&](const NmfGridRows& c) {
    const float* xs = c.y + (size_t)b.k * c.ld;
    for (int r = threadIdx.x; r < c.n; r += blockDim.x) {
      for (int m = 0; m < b.l; ++m) {
        float rec = 0.0f;
        for (int j = 0; j < b.k; ++j) rec += c.y[(size_t)j * c.ld + r] * b.h[j * b.l + m];
        const float d = xs[(size_t)m * c.ld + r] - rec;
        part += d * d;
      }
    }
  });
  return sqrtf(nmf_grid_scalar_sum(g, nmf_block_sum(b, part), syncs));
}

template <int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_GRID_THREADS) mu_cluster_kernel(
    NmfGridPlan p, const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w, float* __restrict__ h,
    int* __restrict__ n_iter_out, float* __restrict__ prev_err_out,
    int* __restrict__ converged_out, float* __restrict__ ws, int batch, int iters,
    float tol, int check_every, int inner_iter, NmfPenalty pen) {
  extern __shared__ float smem[];
  const size_t fit = blockIdx.x / p.blocks;
  const NmfGrid g = nmf_grid(smem, p, ws, batch, fit, (int)(blockIdx.x % p.blocks));
  const float* xf = x + fit * p.n * p.l;
  float* wf = w + fit * p.n * p.k;
  nmf_grid_load(g, xf, w0 + fit * p.n * p.k, wf, h0 + fit * p.k * p.l);
  unsigned syncs = 0;
  int parity = 0;
  if (WITH_STOP) {
    // sklearn's loop, as the block entry runs it; every value that
    // decides a branch is the same in every block of the fit
    const float err0 = mu_grid_error(g, xf, wf, syncs);
    float prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const int steps = min(check_every, iters - n_iter);
      for (int t = 0; t < steps; ++t) {
        mu_grid_step<KMAX>(g, xf, wf, parity, syncs, inner_iter, pen);
        parity ^= 1;
      }
      n_iter += steps;
      if (tol > 0.0f) {
        const float err = mu_grid_error(g, xf, wf, syncs);
        converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
        prev_err = err;
      }
    }
    if (g.rank == 0 && threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) {
      mu_grid_step<KMAX>(g, xf, wf, parity, syncs, inner_iter, pen);
      parity ^= 1;
    }
  }
  nmf_grid_store(g, wf, h + fit * p.k * p.l);
}

// nmf_grid_run with the plan made for `plan_batch` fits (at least
// `batch`): a batch cut from a larger one (a checkpointed bootstrap's
// chunk) runs each fit on the larger batch's blocks, so in its order of
// sums, and gives its bits.
template <typename... Params, typename... Args>
static int mu_grid_run(void (*kernel)(NmfGridPlan, Params...), int batch, int plan_batch,
                       int n, int l, int k, long long ws_floats, int* plan_out,
                       cudaStream_t stream, Args... args) {
  int sms = 0;
  int e = nmf_grid_sms(&sms);
  if (e != 0) return e;
  NmfGridPlan plan;
  e = nmf_grid_rule(plan_batch, n, l, k, sms, &plan);
  if (e == 0) e = nmf_grid_settle(kernel, batch, sms, plan, plan_out);
  if (e != 0) return e;
  return nmf_grid_launch(kernel, batch, plan, nmf_grid_workspace_floats(plan, batch),
                         ws_floats, stream, args...);
}

// The cluster entry: mu_nmf_f32's arguments and results, for frames over
// one block's shared memory and for small batches of smaller frames
// (models/kernels/mu_cuda.py: route), `plan_batch`, the batch the plan is
// made for (at least `batch`; mu_cuda.fit_mu_cuda's plan_batch), and
// `ws`, a zeroed workspace of `ws_floats` floats (at least
// nmf_grid_workspace_floats; mu_cuda.grid_workspace_floats).  Writes the
// plan it took to `plan_out` (NMF_GRID_PLAN_INTS host ints), launches
// once on `stream` and returns cudaGetLastError(), or the error that
// refused the plan.
extern "C" int mu_nmf_cluster_f32(const float* x, const float* w0,
                                  const float* h0, float* w, float* h,
                                  int* n_iter, float* prev_err, int* converged,
                                  int batch, int n, int l, int k, int iters,
                                  float tol, int check_every, int inner_iter,
                                  float l1_w, float l2_w, float l1_h,
                                  float l2_h, int with_stop, int plan_batch,
                                  float* ws, long long ws_floats, int* plan_out,
                                  void* stream) {
  if (batch < 1 || plan_batch < batch || n < 1 || l < 1 || k < 1 || k > NMF_KMAX ||
      iters < 0 || inner_iter < 1 || (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const cudaStream_t s = (cudaStream_t)stream;
#define MU_CLUSTER_RUN(KM, ST)                                                          \
  mu_grid_run(mu_cluster_kernel<KM, ST>, batch, plan_batch, n, l, k, ws_floats, plan_out, \
              s, x, w0, h0, w, h, n_iter, prev_err, converged, ws, batch, iters, tol,    \
              check_every, inner_iter, pen)
#define MU_CLUSTER_CALL(KM) \
  (with_stop ? MU_CLUSTER_RUN(KM, true) : MU_CLUSTER_RUN(KM, false))
  return NMF_CLUSTER_DISPATCH(k, MU_CLUSTER_CALL);
#undef MU_CLUSTER_CALL
#undef MU_CLUSTER_RUN
}
