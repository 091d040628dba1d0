// Batched Frobenius multiplicative-update NMF, one thread block per fit.
//
// Replaces the TPU kernels `mu_iterations_pallas` and `fit_mu_pallas`
// (muscle_synergies_tpu/models/kernels/mu_pallas.py: _mu_kernel,
// _fit_mu_kernel, _mu_step, _lane_error).  The Pallas kernels laid 128
// trials across the vector lanes and unrolled the tiny per-trial
// products as lane-parallel FMAs.  Here each fit is a thread block with
// its X, W and H in shared memory (about 13 KB at N=200, L=8, K=4):
//   - W half-step: H H^T (K*K) first, then one thread per row of W
//     computes its row of X H^T in registers and updates the row;
//   - H half-step: W^T W and W^T X are block reductions over the rows
//     (one warp per entry), then one thread per column of H updates it;
//   - the stopping rule runs inside the block (WITH_STOP), so a block
//     simply ends when its fit converges: that is exactly the frozen-
//     trial semantics of the batched reference.
// Numerics follow models/mu.py: sklearn's update order, the L1/L2
// penalties added to the denominators (l1 + l2 * factor), the float32-eps
// denominator guard (den == 0 -> EPSILON), `inner_iter` repetitions
// reusing X H^T / H H^T and W^T X / W^T W, and sklearn's stopping test
// every `check_every` iterations, (prev_err - err) / err0 < tol, with
// tol <= 0 disabling it.  Zero-padded rank components stay exactly 0:
// their numerator is 0 and their denominator becomes EPSILON.
//
// What bounds it on this card: about 38 KFLOP per fit and iteration in
// float32 on CUDA cores, against shared-memory bandwidth and the
// __syncthreads between the half-steps; device memory is touched only
// at the start and the end of the solve.

#include "nmf_common.cuh"

#define EPSILON 1.1920929e-07f

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
