// Batched HALS / coordinate-descent NMF, one thread block per fit.
//
// Replaces the TPU kernels `cd_iterations_pallas` and `fit_cd_pallas`
// (muscle_synergies_tpu/models/kernels/cd_pallas.py: _cd_kernel,
// _fit_cd_kernel, _cd_iteration).  As in mu_nmf.cu, each fit is a
// thread block with X, W and H in shared memory for the whole solve:
//   - W pass: H H^T first; then one thread per row of W runs the cyclic
//     component loop on its row in registers (the rows are independent
//     given H H^T and X H^T);
//   - H pass: W^T W and W^T X as block reductions, then one thread per
//     column of H runs the cyclic component loop on its column;
//   - the stopping rule runs inside the block (WITH_STOP): a block ends
//     when its fit converges, the frozen-trial semantics of the batched
//     reference.
// Numerics follow models/hals.py (sklearn's _update_cdnmf_fast with
// shuffle=False): gradient W H H^T - X H^T per component, the projected
// gradient taken from the column *before* its update, the L2 penalty on
// the Gram diagonal and the L1 penalty subtracted from X H^T (or W^T X),
// a Newton step grad / hess clipped at 0, the column left unchanged when
// hess == 0
// (which keeps zero-padded rank components exactly 0), and sklearn's
// stop: the summed |projected gradient| of iteration 1 is the reference,
// and a fit stops once violation / violation_init <= tol (or the
// reference is 0).
//
// What bounds it on this card: about 36 KFLOP per fit and iteration in
// float32 on CUDA cores, one divide per coordinate, and the
// __syncthreads between the passes; device memory is touched only at
// the start and the end of the solve.

#include "nmf_common.cuh"

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
