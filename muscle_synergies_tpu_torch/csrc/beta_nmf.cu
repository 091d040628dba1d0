// Batched beta-divergence multiplicative-update NMF, one thread block
// per fit.
//
// Replaces the TPU kernels `beta_mu_iterations_pallas` and
// `kl_mu_iterations_pallas` (muscle_synergies_tpu/models/kernels/
// beta_pallas.py: _beta_step, _num_den_weights, _damp) and the chunked
// driver around them (models/batch.py: _fit_beta_batch_pallas).  The
// Pallas kernel laid 128 trials across the vector lanes; here each fit
// is a thread block with X, W, H and the per-entry weight planes in
// shared memory (about 26 KB at N=200, L=8, K=4) for the whole solve:
//   - W half-step: one thread per row of W rebuilds its row of WH,
//     forms the numerator weight X * max(WH, eps)^(beta-2) and the
//     denominator weight WH^(beta-1) entry by entry in registers, and
//     updates the row (KL's denominator is the row sums of H);
//   - H half-step: the weights of the fresh WH go to shared memory,
//     W^T (weights) are block reductions over the rows (one warp per
//     entry), then one thread per entry of H updates it (KL's
//     denominator is the column sums of W, 0 -> 1 as in sklearn);
//   - the L1/L2 penalties added to the denominators (l1 + l2 * factor),
//     the den == 0 -> EPSILON guard, sklearn's delta^gamma damping and
//     the float64-eps flushes of W (beta < 1) and H (beta <= 1);
//   - the stopping rule runs inside the block (WITH_STOP): sklearn's
//     square-rooted beta divergence, summed in float64, every
//     `check_every` iterations, the last partial chunk up to max_iter
//     storing its divergence without a test.  A converged block simply
//     ends, which is the frozen-trial semantics of the batched driver.
// KIND specialises the weights: KL (beta = 1) needs one quotient per
// entry and no denominator weight, IS (beta = 0) one reciprocal for
// both weights and a square root for gamma = 1/2; the generic kind
// takes beta at run time through powf.  Zero-padded rank components
// stay exactly 0: their numerators are 0 and their denominators are
// guarded, so delta is 0.
//
// What bounds it on this card: about 51 KFLOP (KL) to 77 KFLOP (other
// betas) per fit and iteration in float32 on CUDA cores, plus one
// divide or power per entry of WH, against shared-memory bandwidth and
// the __syncthreads between the half-steps; device memory is touched
// only at the start and the end of the solve.

#include "nmf_common.cuh"

#define EPSILON 1.1920929e-07f
#define F64_EPS 2.220446049250313e-16f

enum BetaKind { BETA_KL = 0, BETA_IS = 1, BETA_GENERIC = 2 };

struct BetaBlock {
  NmfBlock m;    // x, w, h; gram holds the KL row sums of H
  float* num;    // (n, ldx) numerator weights of the H half-step
  float* den;    // (n, ldx) denominator weights of the H half-step
  float* nd;     // (2, k, l): W^T num, then W^T den (KL: column sums of W)
  double* red;   // 33 doubles of float64 reduction scratch
  float beta, gamma;
  NmfPenalty pen;
};

__host__ __device__ inline size_t beta_smem_floats(int n, int l, int k) {
  size_t f = nmf_smem_floats(n, l, k) + 2 * (size_t)n * nmf_odd(l) +
             2 * (size_t)k * l;
  f += f & 1;  // 8-byte alignment of the double scratch
  return f + 2 * 33;
}

__device__ inline BetaBlock beta_block(float* smem, int n, int l, int k,
                                       float beta, float gamma,
                                       NmfPenalty pen) {
  BetaBlock b;
  b.m = nmf_block(smem, n, l, k);
  float* rest = smem + nmf_smem_floats(n, l, k);
  b.num = rest;
  b.den = b.num + (size_t)n * b.m.ldx;
  b.nd = b.den + (size_t)n * b.m.ldx;
  b.red = (double*)(smem + beta_smem_floats(n, l, k) - 2 * 33);
  b.beta = beta;
  b.gamma = gamma;
  b.pen = pen;
  return b;
}

// Numerator weight X * max(WH, eps)^(beta-2) and denominator weight
// WH^(beta-1) (clamped when beta < 1) of one entry; KL has no
// denominator weight.
template <int KIND>
__device__ inline void beta_weights(float x, float wh, float beta, float* a,
                                    float* d) {
  if (KIND == BETA_KL) {
    *a = x / fmaxf(wh, EPSILON);
  } else if (KIND == BETA_IS) {
    const float inv = 1.0f / fmaxf(wh, EPSILON);
    *a = x * (inv * inv);
    *d = inv;
  } else {
    const float whn = beta < 2.0f ? fmaxf(wh, EPSILON) : wh;
    const float whd = beta < 1.0f ? fmaxf(wh, EPSILON) : wh;
    *a = x * powf(whn, beta - 2.0f);
    *d = powf(whd, beta - 1.0f);
  }
}

// sklearn's delta^gamma damping (gamma = 1/2 for IS).
template <int KIND>
__device__ inline float beta_damp(float delta, float gamma) {
  if (KIND == BETA_KL) return delta;
  if (KIND == BETA_IS || gamma == 0.5f) return sqrtf(delta);
  if (gamma == 1.0f) return delta;
  return powf(delta, gamma);
}

template <int KIND>
__device__ inline bool beta_flush_w(float beta) {
  return KIND == BETA_IS || (KIND == BETA_GENERIC && beta < 1.0f);
}

template <int KIND>
__device__ inline bool beta_flush_h(float beta) {
  return KIND != BETA_GENERIC || beta <= 1.0f;
}

template <int KIND, int KMAX>
__device__ void beta_step(const BetaBlock& bb) {
  const NmfBlock& b = bb.m;
  const float beta = bb.beta;

  // ---- W: one thread per row, weights in registers ----
  if (KIND == BETA_KL) {
    for (int i = threadIdx.x; i < b.k; i += blockDim.x) {
      float s = 0.0f;
      for (int m = 0; m < b.l; ++m) s += b.h[i * b.l + m];
      b.gram[i] = s;
    }
    __syncthreads();
  }
  for (int n = threadIdx.x; n < b.n; n += blockDim.x) {
    float wr[KMAX], num[KMAX], den[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      wr[i] = i < b.k ? b.w[n * b.ldw + i] : 0.0f;
      num[i] = 0.0f;
      den[i] = 0.0f;
    }
    for (int m = 0; m < b.l; ++m) {
      float wh = 0.0f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < b.k) wh += wr[j] * b.h[j * b.l + m];
      }
      float a, d;
      beta_weights<KIND>(b.x[n * b.ldx + m], wh, beta, &a, &d);
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < b.k) {
          const float hv = b.h[i * b.l + m];
          num[i] += a * hv;
          if (KIND != BETA_KL) den[i] += d * hv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) {
        float dd = KIND == BETA_KL ? b.gram[i] : den[i];
        dd = (dd + bb.pen.l1_w) + bb.pen.l2_w * wr[i];
        dd = dd == 0.0f ? EPSILON : dd;
        float v = wr[i] * beta_damp<KIND>(num[i] / dd, bb.gamma);
        if (beta_flush_w<KIND>(beta) && v < F64_EPS) v = 0.0f;
        b.w[n * b.ldw + i] = v;
      }
    }
  }
  __syncthreads();

  // ---- H: weights of the fresh WH, then W^T (weights) over the rows ----
  for (int q = threadIdx.x; q < b.n * b.l; q += blockDim.x) {
    const int n = q / b.l;
    const int m = q - n * b.l;
    float wh = 0.0f;
    for (int j = 0; j < b.k; ++j) wh += b.w[n * b.ldw + j] * b.h[j * b.l + m];
    float a, d;
    beta_weights<KIND>(b.x[n * b.ldx + m], wh, beta, &a, &d);
    bb.num[n * b.ldx + m] = a;
    if (KIND != BETA_KL) bb.den[n * b.ldx + m] = d;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int kl = b.k * b.l;
  const int entries = KIND == BETA_KL ? kl + b.k : 2 * kl;
  for (int q = threadIdx.x >> 5; q < entries; q += n_warps) {
    int i;
    const float* col = nullptr;  // nullptr: column sums of W (KL)
    if (q < kl) {
      i = q / b.l;
      col = bb.num + (q - i * b.l);
    } else if (KIND == BETA_KL) {
      i = q - kl;
    } else {
      i = (q - kl) / b.l;
      col = bb.den + (q - kl - i * b.l);
    }
    float s = 0.0f;
    for (int r = lane; r < b.n; r += 32) {
      s += b.w[r * b.ldw + i] * (col ? col[r * b.ldx] : 1.0f);
    }
    s = nmf_warp_sum(s);
    if (lane == 0) bb.nd[q] = s;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kl; q += blockDim.x) {
    float dd;
    if (KIND == BETA_KL) {
      const float ws = bb.nd[kl + q / b.l];
      dd = ws == 0.0f ? 1.0f : ws;
    } else {
      dd = bb.nd[kl + q];
    }
    dd = (dd + bb.pen.l1_h) + bb.pen.l2_h * b.h[q];
    dd = dd == 0.0f ? EPSILON : dd;
    float v = b.h[q] * beta_damp<KIND>(bb.nd[q] / dd, bb.gamma);
    if (beta_flush_h<KIND>(beta) && v < F64_EPS) v = 0.0f;
    b.h[q] = v;
  }
  __syncthreads();
}

// sklearn's square-rooted beta divergence of the block's fit, summed in
// float64 (entries with x <= EPSILON leave the data terms; the IS
// constant counts every entry), returned to every thread.
template <int KIND>
__device__ double beta_divergence(const BetaBlock& bb) {
  const NmfBlock& b = bb.m;
  const double beta = bb.beta;
  const bool frobenius = KIND == BETA_GENERIC && beta == 2.0;
  double part = 0.0;
  for (int q = threadIdx.x; q < b.n * b.l; q += blockDim.x) {
    const int n = q / b.l;
    const int m = q - n * b.l;
    double wh = 0.0;
    for (int j = 0; j < b.k; ++j) {
      wh += (double)b.w[n * b.ldw + j] * (double)b.h[j * b.l + m];
    }
    const double x = b.x[n * b.ldx + m];
    const bool in = x > (double)EPSILON;
    const double whc = fmax(wh, (double)EPSILON);
    if (frobenius) {
      part += (x - wh) * (x - wh);
    } else if (KIND == BETA_KL) {
      part += wh;
      if (in) part += x * log(x / whc) - x;
    } else if (KIND == BETA_IS) {
      part -= 1.0;
      if (in) part += x / whc - log(x / whc);
    } else {
      part += (beta - 1.0) * pow(wh, beta);
      if (in) part += pow(x, beta) - beta * x * pow(whc, beta - 1.0);
    }
  }
  double res = nmf_block_sum_d(bb.red, part);
  if (frobenius) return sqrt(res);
  if (KIND == BETA_GENERIC) res /= beta * (beta - 1.0);
  return sqrt(2.0 * fmax(res, 0.0));
}

template <int KIND, int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_THREADS) beta_nmf_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int n, int l, int k, int iters, float beta, float gamma, double tol,
    int check_every, NmfPenalty pen) {
  extern __shared__ float smem[];
  const BetaBlock bb = beta_block(smem, n, l, k, beta, gamma, pen);
  const size_t fit = blockIdx.x;
  nmf_load(bb.m, x + fit * n * l, w0 + fit * n * k, h0 + fit * k * l);
  if (WITH_STOP) {
    // sklearn's loop: chunks of check_every updates, the counter
    // stopping at max_iter (= iters), a test only at exact multiples
    const double err0 = beta_divergence<KIND>(bb);
    double prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const int steps = min(check_every, iters - n_iter);
      for (int t = 0; t < steps; ++t) beta_step<KIND, KMAX>(bb);
      n_iter += steps;
      if (tol > 0.0) {
        const double err = beta_divergence<KIND>(bb);
        converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
        prev_err = err;
      }
    }
    if (threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = (float)prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) beta_step<KIND, KMAX>(bb);
  }
  nmf_store(bb.m, w + fit * n * k, h + fit * k * l);
}

template <int KIND, int KMAX>
static int beta_dispatch(bool with_stop, const float* x, const float* w0,
                         const float* h0, float* w, float* h, int* n_iter,
                         float* prev_err, int* converged, int batch, int n,
                         int l, int k, int iters, float beta, float gamma,
                         double tol, int check_every, NmfPenalty pen,
                         cudaStream_t stream) {
  const size_t smem = beta_smem_floats(n, l, k) * sizeof(float);
  if (with_stop) {
    return nmf_launch(beta_nmf_kernel<KIND, KMAX, true>, batch, smem, stream,
                      x, w0, h0, w, h, n_iter, prev_err, converged, n, l, k,
                      iters, beta, gamma, tol, check_every, pen);
  }
  return nmf_launch(beta_nmf_kernel<KIND, KMAX, false>, batch, smem, stream,
                    x, w0, h0, w, h, n_iter, prev_err, converged, n, l, k,
                    iters, beta, gamma, tol, check_every, pen);
}

template <int KIND>
static int beta_dispatch_k(bool with_stop, const float* x, const float* w0,
                           const float* h0, float* w, float* h, int* n_iter,
                           float* prev_err, int* converged, int batch, int n,
                           int l, int k, int iters, float beta, float gamma,
                           double tol, int check_every, NmfPenalty pen,
                           cudaStream_t s) {
  if (k <= 4) {
    return beta_dispatch<KIND, 4>(with_stop, x, w0, h0, w, h, n_iter,
                                  prev_err, converged, batch, n, l, k, iters,
                                  beta, gamma, tol, check_every, pen, s);
  }
  if (k <= 8) {
    return beta_dispatch<KIND, 8>(with_stop, x, w0, h0, w, h, n_iter,
                                  prev_err, converged, batch, n, l, k, iters,
                                  beta, gamma, tol, check_every, pen, s);
  }
  return beta_dispatch<KIND, 16>(with_stop, x, w0, h0, w, h, n_iter,
                                 prev_err, converged, batch, n, l, k, iters,
                                 beta, gamma, tol, check_every, pen, s);
}

// x (B, N, L), w0/w (B, N, K), h0/h (B, K, L) float32; n_iter,
// prev_err, converged (B,) written only when with_stop.  `iters` is
// max_iter with the stop and the fixed iteration count without it;
// `gamma` is sklearn's damping exponent for `beta`; l1_w .. l2_h are the
// penalties (0 for none).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int beta_nmf_f32(const float* x, const float* w0, const float* h0,
                            float* w, float* h, int* n_iter, float* prev_err,
                            int* converged, int batch, int n, int l, int k,
                            int iters, float beta, float gamma, double tol,
                            int check_every, float l1_w, float l2_w,
                            float l1_h, float l2_h, int with_stop,
                            void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0 ||
      !(gamma > 0.0f) || (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  if (beta == 1.0f) {
    return beta_dispatch_k<BETA_KL>(with_stop, x, w0, h0, w, h, n_iter,
                                    prev_err, converged, batch, n, l, k,
                                    iters, beta, gamma, tol, check_every,
                                    pen, s);
  }
  if (beta == 0.0f) {
    return beta_dispatch_k<BETA_IS>(with_stop, x, w0, h0, w, h, n_iter,
                                    prev_err, converged, batch, n, l, k,
                                    iters, beta, gamma, tol, check_every,
                                    pen, s);
  }
  return beta_dispatch_k<BETA_GENERIC>(with_stop, x, w0, h0, w, h, n_iter,
                                       prev_err, converged, batch, n, l, k,
                                       iters, beta, gamma, tol, check_every,
                                       pen, s);
}
