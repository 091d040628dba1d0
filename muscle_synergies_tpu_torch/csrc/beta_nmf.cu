// Batched beta-divergence multiplicative-update NMF: a warp-per-fit
// entry for the time-normalised frames of the main paths (KL; IS up to
// rank 4), the cluster (grid) entry, one fit spread over many blocks of
// the card (at the end of this file), for every other frame, and a
// block-per-fit entry for batches of frames within one block that fill
// the card with waves of fits (models/kernels/beta_cuda.py: route).
//
// Replaces the TPU kernels `beta_mu_iterations_pallas` and
// `kl_mu_iterations_pallas` (muscle_synergies_tpu/models/kernels/
// beta_pallas.py: _beta_step, _num_den_weights, _damp) and the chunked
// driver around them (models/batch.py: _fit_beta_batch_pallas).  The
// Pallas kernel laid 128 trials across the vector lanes.  Both entries
// here compute the same iteration:
//   - W half-step: each row of W rebuilds its row of WH, forms the
//     numerator weight X * max(WH, eps)^(beta-2) and the denominator
//     weight WH^(beta-1) entry by entry in registers, and updates the
//     row (KL's denominator is the row sums of H);
//   - H half-step: the weights of the fresh WH, W^T (weights), then
//     each entry of H is updated (KL's denominator is the column sums of
//     W, 0 -> 1 as in sklearn);
//   - the L1/L2 penalties added to the denominators (l1 + l2 * factor),
//     the den == 0 -> EPSILON guard, sklearn's delta^gamma damping and
//     the float64-eps flushes of W (beta < 1) and H (beta <= 1);
//   - the stopping rule inside the fit (WITH_STOP): sklearn's
//     square-rooted beta divergence, summed in float64, every
//     `check_every` iterations, the last partial chunk up to max_iter
//     storing its divergence without a test.  A converged fit simply
//     ends, which is the frozen-trial semantics of the batched driver.
// KIND specialises the weights: KL (beta = 1) needs one quotient per
// entry and no denominator weight, IS (beta = 0) one reciprocal for
// both weights and a square root for gamma = 1/2; the generic kind
// takes beta at run time through powf.  Zero-padded rank components
// stay exactly 0: their numerators are 0 and their denominators are
// guarded, so delta is 0.
//
// Block entry (beta_nmf_f32, any frame whose X, W, H and two weight
// planes fit one block's shared memory, about 26 KB at N=200, L=8,
// K=4; the route gives it only batches that would take the grid entry,
// one block a SM at 184-255 registers a thread, 4 or more waves, and
// whose blocks share an SM 4 at a time): one block of 128 threads per
// fit.  Against the grid entry (H100 80GB HBM3, 700 W, us an iteration,
// scripts/torch_cluster_timing.py): 200 x 8 at beta 1.5, 264 fits 23.5
// against 16.4, 528 fits 29.0 against 32.3, 1,024 fits 49.7 against 63.8;
// KL on 16 x 2,000 x 8 57.3 against 5.8 on 8 blocks each, 1,024 fits 450.5
// against 130.6 (one block a SM either way).  What bounds it: about 51
// KFLOP (KL) to 77 KFLOP (other betas) per fit and iteration on CUDA
// cores plus one divide or power per entry of WH, spent on a chain of
// five __syncthreads (KL's row sums, the W half-step, the weight planes,
// W^T (weights) as warp reductions shared by 4 warps, the H update) and,
// every 10 iterations, a float64 divergence with a 3-barrier block sum.
//
// Warp entry (beta_nmf_warp_f32, N <= NMF_WARP_NMAX; KL at L <=
// NMF_WARP_LMAX and k <= NMF_WARP_KMAX, IS at L <= 8 and k <= 4): K2's
// warp layout (nmf_common.cuh).
// One warp per fit with no __syncthreads; lane i owns rows i, i + 32,
// ... with their X and W in registers.  In the H half-step each lane
// rebuilds the fresh WH of its rows in registers, and W^T (weights)
// (KL: W^T (X / WH) and the column sums of W) are the lanes' partial
// sums combined by butterflies in the block entry's order, so no weight
// plane is stored and the iterates are the block entry's bit for bit;
// one lane per entry of H updates it.  Every loop runs over the padded
// extents: a padded entry has X = 0 and WH = 0, so its numerator weight
// is 0 and every weight it adds is multiplied by a zero of W or H.  The
// divergence counts only the frame's own N x L entries (a padded entry
// would add -1 to IS's constant), a mask applied once per
// `check_every`, outside the iteration; it sums in float64 in another
// order than the block entry, which moves it by ~1e-16.  A run-time
// beta stays on the block entry: with its two powf per entry out of
// line (inlined, they made the source take ~19 minutes to build) a warp
// took 4.47 ms for 50 iterations at 1024 x 200 x 8 against the block
// entry's 2.51 ms (chip_smoke.py, H100); for beta < 0 a padded entry's
// numerator weight, 0 * eps^(beta-2), would also overflow to NaN.  What
// bounds it: the dependent chain of one iteration (the quotients, five
// shuffle rounds per group of 32 sums), so a lone fit's latency, which
// sets the KL path's tail.

#include "nmf_common.cuh"

#define EPSILON 1.1920929e-07f
#define F64_EPS 2.220446049250313e-16f

enum BetaKind { BETA_KL = 0, BETA_IS = 1, BETA_GENERIC = 2 };

struct BetaBlock {
  NmfBlock m;    // x, w, h; gram holds the KL row sums of H
  float* num;    // (n, ldx) numerator weights of the H half-step
  float* den;    // (n, ldx) denominator weights of the H half-step (not KL)
  float* nd;     // (2, k, l): W^T num, then W^T den (KL: column sums of W)
  double* red;   // 33 doubles of float64 reduction scratch
  float beta, gamma;
  NmfPenalty pen;
};

// KL stores no denominator plane, so a frame of 2,000 x 8 at rank 4
// fits one block's shared memory for KL (185 KB) but not for the other
// kinds (257 KB).
__host__ __device__ inline size_t beta_smem_floats(int n, int l, int k,
                                                   bool kl) {
  size_t f = nmf_smem_floats(n, l, k) + (kl ? 1 : 2) * (size_t)n * nmf_odd(l) +
             2 * (size_t)k * l;
  f += f & 1;  // 8-byte alignment of the double scratch
  return f + 2 * 33;
}

template <int KIND>
__device__ inline BetaBlock beta_block(float* smem, int n, int l, int k,
                                       float beta, float gamma,
                                       NmfPenalty pen) {
  const bool kl = KIND == BETA_KL;
  BetaBlock b;
  b.m = nmf_block(smem, n, l, k);
  float* rest = smem + nmf_smem_floats(n, l, k);
  b.num = rest;
  b.den = b.num + (size_t)n * b.m.ldx;
  b.nd = b.den + (kl ? 0 : (size_t)n * b.m.ldx);
  b.red = (double*)(smem + beta_smem_floats(n, l, k, kl) - 2 * 33);
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

// ----------------- pieces of the block and cluster entries -----------------

// b.gram[0..k) <- the row sums of H, KL's W denominator.
__device__ inline void beta_h_row_sums(const NmfBlock& b) {
  for (int i = threadIdx.x; i < b.k; i += blockDim.x) {
    float s = 0.0f;
    for (int m = 0; m < b.l; ++m) s += b.h[i * b.l + m];
    b.gram[i] = s;
  }
  __syncthreads();
}

// Row n of W updated from its row of WH (old W, H) in registers: wr
// holds the new row, also stored to b.w; b.gram holds H's row sums (KL).
template <int KIND, int KMAX>
__device__ __forceinline__ void beta_w_row(const NmfBlock& b, int n, float beta,
                                           float gamma, const NmfPenalty& pen,
                                           float (&wr)[KMAX]) {
  float num[KMAX], den[KMAX];
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
      dd = (dd + pen.l1_w) + pen.l2_w * wr[i];
      dd = dd == 0.0f ? EPSILON : dd;
      float v = wr[i] * beta_damp<KIND>(num[i] / dd, gamma);
      if (beta_flush_w<KIND>(beta) && v < F64_EPS) v = 0.0f;
      wr[i] = v;
      b.w[n * b.ldw + i] = v;
    }
  }
}

// W^T (weights) over rows 0..b.n of the planes num and den (stride
// b.ldx; KL: the column sums of W), one warp per entry, its lanes
// striding over the rows.
template <int KIND>
__device__ inline void beta_wt_weights(const NmfBlock& b, const float* num,
                                       const float* den, float* nd) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int kl = b.k * b.l;
  const int entries = KIND == BETA_KL ? kl + b.k : 2 * kl;
  for (int q = threadIdx.x >> 5; q < entries; q += n_warps) {
    int i;
    const float* col = nullptr;  // nullptr: column sums of W (KL)
    if (q < kl) {
      i = q / b.l;
      col = num + (q - i * b.l);
    } else if (KIND == BETA_KL) {
      i = q - kl;
    } else {
      i = (q - kl) / b.l;
      col = den + (q - kl - i * b.l);
    }
    float s = 0.0f;
    for (int r = lane; r < b.n; r += 32) {
      s += b.w[r * b.ldw + i] * (col ? col[r * b.ldx] : 1.0f);
    }
    s = nmf_warp_sum(s);
    if (lane == 0) nd[q] = s;
  }
  __syncthreads();
}

// H <- H * damp(W^T num / (W^T den + penalties)) from nd (W^T num, then
// W^T den or, for KL, the column sums of W, 0 -> 1 as in sklearn).
template <int KIND>
__device__ inline void beta_update_h(const NmfBlock& b, const float* nd,
                                     float beta, float gamma,
                                     const NmfPenalty& pen) {
  const int kl = b.k * b.l;
  for (int q = threadIdx.x; q < kl; q += blockDim.x) {
    float dd;
    if (KIND == BETA_KL) {
      const float ws = nd[kl + q / b.l];
      dd = ws == 0.0f ? 1.0f : ws;
    } else {
      dd = nd[kl + q];
    }
    dd = (dd + pen.l1_h) + pen.l2_h * b.h[q];
    dd = dd == 0.0f ? EPSILON : dd;
    float v = b.h[q] * beta_damp<KIND>(nd[q] / dd, gamma);
    if (beta_flush_h<KIND>(beta) && v < F64_EPS) v = 0.0f;
    b.h[q] = v;
  }
  __syncthreads();
}

// ---------------------------- block entry ----------------------------

template <int KIND, int KMAX>
__device__ void beta_step(const BetaBlock& bb) {
  const NmfBlock& b = bb.m;
  const float beta = bb.beta;

  // ---- W: one thread per row, weights in registers ----
  if (KIND == BETA_KL) beta_h_row_sums(b);
  for (int n = threadIdx.x; n < b.n; n += blockDim.x) {
    float wr[KMAX];
    beta_w_row<KIND, KMAX>(b, n, beta, bb.gamma, bb.pen, wr);
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
  beta_wt_weights<KIND>(b, bb.num, bb.den, bb.nd);
  beta_update_h<KIND>(b, bb.nd, beta, bb.gamma, bb.pen);
}

// One entry's terms of sklearn's beta divergence added to `part` in
// float64 (an entry with x <= EPSILON leaves the data terms; the IS
// constant counts the entry all the same).  Out of line: the warp entry
// calls it at every one of its unrolled entries, where the inlined
// double log and pow made the source take minutes to build.
template <int KIND>
__device__ __noinline__ double beta_entry_divergence(double part, double x,
                                                     double wh, double beta) {
  const bool in = x > (double)EPSILON;
  const double whc = fmax(wh, (double)EPSILON);
  if (KIND == BETA_GENERIC && beta == 2.0) {
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
  return part;
}

// The square root sklearn takes of the summed divergence.
template <int KIND>
__device__ inline double beta_divergence_root(double res, double beta) {
  if (KIND == BETA_GENERIC && beta == 2.0) return sqrt(res);
  if (KIND == BETA_GENERIC) res /= beta * (beta - 1.0);
  return sqrt(2.0 * fmax(res, 0.0));
}

// sklearn's square-rooted beta divergence of the block's fit, summed in
// float64 over every entry, returned to every thread.
template <int KIND>
__device__ double beta_divergence(const BetaBlock& bb) {
  const NmfBlock& b = bb.m;
  const double beta = bb.beta;
  double part = 0.0;
  for (int q = threadIdx.x; q < b.n * b.l; q += blockDim.x) {
    const int n = q / b.l;
    const int m = q - n * b.l;
    double wh = 0.0;
    for (int j = 0; j < b.k; ++j) {
      wh += (double)b.w[n * b.ldw + j] * (double)b.h[j * b.l + m];
    }
    part = beta_entry_divergence<KIND>(part, b.x[n * b.ldx + m], wh, beta);
  }
  return beta_divergence_root<KIND>(nmf_block_sum_d(bb.red, part), beta);
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
  const BetaBlock bb = beta_block<KIND>(smem, n, l, k, beta, gamma, pen);
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
  const size_t smem = beta_smem_floats(n, l, k, KIND == BETA_KL) * sizeof(float);
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

// ---------------------------- warp entry -----------------------------

// IS is compiled for the main paths' shape only (rank <= 4, L <= 8):
// its two weight planes double the unrolled H half-step, which bounds
// how many instantiations nvcc builds in reasonable time.
#define BETA_WARP_IS_LMAX 8
#define BETA_WARP_IS_KMAX 4

// One fit's slab: H, W^T (numerator weights), and W^T (denominator
// weights) or, for KL, the column sums of W; row strides LMAX.
template <int KIND, int KMAX, int LMAX>
struct __align__(16) BetaWarpSlab {
  float h[KMAX * LMAX];
  float num[KMAX * LMAX];
  float den[KIND == BETA_KL ? KMAX : KMAX * LMAX];
};

// W^T (numerator weights) and W^T (denominator weights) (KL: the column
// sums of W) of the fresh WH into the slab.  Each group of 32 sums holds
// 32 / LMAX components at every column: the lane rebuilds WH and the
// group's weight entry by entry over its rows (the rows a lane of the
// block entry's reduction walks, in its order), then butterflies add
// the lanes' partial sums as the block entry adds them.
template <int KIND, int KMAX, int LMAX>
__device__ __forceinline__ void beta_warp_wt_weights(
    BetaWarpSlab<KIND, KMAX, LMAX>& sl, const float (&xr)[NMF_WARP_ROWS][LMAX],
    const float (&wr)[NMF_WARP_ROWS][KMAX], float beta) {
  constexpr int IPG = 32 / LMAX;  // components a group of 32 sums holds
  constexpr int PLANES = KIND == BETA_KL ? 1 : 2;
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
#pragma unroll
    for (int g = 0; g < KMAX / IPG; ++g) {
      float a[32];
#pragma unroll
      for (int v = 0; v < 32; ++v) a[v] = 0.0f;
#pragma unroll
      for (int r = 0; r < NMF_WARP_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < LMAX; ++m) {
          float wh = 0.0f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) wh += wr[r][j] * sl.h[j * LMAX + m];
          float num, den;
          beta_weights<KIND>(xr[r][m], wh, beta, &num, &den);
          const float wt = p == 0 ? num : den;
#pragma unroll
          for (int i = 0; i < IPG; ++i) a[i * LMAX + m] += wr[r][g * IPG + i] * wt;
        }
      }
      nmf_warp_allsum(a);
      float* out = (p == 0 ? sl.num : sl.den) + 32 * g;
#pragma unroll
      for (int v = 0; v < 32; ++v) out[v] = a[v];
    }
  }
  if (KIND == BETA_KL) {
    float a[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      a[i] = 0.0f;
#pragma unroll
      for (int r = 0; r < NMF_WARP_ROWS; ++r) a[i] += wr[r][i];
    }
    nmf_warp_allsum(a);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) sl.den[i] = a[i];
  }
}

// One beta-MU iteration of one fit on one warp, W half-step then H
// half-step; two __syncwarp order the passes through the slab.
template <int KIND, int KMAX, int LMAX>
__device__ __forceinline__ void beta_warp_step(
    BetaWarpSlab<KIND, KMAX, LMAX>& sl, const float (&xr)[NMF_WARP_ROWS][LMAX],
    float (&wr)[NMF_WARP_ROWS][KMAX], int lane, float beta, float gamma,
    const NmfPenalty& pen) {
  // ---- W: the lane's rows, weights in registers ----
  float hsum[KMAX];  // KL's denominator: the row sums of H
  if (KIND == BETA_KL) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < LMAX; ++m) s += sl.h[i * LMAX + m];
      hsum[i] = s;
    }
  }
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    float num[KMAX], den[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      num[i] = 0.0f;
      den[i] = 0.0f;
    }
#pragma unroll
    for (int m = 0; m < LMAX; ++m) {
      float wh = 0.0f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) wh += wr[r][j] * sl.h[j * LMAX + m];
      float a, d;
      beta_weights<KIND>(xr[r][m], wh, beta, &a, &d);
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        const float hv = sl.h[i * LMAX + m];
        num[i] += a * hv;
        if (KIND != BETA_KL) den[i] += d * hv;
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      float dd = KIND == BETA_KL ? hsum[i] : den[i];
      dd = (dd + pen.l1_w) + pen.l2_w * wr[r][i];
      dd = dd == 0.0f ? EPSILON : dd;
      float v = wr[r][i] * beta_damp<KIND>(num[i] / dd, gamma);
      if (beta_flush_w<KIND>(beta) && v < F64_EPS) v = 0.0f;
      wr[r][i] = v;
    }
  }

  // ---- H: W^T (weights of the fresh WH), then one lane per entry ----
  beta_warp_wt_weights(sl, xr, wr, beta);
  __syncwarp();
  for (int q = lane; q < KMAX * LMAX; q += 32) {
    float dd;
    if (KIND == BETA_KL) {
      const float ws = sl.den[q / LMAX];
      dd = ws == 0.0f ? 1.0f : ws;
    } else {
      dd = sl.den[q];
    }
    const float hv = sl.h[q];
    dd = (dd + pen.l1_h) + pen.l2_h * hv;
    dd = dd == 0.0f ? EPSILON : dd;
    float v = hv * beta_damp<KIND>(sl.num[q] / dd, gamma);
    if (beta_flush_h<KIND>(beta) && v < F64_EPS) v = 0.0f;
    sl.h[q] = v;
  }
  __syncwarp();
}

// sklearn's square-rooted beta divergence of the warp's fit over the
// frame's own n x l entries (the padding left out), summed in float64,
// returned to every lane.
template <int KIND, int KMAX, int LMAX>
__device__ double beta_warp_divergence(const BetaWarpSlab<KIND, KMAX, LMAX>& sl,
                                       const float (&xr)[NMF_WARP_ROWS][LMAX],
                                       const float (&wr)[NMF_WARP_ROWS][KMAX],
                                       int lane, int n, int l, float beta) {
  double part = 0.0;
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    if (lane + 32 * r >= n) continue;
#pragma unroll
    for (int m = 0; m < LMAX; ++m) {
      if (m >= l) continue;
      double wh = 0.0;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) wh += (double)wr[r][j] * (double)sl.h[j * LMAX + m];
      part = beta_entry_divergence<KIND>(part, xr[r][m], wh, beta);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_xor_sync(NMF_FULL_MASK, part, off);
  }
  return beta_divergence_root<KIND>(part, beta);
}

template <int KIND, int KMAX, int LMAX, bool WITH_STOP>
__global__ void __launch_bounds__(32 * NMF_WARP_FITS) beta_warp_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int batch, int n, int l, int k, int iters, float beta, float gamma,
    double tol, int check_every, NmfPenalty pen) {
  __shared__ BetaWarpSlab<KIND, KMAX, LMAX> slabs[NMF_WARP_FITS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t fit = (size_t)blockIdx.x * NMF_WARP_FITS + warp;
  if (fit >= (size_t)batch) return;  // whole warps only: no block barrier
  BetaWarpSlab<KIND, KMAX, LMAX>& sl = slabs[warp];
  float xr[NMF_WARP_ROWS][LMAX], wr[NMF_WARP_ROWS][KMAX];
  nmf_warp_load<KMAX, LMAX>(x + fit * n * l, w0 + fit * n * k,
                            h0 + fit * k * l, n, l, k, lane, xr, wr, sl.h);
  if (WITH_STOP) {
    // sklearn's loop: chunks of check_every updates, the counter
    // stopping at max_iter (= iters), a test only at exact multiples
    const double err0 = beta_warp_divergence(sl, xr, wr, lane, n, l, beta);
    double prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const int steps = min(check_every, iters - n_iter);
      for (int t = 0; t < steps; ++t) {
        beta_warp_step(sl, xr, wr, lane, beta, gamma, pen);
      }
      n_iter += steps;
      if (tol > 0.0) {
        const double err = beta_warp_divergence(sl, xr, wr, lane, n, l, beta);
        converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
        prev_err = err;
      }
    }
    if (lane == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = (float)prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) beta_warp_step(sl, xr, wr, lane, beta, gamma, pen);
  }
  nmf_warp_store<KMAX, LMAX>(w + fit * n * k, h + fit * k * l, n, l, k, lane,
                             wr, sl.h);
}

template <int KIND, int KMAX, int LMAX>
static int beta_warp_dispatch(bool with_stop, const float* x, const float* w0,
                              const float* h0, float* w, float* h, int* n_iter,
                              float* prev_err, int* converged, int batch, int n,
                              int l, int k, int iters, float beta, float gamma,
                              double tol, int check_every, NmfPenalty pen,
                              cudaStream_t stream) {
  const int blocks = (batch + NMF_WARP_FITS - 1) / NMF_WARP_FITS;
  if (with_stop) {
    beta_warp_kernel<KIND, KMAX, LMAX, true>
        <<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
            x, w0, h0, w, h, n_iter, prev_err, converged, batch, n, l, k,
            iters, beta, gamma, tol, check_every, pen);
  } else {
    beta_warp_kernel<KIND, KMAX, LMAX, false>
        <<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
            x, w0, h0, w, h, n_iter, prev_err, converged, batch, n, l, k,
            iters, beta, gamma, tol, check_every, pen);
  }
  return (int)cudaGetLastError();
}

// The warp entry: beta_nmf_f32's arguments and results, for frames with
// n <= NMF_WARP_NMAX at beta = 1 (l <= NMF_WARP_LMAX, k <= NMF_WARP_KMAX)
// or beta = 0 (l <= BETA_WARP_IS_LMAX, k <= BETA_WARP_IS_KMAX)
// (models/kernels/beta_cuda.py: route); anything else is refused.
extern "C" int beta_nmf_warp_f32(const float* x, const float* w0,
                                 const float* h0, float* w, float* h,
                                 int* n_iter, float* prev_err, int* converged,
                                 int batch, int n, int l, int k, int iters,
                                 float beta, float gamma, double tol,
                                 int check_every, float l1_w, float l2_w,
                                 float l1_h, float l2_h, int with_stop,
                                 void* stream) {
  const bool kl = beta == 1.0f;
  if (batch < 1 || n < 1 || l < 1 || k < 1 || n > NMF_WARP_NMAX ||
      !(kl || beta == 0.0f) || l > (kl ? NMF_WARP_LMAX : BETA_WARP_IS_LMAX) ||
      k > (kl ? NMF_WARP_KMAX : BETA_WARP_IS_KMAX) || iters < 0 ||
      !(gamma > 0.0f) || (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const bool st = with_stop != 0;
  if (!kl) {
    return beta_warp_dispatch<BETA_IS, 4, 8>(st, x, w0, h0, w, h, n_iter,
                                             prev_err, converged, batch, n, l,
                                             k, iters, beta, gamma, tol,
                                             check_every, pen, s);
  }
  if (k <= 4) {
    return l <= 8 ? beta_warp_dispatch<BETA_KL, 4, 8>(
                        st, x, w0, h0, w, h, n_iter, prev_err, converged,
                        batch, n, l, k, iters, beta, gamma, tol, check_every,
                        pen, s)
                  : beta_warp_dispatch<BETA_KL, 4, 16>(
                        st, x, w0, h0, w, h, n_iter, prev_err, converged,
                        batch, n, l, k, iters, beta, gamma, tol, check_every,
                        pen, s);
  }
  return l <= 8 ? beta_warp_dispatch<BETA_KL, 8, 8>(
                      st, x, w0, h0, w, h, n_iter, prev_err, converged, batch,
                      n, l, k, iters, beta, gamma, tol, check_every, pen, s)
                : beta_warp_dispatch<BETA_KL, 8, 16>(
                      st, x, w0, h0, w, h, n_iter, prev_err, converged, batch,
                      n, l, k, iters, beta, gamma, tol, check_every, pen, s);
}

// --------------------------- cluster entry ---------------------------
//
// beta_nmf_cluster_f32: the entry for frames whose fit exceeds one
// block's shared memory (a subject's concatenated cycles, a whole
// capture), and for frames within it that the warp entry does not take
// unless the batch keeps the block entry (a run-time beta on 16 fits of
// 200 x 8, KL's 2,000 x 8 at any batch), replacing
// `beta_mu_iterations_pallas` (beta_pallas.py:231) and
// `kl_mu_iterations_pallas` (beta_pallas.py:292) there.  One fit is
// spread over P blocks of the whole card on K1's grid design
// (nmf_common.cuh: the grid entries): a lone 124,460 x 8 fit over all
// 132 SMs, 943 rows a block resident in shared memory (k + l floats a
// row, 48 B at rank 4: 45 KB); the rank 1-4 sweep of one trial as 4
// fits of 33 blocks of 3,772 rows (181 KB); more fits than that stream
// their rows in tiles.  An iteration keeps sklearn's order, W then H, in
// one pass over a block's rows, one thread a row: the row's WH (old W,
// old H) and its weights in registers update the row of W; the fresh WH
// of the new row (new W, old H) gives the weights X * max(WH,
// eps)^(beta-2) and WH^(beta-1) of the H update, multiplied into the
// row's share of W^T (weights) in registers (4 components x 8 columns of
// each plane a tile; KL: W^T (X / WH) and, in place of the second plane,
// the column sums of W); the warps' lanes combine by a reduce-scatter,
// the warps in order, into the block's partial set.  The set goes to the
// workspace by the iteration's parity; after the fit's one barrier in
// device memory every block adds the P sets in block order 0..P-1 and
// updates H from the same numbers, so H is the same bits everywhere.
// The float64-eps flushes of W (beta < 1) and H (beta <= 1), the
// max(WH, EPSILON) clamps, the penalties and the den == 0 guards are the
// block entry's.  The stop is sklearn's beta divergence summed in
// float64 over each block's own rows, the blocks' sums added in block
// order (one more barrier every check_every iterations), never formed
// from the planes.  What bounds it on this card: not the bytes (X is
// read once) nor the operations (~(4 k + 2) l flops and two quotients
// or four powers an entry an iteration, ~0.5 us of the card at a
// capture's 124,460 x 8), but an iteration's dependent chain: the
// quotients or powf of each row's 2 l entries on the row's thread, then
// the barrier's round trip through L2 and the P sets read back.  The
// design spreads the rows over every SM, keeps each entry's weights in
// registers (no weight plane in shared memory, so a sweep's 4 fits stay
// resident) and has one device-memory barrier an iteration.

// Entries of a K4 partial set: tiles of 4 components x 8 columns, each
// 32 entries of W^T num then 32 of W^T den (KL: the column sums of W at
// column 0 of the tiles of columns 0-7).
__host__ __device__ inline int beta_grid_nq(int l, int k) {
  return 64 * ((k + 3) / 4) * ((l + 7) / 8);
}

// Floats of a K4 grid block besides its rows: 33 doubles of float64
// scratch, H, KL's row sums of H, the fit's sums of the two planes (KL:
// of W^T num and the column sums of W), the block's partial set and the
// warps' sums of a tile (models/kernels/beta_cuda.py: grid_small_floats).
__host__ __device__ inline size_t beta_grid_small_floats(int l, int k, bool kl) {
  return 66 + 2 * (size_t)k * l + k + (kl ? (size_t)k : (size_t)k * l) +
         beta_grid_nq(l, k) + NMF_GRID_WARPS * 64;
}

// K4's plan: K1's rule with K4's small state, rows of k + l floats and
// sets of nq entries (models/kernels/beta_cuda.py: grid_plan).
inline int beta_grid_rule(int batch, int n, int l, int k, bool kl, int sms,
                          NmfGridPlan* plan) {
  const int r = nmf_grid_rule_sized(batch, n, l, k, sms, beta_grid_small_floats(l, k, kl),
                                    (long long)k + l, plan);
  if (r != 0) return r;
  plan->nq = beta_grid_nq(l, k);
  plan->pstride = (int)nmf_r4(plan->nq);
  return 0;
}

// Floats of K4's workspace: the fits' arrive counters, a float64
// divergence slot a block, two partial sets a block
// (models/kernels/beta_cuda.py: grid_workspace_floats).
inline size_t beta_grid_workspace_floats(const NmfGridPlan& p, int batch) {
  const size_t blocks = (size_t)batch * p.blocks;
  return nmf_r4(batch) + 2 * nmf_r4(blocks) + 2 * blocks * p.pstride;
}

struct BetaGrid {
  NmfGrid g;     // b.h: H, b.gram: KL's row sums of H; bpart, wred, y; the workspace
  float* nd;     // the fit's sums: W^T num (k, l), then W^T den (k, l) or the column sums of W (KL)
  double* red;   // 33 doubles of float64 reduction scratch
  double* err;   // the fit's divergence slots, one a block
  float beta, gamma;
  NmfPenalty pen;
};

template <int KIND>
__device__ inline BetaGrid beta_grid(float* smem, const NmfGridPlan& p, float* ws,
                                     int batch, size_t fit, int rank, float beta,
                                     float gamma, NmfPenalty pen) {
  BetaGrid bg;
  NmfGrid& g = bg.g;
  NmfBlock& b = g.b;
  bg.red = reinterpret_cast<double*>(smem);
  b.n = p.tile;
  b.l = p.l;
  b.k = p.k;
  b.ldx = b.ldw = 0;
  b.x = b.w = nullptr;
  b.cross = b.red = nullptr;
  b.h = smem + 66;
  b.gram = b.h + p.k * p.l;
  bg.nd = b.gram + p.k;
  g.bpart = bg.nd + p.k * p.l + (KIND == BETA_KL ? p.k : p.k * p.l);
  g.wred = g.bpart + p.nq;
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
  const size_t blocks = (size_t)batch * p.blocks;
  g.counter = reinterpret_cast<unsigned*>(ws) + fit;
  g.err = nullptr;
  bg.err = reinterpret_cast<double*>(ws + nmf_r4(batch)) + fit * p.blocks;
  g.part = ws + nmf_r4(batch) + 2 * nmf_r4(blocks) + fit * 2 * p.blocks * p.pstride;
  bg.beta = beta;
  bg.gamma = gamma;
  bg.pen = pen;
  return bg;
}

// The warps' sums of a tile's 64 entries (an: W^T num, ad: W^T den or
// KL's column sums) added to the block's set at entry 64 t: each warp's
// lanes by a reduce-scatter, then the warps in order.
__device__ inline void beta_grid_reduce(const NmfGrid& g, float (&an)[32], float (&ad)[32],
                                        int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  nmf_warp_halve<16>(an, lane);
  nmf_warp_halve<16>(ad, lane);
  g.wred[warp * 64 + lane] = an[0];
  g.wred[warp * 64 + 32 + lane] = ad[0];
  __syncthreads();
  if (threadIdx.x < 64) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NMF_GRID_WARPS; ++w) s += g.wred[w * 64 + threadIdx.x];
    g.bpart[64 * t + threadIdx.x] += s;
  }
  __syncthreads();
}

// One row's share of tile (i0, j0) of the H update's sums: the weights of
// the fresh WH (wr: the row's new W) at columns j0..j0+7 (y: the rows,
// column-major, stride ld; H in b.h), times p = W[row, i0..i0+3].
template <int KIND, int KMAX>
__device__ __forceinline__ void beta_grid_tile_row(const NmfBlock& b, const float* y,
                                                   int ld, int r, const float (&wr)[KMAX],
                                                   const float (&p)[4], int j0, float beta,
                                                   float (&an)[32], float (&ad)[32]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int m = j0 + jj;
    if (m < b.l) {
      float wh = 0.0f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < b.k) wh += wr[j] * b.h[j * b.l + m];
      }
      float a, d;
      beta_weights<KIND>(y[(size_t)(b.k + m) * ld + r], wh, beta, &a, &d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        an[8 * i + jj] += p[i] * a;
        if (KIND != BETA_KL) ad[8 * i + jj] += p[i] * d;
      }
    }
  }
  if (KIND == BETA_KL && j0 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ad[8 * i] += p[i];
  }
}

// The W pass on a pass's rows, one thread a row, with tile 0 (components
// 0-3, columns 0-7) of the H update's sums: the row's weights of the old
// WH update its W (b.gram: KL's row sums of H), then the fresh WH's
// weights add the row's share of tile 0; the warps' sums go to the set.
template <int KIND, int KMAX>
__device__ void beta_grid_w_pass(const BetaGrid& bg, const NmfGridRows& c) {
  const NmfBlock& b = bg.g.b;
  const int k = b.k, l = b.l, ld = c.ld;
  float* __restrict__ y = c.y;
  const float* __restrict__ h = b.h;
  const float beta = bg.beta;
  const NmfPenalty& pen = bg.pen;
  float an[32], ad[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) an[v] = ad[v] = 0.0f;
  for (int r = threadIdx.x; r < c.n; r += blockDim.x) {
    float wr[KMAX], num[KMAX], den[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      wr[i] = i < k ? y[(size_t)i * ld + r] : 0.0f;
      num[i] = den[i] = 0.0f;
    }
#pragma unroll 4
    for (int m = 0; m < l; ++m) {
      float wh = 0.0f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) wh += wr[j] * h[j * l + m];
      }
      float a, d;
      beta_weights<KIND>(y[(size_t)(k + m) * ld + r], wh, beta, &a, &d);
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) {
          const float hv = h[i * l + m];
          num[i] += a * hv;
          if (KIND != BETA_KL) den[i] += d * hv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) {
        float dd = KIND == BETA_KL ? b.gram[i] : den[i];
        dd = (dd + pen.l1_w) + pen.l2_w * wr[i];
        dd = dd == 0.0f ? EPSILON : dd;
        float v = wr[i] * beta_damp<KIND>(num[i] / dd, bg.gamma);
        if (beta_flush_w<KIND>(beta) && v < F64_EPS) v = 0.0f;
        wr[i] = v;
        y[(size_t)i * ld + r] = v;
      }
    }
    const float p[4] = {wr[0], wr[1], wr[2], wr[3]};  // KMAX >= 4; zero past k
    beta_grid_tile_row<KIND, KMAX>(b, y, ld, r, wr, p, 0, beta, an, ad);
  }
  beta_grid_reduce(bg.g, an, ad, 0);
}

// Tile t > 0 of the H update's sums over a pass's rows (their W already
// updated): each row rebuilds its fresh WH at the tile's 8 columns.
template <int KIND, int KMAX>
__device__ void beta_grid_tile_pass(const BetaGrid& bg, const NmfGridRows& c, int t) {
  const NmfBlock& b = bg.g.b;
  const int k = b.k, ld = c.ld, tj = (b.l + 7) / 8;
  const int i0 = 4 * (t / tj), j0 = 8 * (t % tj);
  const float* __restrict__ y = c.y;
  float an[32], ad[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) an[v] = ad[v] = 0.0f;
  for (int r = threadIdx.x; r < c.n; r += blockDim.x) {
    float wr[KMAX], p[4];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) wr[i] = i < k ? y[(size_t)i * ld + r] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = i0 + i < k ? y[(size_t)(i0 + i) * ld + r] : 0.0f;
    beta_grid_tile_row<KIND, KMAX>(b, y, ld, r, wr, p, j0, bg.beta, an, ad);
  }
  beta_grid_reduce(bg.g, an, ad, t);
}

// Whether entry q of a set holds a sum the H update reads (KL's den half
// holds only the column sums, at column 0).
__device__ __forceinline__ bool beta_grid_used(const NmfBlock& b, int q, bool kl,
                                               int* dst) {
  const int tj = (b.l + 7) / 8, t = q >> 6, v = q & 63;
  const bool den = v >= 32;
  const int i = 4 * (t / tj) + ((v & 31) >> 3), j = 8 * (t % tj) + (v & 7);
  if (i >= b.k || j >= b.l) return false;
  const int kl_ = b.k * b.l;
  if (!den) {
    *dst = i * b.l + j;
  } else if (!kl) {
    *dst = kl_ + i * b.l + j;
  } else if (j == 0) {
    *dst = kl_ + i;
  } else {
    return false;
  }
  return true;
}

// After a pass: the fit's sums of every block's partial set into bg.nd,
// the same bits in every block: the block's set to the workspace at
// `parity`, the fit's barrier, then each entry's P values added in block
// order 0..P-1 (a lone block: its own set).  `syncs` counts the fit's
// barriers.
template <int KIND>
__device__ inline void beta_grid_sum(const BetaGrid& bg, int parity, unsigned& syncs) {
  const NmfGrid& g = bg.g;
  __syncthreads();
  if (g.blocks > 1) {
    const float* sets = g.part + (size_t)parity * g.blocks * g.pstride;
    float* mine = g.part + ((size_t)parity * g.blocks + g.rank) * g.pstride;
    for (int q = threadIdx.x; q < g.nq; q += blockDim.x) __stcg(mine + q, g.bpart[q]);
    syncs += 1;
    nmf_grid_barrier(g.counter, syncs * g.blocks);
    for (int q = threadIdx.x; q < g.nq; q += blockDim.x) {
      int dst;
      if (beta_grid_used(g.b, q, KIND == BETA_KL, &dst)) {
        bg.nd[dst] = nmf_grid_ordered_sum(sets + q, g.blocks, g.pstride);
      }
    }
  } else {
    for (int q = threadIdx.x; q < g.nq; q += blockDim.x) {
      int dst;
      if (beta_grid_used(g.b, q, KIND == BETA_KL, &dst)) bg.nd[dst] = g.bpart[q];
    }
  }
  __syncthreads();
}

// One beta-MU iteration of the fit; `parity` picks the partial-set
// buffer.  xf / wf: the fit's X and W in device memory (read and written
// there only when streamed).
template <int KIND, int KMAX>
__device__ void beta_grid_step(const BetaGrid& bg, const float* xf, float* wf, int parity,
                               unsigned& syncs) {
  const NmfGrid& g = bg.g;
  for (int q = threadIdx.x; q < g.nq; q += blockDim.x) g.bpart[q] = 0.0f;
  if (KIND == BETA_KL) {
    beta_h_row_sums(g.b);  // its barrier also orders the zeroing
  } else {
    __syncthreads();
  }
  const int tiles = g.nq / 64;
  nmf_grid_chunks<true>(g, xf, wf, [&](const NmfGridRows& c) {
    beta_grid_w_pass<KIND, KMAX>(bg, c);
    for (int t = 1; t < tiles; ++t) beta_grid_tile_pass<KIND, KMAX>(bg, c, t);
  });
  beta_grid_sum<KIND>(bg, parity, syncs);
  beta_update_h<KIND>(g.b, bg.nd, bg.beta, bg.gamma, bg.pen);
}

// sklearn's square-rooted beta divergence of the fit, returned to every
// thread of every block: each block's float64 sum over its own rows, then
// the blocks' sums in block order.  A barrier of an iteration lies between
// two calls, so one slot a block suffices.  Out of line: one copy serves
// every KMAX.
template <int KIND>
__device__ __noinline__ double beta_grid_divergence(const BetaGrid& bg, const float* xf,
                                                    float* wf, unsigned& syncs) {
  const NmfGrid& g = bg.g;
  const NmfBlock& b = g.b;
  const double beta = bg.beta;
  double part = 0.0;
  nmf_grid_chunks<false>(g, xf, wf, [&](const NmfGridRows& c) {
    for (int r = threadIdx.x; r < c.n; r += blockDim.x) {
      for (int m = 0; m < b.l; ++m) {
        double wh = 0.0;
        for (int j = 0; j < b.k; ++j) {
          wh += (double)c.y[(size_t)j * c.ld + r] * (double)b.h[j * b.l + m];
        }
        part = beta_entry_divergence<KIND>(part, c.y[(size_t)(b.k + m) * c.ld + r], wh, beta);
      }
    }
  });
  const double total = nmf_grid_total_d(g.counter, bg.err, g.rank, g.blocks, syncs, bg.red,
                                        nmf_block_sum_d(bg.red, part));
  return beta_divergence_root<KIND>(total, beta);
}

// The stop is a run-time switch here, not a template one as in the block
// and warp entries: one kernel a kind and KMAX holds one copy of the
// iteration, where two made the source take minutes longer to build.
template <int KIND, int KMAX>
__global__ void __launch_bounds__(NMF_GRID_THREADS) beta_cluster_kernel(
    NmfGridPlan p, const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w, float* __restrict__ h,
    int* __restrict__ n_iter_out, float* __restrict__ prev_err_out,
    int* __restrict__ converged_out, float* __restrict__ ws, int batch, int iters,
    float beta, float gamma, double tol, int check_every, NmfPenalty pen, int with_stop) {
  extern __shared__ float smem[];
  const size_t fit = blockIdx.x / p.blocks;
  const BetaGrid bg = beta_grid<KIND>(smem, p, ws, batch, fit, (int)(blockIdx.x % p.blocks),
                                      beta, gamma, pen);
  const NmfGrid& g = bg.g;
  const float* xf = x + fit * p.n * p.l;
  float* wf = w + fit * p.n * p.k;
  nmf_grid_load(g, xf, w0 + fit * p.n * p.k, wf, h0 + fit * p.k * p.l);
  unsigned syncs = 0;
  int parity = 0;
  // sklearn's loop, as the block entry runs it (with the stop off, one
  // chunk of `iters` updates); every value that decides a branch is the
  // same in every block of the fit
  const double err0 = with_stop ? beta_grid_divergence<KIND>(bg, xf, wf, syncs) : 0.0;
  double prev_err = err0;
  int n_iter = 0;
  bool converged = false;
  while (n_iter < iters && !converged) {
    const int steps = with_stop ? min(check_every, iters - n_iter) : iters - n_iter;
    for (int t = 0; t < steps; ++t) {
      beta_grid_step<KIND, KMAX>(bg, xf, wf, parity, syncs);
      parity ^= 1;
    }
    n_iter += steps;
    if (with_stop && tol > 0.0) {
      const double err = beta_grid_divergence<KIND>(bg, xf, wf, syncs);
      converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
      prev_err = err;
    }
  }
  if (with_stop && g.rank == 0 && threadIdx.x == 0) {
    n_iter_out[fit] = n_iter;
    prev_err_out[fit] = (float)prev_err;
    converged_out[fit] = converged ? 1 : 0;
  }
  nmf_grid_store(g, wf, h + fit * p.k * p.l);
}

// Plan and launch the cluster entry of one kind and KMAX.
template <int KIND, int KMAX>
static int beta_cluster_dispatch(bool with_stop, const float* x, const float* w0,
                                 const float* h0, float* w, float* h, int* n_iter,
                                 float* prev_err, int* converged, int batch, int n, int l,
                                 int k, int iters, float beta, float gamma, double tol,
                                 int check_every, NmfPenalty pen, float* ws,
                                 long long ws_floats, int* plan_out, cudaStream_t s) {
  int sms = 0;
  int e = nmf_grid_sms(&sms);
  if (e != 0) return e;
  NmfGridPlan plan;
  e = beta_grid_rule(batch, n, l, k, KIND == BETA_KL, sms, &plan);
  if (e != 0) return e;
  const auto kernel = beta_cluster_kernel<KIND, KMAX>;
  e = nmf_grid_settle(kernel, batch, sms, plan, plan_out);
  if (e != 0) return e;
  return nmf_grid_launch(kernel, batch, plan, beta_grid_workspace_floats(plan, batch),
                         ws_floats, s, x, w0, h0, w, h, n_iter, prev_err, converged, ws,
                         batch, iters, beta, gamma, tol, check_every, pen, with_stop ? 1 : 0);
}

template <int KIND>
static int beta_cluster_dispatch_k(bool with_stop, const float* x, const float* w0,
                                   const float* h0, float* w, float* h, int* n_iter,
                                   float* prev_err, int* converged, int batch, int n, int l,
                                   int k, int iters, float beta, float gamma, double tol,
                                   int check_every, NmfPenalty pen, float* ws,
                                   long long ws_floats, int* plan_out, cudaStream_t s) {
#define BETA_CLUSTER_CALL(KM)                                                          \
  beta_cluster_dispatch<KIND, KM>(with_stop, x, w0, h0, w, h, n_iter, prev_err,        \
                                  converged, batch, n, l, k, iters, beta, gamma, tol,  \
                                  check_every, pen, ws, ws_floats, plan_out, s)
  return NMF_CLUSTER_DISPATCH(k, BETA_CLUSTER_CALL);
#undef BETA_CLUSTER_CALL
}

// The cluster entry: beta_nmf_f32's arguments and results, for frames
// over one block's shared memory (models/kernels/beta_cuda.py: route),
// and `ws`, a zeroed workspace of `ws_floats` floats (at least
// beta_grid_workspace_floats; beta_cuda.grid_workspace_floats).  Writes
// the plan it took to `plan_out` (NMF_GRID_PLAN_INTS host ints),
// launches once on `stream` and returns cudaGetLastError(), or the error
// that refused the plan.
extern "C" int beta_nmf_cluster_f32(const float* x, const float* w0,
                                    const float* h0, float* w, float* h,
                                    int* n_iter, float* prev_err,
                                    int* converged, int batch, int n, int l,
                                    int k, int iters, float beta, float gamma,
                                    double tol, int check_every, float l1_w,
                                    float l2_w, float l1_h, float l2_h,
                                    int with_stop, float* ws, long long ws_floats,
                                    int* plan_out, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0 ||
      !(gamma > 0.0f) || (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const bool st = with_stop != 0;
  if (beta == 1.0f) {
    return beta_cluster_dispatch_k<BETA_KL>(st, x, w0, h0, w, h, n_iter, prev_err,
                                            converged, batch, n, l, k, iters, beta, gamma,
                                            tol, check_every, pen, ws, ws_floats, plan_out,
                                            s);
  }
  if (beta == 0.0f) {
    return beta_cluster_dispatch_k<BETA_IS>(st, x, w0, h0, w, h, n_iter, prev_err,
                                            converged, batch, n, l, k, iters, beta, gamma,
                                            tol, check_every, pen, ws, ws_floats, plan_out,
                                            s);
  }
  return beta_cluster_dispatch_k<BETA_GENERIC>(st, x, w0, h0, w, h, n_iter, prev_err,
                                               converged, batch, n, l, k, iters, beta,
                                               gamma, tol, check_every, pen, ws, ws_floats,
                                               plan_out, s);
}
