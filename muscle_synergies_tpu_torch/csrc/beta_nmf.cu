// Batched beta-divergence multiplicative-update NMF: a warp-per-fit
// entry for the time-normalised frames of the main paths, a
// block-per-fit entry for larger frames, and a cluster-per-fit entry for
// frames over one block's shared memory (at the end of this file).
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
// K=4): one block of 128 threads per fit.  What bounds it: about 51
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
// striding over the rows; ADD adds each sum to nd[q] instead of storing it.
template <int KIND, bool ADD>
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
    if (lane == 0) nd[q] = ADD ? nd[q] + s : s;
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
  beta_wt_weights<KIND, false>(b, bb.num, bb.den, bb.nd);
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
// beta_nmf_cluster_f32: one thread-block cluster per fit, for frames
// whose fit exceeds one block's shared memory (nmf_common.cuh: the
// cluster entries; rows resident in shared memory or streamed through
// L2 in tiles).  An iteration keeps sklearn's order, W then H, in one
// pass over the block's rows: each row of W is updated from its row of
// WH (old W, old H: row-local), its row of WH is rebuilt at once from
// the new W and the old H, and the row's weights X * max(WH,
// eps)^(beta-2) and WH^(beta-1) go to per-tile planes, whose share of
// W^T (weights) (KL: W^T (X / WH) and the column sums of W) each block
// adds to its two (k, l) partial planes.  After a cluster barrier every
// block sums the C blocks' planes in rank order over distributed shared
// memory and updates H from the same numbers, so H is the same bits in
// every block.  The float64-eps flushes of W (beta < 1) and H (beta <=
// 1) and the max(WH, EPSILON) clamps are the block entry's.  The stop
// is sklearn's beta divergence summed in float64 over each block's own
// rows (KL: X log(X / WH) - X + WH; IS: X / WH - log(X / WH) - 1), the
// blocks' sums added in rank order, never formed from the planes; every
// block takes each branch from the same numbers, and a last cluster
// barrier keeps any block from leaving while another reads its shared
// memory.  What bounds it: as K1's cluster entry, with one divide (KL),
// or two powers (a run-time beta), per entry of WH twice an iteration.

// Floats of a cluster block's own state besides nmf_cluster's (two (k,
// l) planes a parity): the cluster's sums of the planes, one float to
// align 34 doubles of float64 reduction scratch and the divergence.
__host__ __device__ inline int beta_cluster_extra(int l, int k) {
  return 2 * k * l + 1 + 2 * 34;
}

// All the floats a cluster block keeps besides its rows
// (models/kernels/beta_cuda.py mirrors it: cluster_smem_bytes).
__host__ __device__ inline size_t beta_cluster_small_floats(int l, int k) {
  return 2 * (size_t)k * l + (size_t)k * k + 34 + 4 * (size_t)k * l +
         beta_cluster_extra(l, k);
}

struct BetaCluster {
  NmfCluster c;   // b.gram holds KL's row sums of H
  float* num;     // (tile, ldx) numerator weights of the rows' fresh WH
  float* den;     // (tile, ldx) denominator weights (not KL)
  float* nd;      // (2, k, l): the cluster's W^T num, then W^T den (KL: column sums of W)
  double* red;    // 33 doubles of float64 reduction scratch
  double* err;    // the block's share of the divergence
  float beta, gamma;
  NmfPenalty pen;
};

__device__ inline BetaCluster beta_cluster(float* smem, const NmfClusterPlan& p,
                                           int rank, float beta, float gamma,
                                           NmfPenalty pen) {
  BetaCluster bc;
  bc.c = nmf_cluster_sized(smem, p, rank, 2 * p.k * p.l, beta_cluster_extra(p.l, p.k));
  bc.nd = bc.c.err + 1;  // nmf_cluster's `extra` floats
  size_t off = (size_t)(bc.nd + 2 * p.k * p.l - smem);
  off += off & 1;  // 8-byte alignment of the doubles
  bc.red = (double*)(smem + off);
  bc.err = bc.red + 33;
  bc.num = nmf_cluster_rows_end(bc.c);
  bc.den = bc.num + (size_t)bc.c.tile * bc.c.b.ldx;
  bc.beta = beta;
  bc.gamma = gamma;
  bc.pen = pen;
  return bc;
}

// One beta-MU iteration of the cluster's fit; `parity` picks the
// partial-plane buffer.  xf / wf: the fit's X and W in device memory
// (W is read and written there only when streamed).
template <int KIND, int KMAX>
__device__ void beta_cluster_step(const BetaCluster& bc, nmf_cg::cluster_group& cl,
                                  const float* xf, float* wf, int parity) {
  const NmfCluster& c = bc.c;
  const NmfBlock& b = c.b;
  const int kl = b.k * b.l;
  const int entries = KIND == BETA_KL ? kl + b.k : 2 * kl;
  float* part = c.part + parity * c.pstride;
  for (int q = threadIdx.x; q < entries; q += blockDim.x) part[q] = 0.0f;
  if (KIND == BETA_KL) {
    beta_h_row_sums(b);  // its barrier also orders the zeroing
  } else {
    __syncthreads();
  }
  nmf_cluster_tiles<true>(c, xf, wf, [&](const NmfBlock& t) {
    for (int n = threadIdx.x; n < t.n; n += blockDim.x) {
      float wr[KMAX];
      beta_w_row<KIND, KMAX>(t, n, bc.beta, bc.gamma, bc.pen, wr);
      // the weights of the row's fresh WH: the new W, the old H
      for (int m = 0; m < t.l; ++m) {
        float wh = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < t.k) wh += wr[j] * t.h[j * t.l + m];
        }
        float a, d;
        beta_weights<KIND>(t.x[n * t.ldx + m], wh, bc.beta, &a, &d);
        bc.num[n * t.ldx + m] = a;
        if (KIND != BETA_KL) bc.den[n * t.ldx + m] = d;
      }
    }
    __syncthreads();
    beta_wt_weights<KIND, true>(t, bc.num, bc.den, part);
  });
  cl.sync();  // every block's planes are readable
  for (int q = threadIdx.x; q < entries; q += blockDim.x) {
    bc.nd[q] = nmf_cluster_sum(cl, part, q);
  }
  __syncthreads();
  beta_update_h<KIND>(b, bc.nd, bc.beta, bc.gamma, bc.pen);
}

// sklearn's square-rooted beta divergence of the cluster's fit, returned
// to every thread of every block: each block's float64 sum over its own
// rows, then the blocks' sums in rank order.  At least one cluster
// barrier of an iteration lies between two calls, so one slot a block
// suffices.
template <int KIND>
__device__ double beta_cluster_divergence(const BetaCluster& bc,
                                          nmf_cg::cluster_group& cl,
                                          const float* xf, float* wf) {
  const double beta = bc.beta;
  double part = 0.0;
  nmf_cluster_tiles<false>(bc.c, xf, wf, [&](const NmfBlock& t) {
    for (int q = threadIdx.x; q < t.n * t.l; q += blockDim.x) {
      const int n = q / t.l;
      const int m = q - n * t.l;
      double wh = 0.0;
      for (int j = 0; j < t.k; ++j) {
        wh += (double)t.w[n * t.ldw + j] * (double)t.h[j * t.l + m];
      }
      part = beta_entry_divergence<KIND>(part, t.x[n * t.ldx + m], wh, beta);
    }
  });
  const double mine = nmf_block_sum_d(bc.red, part);
  if (threadIdx.x == 0) *bc.err = mine;
  cl.sync();
  return beta_divergence_root<KIND>(nmf_cluster_sum_d(cl, bc.err, 0), beta);
}

template <int KIND, int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_CLUSTER_THREADS) beta_cluster_kernel(
    NmfClusterPlan p, const float* __restrict__ x,
    const float* __restrict__ w0, const float* __restrict__ h0,
    float* __restrict__ w, float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int iters, float beta, float gamma, double tol, int check_every,
    NmfPenalty pen) {
  extern __shared__ float smem[];
  nmf_cg::cluster_group cl = nmf_cg::this_cluster();
  const size_t fit = blockIdx.x / cl.num_blocks();
  const BetaCluster bc = beta_cluster(smem, p, (int)cl.block_rank(), beta, gamma, pen);
  const float* xf = x + fit * p.n * p.l;
  float* wf = w + fit * p.n * p.k;
  nmf_cluster_load(bc.c, xf, w0 + fit * p.n * p.k, wf, h0 + fit * p.k * p.l);
  int parity = 0;
  if (WITH_STOP) {
    // sklearn's loop, as the block entry runs it; every value that
    // decides a branch is the same in every block of the cluster
    const double err0 = beta_cluster_divergence<KIND>(bc, cl, xf, wf);
    double prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const int steps = min(check_every, iters - n_iter);
      for (int t = 0; t < steps; ++t) {
        beta_cluster_step<KIND, KMAX>(bc, cl, xf, wf, parity);
        parity ^= 1;
      }
      n_iter += steps;
      if (tol > 0.0) {
        const double err = beta_cluster_divergence<KIND>(bc, cl, xf, wf);
        converged = (prev_err - err) / err0 < tol && n_iter % check_every == 0;
        prev_err = err;
      }
    }
    if (bc.c.rank == 0 && threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = (float)prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) {
      beta_cluster_step<KIND, KMAX>(bc, cl, xf, wf, parity);
      parity ^= 1;
    }
  }
  cl.sync();  // no block leaves while another reads its shared memory
  nmf_cluster_store(bc.c, wf, h + fit * p.k * p.l);
}

// Plan and launch the cluster entry of one kind and KMAX.
template <int KIND, int KMAX>
static int beta_cluster_dispatch(bool with_stop, const float* x, const float* w0,
                                 const float* h0, float* w, float* h, int* n_iter,
                                 float* prev_err, int* converged, int batch,
                                 int n, int l, int k, int iters, float beta,
                                 float gamma, double tol, int check_every,
                                 NmfPenalty pen, cudaStream_t s) {
  const size_t small = beta_cluster_small_floats(l, k);
  const size_t row = (size_t)nmf_odd(l) + nmf_odd(k);
  const size_t planes = (KIND == BETA_KL ? 1 : 2) * (size_t)nmf_odd(l);
  auto run = [&](auto kernel) {
    NmfClusterPlan plan;
    const int e = nmf_cluster_plan_sized(kernel, n, l, k, small, row, planes, &plan);
    if (e != 0) return e;
    return nmf_cluster_launch(kernel, plan, batch, s, x, w0, h0, w, h, n_iter,
                              prev_err, converged, iters, beta, gamma, tol,
                              check_every, pen);
  };
  return with_stop ? run(beta_cluster_kernel<KIND, KMAX, true>)
                   : run(beta_cluster_kernel<KIND, KMAX, false>);
}

template <int KIND>
static int beta_cluster_dispatch_k(bool with_stop, const float* x,
                                   const float* w0, const float* h0, float* w,
                                   float* h, int* n_iter, float* prev_err,
                                   int* converged, int batch, int n, int l,
                                   int k, int iters, float beta, float gamma,
                                   double tol, int check_every, NmfPenalty pen,
                                   cudaStream_t s) {
#define BETA_CLUSTER_CALL(KM)                                                  \
  beta_cluster_dispatch<KIND, KM>(with_stop, x, w0, h0, w, h, n_iter,          \
                                  prev_err, converged, batch, n, l, k, iters,  \
                                  beta, gamma, tol, check_every, pen, s)
  return NMF_CLUSTER_DISPATCH(k, BETA_CLUSTER_CALL);
#undef BETA_CLUSTER_CALL
}

// The cluster entry: beta_nmf_f32's arguments and results, for frames
// over one block's shared memory (models/kernels/beta_cuda.py: route).
// Launches one cluster a fit on `stream` and returns cudaGetLastError(),
// or the error that left no cluster able to run the fit.
extern "C" int beta_nmf_cluster_f32(const float* x, const float* w0,
                                    const float* h0, float* w, float* h,
                                    int* n_iter, float* prev_err,
                                    int* converged, int batch, int n, int l,
                                    int k, int iters, float beta, float gamma,
                                    double tol, int check_every, float l1_w,
                                    float l2_w, float l1_h, float l2_h,
                                    int with_stop, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0 ||
      !(gamma > 0.0f) || (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const bool st = with_stop != 0;
  if (beta == 1.0f) {
    return beta_cluster_dispatch_k<BETA_KL>(st, x, w0, h0, w, h, n_iter,
                                            prev_err, converged, batch, n, l,
                                            k, iters, beta, gamma, tol,
                                            check_every, pen, s);
  }
  if (beta == 0.0f) {
    return beta_cluster_dispatch_k<BETA_IS>(st, x, w0, h0, w, h, n_iter,
                                            prev_err, converged, batch, n, l,
                                            k, iters, beta, gamma, tol,
                                            check_every, pen, s);
  }
  return beta_cluster_dispatch_k<BETA_GENERIC>(st, x, w0, h0, w, h, n_iter,
                                               prev_err, converged, batch, n,
                                               l, k, iters, beta, gamma, tol,
                                               check_every, pen, s);
}
