// Batched convolutive NMF (time-varying synergies), one thread block
// per fit.
//
// Replaces the TPU kernel `cnmf_iterations_pallas`
// (muscle_synergies_tpu/models/kernels/cnmf_pallas.py: _cnmf_step) and
// the chunked driver around it (models/cnmf.py: _fit_cnmf_batch_pallas).
// The model is X[t, l] ~ sum_k sum_d C[t-d, k] S[k, d, l].  The Pallas
// kernel laid 128 trials across the vector lanes and made the causal
// shifts sublane concat-slices; here each fit is a thread block with X
// (T, L), C (T, K), S (K, D, L) and the reconstruction Xh (T, L) in
// shared memory (about 20 KB at T=200, L=8, K=4, D=10), and a shift is
// an index offset into shared memory, not a copy:
//   - reconstruction: one thread per entry (t, l) of Xh sums K*D terms;
//   - S update: one thread per entry (k, d, l) reduces over time,
//     sum_t C[t-d, k] X[t, l] over sum_t C[t-d, k] Xh[t, l];
//   - C update, after a reconstruction with the fresh S: one thread per
//     entry (k, t), consecutive threads on consecutive t, takes the
//     look-ahead sums sum_d sum_l X[t+d, l] S[k, d, l] over the same
//     with Xh, zero past the end of the trial;
//   - the den == 0 -> EPSILON guard on both quotients;
//   - the stopping rule inside the block (WITH_STOP): the Frobenius
//     error, reconstructed and summed in float64, every `check_every`
//     iterations; like the JAX driver there is no tail chunk, so the
//     count moves in steps of `check_every` and may pass max_iter, and
//     the improvement is divided by max(err0, EPSILON).  A converged
//     block simply ends.
// The C update reads X[t+d] across the whole trial, which is why the
// block holds all of X.
//
// What bounds it on this card: six passes of K*D*L*T multiply-adds per
// iteration (about 770 KFLOP per fit at T=200, L=8, K=4, D=10) in
// float32 on CUDA cores, fed from shared memory; device memory is
// touched only at the start and the end of the solve.

#include "nmf_common.cuh"

#define EPSILON 1.1920929e-07f

struct CnmfBlock {
  int t, l, k, d;
  int ldx, ldc;
  float* x;     // (t, ldx)
  float* xh;    // (t, ldx) reconstruction
  float* c;     // (t, ldc)
  float* s;     // (k, d, l)
  double* red;  // 33 doubles of float64 reduction scratch
};

__host__ __device__ inline size_t cnmf_smem_floats(int t, int l, int k,
                                                   int d) {
  size_t f = 2 * (size_t)t * nmf_odd(l) + (size_t)t * nmf_odd(k) +
             (size_t)k * d * l;
  f += f & 1;  // 8-byte alignment of the double scratch
  return f + 2 * 33;
}

__device__ inline CnmfBlock cnmf_block(float* smem, int t, int l, int k,
                                       int d) {
  CnmfBlock b;
  b.t = t;
  b.l = l;
  b.k = k;
  b.d = d;
  b.ldx = nmf_odd(l);
  b.ldc = nmf_odd(k);
  b.x = smem;
  b.xh = b.x + (size_t)t * b.ldx;
  b.c = b.xh + (size_t)t * b.ldx;
  b.s = b.c + (size_t)t * b.ldc;
  b.red = (double*)(smem + cnmf_smem_floats(t, l, k, d) - 2 * 33);
  return b;
}

__device__ inline void cnmf_load(const CnmfBlock& b, const float* x,
                                 const float* c, const float* s) {
  for (int i = threadIdx.x; i < b.t * b.l; i += blockDim.x) {
    b.x[(i / b.l) * b.ldx + i % b.l] = x[i];
  }
  for (int i = threadIdx.x; i < b.t * b.k; i += blockDim.x) {
    b.c[(i / b.k) * b.ldc + i % b.k] = c[i];
  }
  for (int i = threadIdx.x; i < b.k * b.d * b.l; i += blockDim.x) {
    b.s[i] = s[i];
  }
  __syncthreads();
}

__device__ inline void cnmf_store(const CnmfBlock& b, float* c, float* s) {
  for (int i = threadIdx.x; i < b.t * b.k; i += blockDim.x) {
    c[i] = b.c[(i / b.k) * b.ldc + i % b.k];
  }
  for (int i = threadIdx.x; i < b.k * b.d * b.l; i += blockDim.x) {
    s[i] = b.s[i];
  }
}

// Xh[t, l] = sum_k sum_{d <= t} C[t-d, k] S[k, d, l].
__device__ void cnmf_reconstruct(const CnmfBlock& b) {
  const int dl = b.d * b.l;
  for (int q = threadIdx.x; q < b.t * b.l; q += blockDim.x) {
    const int t = q / b.l;
    const int m = q - t * b.l;
    float acc = 0.0f;
    for (int d = 0; d < b.d && d <= t; ++d) {
      const float* cr = b.c + (t - d) * b.ldc;
      const float* sp = b.s + d * b.l + m;
      for (int k = 0; k < b.k; ++k) acc += cr[k] * sp[k * dl];
    }
    b.xh[t * b.ldx + m] = acc;
  }
  __syncthreads();
}

// One multiplicative update of S then C (cnmf_update's order).
__device__ void cnmf_step(const CnmfBlock& b) {
  const int dl = b.d * b.l;
  // ---- S: time-reduced projections against the current C ----
  cnmf_reconstruct(b);
  for (int q = threadIdx.x; q < b.k * dl; q += blockDim.x) {
    const int k = q / dl;
    const int d = (q - k * dl) / b.l;
    const int m = q - k * dl - d * b.l;
    float num = 0.0f, den = 0.0f;
    for (int t = d; t < b.t; ++t) {
      const float cv = b.c[(t - d) * b.ldc + k];
      num += cv * b.x[t * b.ldx + m];
      den += cv * b.xh[t * b.ldx + m];
    }
    den = den == 0.0f ? EPSILON : den;
    b.s[q] = b.s[q] * (num / den);
  }
  __syncthreads();

  // ---- C: look-ahead lag sums against the fresh S ----
  cnmf_reconstruct(b);
  for (int q = threadIdx.x; q < b.k * b.t; q += blockDim.x) {
    const int k = q / b.t;
    const int t = q - k * b.t;
    const int d_end = min(b.d, b.t - t);
    float num = 0.0f, den = 0.0f;
    for (int d = 0; d < d_end; ++d) {
      const float* xr = b.x + (t + d) * b.ldx;
      const float* hr = b.xh + (t + d) * b.ldx;
      const float* sp = b.s + k * dl + d * b.l;
      for (int m = 0; m < b.l; ++m) {
        num += xr[m] * sp[m];
        den += hr[m] * sp[m];
      }
    }
    den = den == 0.0f ? EPSILON : den;
    b.c[t * b.ldc + k] = b.c[t * b.ldc + k] * (num / den);
  }
  __syncthreads();
}

// ||X - Xh||_F of the block's fit, reconstructed and summed in float64,
// returned to every thread.
__device__ double cnmf_error(const CnmfBlock& b) {
  const int dl = b.d * b.l;
  double part = 0.0;
  for (int q = threadIdx.x; q < b.t * b.l; q += blockDim.x) {
    const int t = q / b.l;
    const int m = q - t * b.l;
    double acc = 0.0;
    for (int d = 0; d < b.d && d <= t; ++d) {
      const float* cr = b.c + (t - d) * b.ldc;
      const float* sp = b.s + d * b.l + m;
      for (int k = 0; k < b.k; ++k) acc += (double)cr[k] * (double)sp[k * dl];
    }
    const double diff = (double)b.x[t * b.ldx + m] - acc;
    part += diff * diff;
  }
  return sqrt(nmf_block_sum_d(b.red, part));
}

template <bool WITH_STOP>
__global__ void __launch_bounds__(NMF_THREADS) cnmf_kernel(
    const float* __restrict__ x, const float* __restrict__ c0,
    const float* __restrict__ s0, float* __restrict__ c,
    float* __restrict__ s, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int t, int l, int k, int d, int iters, double tol, int check_every) {
  extern __shared__ float smem[];
  const CnmfBlock b = cnmf_block(smem, t, l, k, d);
  const size_t fit = blockIdx.x;
  cnmf_load(b, x + fit * t * l, c0 + fit * t * k, s0 + fit * k * d * l);
  if (WITH_STOP) {
    const double err0 = cnmf_error(b);
    const double scale = fmax(err0, (double)EPSILON);
    double prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      for (int i = 0; i < check_every; ++i) cnmf_step(b);
      n_iter += check_every;
      const double err = cnmf_error(b);
      converged = (prev_err - err) / scale < tol;
      prev_err = err;
    }
    if (threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = (float)prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int i = 0; i < iters; ++i) cnmf_step(b);
  }
  cnmf_store(b, c + fit * t * k, s + fit * k * d * l);
}

// x (B, T, L), c0/c (B, T, K), s0/s (B, K, D, L) float32; n_iter,
// prev_err, converged (B,) written only when with_stop.  `iters` is
// max_iter with the stop and the fixed iteration count without it.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int cnmf_f32(const float* x, const float* c0, const float* s0,
                        float* c, float* s, int* n_iter, float* prev_err,
                        int* converged, int batch, int t, int l, int k, int d,
                        int iters, double tol, int check_every, int with_stop,
                        void* stream) {
  if (batch < 1 || t < 1 || l < 1 || k < 1 || d < 1 || d > t || iters < 0 ||
      (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = cnmf_smem_floats(t, l, k, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (with_stop) {
    return nmf_launch(cnmf_kernel<true>, batch, smem, st, x, c0, s0, c, s,
                      n_iter, prev_err, converged, t, l, k, d, iters, tol,
                      check_every);
  }
  return nmf_launch(cnmf_kernel<false>, batch, smem, st, x, c0, s0, c, s,
                    n_iter, prev_err, converged, t, l, k, d, iters, tol,
                    check_every);
}
