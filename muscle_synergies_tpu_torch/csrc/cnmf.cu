// Batched convolutive NMF (time-varying synergies), one thread block
// per fit, register-tiled.
//
// Replaces the TPU kernel `cnmf_iterations_pallas`
// (muscle_synergies_tpu/models/kernels/cnmf_pallas.py: _cnmf_step) and
// the chunked driver around it (models/cnmf.py: _fit_cnmf_batch_pallas).
// The model is X[t, l] ~ sum_k sum_d C[t-d, k] S[k, d, l].  The Pallas
// kernel laid 128 trials across the vector lanes and made the causal
// shifts sublane concat-slices; here each fit is a thread block with X
// (T, L), its reconstruction Xh (T, L), C (stored as C^T, (K, T)) and
// S (K, D, L) in shared memory, and a shift is an index offset.
//
// What bounded the first design (one thread per output entry): every
// multiply-add read both its operands from shared memory as scalars,
// about two shared-memory wavefronts per warp-FMA, so the SM's one
// wavefront a cycle held the kernel near 1/8 of its FMA rate (measured
// 8.2% of the operations bound), and the path's tail (the longest fit,
// ~28,500 iterations, alone on its SM) ran at that latency.
//
// This design keeps one operand in registers and makes the other a
// broadcast, so that one wavefront feeds 8 or more FMAs:
//   - reconstruction: one thread per two rows t and t + 128 holds the
//     8 outputs of an L-tile of each; per (d, k) it loads C[t-d, k] of
//     each row (consecutive threads, consecutive addresses of C^T) and
//     S[k, d, tile] once, as two float4 broadcasts, for both rows;
//   - S update: threads over (k, d) pairs, in G groups that split time;
//     a group's threads walk the same t together, so X[t, tile] and
//     Xh[t, tile] are broadcasts and each thread keeps num[8] and den[8]
//     in registers; groups 1..G-1 leave their partial sums in shared
//     memory and group 0 adds them (in group order) and updates S;
//   - C update, after a reconstruction with the fresh S: one thread per
//     t holds num and den for 4 synergies; per d it reads X[t+d, tile]
//     and Xh[t+d, tile] as float4 vectors and S[k, d, tile] as
//     broadcasts, zero past the end of the trial.
// Rows of X and Xh are L rounded up to a power of two (at least 8)
// floats, zero-padded, with their 16-byte chunks XOR-swizzled by row so
// that 8 threads on 8 consecutive rows hit 8 distinct bank groups.  At
// T=200, L=8, K=4, D=10 a fit needs 22.7 KB and at most 64 registers a
// thread, so 8 blocks fit on an SM and all 1,024 fits of the
// time-varying path are resident at once.  Five barriers an iteration:
// reconstruct, S partial sums, S update, reconstruct, C update.
//
// Semantics as before, and as cnmf_update: S then C; the den == 0 ->
// EPSILON guard on both quotients; the stopping rule inside the block
// (WITH_STOP): the Frobenius error, reconstructed and summed in float64,
// every `check_every` iterations, off the per-iteration path; like the
// JAX driver there is no tail chunk, so the count moves in steps of
// `check_every` and may pass max_iter, and the improvement is divided
// by max(err0, EPSILON).  A converged block simply ends.
//
// What bounds it now: six passes of K*D*L*T float32 multiply-adds per
// iteration (about 770 KFLOP per fit at T=200, L=8, K=4, D=10) on CUDA
// cores, and for the path's tail the latency of one lone block's
// iteration; device memory is touched only at the start and the end.
// TF32 tensor cores are not used: at L = 8 the products are tiny, and
// ~10^4 multiplicative iterations would not hold 1e-3 at TF32's
// precision.

#include "nmf_common.cuh"

#define EPSILON 1.1920929e-07f
#define CNMF_LT 8  // L-tile: accumulators a thread keeps per row
#define CNMF_KT 4  // synergies a thread updates at once in the C update

struct CnmfBlock {
  int t, l, k, d;
  int lp;      // row stride of X, Xh and S: L rounded up to 2^j >= 8
  int sh;      // swizzle shift: row t's chunks are XORed with (t >> sh)
  int groups;  // time slices of the S update
  float* x;    // (t, lp), swizzled
  float* xh;   // (t, lp), swizzled
  float* ct;   // (k, t): C transposed, padded to a multiple of 4
  float* s;    // (k, d, lp)
  float* part; // 16 x (groups - 1) * k * d partial sums of the S update
  double* red; // 33 doubles of float64 reduction scratch
};

__host__ __device__ inline int cnmf_lp(int l) {
  int lp = CNMF_LT;
  while (lp < l) lp *= 2;
  return lp;
}

__host__ __device__ inline int cnmf_groups(int k, int d) {
  const int g = NMF_THREADS / (k * d);
  return g < 1 ? 1 : (g > 4 ? 4 : g);
}

// C^T's floats, rounded up to keep S 16-byte aligned.
__host__ __device__ inline size_t cnmf_ct_floats(int t, int k) {
  return ((size_t)k * t + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t cnmf_smem_floats(int t, int l, int k,
                                                   int d) {
  const size_t lp = cnmf_lp(l), p = (size_t)k * d;
  size_t f = 2 * (size_t)t * lp + cnmf_ct_floats(t, k) + p * lp +
             16 * (cnmf_groups(k, d) - 1) * p;
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
  b.lp = cnmf_lp(l);
  const int nc = b.lp / 4;  // 16-byte chunks per row
  b.sh = nc == 2 ? 2 : (nc == 4 ? 1 : 0);
  b.groups = cnmf_groups(k, d);
  b.x = smem;
  b.xh = b.x + (size_t)t * b.lp;
  b.ct = b.xh + (size_t)t * b.lp;
  b.s = b.ct + cnmf_ct_floats(t, k);
  b.part = b.s + (size_t)k * d * b.lp;
  b.red = (double*)(smem + cnmf_smem_floats(t, l, k, d) - 2 * 33);
  return b;
}

// Offset of the 16-byte chunk `c` of row `t` in X or Xh.
__device__ inline int cnmf_chunk(const CnmfBlock& b, int t, int c) {
  return t * b.lp + 4 * (c ^ ((t >> b.sh) & (b.lp / 4 - 1)));
}

__device__ inline int cnmf_xidx(const CnmfBlock& b, int t, int m) {
  return cnmf_chunk(b, t, m >> 2) + (m & 3);
}

// The 8 values of L-tile `j` of row `t` (X or Xh).
__device__ inline void cnmf_row_tile(const CnmfBlock& b, const float* a,
                                     int t, int j, float* v) {
  const float4 lo = *(const float4*)(a + cnmf_chunk(b, t, 2 * j));
  const float4 hi = *(const float4*)(a + cnmf_chunk(b, t, 2 * j + 1));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// S[k, d, tile j] (a broadcast when every thread asks for the same one).
__device__ inline void cnmf_s_tile(const CnmfBlock& b, int k, int d, int j,
                                   float* v) {
  const float4* sp = (const float4*)(b.s + (k * b.d + d) * b.lp + CNMF_LT * j);
  const float4 lo = sp[0], hi = sp[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ inline void cnmf_load(const CnmfBlock& b, const float* x,
                                 const float* c, const float* s) {
  for (int i = threadIdx.x; i < b.t * b.lp; i += blockDim.x) {
    const int t = i / b.lp, m = i - t * b.lp;
    b.x[cnmf_xidx(b, t, m)] = m < b.l ? x[t * b.l + m] : 0.0f;
  }
  for (int i = threadIdx.x; i < b.t * b.k; i += blockDim.x) {
    b.ct[(i % b.k) * b.t + i / b.k] = c[i];
  }
  for (int i = threadIdx.x; i < b.k * b.d * b.lp; i += blockDim.x) {
    const int r = i / b.lp, m = i - r * b.lp;
    b.s[i] = m < b.l ? s[r * b.l + m] : 0.0f;
  }
  __syncthreads();
}

__device__ inline void cnmf_store(const CnmfBlock& b, float* c, float* s) {
  for (int i = threadIdx.x; i < b.t * b.k; i += blockDim.x) {
    c[i] = b.ct[(i % b.k) * b.t + i / b.k];
  }
  for (int i = threadIdx.x; i < b.k * b.d * b.l; i += blockDim.x) {
    const int r = i / b.l;
    s[i] = b.s[r * b.lp + i - r * b.l];
  }
}

// Rows t, t + blockDim.x, ... (R of them, those past T masked) of
// Xh[t, l] = sum_{d <= t} sum_k C[t-d, k] S[k, d, l], summed over d then
// k as before; the rows share each S broadcast, and a masked term adds
// an exact 0.  Padded columns come out 0 because S's are.
template <int R>
__device__ inline void cnmf_reconstruct_rows(const CnmfBlock& b, int t) {
  const int step = blockDim.x;
  const int dmax = min(b.d - 1, min(t + (R - 1) * step, b.t - 1));
  for (int j = 0; j < b.lp / CNMF_LT; ++j) {
    float acc[R][CNMF_LT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) acc[r][i] = 0.0f;
    }
    for (int d = 0; d <= dmax; ++d) {
#pragma unroll 2
      for (int k = 0; k < b.k; ++k) {
        float sv[CNMF_LT];
        cnmf_s_tile(b, k, d, j, sv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int tr = t + r * step;
          const float cv = tr < b.t && d <= tr ? b.ct[k * b.t + tr - d] : 0.0f;
#pragma unroll
          for (int i = 0; i < CNMF_LT; ++i) acc[r][i] += cv * sv[i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tr = t + r * step;
      if (tr < b.t) {
        *(float4*)(b.xh + cnmf_chunk(b, tr, 2 * j)) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *(float4*)(b.xh + cnmf_chunk(b, tr, 2 * j + 1)) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
}

// Xh from the current C and S: each thread takes two rows (t and
// t + blockDim.x) where its warp has any second row, else one.
__device__ void cnmf_reconstruct(const CnmfBlock& b) {
  for (int t = threadIdx.x; t < b.t; t += 2 * blockDim.x) {
    if ((t & ~31) + (int)blockDim.x < b.t) {
      cnmf_reconstruct_rows<2>(b, t);
    } else {
      cnmf_reconstruct_rows<1>(b, t);
    }
  }
  __syncthreads();
}

// num and den of pair (k, d) on L-tile j over t in [t0, t1), t >= d,
// added to the registers num[8], den[8].  Every thread of a group walks
// the same t, so the X and Xh rows are broadcasts.
__device__ inline void cnmf_s_sums(const CnmfBlock& b, int k, int d, int j,
                                   int t0, int t1, float* num, float* den) {
  const float* crow = b.ct + k * b.t - d;
#pragma unroll 2
  for (int t = t0; t < t1; ++t) {
    if (t >= d) {
      const float cv = crow[t];
      float xv[CNMF_LT], hv[CNMF_LT];
      cnmf_row_tile(b, b.x, t, j, xv);
      cnmf_row_tile(b, b.xh, t, j, hv);
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) {
        num[i] += cv * xv[i];
        den[i] += cv * hv[i];
      }
    }
  }
}

__device__ inline void cnmf_s_apply(const CnmfBlock& b, int p, int j,
                                    const float* num, float* den) {
  float* sp = b.s + p * b.lp + CNMF_LT * j;
#pragma unroll
  for (int i = 0; i < CNMF_LT; ++i) {
    if (CNMF_LT * j + i < b.l) {
      const float dn = den[i] == 0.0f ? EPSILON : den[i];
      sp[i] = sp[i] * (num[i] / dn);
    }
  }
}

// S <- S * (sum_t C[t-d, k] X[t, l]) / (sum_t C[t-d, k] Xh[t, l]).
__device__ void cnmf_update_s(const CnmfBlock& b) {
  const int p_count = b.k * b.d;
  const int g_count = b.groups;
  for (int j = 0; j < b.lp / CNMF_LT; ++j) {
    if (g_count == 1) {
      for (int p = threadIdx.x; p < p_count; p += blockDim.x) {
        float num[CNMF_LT], den[CNMF_LT];
#pragma unroll
        for (int i = 0; i < CNMF_LT; ++i) num[i] = den[i] = 0.0f;
        const int k = p / b.d, d = p - k * b.d;
        cnmf_s_sums(b, k, d, j, d, b.t, num, den);
        cnmf_s_apply(b, p, j, num, den);
      }
      __syncthreads();
      continue;
    }
    const int g = threadIdx.x / p_count;
    const int p = threadIdx.x - g * p_count;
    const int stride = (g_count - 1) * p_count;  // of one partial's plane
    float num[CNMF_LT], den[CNMF_LT];
#pragma unroll
    for (int i = 0; i < CNMF_LT; ++i) num[i] = den[i] = 0.0f;
    if (g < g_count) {
      const int k = p / b.d, d = p - k * b.d;
      cnmf_s_sums(b, k, d, j, g * b.t / g_count, (g + 1) * b.t / g_count,
                  num, den);
      if (g > 0) {
        float* out = b.part + (g - 1) * p_count + p;
#pragma unroll
        for (int i = 0; i < CNMF_LT; ++i) {
          out[i * stride] = num[i];
          out[(CNMF_LT + i) * stride] = den[i];
        }
      }
    }
    __syncthreads();
    if (g == 0) {
      for (int gg = 1; gg < g_count; ++gg) {
        const float* in = b.part + (gg - 1) * p_count + p;
#pragma unroll
        for (int i = 0; i < CNMF_LT; ++i) {
          num[i] += in[i * stride];
          den[i] += in[(CNMF_LT + i) * stride];
        }
      }
      cnmf_s_apply(b, p, j, num, den);
    }
    __syncthreads();
  }
}

// C <- C * (sum_d sum_l X[t+d, l] S[k, d, l]) / (the same with Xh),
// zero past the end of the trial.
__device__ void cnmf_update_c(const CnmfBlock& b) {
  const int tiles = b.lp / CNMF_LT;
  for (int t = threadIdx.x; t < b.t; t += blockDim.x) {
    const int d_end = min(b.d, b.t - t);
    for (int k0 = 0; k0 < b.k; k0 += CNMF_KT) {
      float num[CNMF_KT], den[CNMF_KT];
#pragma unroll
      for (int q = 0; q < CNMF_KT; ++q) num[q] = den[q] = 0.0f;
      for (int d = 0; d < d_end; ++d) {
        for (int j = 0; j < tiles; ++j) {
          float xv[CNMF_LT], hv[CNMF_LT];
          cnmf_row_tile(b, b.x, t + d, j, xv);
          cnmf_row_tile(b, b.xh, t + d, j, hv);
#pragma unroll
          for (int q = 0; q < CNMF_KT; ++q) {
            if (k0 + q < b.k) {
              float sv[CNMF_LT];
              cnmf_s_tile(b, k0 + q, d, j, sv);
#pragma unroll
              for (int i = 0; i < CNMF_LT; ++i) {
                num[q] += xv[i] * sv[i];
                den[q] += hv[i] * sv[i];
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CNMF_KT; ++q) {
        if (k0 + q < b.k) {
          const float dn = den[q] == 0.0f ? EPSILON : den[q];
          float* cp = b.ct + (k0 + q) * b.t + t;
          *cp = *cp * (num[q] / dn);
        }
      }
    }
  }
  __syncthreads();
}

// One multiplicative update of S then C (cnmf_update's order).
__device__ inline void cnmf_step(const CnmfBlock& b) {
  cnmf_reconstruct(b);
  cnmf_update_s(b);
  cnmf_reconstruct(b);
  cnmf_update_c(b);
}

// ||X - Xh||_F of the block's fit, reconstructed and summed in float64,
// returned to every thread.
__device__ double cnmf_error(const CnmfBlock& b) {
  double part = 0.0;
  for (int q = threadIdx.x; q < b.t * b.l; q += blockDim.x) {
    const int t = q / b.l;
    const int m = q - t * b.l;
    double acc = 0.0;
    for (int d = 0; d < b.d && d <= t; ++d) {
      for (int k = 0; k < b.k; ++k) {
        acc += (double)b.ct[k * b.t + t - d] *
               (double)b.s[(k * b.d + d) * b.lp + m];
      }
    }
    const double diff = (double)b.x[cnmf_xidx(b, t, m)] - acc;
    part += diff * diff;
  }
  return sqrt(nmf_block_sum_d(b.red, part));
}

template <bool WITH_STOP>
__global__ void __launch_bounds__(NMF_THREADS, 8) cnmf_kernel(
    const float* __restrict__ x, const float* __restrict__ c0,
    const float* __restrict__ s0, float* __restrict__ c,
    float* __restrict__ s, int* __restrict__ n_iter_out,
    float* __restrict__ prev_err_out, int* __restrict__ converged_out,
    int t, int l, int k, int d, int iters, double tol, int check_every) {
  extern __shared__ __align__(16) float smem[];
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
