// Batched convolutive NMF (time-varying synergies), one thread block
// per fit, register-tiled, and one thread-block cluster per fit for
// frames over one block's shared memory (at the end of this file).
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

// --------------------------- cluster entry ---------------------------
//
// cnmf_cluster_f32: one thread-block cluster per fit, for frames whose
// fit exceeds one block's shared memory (nmf_common.cuh: the cluster
// plan and launch, the rank-ordered sums).  Block r owns rows [t0, t1)
// of time (ceil(T / C) rows a block, the last shorter, a block past T
// none) and keeps S, its S sums and a few rows of C in shared memory; X
// stays in device memory and C is updated in place there, both read in
// tiles of `tile` rows (the whole share at once where it fits, else
// streamed through L2).  An iteration keeps the block entry's order:
//   1. Xh of the block's rows from the old C and S, and the block's
//      share of the S sums, sum_t C[t-d, k] X[t, l] and the same with
//      Xh, added tile by tile in registers and shared memory;
//   2. after a cluster barrier, the C blocks' sums added in rank order
//      over distributed shared memory and S updated from them, the same
//      bits in every block;
//   3. Xh again with the new S, over the block's rows and the D - 1 rows
//      after them;
//   4. C of the block's rows from X and Xh rows t..t+D-1.
// The lags need a halo: rows t0-D+1..t0-1 of C for the first Xh rows
// and rows t1..t1+D-2 for the last C rows' Xh, the old C in both.  Each
// block keeps its first and last D - 1 rows of C in an edge buffer,
// written with the new C in step 4 and keyed on the iteration's parity;
// after the barrier that opens an iteration every block reads its 2 (D -
// 1) halo rows from the edge buffers of the blocks that own them, so no
// Xh crosses a block.  A range shorter than D - 1 rows is read where it
// lies: each halo row is fetched from the block that owns it (row g from
// block g / rows), which may be more than one neighbour away.  Inside a
// block, the D - 1 old rows of C before each tile are carried from the
// tile before it, since step 4 overwrites them in device memory.  Two
// cluster barriers an iteration (the edges, the S sums).  The stop is
// ||X - Xh||_F, Xh rebuilt in float64 over each block's own rows, the
// blocks' sums added in rank order, so every block takes the same
// branch; a last cluster barrier keeps any block from leaving while
// another reads its shared memory.  What bounds it: the block entry's
// six passes of K*D*L*T multiply-adds, spread over the cluster's SMs,
// plus the tiles' X and C through L2 and two barriers an iteration.

#define CNMF_CLUSTER_SLICES 8  // most time slices of a tile's S sums

__host__ __device__ inline int cnmf_cluster_slices(int items) {
  const int g = NMF_CLUSTER_THREADS / items;
  return g < 1 ? 1 : (g > CNMF_CLUSTER_SLICES ? CNMF_CLUSTER_SLICES : g);
}

// Floats a cluster block keeps besides its tile's rows (a tile of n rows
// adds n * (2 Lp + K)): the X and Xh rows past a tile, S, two parities of
// S sums (16 floats a (k, d, L-tile) item), the slices' partial sums,
// C^T's halo rows and rounding, the edge buffers, the halo and the
// carried rows, and 34 doubles (models/kernels/cnmf_cuda.py mirrors it:
// cluster_smem_bytes).
__host__ __device__ inline size_t cnmf_cluster_small_floats(int l, int k, int d) {
  const size_t lp = cnmf_lp(l), h1 = d - 1;
  const size_t items = (size_t)k * d * (lp / CNMF_LT);
  return 2 * h1 * lp + k * d * lp + 32 * items +
         16 * (cnmf_cluster_slices((int)items) - 1) * items + k * (2 * h1 + 3) +
         7 * h1 * k + 1 + 2 * 34;
}

struct CnmfCluster {
  CnmfBlock b;     // lp, sh, l, k, d, s; x, xh: the tile's rows (from its first)
  int T;           // the fit's rows
  int rows;        // rows a block (the plan's)
  int t0, t1;      // the block's rows [t0, t1)
  int tile;        // rows a tile
  int h1;          // D - 1
  int ldc;         // row stride of ct: tile + 2 (D - 1), rounded up to 4
  int items;       // (k, d, L-tile) items of the S sums
  int slices;      // time slices of a tile's S sums
  float* ct;       // (k, ldc): C^T of a tile's rows from its first minus D - 1
  float* part;     // 2 parities x items x 16: S sums (8 numerators, 8 denominators)
  float* scratch;  // (slices - 1) x items x 16: the slices' partial sums
  float* edge;     // 2 parities x (first, last) x (D - 1) x k: the block's edge rows
  float* hlo;      // (D - 1, k): C rows [t0 - D + 1, t0), the lower halo
  float* hhi;      // (D - 1, k): C rows [t1, t1 + D - 1), the upper halo
  float* carry;    // (D - 1, k): old C rows just before the current tile
  double* red;     // 33 doubles of float64 reduction scratch
  double* err;     // the block's share of the stopping statistic
};

__device__ inline CnmfCluster cnmf_cluster(float* smem, const NmfClusterPlan& p,
                                           int d, int rank) {
  CnmfCluster cc;
  CnmfBlock& b = cc.b;
  b.l = p.l;
  b.k = p.k;
  b.d = d;
  b.lp = cnmf_lp(p.l);
  const int nc = b.lp / 4;
  b.sh = nc == 2 ? 2 : (nc == 4 ? 1 : 0);
  cc.T = p.n;
  cc.rows = p.rows;
  cc.tile = p.tile;
  cc.h1 = d - 1;
  cc.t0 = (int)min((long long)rank * p.rows, (long long)p.n);
  cc.t1 = (int)min((long long)cc.t0 + p.rows, (long long)p.n);
  b.t = p.tile + cc.h1;
  cc.ldc = (p.tile + 2 * cc.h1 + 3) & ~3;
  cc.items = p.k * d * (b.lp / CNMF_LT);
  cc.slices = cnmf_cluster_slices(cc.items);
  b.x = smem;
  b.xh = b.x + (size_t)b.t * b.lp;
  b.s = b.xh + (size_t)b.t * b.lp;
  cc.part = b.s + (size_t)p.k * d * b.lp;
  cc.scratch = cc.part + 32 * (size_t)cc.items;
  cc.ct = cc.scratch + 16 * (size_t)(cc.slices - 1) * cc.items;
  cc.edge = cc.ct + (size_t)p.k * cc.ldc;
  cc.hlo = cc.edge + 4 * (size_t)cc.h1 * p.k;
  cc.hhi = cc.hlo + (size_t)cc.h1 * p.k;
  cc.carry = cc.hhi + (size_t)cc.h1 * p.k;
  size_t off = (size_t)(cc.carry + (size_t)cc.h1 * p.k - smem);
  off += off & 1;  // 8-byte alignment of the doubles
  cc.red = (double*)(smem + off);
  cc.err = cc.red + 33;
  return cc;
}

// The block's edge rows of C for `parity`: its first D - 1 rows, then
// its last D - 1 (of a range shorter than that, all of it in each).
__device__ inline float* cnmf_edge(const CnmfCluster& cc, int parity, bool last) {
  return cc.edge + ((size_t)2 * parity + (last ? 1 : 0)) * cc.h1 * cc.b.k;
}

// Load one fit: S into every block, C0's rows of the block into C in
// device memory (updated in place there) and into the edges of parity 0.
__device__ void cnmf_cluster_load(const CnmfCluster& cc, const float* c0f,
                                  float* cf, const float* s0f) {
  const CnmfBlock& b = cc.b;
  for (int i = threadIdx.x; i < b.k * b.d * b.lp; i += blockDim.x) {
    const int r = i / b.lp, m = i - r * b.lp;
    b.s[i] = m < b.l ? s0f[r * b.l + m] : 0.0f;
  }
  const int n = cc.t1 - cc.t0;
  const int e = min(cc.h1, n);
  for (int i = threadIdx.x; i < n * b.k; i += blockDim.x) {
    const float v = c0f[(size_t)cc.t0 * b.k + i];
    cf[(size_t)cc.t0 * b.k + i] = v;
    const int r = i / b.k;
    if (r < e) cnmf_edge(cc, 0, false)[i] = v;
    if (r >= n - e) cnmf_edge(cc, 0, true)[i - (n - e) * b.k] = v;
  }
  __syncthreads();
}

// The block's halo rows of C for `parity` (rows before t0 into hlo,
// rows from t1 on into hhi; rows outside the fit 0), each read from the
// edge buffer of the block that owns it; then carry <- hlo.  Call after
// a cluster barrier that follows the edges' writes.
__device__ void cnmf_cluster_halo(const CnmfCluster& cc, nmf_cg::cluster_group& cl,
                                  int parity) {
  const int k = cc.b.k, hk = cc.h1 * k;
  for (int i = threadIdx.x; i < 2 * hk; i += blockDim.x) {
    const bool upper = i >= hk;
    const int j = upper ? i - hk : i;
    const int r = j / k, kk = j - r * k;
    const int g = upper ? cc.t1 + r : cc.t0 - cc.h1 + r;
    float v = 0.0f;
    if (cc.t1 > cc.t0 && g >= 0 && g < cc.T) {
      const int q = g / cc.rows;  // the owner
      const int rq = min(cc.rows, cc.T - q * cc.rows);
      const int o = g - q * cc.rows;
      // an upper row is among the owner's first rows, a lower one among its last
      const int row = upper ? o : o - (rq - min(cc.h1, rq));
      v = cl.map_shared_rank(cnmf_edge(cc, parity, !upper), q)[row * k + kk];
    }
    (upper ? cc.hhi : cc.hlo)[j] = v;
    if (!upper) cc.carry[j] = v;
  }
  __syncthreads();
}

// Load a tile starting at row a: C rows [a - D + 1, a + n_c - D + 1) into
// ct (before a from carry, then the fit's C in device memory up to t1,
// then the upper halo, 0 outside the fit) and X rows [a, a + n_x) into
// b.x (0 past T).
__device__ void cnmf_cluster_tile(const CnmfCluster& cc, const float* xf,
                                  const float* cf, int a, int n_c, int n_x) {
  const CnmfBlock& b = cc.b;
  for (int i = threadIdx.x; i < b.k * n_c; i += blockDim.x) {
    const int kk = i / n_c, j = i - kk * n_c;
    const int g = a - cc.h1 + j;
    float v;
    if (g < 0 || g >= cc.T) {
      v = 0.0f;
    } else if (g < a) {
      v = cc.carry[(g - (a - cc.h1)) * b.k + kk];
    } else if (g < cc.t1) {
      v = cf[(size_t)g * b.k + kk];
    } else {
      v = cc.hhi[(g - cc.t1) * b.k + kk];
    }
    cc.ct[kk * cc.ldc + j] = v;
  }
  for (int i = threadIdx.x; i < n_x * b.lp; i += blockDim.x) {
    const int j = i / b.lp, m = i - j * b.lp;
    const long long g = (long long)a + j;
    b.x[cnmf_xidx(b, j, m)] = m < b.l && g < cc.T ? xf[g * b.l + m] : 0.0f;
  }
  __syncthreads();
}

// carry <- the old C rows [a + n - D + 1, a + n) of the tile in ct, for
// the next tile; barriers before (the tile's reads) and after.
__device__ inline void cnmf_cluster_carry(const CnmfCluster& cc, int n) {
  const int k = cc.b.k;
  for (int i = threadIdx.x; i < cc.h1 * k; i += blockDim.x) {
    const int r = i / k, kk = i - r * k;
    cc.carry[i] = cc.ct[kk * cc.ldc + n + r];
  }
  __syncthreads();
}

// Xh rows [0, n_rows) of the tile from ct and S: Xh[j] = sum_d sum_k
// C[a + j - d, k] S[k, d, :], summed over d then k as the block entry.
__device__ void cnmf_cluster_reconstruct(const CnmfCluster& cc, int n_rows) {
  const CnmfBlock& b = cc.b;
  for (int j = threadIdx.x; j < n_rows; j += blockDim.x) {
    const float* cj = cc.ct + j + cc.h1;
    for (int jt = 0; jt < b.lp / CNMF_LT; ++jt) {
      float acc[CNMF_LT];
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) acc[i] = 0.0f;
      for (int d = 0; d < b.d; ++d) {
#pragma unroll 2
        for (int k = 0; k < b.k; ++k) {
          float sv[CNMF_LT];
          cnmf_s_tile(b, k, d, jt, sv);
          const float cv = cj[k * cc.ldc - d];
#pragma unroll
          for (int i = 0; i < CNMF_LT; ++i) acc[i] += cv * sv[i];
        }
      }
      *(float4*)(b.xh + cnmf_chunk(b, j, 2 * jt)) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *(float4*)(b.xh + cnmf_chunk(b, j, 2 * jt + 1)) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();
}

// Item q's S sums over tile rows [r0, r1) added to num[8] and den[8]:
// sum_t C[t - d, k] X[t, tile] and the same with Xh.
__device__ inline void cnmf_cluster_item(const CnmfCluster& cc, int q, int r0,
                                         int r1, float* num, float* den) {
  const CnmfBlock& b = cc.b;
  const int tiles = b.lp / CNMF_LT;
  const int k = q / (b.d * tiles);
  const int rem = q - k * b.d * tiles;
  const int d = rem / tiles, jt = rem - d * tiles;
  const float* crow = cc.ct + k * cc.ldc + cc.h1 - d;
#pragma unroll 2
  for (int t = r0; t < r1; ++t) {
    const float cv = crow[t];
    float xv[CNMF_LT], hv[CNMF_LT];
    cnmf_row_tile(b, b.x, t, jt, xv);
    cnmf_row_tile(b, b.xh, t, jt, hv);
#pragma unroll
    for (int i = 0; i < CNMF_LT; ++i) {
      num[i] += cv * xv[i];
      den[i] += cv * hv[i];
    }
  }
}

// The tile's share of the S sums (its rows [0, n)) added to `part`:
// threads over items in `slices` time slices, slice 0 adding the
// others' partial sums in slice order.
__device__ void cnmf_cluster_s_sums(const CnmfCluster& cc, int n, float* part) {
  const int items = cc.items, slices = cc.slices;
  if (slices == 1) {
    for (int q = threadIdx.x; q < items; q += blockDim.x) {
      float num[CNMF_LT], den[CNMF_LT];
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) num[i] = den[i] = 0.0f;
      cnmf_cluster_item(cc, q, 0, n, num, den);
      float* out = part + 16 * q;
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) {
        out[i] += num[i];
        out[CNMF_LT + i] += den[i];
      }
    }
    __syncthreads();
    return;
  }
  const int g = threadIdx.x / items;
  const int q = threadIdx.x - g * items;
  float num[CNMF_LT], den[CNMF_LT];
#pragma unroll
  for (int i = 0; i < CNMF_LT; ++i) num[i] = den[i] = 0.0f;
  if (g < slices) {
    cnmf_cluster_item(cc, q, g * n / slices, (g + 1) * n / slices, num, den);
    if (g > 0) {
      float* out = cc.scratch + 16 * ((size_t)(g - 1) * items + q);
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) {
        out[i] = num[i];
        out[CNMF_LT + i] = den[i];
      }
    }
  }
  __syncthreads();
  if (g == 0) {
    for (int gg = 1; gg < slices; ++gg) {
      const float* in = cc.scratch + 16 * ((size_t)(gg - 1) * items + q);
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) {
        num[i] += in[i];
        den[i] += in[CNMF_LT + i];
      }
    }
    float* out = part + 16 * q;
#pragma unroll
    for (int i = 0; i < CNMF_LT; ++i) {
      out[i] += num[i];
      out[CNMF_LT + i] += den[i];
    }
  }
  __syncthreads();
}

// C of the tile's rows [0, n) (fit rows a..a+n-1) from X and Xh rows
// t..t+D-1 (zero past T) and ct's old C, written to the fit's C in
// device memory and, for the block's edge rows, to the edges of `parity`.
__device__ void cnmf_cluster_update_c(const CnmfCluster& cc, float* cf, int a,
                                      int n, int parity) {
  const CnmfBlock& b = cc.b;
  const int tiles = b.lp / CNMF_LT;
  const int e = min(cc.h1, cc.t1 - cc.t0);
  float* first = cnmf_edge(cc, parity, false);
  float* last = cnmf_edge(cc, parity, true);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int g = a + j;
    const int d_end = min(b.d, cc.T - g);
    for (int k0 = 0; k0 < b.k; k0 += CNMF_KT) {
      float num[CNMF_KT], den[CNMF_KT];
#pragma unroll
      for (int q = 0; q < CNMF_KT; ++q) num[q] = den[q] = 0.0f;
      for (int d = 0; d < d_end; ++d) {
        for (int jt = 0; jt < tiles; ++jt) {
          float xv[CNMF_LT], hv[CNMF_LT];
          cnmf_row_tile(b, b.x, j + d, jt, xv);
          cnmf_row_tile(b, b.xh, j + d, jt, hv);
#pragma unroll
          for (int q = 0; q < CNMF_KT; ++q) {
            if (k0 + q < b.k) {
              float sv[CNMF_LT];
              cnmf_s_tile(b, k0 + q, d, jt, sv);
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
        const int kk = k0 + q;
        if (kk < b.k) {
          const float dn = den[q] == 0.0f ? EPSILON : den[q];
          const float v = cc.ct[kk * cc.ldc + j + cc.h1] * (num[q] / dn);
          cf[(size_t)g * b.k + kk] = v;
          if (g - cc.t0 < e) first[(g - cc.t0) * b.k + kk] = v;
          if (g >= cc.t1 - e) last[(g - (cc.t1 - e)) * b.k + kk] = v;
        }
      }
    }
  }
  __syncthreads();
}

// One multiplicative update of S then C of the cluster's fit; `parity`
// keys the edges of the C it starts from (the new C's go to parity ^ 1)
// and the S sums' buffer.
__device__ void cnmf_cluster_step(const CnmfCluster& cc, nmf_cg::cluster_group& cl,
                                  const float* xf, float* cf, int parity) {
  const CnmfBlock& b = cc.b;
  float* part = cc.part + (size_t)parity * 16 * cc.items;
  for (int i = threadIdx.x; i < 16 * cc.items; i += blockDim.x) part[i] = 0.0f;
  cl.sync();  // every block's edges of `parity` are written
  cnmf_cluster_halo(cc, cl, parity);  // its barrier also orders the zeroing
  // ---- S: the block's share of the sums, from the old C and S ----
  for (int a = cc.t0; a < cc.t1; a += cc.tile) {
    const int n = min(cc.tile, cc.t1 - a);
    cnmf_cluster_tile(cc, xf, cf, a, n + cc.h1, n);
    cnmf_cluster_reconstruct(cc, n);
    cnmf_cluster_s_sums(cc, n, part);
    cnmf_cluster_carry(cc, n);
  }
  cl.sync();  // every block's S sums are readable
  const int dl = b.d * b.l;
  for (int i = threadIdx.x; i < b.k * dl; i += blockDim.x) {
    const int k = i / dl, r = i - k * dl;
    const int d = r / b.l, m = r - d * b.l;
    const int q = 16 * ((k * b.d + d) * (b.lp / CNMF_LT) + m / CNMF_LT) + m % CNMF_LT;
    const float num = nmf_cluster_sum(cl, part, q);
    const float den = nmf_cluster_sum(cl, part, q + CNMF_LT);
    const float dn = den == 0.0f ? EPSILON : den;
    float* sp = b.s + (k * b.d + d) * b.lp + m;
    *sp = *sp * (num / dn);
  }
  __syncthreads();
  // ---- C: Xh with the new S over the block's rows and D - 1 after ----
  for (int i = threadIdx.x; i < cc.h1 * b.k; i += blockDim.x) cc.carry[i] = cc.hlo[i];
  __syncthreads();
  for (int a = cc.t0; a < cc.t1; a += cc.tile) {
    const int n = min(cc.tile, cc.t1 - a);
    cnmf_cluster_tile(cc, xf, cf, a, n + 2 * cc.h1, n + cc.h1);
    cnmf_cluster_reconstruct(cc, n + cc.h1);
    cnmf_cluster_carry(cc, n);  // ct's old C, before update_c overwrites cf
    cnmf_cluster_update_c(cc, cf, a, n, parity ^ 1);
  }
}

// ||X - Xh||_F of the cluster's fit, Xh rebuilt in float64 from the C
// whose edges are keyed `parity`, returned to every thread of every
// block: each block's sum over its rows, then the blocks' sums in rank
// order.  Cluster barriers lie between two calls' uses of the slot.
__device__ double cnmf_cluster_error(const CnmfCluster& cc, nmf_cg::cluster_group& cl,
                                     const float* xf, const float* cf, int parity) {
  const CnmfBlock& b = cc.b;
  cl.sync();  // every block's edges of `parity` are written
  cnmf_cluster_halo(cc, cl, parity);
  double part = 0.0;
  for (int a = cc.t0; a < cc.t1; a += cc.tile) {
    const int n = min(cc.tile, cc.t1 - a);
    cnmf_cluster_tile(cc, xf, cf, a, n + cc.h1, n);
    for (int q = threadIdx.x; q < n * b.l; q += blockDim.x) {
      const int j = q / b.l, m = q - j * b.l;
      double acc = 0.0;
      for (int d = 0; d < b.d; ++d) {
        for (int k = 0; k < b.k; ++k) {
          acc += (double)cc.ct[k * cc.ldc + j + cc.h1 - d] *
                 (double)b.s[(k * b.d + d) * b.lp + m];
        }
      }
      const double diff = (double)b.x[cnmf_xidx(b, j, m)] - acc;
      part += diff * diff;
    }
    cnmf_cluster_carry(cc, n);
  }
  const double mine = nmf_block_sum_d(cc.red, part);
  if (threadIdx.x == 0) *cc.err = mine;
  cl.sync();
  return sqrt(nmf_cluster_sum_d(cl, cc.err, 0));
}

template <bool WITH_STOP>
__global__ void __launch_bounds__(NMF_CLUSTER_THREADS) cnmf_cluster_kernel(
    NmfClusterPlan p, const float* __restrict__ x, const float* __restrict__ c0,
    const float* __restrict__ s0, float* c, float* __restrict__ s,
    int* __restrict__ n_iter_out, float* __restrict__ prev_err_out,
    int* __restrict__ converged_out, int d, int iters, double tol,
    int check_every) {
  extern __shared__ __align__(16) float smem[];
  nmf_cg::cluster_group cl = nmf_cg::this_cluster();
  const size_t fit = blockIdx.x / cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const CnmfCluster cc = cnmf_cluster(smem, p, d, rank);
  const float* xf = x + fit * p.n * p.l;
  float* cf = c + fit * p.n * p.k;
  cnmf_cluster_load(cc, c0 + fit * p.n * p.k, cf, s0 + fit * p.k * d * p.l);
  int parity = 0;
  if (WITH_STOP) {
    // the block entry's loop: no tail chunk; every value that decides a
    // branch is the same in every block of the cluster
    const double err0 = cnmf_cluster_error(cc, cl, xf, cf, parity);
    const double scale = fmax(err0, (double)EPSILON);
    double prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      for (int i = 0; i < check_every; ++i) {
        cnmf_cluster_step(cc, cl, xf, cf, parity);
        parity ^= 1;
      }
      n_iter += check_every;
      const double err = cnmf_cluster_error(cc, cl, xf, cf, parity);
      converged = (prev_err - err) / scale < tol;
      prev_err = err;
    }
    if (rank == 0 && threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      prev_err_out[fit] = (float)prev_err;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int i = 0; i < iters; ++i) {
      cnmf_cluster_step(cc, cl, xf, cf, parity);
      parity ^= 1;
    }
  }
  cl.sync();  // no block leaves while another reads its shared memory
  if (rank == 0) {
    const CnmfBlock& b = cc.b;
    float* sf = s + fit * p.k * d * p.l;
    for (int i = threadIdx.x; i < b.k * b.d * b.l; i += blockDim.x) {
      const int r = i / b.l;
      sf[i] = b.s[r * b.lp + i - r * b.l];
    }
  }
}

// The cluster entry: cnmf_f32's arguments and results, for frames over
// one block's shared memory (models/kernels/cnmf_cuda.py: route).
// Launches one cluster a fit on `stream` and returns cudaGetLastError(),
// or the error that left no cluster able to run the fit.
extern "C" int cnmf_cluster_f32(const float* x, const float* c0, const float* s0,
                                float* c, float* s, int* n_iter, float* prev_err,
                                int* converged, int batch, int t, int l, int k,
                                int d, int iters, double tol, int check_every,
                                int with_stop, void* stream) {
  if (batch < 1 || t < 1 || l < 1 || k < 1 || d < 1 || d > t || iters < 0 ||
      (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t small = cnmf_cluster_small_floats(l, k, d);
  const size_t per_row = 2 * (size_t)cnmf_lp(l) + k;
  auto run = [&](auto kernel) {
    NmfClusterPlan plan;
    const int e = nmf_cluster_plan_sized(kernel, t, l, k, small, 0, per_row, &plan);
    if (e != 0) return e;
    return nmf_cluster_launch(kernel, plan, batch, st, x, c0, s0, c, s, n_iter,
                              prev_err, converged, d, iters, tol, check_every);
  };
  return with_stop ? run(cnmf_cluster_kernel<true>) : run(cnmf_cluster_kernel<false>);
}
