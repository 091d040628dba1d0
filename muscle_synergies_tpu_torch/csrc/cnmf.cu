// Batched convolutive NMF (time-varying synergies), one thread block
// per fit, register-tiled: the block entry (128 threads a fit) and the
// wide entry (the same fit on CNMF_WIDE_THREADS threads, for fits with an
// SM to themselves); and the cluster entry, one fit spread over many
// blocks of the card, for frames over one block's shared memory (at the
// end of this file).
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
// by max(err0, EPSILON).  A converged block simply ends.  A launch may
// stop a fit after `cap` iterations and a later one resume it (on either
// one-block entry) from its count, last error and scale, kept in float64.
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

// Phase marks of an iteration, empty here; scripts/torch_cnmf_profile.py
// defines them in a marked copy of this file (clock64() on thread 0).
#ifndef CNMF_MARK
#define CNMF_MARK(i)
#define CNMF_MARK_START()
#define CNMF_MARK_FLUSH()
#endif

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
    CNMF_MARK(2);
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
  CNMF_MARK(0);
  cnmf_reconstruct(b);
  CNMF_MARK(1);
  cnmf_update_s(b);
  CNMF_MARK(3);
  cnmf_reconstruct(b);
  CNMF_MARK(4);
  cnmf_update_c(b);
  CNMF_MARK(5);
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

// ---------------------------- wide entry -----------------------------
//
// cnmf_wide_f32: the same fit as the block entry on CNMF_WIDE_THREADS
// threads, for a fit that has an SM (or half of one) to itself: the path's
// tail, CNMFModel's restarts, the bootstraps.  The block entry's 128
// threads are one warp a scheduler, each a long serial chain (a lone
// 200 x 8 fit at K = 4, D = 10: 17.3 us an iteration against ~2 us of
// issue); here the same passes are spread over four times the threads,
// and every float is the block entry's: each sum keeps its order, its
// terms and its fused multiply-adds whichever thread computes it.
//   - reconstruction: one thread an L-tile of a row (8 columns), each
//     Xh[t, l] summed over d, then k;
//   - S sums: (pair, time slice, column slice) items, the slices exactly
//     cnmf_groups(k, d) at 128 threads with their bounds g*T/G, a tile's
//     columns split in two where the items then fill the block (4 columns
//     an item: fewer cost more instructions than the threads they add
//     hide, cnmf profile runs); slices 1..G-1 leave their sums in `part`,
//     in the block entry's layout, and slice 0 adds them in order and
//     updates S;
//   - C update: one thread two synergies of a row, summed over d, L-tile,
//     column;
//   - the error: each entry's float64 difference computed by any thread
//     into the dead Xh (rebuilt at the next step), then added as the
//     block entry's 128 threads add them (q strided by 128) and reduced
//     by its 4-warp tree.
// The rows of the S sums and the lags of the C update are unrolled so
// that their loads issue together.  Same shared layout (CnmfBlock), same
// five barriers an iteration.

// Threads a fit (512 ran faster than 256 and 1,024 in the cnmf profile
// runs).  A multiple of the block entry's 128: threads 0..127 hold the
// error's partials, and the S items of several time slices (at most 128)
// take one round of the block.
#define CNMF_WIDE_THREADS 512
static_assert(CNMF_WIDE_THREADS % NMF_THREADS == 0 && CNMF_WIDE_THREADS <= 1024,
              "the wide entry's threads: a multiple of NMF_THREADS, at most 1,024");
// blocks a SM the registers allow: at most 64 registers a thread
#define CNMF_WIDE_MIN_BLOCKS (1024 / CNMF_WIDE_THREADS)
#define CNMF_WIDE_KT 2  // synergies of a row a thread updates in the C update

// Xh of every row, one thread an L-tile of a row.
__device__ void cnmf_wide_reconstruct(const CnmfBlock& b) {
  const int tiles = b.lp / CNMF_LT;
  for (int q = threadIdx.x; q < b.t * tiles; q += blockDim.x) {
    const int t = q / tiles, j = q - t * tiles;
    const int dmax = min(b.d - 1, t);
    float acc[CNMF_LT];
#pragma unroll
    for (int i = 0; i < CNMF_LT; ++i) acc[i] = 0.0f;
    for (int d = 0; d <= dmax; ++d) {
      const float* crow = b.ct + t - d;
#pragma unroll 4
      for (int k = 0; k < b.k; ++k) {
        const float cv = crow[k * b.t];
        float sv[CNMF_LT];
        cnmf_s_tile(b, k, d, j, sv);
#pragma unroll
        for (int i = 0; i < CNMF_LT; ++i) acc[i] += cv * sv[i];
      }
    }
    *(float4*)(b.xh + cnmf_chunk(b, t, 2 * j)) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *(float4*)(b.xh + cnmf_chunk(b, t, 2 * j + 1)) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
}

// CW (4 or 8) floats of row t of X or Xh from column `col`, a multiple of CW.
template <int CW>
__device__ inline void cnmf_wide_cols(const CnmfBlock& b, const float* a, int t, int col,
                                      float* v) {
  if constexpr (CW == 8) {
    cnmf_row_tile(b, a, t, col / 8, v);
  } else {
    const float4 u = *(const float4*)(a + cnmf_chunk(b, t, col >> 2));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
}

// S <- S * (sum_t C[t-d, k] X[t, l]) / (sum_t C[t-d, k] Xh[t, l]) on items
// of CW columns of a tile.  With more than one time slice the items are
// at most the block's threads (the slices times the pairs are at most 128
// and CW is chosen for it), one a thread.
template <int CW>
__device__ void cnmf_wide_update_s_cols(const CnmfBlock& b) {
  const int p_count = b.k * b.d, g_count = b.groups;
  const int slices = CNMF_LT / CW;
  const int items = g_count * p_count * slices;
  const int stride = (g_count - 1) * p_count;
  for (int j = 0; j < b.lp / CNMF_LT; ++j) {
    for (int q = threadIdx.x; q < (g_count == 1 ? items : (int)blockDim.x);
         q += blockDim.x) {
      const int cs = q % slices, r = q / slices;
      const int p = r % p_count, g = r / p_count;
      const int col = CNMF_LT * j + CW * cs;
      float num[CW], den[CW];
#pragma unroll
      for (int i = 0; i < CW; ++i) num[i] = den[i] = 0.0f;
      if (q < items) {
        const int k = p / b.d, d = p - k * b.d;
        const float* crow = b.ct + k * b.t - d;
        const int t1 = (g + 1) * b.t / g_count;
        // a row before the lag adds an exact 0 (the sums are >= +0), so
        // the rows need no branch and the unrolled rows' loads go together
#pragma unroll 4
        for (int t = g * b.t / g_count; t < t1; ++t) {
          const float cv = t >= d ? crow[t] : 0.0f;
          float xv[CW], hv[CW];
          cnmf_wide_cols<CW>(b, b.x, t, col, xv);
          cnmf_wide_cols<CW>(b, b.xh, t, col, hv);
#pragma unroll
          for (int i = 0; i < CW; ++i) {
            num[i] += cv * xv[i];
            den[i] += cv * hv[i];
          }
        }
        if (g > 0) {
          float* out = b.part + (g - 1) * p_count + p;
#pragma unroll
          for (int i = 0; i < CW; ++i) {
            out[(CW * cs + i) * stride] = num[i];
            out[(CNMF_LT + CW * cs + i) * stride] = den[i];
          }
        }
      }
      if (g_count > 1) {
        __syncthreads();
        CNMF_MARK(2);
        if (q >= items || g > 0) continue;
        for (int gg = 1; gg < g_count; ++gg) {
          const float* in = b.part + (gg - 1) * p_count + p;
#pragma unroll
          for (int i = 0; i < CW; ++i) {
            num[i] += in[(CW * cs + i) * stride];
            den[i] += in[(CNMF_LT + CW * cs + i) * stride];
          }
        }
      }
      float* sp = b.s + p * b.lp + col;
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        if (col + i < b.l) {
          const float dn = den[i] == 0.0f ? EPSILON : den[i];
          sp[i] = sp[i] * (num[i] / dn);
        }
      }
    }
    __syncthreads();
  }
}

// Half a tile an S item where the items then fill the block, else a whole
// tile (with one time slice, over as many rounds of the block as it takes).
__device__ void cnmf_wide_update_s(const CnmfBlock& b) {
  if (b.groups * b.k * b.d * 2 <= (int)blockDim.x) {
    cnmf_wide_update_s_cols<4>(b);
  } else {
    cnmf_wide_update_s_cols<8>(b);
  }
}

// C <- C * (sum_d sum_l X[t+d, l] S[k, d, l]) / (the same with Xh), one
// thread CNMF_WIDE_KT synergies of a row, zero past the end of the trial.
__device__ void cnmf_wide_update_c(const CnmfBlock& b) {
  const int tiles = b.lp / CNMF_LT;
  const int nk = (b.k + CNMF_WIDE_KT - 1) / CNMF_WIDE_KT;
  for (int q = threadIdx.x; q < b.t * nk; q += blockDim.x) {
    const int t = q / nk, k0 = (q - t * nk) * CNMF_WIDE_KT;
    const int d_end = min(b.d, b.t - t);
    float num[CNMF_WIDE_KT], den[CNMF_WIDE_KT];
#pragma unroll
    for (int r = 0; r < CNMF_WIDE_KT; ++r) num[r] = den[r] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < d_end; ++d) {
      for (int j = 0; j < tiles; ++j) {
        float xv[CNMF_LT], hv[CNMF_LT];
        cnmf_row_tile(b, b.x, t + d, j, xv);
        cnmf_row_tile(b, b.xh, t + d, j, hv);
#pragma unroll
        for (int r = 0; r < CNMF_WIDE_KT; ++r) {
          if (k0 + r < b.k) {
            float sv[CNMF_LT];
            cnmf_s_tile(b, k0 + r, d, j, sv);
#pragma unroll
            for (int i = 0; i < CNMF_LT; ++i) {
              num[r] += xv[i] * sv[i];
              den[r] += hv[i] * sv[i];
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < CNMF_WIDE_KT; ++r) {
      if (k0 + r < b.k) {
        const float dn = den[r] == 0.0f ? EPSILON : den[r];
        float* cp = b.ct + (k0 + r) * b.t + t;
        *cp = *cp * (num[r] / dn);
      }
    }
  }
  __syncthreads();
}

__device__ inline void cnmf_wide_step(const CnmfBlock& b) {
  CNMF_MARK(0);
  cnmf_wide_reconstruct(b);
  CNMF_MARK(1);
  cnmf_wide_update_s(b);
  CNMF_MARK(3);
  cnmf_wide_reconstruct(b);
  CNMF_MARK(4);
  cnmf_wide_update_c(b);
  CNMF_MARK(5);
}

// nmf_block_sum_d of `v` as a block of NMF_THREADS threads holds it
// (threads 0..127 hold the values; the others take part in the barriers).
__device__ inline double cnmf_wide_sum_d(double* red, double v) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp < NMF_THREADS / 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < NMF_THREADS / 32 ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const double total = red[32];
  __syncthreads();
  return total;
}

// cnmf_error's value, bit for bit: every entry's difference in float64
// into Xh's space (as many doubles as it holds at a time), then the
// squares added by thread v < 128 over q = v, v + 128, ... in order.
__device__ double cnmf_wide_error(const CnmfBlock& b) {
  double* diff = (double*)b.xh;
  const int n = b.t * b.l;
  const int room = b.t * b.lp / 2;
  double part = 0.0;
  for (int q0 = 0; q0 < n; q0 += room) {
    const int q1 = min(n, q0 + room);
    for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
      const int t = q / b.l;
      const int m = q - t * b.l;
      double acc = 0.0;
      for (int d = 0; d < b.d && d <= t; ++d) {
#pragma unroll 4
        for (int k = 0; k < b.k; ++k) {
          acc += (double)b.ct[k * b.t + t - d] * (double)b.s[(k * b.d + d) * b.lp + m];
        }
      }
      diff[q - q0] = (double)b.x[cnmf_xidx(b, t, m)] - acc;
    }
    __syncthreads();
    if (threadIdx.x < NMF_THREADS) {
      const int v = threadIdx.x;
      for (int q = q0 + (v - q0 % NMF_THREADS + NMF_THREADS) % NMF_THREADS; q < q1;
           q += NMF_THREADS) {
        const double e = diff[q - q0];
        part += e * e;
      }
    }
    __syncthreads();
  }
  return sqrt(cnmf_wide_sum_d(b.red, part));
}

// ------------------- the two one-block entries' fit -------------------
//
// Both entries run fits from a list (or fits 0..B-1 when there is none),
// each reading and writing its C and S in the caller's arrays in place,
// and resume a fit's stop where a launch before left it: per fit, its
// count, its error at the last check and the scale in float64, and
// whether it converged.  A fit with a count of 0 starts: its error from
// C0 and S0 sets both.  A launch runs at most `cap` iterations of a fit
// (a multiple of check_every), so a fit resumed makes the checks an
// uninterrupted one makes, at the same iterations, with the same bits.
template <bool WIDE, bool WITH_STOP>
__device__ inline void cnmf_fit(const float* __restrict__ x, float* c, float* s,
                                const int* __restrict__ fits, int* n_iter_io,
                                double* prev_err_io, double* scale_io, int* converged_io,
                                int t, int l, int k, int d, int max_iter, int cap,
                                double tol, int check_every) {
  extern __shared__ __align__(16) float smem[];
  const CnmfBlock b = cnmf_block(smem, t, l, k, d);
  const size_t fit = fits == nullptr ? blockIdx.x : (size_t)fits[blockIdx.x];
  float* cf = c + fit * t * k;
  float* sf = s + fit * k * d * l;
  cnmf_load(b, x + fit * t * l, cf, sf);
  CNMF_MARK_START();
  if (WITH_STOP) {
    int n_iter = n_iter_io[fit];
    bool converged = converged_io[fit] != 0;
    double prev_err, scale;
    if (n_iter == 0) {
      prev_err = WIDE ? cnmf_wide_error(b) : cnmf_error(b);
      scale = fmax(prev_err, (double)EPSILON);
    } else {
      prev_err = prev_err_io[fit];
      scale = scale_io[fit];
    }
    for (int done = 0; n_iter < max_iter && !converged && done < cap;
         done += check_every) {
      for (int i = 0; i < check_every; ++i) {
        if (WIDE) {
          cnmf_wide_step(b);
        } else {
          cnmf_step(b);
        }
      }
      n_iter += check_every;
      CNMF_MARK(0);
      const double err = WIDE ? cnmf_wide_error(b) : cnmf_error(b);
      CNMF_MARK(6);
      converged = (prev_err - err) / scale < tol;
      prev_err = err;
    }
    if (threadIdx.x == 0) {
      n_iter_io[fit] = n_iter;
      prev_err_io[fit] = prev_err;
      scale_io[fit] = scale;
      converged_io[fit] = converged ? 1 : 0;
    }
  } else {
    for (int i = 0; i < max_iter; ++i) {
      if (WIDE) {
        cnmf_wide_step(b);
      } else {
        cnmf_step(b);
      }
    }
  }
  CNMF_MARK_FLUSH();
  cnmf_store(b, cf, sf);
}

#define CNMF_FIT_PARAMS                                                         \
  const float* __restrict__ x, float* c, float* s, const int* __restrict__ fits, \
      int* n_iter, double* prev_err, double* scale, int* converged, int t, int l, \
      int k, int d, int max_iter, int cap, double tol, int check_every
#define CNMF_FIT_ARGS \
  x, c, s, fits, n_iter, prev_err, scale, converged, t, l, k, d, max_iter, cap, tol, check_every

template <bool WITH_STOP>
__global__ void __launch_bounds__(NMF_THREADS, 8) cnmf_kernel(CNMF_FIT_PARAMS) {
  cnmf_fit<false, WITH_STOP>(CNMF_FIT_ARGS);
}

template <bool WITH_STOP>
__global__ void __launch_bounds__(CNMF_WIDE_THREADS, CNMF_WIDE_MIN_BLOCKS)
    cnmf_wide_kernel(CNMF_FIT_PARAMS) {
  cnmf_fit<true, WITH_STOP>(CNMF_FIT_ARGS);
}

template <class Kernel, class... Args>
inline int cnmf_wide_launch(Kernel kernel, int blocks, size_t smem, cudaStream_t stream,
                            Args... args) {
  if (smem > NMF_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, CNMF_WIDE_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The one-block entries.  x (B, T, L), c (B, T, K), s (B, K, D, L)
// float32, C and S updated in place; `fits` (n_fits ints on the device,
// each in 0..B-1) the fits to run, or null for fits 0..n_fits-1; n_iter,
// prev_err (float64), scale (float64) and converged (B,) read and
// written only with the stop.  With the stop a fit runs to max_iter or
// convergence, at most `cap` iterations in this launch (a multiple of
// check_every); without it, max_iter iterations.  Launch on `stream`;
// return cudaGetLastError().
static int cnmf_check(int n_fits, int t, int l, int k, int d, int max_iter, int cap,
                      int check_every, int with_stop) {
  return n_fits < 1 || t < 1 || l < 1 || k < 1 || d < 1 || d > t || max_iter < 0 ||
         (with_stop && (check_every < 1 || cap < check_every || cap % check_every != 0));
}

extern "C" int cnmf_f32(const float* x, float* c, float* s, const int* fits, int n_fits,
                        int* n_iter, double* prev_err, double* scale, int* converged,
                        int t, int l, int k, int d, int max_iter, int cap, double tol,
                        int check_every, int with_stop, void* stream) {
  if (cnmf_check(n_fits, t, l, k, d, max_iter, cap, check_every, with_stop)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = cnmf_smem_floats(t, l, k, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (with_stop) {
    return nmf_launch(cnmf_kernel<true>, n_fits, smem, st, CNMF_FIT_ARGS);
  }
  return nmf_launch(cnmf_kernel<false>, n_fits, smem, st, CNMF_FIT_ARGS);
}

// The wide entry's threads a fit, which the wrapper checks against its own.
extern "C" int cnmf_wide_threads(void) { return CNMF_WIDE_THREADS; }

extern "C" int cnmf_wide_f32(const float* x, float* c, float* s, const int* fits,
                             int n_fits, int* n_iter, double* prev_err, double* scale,
                             int* converged, int t, int l, int k, int d, int max_iter,
                             int cap, double tol, int check_every, int with_stop,
                             void* stream) {
  if (cnmf_check(n_fits, t, l, k, d, max_iter, cap, check_every, with_stop)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = cnmf_smem_floats(t, l, k, d) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (with_stop) {
    return cnmf_wide_launch(cnmf_wide_kernel<true>, n_fits, smem, st, CNMF_FIT_ARGS);
  }
  return cnmf_wide_launch(cnmf_wide_kernel<false>, n_fits, smem, st, CNMF_FIT_ARGS);
}

// --------------------------- cluster entry ---------------------------
//
// cnmf_cluster_f32: the entry for frames whose fit exceeds one block's
// shared memory (a subject's concatenated cycles, a whole capture),
// replacing `cnmf_iterations_pallas` (cnmf_pallas.py:147) there.  One fit
// is spread over P blocks of the whole card on K1's grid design
// (nmf_common.cuh: the grid entries).  Block r owns rows [t0, t1) of time
// and keeps S and its S sums in shared memory.  An iteration keeps the
// block entry's order and passes, register-tiled as there (two rows a
// thread in the C update, up to four in the reconstructions, sharing S's
// float4 broadcasts; the S sums by (k, d, L-tile) items in time slices;
// 4 synergies of a row's C in registers):
//   1. Xh of the block's rows from the old C and S, and the block's share
//      of the S sums, sum_t C[t-d, k] X[t, l] and the same with Xh;
//   2. the set to the workspace, the fit's barrier in device memory, the
//      P sets added in block order 0..P-1 (float4 loads, each entry's sum
//      in order) and S updated from them, the same bits in every block;
//   3. Xh again with the new S, over the block's rows and the D - 1 rows
//      after them;
//   4. C of the block's rows from X and Xh rows t..t+D-1 (den == 0 ->
//      EPSILON, as cnmf_update).
// The lags need a halo of the old C: rows t0-D+1..t0-1 for the first Xh
// rows and t1..t1+D-2 for the last C rows' Xh.  Each block writes its
// first and last D - 1 rows of the new C to the workspace, one slot a
// parity, and then a flag (its C's version, a release store); at the
// next pass a block waits for the flags of the blocks that own its halo
// rows (acquire) and reads the rows from their slots, each from the block
// that owns it, which is more than one block away when a range is
// shorter than D - 1.  So an iteration has two syncs in device memory:
// the flags of the edges (point to point, with the owners only) and the
// fit's barrier of the S sums.  One is not enough: the S sums of an
// iteration need the halo of the C that the owners update after the S
// sums of the iteration before, and the C update needs the S the whole
// fit sums; each dependence crosses blocks, one after the other.  A
// block rewrites an edge slot of parity p only after the S barrier of
// the next iteration, which every block passes after reading parity p.
// The stop is ||X - Xh||_F, Xh rebuilt in float64 over each block's own
// rows, the blocks' sums added in block order (one more barrier every
// check_every iterations); no tail chunk, as the block entry.
//
// Where rows live (cnmf_grid_rule, K1's rule with K5's sizes): a row
// costs X and Xh (2 Lp floats) and C (K floats), 80 B at L = 8, K = 4.
// A lone 124,460 x 8 trial is 132 blocks of 943 rows, resident: X (with
// the D - 1 rows after the block), Xh and C^T stay in shared memory for
// the whole solve, 75 KB of rows and 94 KB a block with S and its sums,
// and only the halo moves.
// CNMFModel(4, 10)'s 4 restarts are 33 blocks of 3,772 rows: 302 KB with
// Xh, over the 227 KB of a block, so those rows stream: C lives in device
// memory, updated in place, and each pass reads X and C through L2 in
// tiles of as many rows as fit (2,677 at K = 4, D = 10), the D - 1 old
// rows of C before each tile carried from the tile before it.  Streaming
// X was chosen over rebuilding Xh in tiles from resident X and C (181
// KB): the X of 4 fits is 16 MB and their C 8 MB, well inside the 50 MB
// of L2, and one tiled path then serves every plan that does not fit,
// a wider batch or more restarts included.  What bounds it on this card:
// the six passes of K*D*L*T multiply-adds (7.1 us an iteration at a
// capture's 124,460 x 8, K = 4, D = 10, at the card's float32 peak),
// spread over every SM, then an iteration's chain: the halo flags, the
// barrier and the P sets (16 K D L floats each) read back from L2.

#define CNMF_GRID_SLICES 8  // most time slices of the S sums
#define CNMF_GRID_SUM4 16   // float4 loads in flight a thread while summing the sets
#define CNMF_GRID_BATCH 8   // loads in flight a thread while a streamed tile is copied in

__host__ __device__ inline int cnmf_grid_items(int l, int k, int d) {
  return k * d * (cnmf_lp(l) / CNMF_LT);
}

__host__ __device__ inline int cnmf_grid_slices(int items) {
  const int g = NMF_GRID_THREADS / items;
  return g < 1 ? 1 : (g > CNMF_GRID_SLICES ? CNMF_GRID_SLICES : g);
}

// Floats a K5 grid block keeps besides its rows (a tile of n rows adds n
// (2 Lp + K): X and Xh rows, C^T): the X and Xh rows past a tile (D - 1
// each), S, 34 doubles' room of float64 scratch, the block's S sums and
// the time slices' partial sums (16 floats a (k, d, L-tile) item and
// slice), the lower halo, upper halo and carried rows of C, and C^T's
// halo columns and rounding (models/kernels/cnmf_cuda.py:
// grid_small_floats).
__host__ __device__ inline size_t cnmf_grid_small_floats(int l, int k, int d) {
  const size_t lp = cnmf_lp(l), h1 = d - 1;
  const size_t items = cnmf_grid_items(l, k, d);
  return 2 * h1 * lp + (size_t)k * d * lp + 68 + 16 * items * cnmf_grid_slices((int)items) +
         3 * h1 * k + (size_t)k * (2 * h1 + 3);
}

// K5's plan (models/kernels/cnmf_cuda.py: grid_plan).
inline int cnmf_grid_rule(int batch, int t, int l, int k, int d, int sms,
                          NmfGridPlan* plan) {
  const int r = nmf_grid_rule_sized(batch, t, l, k, sms, cnmf_grid_small_floats(l, k, d),
                                    2 * (long long)cnmf_lp(l) + k, plan);
  if (r != 0) return r;
  plan->nq = 16 * cnmf_grid_items(l, k, d);
  plan->pstride = plan->nq;
  return 0;
}

// Floats of one fit's edge slots: two parities of a block's first and
// last D - 1 rows of C.
__host__ __device__ inline size_t cnmf_grid_edge_floats(const NmfGridPlan& p, int d) {
  return nmf_r4((size_t)4 * p.blocks * (d - 1) * p.k);
}

// Floats of K5's workspace: the fits' arrive counters, a flag a block, a
// float64 error slot a block, the fits' edge slots and two partial sets
// a block (models/kernels/cnmf_cuda.py: grid_workspace_floats).
inline size_t cnmf_grid_workspace_floats(const NmfGridPlan& p, int d, int batch) {
  const size_t blocks = (size_t)batch * p.blocks;
  return nmf_r4(batch) + 3 * nmf_r4(blocks) + batch * cnmf_grid_edge_floats(p, d) +
         2 * blocks * p.pstride;
}

struct CnmfGrid {
  CnmfBlock b;      // lp, sh, l, k, d; s: S; x, xh: a tile's X and Xh rows from its first; red
  float* ct;        // (k, ldc): C^T, column c the fit's row a - (D - 1) + c (a: the tile's first)
  float* bpart;     // the block's S sums, 16 floats an item (8 numerators, 8 denominators)
  float* scratch;   // (slices - 1) x items x 16: the time slices' partial sums
  float* hlo;       // (D - 1, k): C rows [t0 - D + 1, t0), the lower halo
  float* hhi;       // (D - 1, k): C rows [t1, t1 + D - 1), the upper halo
  float* carry;     // (D - 1, k): the old C rows just before the current tile
  int T;            // the fit's rows
  int rows;         // rows a block (the plan's)
  int t0, t1;       // the block's rows [t0, t1)
  int tile;         // rows a tile (resident: = rows)
  int h1;           // D - 1
  int ldc;          // row stride of ct: tile + 2 (D - 1), rounded up to 4
  int items, slices, rank, blocks, nq, pstride;
  bool resident;
  unsigned* counter;  // the fit's arrive counter
  unsigned* flags;    // the fit's blocks' edge versions
  double* err;        // the fit's error slots, one a block
  float* edge;        // the fit's edge slots, [2][blocks][first, last][D - 1][k]
  float* part;        // the fit's partial sets, [2][blocks][pstride]
};

__device__ inline CnmfGrid cnmf_grid(float* smem, const NmfGridPlan& p, int d, float* ws,
                                     int batch, size_t fit, int rank) {
  CnmfGrid cg;
  CnmfBlock& b = cg.b;
  b.l = p.l;
  b.k = p.k;
  b.d = d;
  b.lp = cnmf_lp(p.l);
  const int nc = b.lp / 4;
  b.sh = nc == 2 ? 2 : (nc == 4 ? 1 : 0);
  b.groups = 1;
  b.part = nullptr;
  cg.T = p.n;
  cg.rows = p.rows;
  cg.tile = p.tile;
  cg.h1 = d - 1;
  cg.t0 = (int)min((long long)rank * p.rows, (long long)p.n);
  cg.t1 = (int)min((long long)cg.t0 + p.rows, (long long)p.n);
  b.t = p.tile + cg.h1;  // rows of the X and Xh buffers
  cg.ldc = (p.tile + 2 * cg.h1 + 3) & ~3;
  cg.items = cnmf_grid_items(p.l, p.k, d);
  cg.slices = cnmf_grid_slices(cg.items);
  cg.rank = rank;
  cg.blocks = p.blocks;
  cg.nq = p.nq;
  cg.pstride = p.pstride;
  cg.resident = p.resident != 0;
  b.x = smem;
  b.xh = b.x + (size_t)b.t * b.lp;
  b.s = b.xh + (size_t)b.t * b.lp;
  b.red = reinterpret_cast<double*>(b.s + (size_t)p.k * d * b.lp);
  cg.bpart = b.s + (size_t)p.k * d * b.lp + 68;  // 16-byte aligned, past the doubles
  cg.scratch = cg.bpart + 16 * (size_t)cg.items;
  cg.hlo = cg.scratch + 16 * (size_t)(cg.slices - 1) * cg.items;
  cg.hhi = cg.hlo + (size_t)cg.h1 * p.k;
  cg.carry = cg.hhi + (size_t)cg.h1 * p.k;
  cg.ct = cg.carry + (size_t)cg.h1 * p.k;
  const size_t blocks = (size_t)batch * p.blocks;
  cg.counter = reinterpret_cast<unsigned*>(ws) + fit;
  cg.flags = reinterpret_cast<unsigned*>(ws + nmf_r4(batch)) + fit * p.blocks;
  cg.err = reinterpret_cast<double*>(ws + nmf_r4(batch) + nmf_r4(blocks)) + fit * p.blocks;
  cg.edge = ws + nmf_r4(batch) + 3 * nmf_r4(blocks) + fit * cnmf_grid_edge_floats(p, d);
  cg.part = ws + nmf_r4(batch) + 3 * nmf_r4(blocks) + batch * cnmf_grid_edge_floats(p, d) +
            fit * 2 * p.blocks * p.pstride;
  return cg;
}

// Block q's edge slot of `parity`: its first D - 1 rows of C, or its
// last (of a range shorter than that, all of it in each).
__device__ inline float* cnmf_grid_edge(const CnmfGrid& cg, int parity, int q, bool last) {
  return cg.edge + (((size_t)parity * cg.blocks + q) * 2 + (last ? 1 : 0)) * cg.h1 * cg.b.k;
}

// Row g of the new C (value v of synergy kk) to the block's edge slots of
// `parity` where it is among the block's first or last D - 1 rows.
__device__ __forceinline__ void cnmf_grid_put_edge(const CnmfGrid& cg, int parity, int g,
                                                   int kk, float v) {
  const int e = min(cg.h1, cg.t1 - cg.t0);
  if (g - cg.t0 < e) __stcg(cnmf_grid_edge(cg, parity, cg.rank, false) + (g - cg.t0) * cg.b.k + kk, v);
  if (g >= cg.t1 - e) {
    __stcg(cnmf_grid_edge(cg, parity, cg.rank, true) + (g - (cg.t1 - e)) * cg.b.k + kk, v);
  }
}

// The block's edges are written: its flag to `ver` (after a barrier and
// a fence, a release store).
__device__ inline void cnmf_grid_publish(const CnmfGrid& cg, unsigned ver) {
  __syncthreads();
  if (threadIdx.x == 0 && cg.blocks > 1 && cg.h1 > 0) {
    __threadfence();
    nmf_st_release(cg.flags + cg.rank, ver);
  }
}

// Load one fit: S into every block; resident, the block's X rows and the
// D - 1 after them into its shared memory and its rows of C0 into C^T;
// streamed, its rows of C0 copied to C in device memory (updated in
// place there); and its edges of C0 to the slots of parity 0.
__device__ void cnmf_grid_load(const CnmfGrid& cg, const float* xf, const float* c0f,
                               float* cf, const float* s0f) {
  const CnmfBlock& b = cg.b;
  for (int i = threadIdx.x; i < b.k * b.d * b.lp; i += blockDim.x) {
    const int r = i / b.lp, m = i - r * b.lp;
    b.s[i] = m < b.l ? s0f[r * b.l + m] : 0.0f;
  }
  const int n = cg.t1 - cg.t0;
  if (cg.resident) {
    for (int i = threadIdx.x; i < (n + cg.h1) * b.lp; i += blockDim.x) {
      const int j = i / b.lp, m = i - j * b.lp;
      const long long g = (long long)cg.t0 + j;
      b.x[cnmf_xidx(b, j, m)] = m < b.l && g < cg.T ? xf[g * b.l + m] : 0.0f;
    }
  }
  const bool edges = cg.blocks > 1 && cg.h1 > 0;
  for (int i = threadIdx.x; i < n * b.k; i += blockDim.x) {
    const float v = c0f[(size_t)cg.t0 * b.k + i];
    const int r = i / b.k, kk = i - r * b.k;
    if (cg.resident) {
      cg.ct[kk * cg.ldc + cg.h1 + r] = v;
    } else {
      cf[(size_t)cg.t0 * b.k + i] = v;
    }
    if (edges) cnmf_grid_put_edge(cg, 0, cg.t0 + r, kk, v);
  }
  __syncthreads();
}

// The block's halo rows of C for `parity` (rows before t0 into hlo, rows
// from t1 on into hhi; rows outside the fit 0), each read from the edge
// slot of the block that owns it once that block's flag reaches `ver`;
// then carry <- hlo.  Ends with a barrier.
__device__ void cnmf_grid_halo(const CnmfGrid& cg, int parity, unsigned ver) {
  const int k = cg.b.k, hk = cg.h1 * k;
  const bool rows = cg.t1 > cg.t0;
  if (hk > 0 && rows && cg.blocks > 1 && threadIdx.x == 0) {
    const int lo = max(0, cg.t0 - cg.h1), hi = min(cg.T, cg.t1 + cg.h1) - 1;
    for (int q = lo / cg.rows; q <= hi / cg.rows; ++q) {
      if (q == cg.rank) continue;
      while (nmf_ld_acquire(cg.flags + q) < ver) {
      }
    }
    __threadfence();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * hk; i += blockDim.x) {
    const bool upper = i >= hk;
    const int j = upper ? i - hk : i;
    const int r = j / k, kk = j - r * k;
    const int g = upper ? cg.t1 + r : cg.t0 - cg.h1 + r;
    float v = 0.0f;
    if (rows && g >= 0 && g < cg.T) {
      const int q = g / cg.rows;  // the owner
      const int rq = min(cg.rows, cg.T - q * cg.rows);
      const int o = g - q * cg.rows;
      // an upper row is among the owner's first rows, a lower one among its last
      const int row = upper ? o : o - (rq - min(cg.h1, rq));
      v = __ldcg(cnmf_grid_edge(cg, parity, q, !upper) + row * k + kk);
    }
    (upper ? cg.hhi : cg.hlo)[j] = v;
    if (!upper) cg.carry[j] = v;
  }
  __syncthreads();
}

// Load a tile starting at fit row a: C rows [a - D + 1, a - D + 1 + n_c)
// into ct (before a from carry, then the fit's C up to t1, then the upper
// halo, 0 outside the fit) and X rows [a, a + n_x) into b.x (0 past T).
// Resident (one tile, a = t0): the block's X and its own C stay in shared
// memory, and only C's halo columns are written, the lower from hlo and,
// where n_c reaches past the block's rows, the upper from hhi.
__device__ void cnmf_grid_tile(const CnmfGrid& cg, const float* xf, const float* cf, int a,
                               int n_c, int n_x) {
  const CnmfBlock& b = cg.b;
  const int k = b.k;
  if (cg.resident) {
    const int own = cg.t1 - cg.t0, hk = cg.h1 * k;
    for (int i = threadIdx.x; i < k * (n_c - own); i += blockDim.x) {
      const bool upper = i >= hk;
      const int j = upper ? i - hk : i;
      const int r = j / k, kk = j - r * k;
      cg.ct[kk * cg.ldc + (upper ? cg.h1 + own + r : r)] = (upper ? cg.hhi : cg.hlo)[j];
    }
  } else {
    // C, a row's 4 synergies at a time (one 16-byte load where K is a
    // multiple of 4), CNMF_GRID_BATCH loads in flight a thread
    const int kc = (k + 3) / 4, total = n_c * kc;
    const bool vec = (k & 3) == 0;
    for (int base = threadIdx.x; base < total; base += CNMF_GRID_BATCH * blockDim.x) {
      float4 v[CNMF_GRID_BATCH];
#pragma unroll
      for (int u = 0; u < CNMF_GRID_BATCH; ++u) {
        const int e = base + u * blockDim.x;
        if (e >= total) continue;
        const int j = e / kc, c = e - j * kc;
        const int g = a - cg.h1 + j;
        if (vec && g >= a && g < cg.t1) {
          v[u] = __ldcg(reinterpret_cast<const float4*>(cf + (size_t)g * k) + c);
          continue;
        }
        float q[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int kk = 4 * c + w;
          if (kk >= k || g < 0 || g >= cg.T) {
            q[w] = 0.0f;
          } else if (g < a) {
            q[w] = cg.carry[(g - (a - cg.h1)) * k + kk];
          } else if (g < cg.t1) {
            q[w] = __ldcg(cf + (size_t)g * k + kk);
          } else {
            q[w] = cg.hhi[(g - cg.t1) * k + kk];
          }
        }
        v[u] = make_float4(q[0], q[1], q[2], q[3]);
      }
#pragma unroll
      for (int u = 0; u < CNMF_GRID_BATCH; ++u) {
        const int e = base + u * blockDim.x;
        if (e >= total) continue;
        const int j = e / kc, c = e - j * kc;
        const float q[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (4 * c + w < k) cg.ct[(4 * c + w) * cg.ldc + j] = q[w];
        }
      }
    }
    // X, a row's 16-byte chunks (one 16-byte load where L is a multiple
    // of 4), 0 past L and past T
    const int cr = b.lp / 4, tx = n_x * cr;
    for (int base = threadIdx.x; base < tx; base += CNMF_GRID_BATCH * blockDim.x) {
      float4 v[CNMF_GRID_BATCH];
#pragma unroll
      for (int u = 0; u < CNMF_GRID_BATCH; ++u) {
        const int e = base + u * blockDim.x;
        if (e >= tx) continue;
        const int j = e / cr, c = e - j * cr;
        const long long g = (long long)a + j;
        if ((b.l & 3) == 0) {
          v[u] = 4 * c < b.l && g < cg.T
                     ? *(reinterpret_cast<const float4*>(xf + g * b.l) + c)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          float q[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            q[w] = 4 * c + w < b.l && g < cg.T ? xf[g * b.l + 4 * c + w] : 0.0f;
          }
          v[u] = make_float4(q[0], q[1], q[2], q[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < CNMF_GRID_BATCH; ++u) {
        const int e = base + u * blockDim.x;
        if (e >= tx) continue;
        const int j = e / cr, c = e - j * cr;
        *reinterpret_cast<float4*>(b.x + cnmf_chunk(b, j, c)) = v[u];
      }
    }
  }
  __syncthreads();
}

// carry <- the old C rows [a + n - D + 1, a + n) of the tile in ct, for
// the next tile; barriers before (the tile's reads) and after.
__device__ inline void cnmf_grid_carry(const CnmfGrid& cg, int n) {
  const int k = cg.b.k;
  __syncthreads();
  for (int i = threadIdx.x; i < cg.h1 * k; i += blockDim.x) {
    const int r = i / k, kk = i - r * k;
    cg.carry[i] = cg.ct[kk * cg.ldc + n + r];
  }
  __syncthreads();
}

// Tile rows j, j + blockDim.x, ... (R of them, those from m on masked)
// of Xh[j, l] = sum_d sum_k C[a + j - d, k] S[k, d, l], summed over d
// then k as the block entry; the rows share each S broadcast.
template <int R>
__device__ inline void cnmf_grid_rows(const CnmfGrid& cg, int j, int m) {
  const CnmfBlock& b = cg.b;
  const int step = blockDim.x;
  for (int jt = 0; jt < b.lp / CNMF_LT; ++jt) {
    float acc[R][CNMF_LT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) acc[r][i] = 0.0f;
    }
    for (int d = 0; d < b.d; ++d) {
      const float* cd = cg.ct + cg.h1 - d + j;
#pragma unroll 2
      for (int k = 0; k < b.k; ++k) {
        float sv[CNMF_LT];
        cnmf_s_tile(b, k, d, jt, sv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float cv = j + r * step < m ? cd[k * cg.ldc + r * step] : 0.0f;
#pragma unroll
          for (int i = 0; i < CNMF_LT; ++i) acc[r][i] += cv * sv[i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jr = j + r * step;
      if (jr < m) {
        *(float4*)(b.xh + cnmf_chunk(b, jr, 2 * jt)) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *(float4*)(b.xh + cnmf_chunk(b, jr, 2 * jt + 1)) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
}

// Xh rows [0, m) of the tile from ct and S: each thread takes rows j, j
// + blockDim.x, j + 2 blockDim.x, j + 3 blockDim.x, as many of them as
// its warp has (1, 2, or up to 4).
__device__ void cnmf_grid_reconstruct(const CnmfGrid& cg, int m) {
  const int step = blockDim.x;
  for (int j = threadIdx.x; j < m; j += 4 * step) {
    const int left = m - (j & ~31);
    if (left > 2 * step) {
      cnmf_grid_rows<4>(cg, j, m);
    } else if (left > step) {
      cnmf_grid_rows<2>(cg, j, m);
    } else {
      cnmf_grid_rows<1>(cg, j, m);
    }
  }
  __syncthreads();
}

// Item q's S sums over tile rows [r0, r1) added to num[8] and den[8]:
// sum_t C[t - d, k] X[t, tile] and the same with Xh.  Every thread of a
// slice walks the same rows, so the X and Xh rows are broadcasts.
__device__ inline void cnmf_grid_item(const CnmfGrid& cg, int q, int r0, int r1, float* num,
                                      float* den) {
  const CnmfBlock& b = cg.b;
  const int tiles = b.lp / CNMF_LT;
  const int k = q / (b.d * tiles);
  const int rem = q - k * b.d * tiles;
  const int d = rem / tiles, jt = rem - d * tiles;
  const float* crow = cg.ct + k * cg.ldc + cg.h1 - d;
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

// The tile's share of the S sums (its rows [0, n)) added to the block's
// set: threads over items in `slices` time slices, slice 0 adding the
// others' partial sums in slice order.
__device__ void cnmf_grid_s_sums(const CnmfGrid& cg, int n) {
  const int items = cg.items, slices = cg.slices;
  if (slices == 1) {
    for (int q = threadIdx.x; q < items; q += blockDim.x) {
      float num[CNMF_LT], den[CNMF_LT];
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) num[i] = den[i] = 0.0f;
      cnmf_grid_item(cg, q, 0, n, num, den);
      float* out = cg.bpart + 16 * q;
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
    cnmf_grid_item(cg, q, g * n / slices, (g + 1) * n / slices, num, den);
    if (g > 0) {
      float* out = cg.scratch + 16 * ((size_t)(g - 1) * items + q);
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
      const float* in = cg.scratch + 16 * ((size_t)(gg - 1) * items + q);
#pragma unroll
      for (int i = 0; i < CNMF_LT; ++i) {
        num[i] += in[i];
        den[i] += in[CNMF_LT + i];
      }
    }
    float* out = cg.bpart + 16 * q;
#pragma unroll
    for (int i = 0; i < CNMF_LT; ++i) {
      out[i] += num[i];
      out[CNMF_LT + i] += den[i];
    }
  }
  __syncthreads();
}

// The sum of `count` float4s at src, src + stride, ..., each component
// added one after another from 0: rounds of CNMF_GRID_SUM4 loads in
// flight, then the rest one by one.
__device__ __forceinline__ float4 cnmf_grid_sum4(const float* src, int count, int stride) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int r = 0;
  for (; r + CNMF_GRID_SUM4 <= count; r += CNMF_GRID_SUM4) {
    float4 v[CNMF_GRID_SUM4];
#pragma unroll
    for (int u = 0; u < CNMF_GRID_SUM4; ++u) {
      v[u] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(r + u) * stride));
    }
#pragma unroll
    for (int u = 0; u < CNMF_GRID_SUM4; ++u) {
      s.x += v[u].x;
      s.y += v[u].y;
      s.z += v[u].z;
      s.w += v[u].w;
    }
  }
  for (; r < count; ++r) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * stride));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return s;
}

// After the S pass: the fit's S sums (the block's set to the workspace at
// `parity`, the fit's barrier, the P sets added in block order into the
// block's set; a lone block: its own), then S <- S * num / den, the same
// bits in every block.  `syncs` counts the fit's barriers.
__device__ void cnmf_grid_update_s(const CnmfGrid& cg, int parity, unsigned& syncs) {
  const CnmfBlock& b = cg.b;
  __syncthreads();
  if (cg.blocks > 1) {
    const float* sets = cg.part + (size_t)parity * cg.blocks * cg.pstride;
    float4* mine = reinterpret_cast<float4*>(
        cg.part + ((size_t)parity * cg.blocks + cg.rank) * cg.pstride);
    float4* own = reinterpret_cast<float4*>(cg.bpart);
    for (int q = threadIdx.x; q < cg.nq / 4; q += blockDim.x) __stcg(mine + q, own[q]);
    syncs += 1;
    nmf_grid_barrier(cg.counter, syncs * cg.blocks);
    for (int q = threadIdx.x; q < cg.nq / 4; q += blockDim.x) {
      own[q] = cnmf_grid_sum4(sets + 4 * q, cg.blocks, cg.pstride);
    }
    __syncthreads();
  }
  const int dl = b.d * b.l, tiles = b.lp / CNMF_LT;
  for (int i = threadIdx.x; i < b.k * dl; i += blockDim.x) {
    const int k = i / dl, r = i - k * dl;
    const int d = r / b.l, m = r - d * b.l;
    const int q = 16 * ((k * b.d + d) * tiles + m / CNMF_LT) + m % CNMF_LT;
    const float den = cg.bpart[q + CNMF_LT];
    const float dn = den == 0.0f ? EPSILON : den;
    float* sp = b.s + (k * b.d + d) * b.lp + m;
    *sp = *sp * (cg.bpart[q] / dn);
  }
  __syncthreads();
}

// C of tile rows j, j + blockDim.x, ... (R of them, those from n on
// masked; fit rows a + j, ...) from X and Xh rows t..t+D-1 (none past T)
// and ct's old C, 4 synergies at once, the rows sharing each S broadcast:
// into ct (resident) or the fit's C in device memory (streamed) and, for
// the block's edge rows, to its edge slots of `parity`.
template <int R>
__device__ inline void cnmf_grid_c_rows(const CnmfGrid& cg, float* cf, int a, int j, int n,
                                        int parity) {
  const CnmfBlock& b = cg.b;
  const int tiles = b.lp / CNMF_LT, step = blockDim.x;
  const bool edges = cg.blocks > 1 && cg.h1 > 0;
  int d_end[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    d_end[r] = j + r * step < n ? min(b.d, cg.T - (a + j + r * step)) : 0;
  }
  for (int k0 = 0; k0 < b.k; k0 += CNMF_KT) {
    float num[R][CNMF_KT], den[R][CNMF_KT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < CNMF_KT; ++q) num[r][q] = den[r][q] = 0.0f;
    }
    for (int d = 0; d < d_end[0]; ++d) {
      for (int jt = 0; jt < tiles; ++jt) {
        float sv[CNMF_KT][CNMF_LT];
#pragma unroll
        for (int q = 0; q < CNMF_KT; ++q) {
          if (k0 + q < b.k) {
            cnmf_s_tile(b, k0 + q, d, jt, sv[q]);
          } else {
#pragma unroll
            for (int i = 0; i < CNMF_LT; ++i) sv[q][i] = 0.0f;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (d < d_end[r]) {
            float xv[CNMF_LT], hv[CNMF_LT];
            cnmf_row_tile(b, b.x, j + r * step + d, jt, xv);
            cnmf_row_tile(b, b.xh, j + r * step + d, jt, hv);
#pragma unroll
            for (int q = 0; q < CNMF_KT; ++q) {
#pragma unroll
              for (int i = 0; i < CNMF_LT; ++i) {
                num[r][q] += xv[i] * sv[q][i];
                den[r][q] += hv[i] * sv[q][i];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jr = j + r * step;
      if (jr >= n) continue;
      const int g = a + jr;
#pragma unroll
      for (int q = 0; q < CNMF_KT; ++q) {
        const int kk = k0 + q;
        if (kk < b.k) {
          const float dn = den[r][q] == 0.0f ? EPSILON : den[r][q];
          float* cp = cg.ct + kk * cg.ldc + jr + cg.h1;
          const float v = *cp * (num[r][q] / dn);
          if (cg.resident) {
            *cp = v;
          } else {
            cf[(size_t)g * b.k + kk] = v;
          }
          if (edges) cnmf_grid_put_edge(cg, parity, g, kk, v);
        }
      }
    }
  }
}

// C of the tile's rows [0, n): two rows a thread (j and j + blockDim.x)
// where its warp has any second row, else one.
__device__ void cnmf_grid_update_c(const CnmfGrid& cg, float* cf, int a, int n, int parity) {
  for (int j = threadIdx.x; j < n; j += 2 * blockDim.x) {
    if ((j & ~31) + (int)blockDim.x < n) {
      cnmf_grid_c_rows<2>(cg, cf, a, j, n, parity);
    } else {
      cnmf_grid_c_rows<1>(cg, cf, a, j, n, parity);
    }
  }
  __syncthreads();
}

// One multiplicative update of S then C of the fit, starting from the C
// whose edges are keyed `parity` and of version `ver` (the new C's go to
// parity ^ 1 as version ver + 1); the S sums' buffer is keyed `parity`.
__device__ void cnmf_grid_step(const CnmfGrid& cg, const float* xf, float* cf, int parity,
                               unsigned& ver, unsigned& syncs) {
  for (int i = threadIdx.x; i < cg.nq; i += blockDim.x) cg.bpart[i] = 0.0f;
  cnmf_grid_halo(cg, parity, ver);  // its barriers also order the zeroing
  // ---- S: the block's share of the sums, from the old C and S ----
  for (int a = cg.t0; a < cg.t1; a += cg.tile) {
    const int n = min(cg.tile, cg.t1 - a);
    cnmf_grid_tile(cg, xf, cf, a, n + cg.h1, n);
    cnmf_grid_reconstruct(cg, n);
    cnmf_grid_s_sums(cg, n);
    if (!cg.resident) cnmf_grid_carry(cg, n);
  }
  cnmf_grid_update_s(cg, parity, syncs);
  // ---- C: Xh with the new S over the block's rows and D - 1 after ----
  if (!cg.resident) {
    for (int i = threadIdx.x; i < cg.h1 * cg.b.k; i += blockDim.x) cg.carry[i] = cg.hlo[i];
    __syncthreads();
  }
  for (int a = cg.t0; a < cg.t1; a += cg.tile) {
    const int n = min(cg.tile, cg.t1 - a);
    cnmf_grid_tile(cg, xf, cf, a, n + 2 * cg.h1, n + cg.h1);
    cnmf_grid_reconstruct(cg, n + cg.h1);
    if (!cg.resident) cnmf_grid_carry(cg, n);  // ct's old C, before the next tile
    cnmf_grid_update_c(cg, cf, a, n, parity ^ 1);
  }
  ver += 1;
  cnmf_grid_publish(cg, ver);
}

// ||X - Xh||_F of the fit, Xh rebuilt in float64 from the C whose edges
// are keyed `parity` (version `ver`), returned to every thread of every
// block: each block's sum over its rows, then the blocks' sums in block
// order.  A barrier of an iteration lies between two calls' uses of the
// slot.
__device__ double cnmf_grid_error(const CnmfGrid& cg, const float* xf, const float* cf,
                                  int parity, unsigned ver, unsigned& syncs) {
  const CnmfBlock& b = cg.b;
  cnmf_grid_halo(cg, parity, ver);
  double part = 0.0;
  for (int a = cg.t0; a < cg.t1; a += cg.tile) {
    const int n = min(cg.tile, cg.t1 - a);
    cnmf_grid_tile(cg, xf, cf, a, n + cg.h1, n);
    for (int q = threadIdx.x; q < n * b.l; q += blockDim.x) {
      const int j = q / b.l, m = q - j * b.l;
      double acc = 0.0;
      for (int d = 0; d < b.d; ++d) {
        for (int k = 0; k < b.k; ++k) {
          acc += (double)cg.ct[k * cg.ldc + j + cg.h1 - d] *
                 (double)b.s[(k * b.d + d) * b.lp + m];
        }
      }
      const double diff = (double)b.x[cnmf_xidx(b, j, m)] - acc;
      part += diff * diff;
    }
    if (!cg.resident) cnmf_grid_carry(cg, n);
  }
  return sqrt(nmf_grid_total_d(cg.counter, cg.err, cg.rank, cg.blocks, syncs, b.red,
                               nmf_block_sum_d(b.red, part)));
}

template <bool WITH_STOP>
__global__ void __launch_bounds__(NMF_GRID_THREADS) cnmf_cluster_kernel(
    NmfGridPlan p, const float* __restrict__ x, const float* __restrict__ c0,
    const float* __restrict__ s0, float* c, float* __restrict__ s,
    int* __restrict__ n_iter_out, float* __restrict__ prev_err_out,
    int* __restrict__ converged_out, float* __restrict__ ws, int batch, int d, int iters,
    double tol, int check_every) {
  extern __shared__ __align__(16) float smem[];
  const size_t fit = blockIdx.x / p.blocks;
  const int rank = (int)(blockIdx.x % p.blocks);
  const CnmfGrid cg = cnmf_grid(smem, p, d, ws, batch, fit, rank);
  const float* xf = x + fit * p.n * p.l;
  float* cf = c + fit * p.n * p.k;
  cnmf_grid_load(cg, xf, c0 + fit * p.n * p.k, cf, s0 + fit * p.k * d * p.l);
  unsigned ver = 1, syncs = 0;
  cnmf_grid_publish(cg, ver);
  int parity = 0;
  if (WITH_STOP) {
    // the block entry's loop: no tail chunk; every value that decides a
    // branch is the same in every block of the fit
    const double err0 = cnmf_grid_error(cg, xf, cf, parity, ver, syncs);
    const double scale = fmax(err0, (double)EPSILON);
    double prev_err = err0;
    int n_iter = 0;
    bool converged = false;
    while (n_iter < iters && !converged) {
      for (int i = 0; i < check_every; ++i) {
        cnmf_grid_step(cg, xf, cf, parity, ver, syncs);
        parity ^= 1;
      }
      n_iter += check_every;
      const double err = cnmf_grid_error(cg, xf, cf, parity, ver, syncs);
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
      cnmf_grid_step(cg, xf, cf, parity, ver, syncs);
      parity ^= 1;
    }
  }
  const CnmfBlock& b = cg.b;
  if (cg.resident) {
    for (int i = threadIdx.x; i < (cg.t1 - cg.t0) * b.k; i += blockDim.x) {
      const int r = i / b.k, kk = i - r * b.k;
      cf[(size_t)cg.t0 * b.k + i] = cg.ct[kk * cg.ldc + cg.h1 + r];
    }
  }
  if (rank == 0) {
    float* sf = s + fit * p.k * d * p.l;
    for (int i = threadIdx.x; i < b.k * b.d * b.l; i += blockDim.x) {
      const int r = i / b.l;
      sf[i] = b.s[r * b.lp + i - r * b.l];
    }
  }
}

// The cluster entry: cnmf_f32's arguments and results, for frames over
// one block's shared memory (models/kernels/cnmf_cuda.py: route), and
// `ws`, a zeroed workspace of `ws_floats` floats (at least
// cnmf_grid_workspace_floats; cnmf_cuda.grid_workspace_floats).  Writes
// the plan it took to `plan_out` (NMF_GRID_PLAN_INTS host ints),
// launches once on `stream` and returns cudaGetLastError(), or the error
// that refused the plan.
extern "C" int cnmf_cluster_f32(const float* x, const float* c0, const float* s0,
                                float* c, float* s, int* n_iter, float* prev_err,
                                int* converged, int batch, int t, int l, int k,
                                int d, int iters, double tol, int check_every,
                                int with_stop, float* ws, long long ws_floats,
                                int* plan_out, void* stream) {
  if (batch < 1 || t < 1 || l < 1 || k < 1 || d < 1 || d > t || iters < 0 ||
      (with_stop && check_every < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  int e = nmf_grid_sms(&sms);
  if (e != 0) return e;
  NmfGridPlan plan;
  e = cnmf_grid_rule(batch, t, l, k, d, sms, &plan);
  if (e != 0) return e;
  auto run = [&](auto kernel) {
    const int r = nmf_grid_settle(kernel, batch, sms, plan, plan_out);
    if (r != 0) return r;
    return nmf_grid_launch(kernel, batch, plan, cnmf_grid_workspace_floats(plan, d, batch),
                           ws_floats, st, x, c0, s0, c, s, n_iter, prev_err, converged, ws,
                           batch, d, iters, tol, check_every);
  };
  return with_stop ? run(cnmf_cluster_kernel<true>) : run(cnmf_cluster_kernel<false>);
}
