// Batched HALS / coordinate-descent NMF: a warp-per-fit entry for the
// time-normalised frames of the main paths, the cluster (grid) entry, one
// fit spread over many blocks of the card (at the end of this file), for
// every larger frame, and a block-per-fit entry for batches of frames
// within one block's shared memory at rank 9-10 that fill the card with
// waves of fits (models/kernels/cd_cuda.py: route).
//
// Replaces the TPU kernels `cd_iterations_pallas` and `fit_cd_pallas`
// (muscle_synergies_tpu/models/kernels/cd_pallas.py: _cd_kernel,
// _fit_cd_kernel, _cd_iteration).  Both entries compute the same
// iteration:
//   - W pass: H H^T first; then the cyclic component loop on each row of
//     W in registers (the rows are independent given H H^T and X H^T);
//   - H pass: W^T W and W^T X, then the cyclic component loop on each
//     column of H;
//   - the stopping rule inside the fit (WITH_STOP): a fit ends when it
//     converges, the frozen-trial semantics of the batched reference.
// Numerics follow models/hals.py (sklearn's _update_cdnmf_fast with
// shuffle=False): gradient W H H^T - X H^T per component, the projected
// gradient taken from the column *before* its update, the L2 penalty on
// the Gram diagonal and the L1 penalty subtracted from X H^T (or W^T X),
// a Newton step grad / hess clipped at 0, the column left unchanged when
// hess == 0 (which keeps zero-padded rank components exactly 0), and
// sklearn's stop: the summed |projected gradient| of iteration 1 is the
// reference, and a fit stops once violation / violation_init <= tol (or
// the reference is 0).  The two entries sum in different orders, so
// their float32 results differ by rounding.
//
// Block entry (cd_nmf_f32, any frame whose X, W and H fit one block's
// shared memory; the route gives it only batches at rank 9-10 that would
// take the grid entry 4 or more waves of one block a SM): one block of
// 128 threads per fit, everything in shared memory.  Against the grid
// entry (H100 80GB HBM3, 700 W, us an iteration,
// scripts/torch_cluster_timing.py): one fit of 2,400 x 8 at rank 4 23.7
// against 5.8 on 10 blocks, 1,024 fits 179.9 against 88.2 on one block
// each (two a SM); at rank 9-16, whose grid kernel holds one block a SM,
// 1,024 x 200 x 16 at rank 9 100.4 against 108.6, at rank 12 131.9
// against 115.8.  What bounds it: a fit is ~36 KFLOP an iteration at
// 200 x 8, rank 4, and the block spends its iteration on a chain of
// seven __syncthreads (H H^T, the W pass, W^T W and W^T X as 48 warp
// reductions over 4 warps, the H pass on 8 of 128 threads, a 3-barrier
// block sum for the violation), so the CD path's rank-1 fits, which run
// all 100,000 iterations, ran at 7.6 us an iteration alone on an H100
// (scripts/torch_ab_parent_kernels.py).
//
// Warp entry (cd_nmf_warp_f32, N <= NMF_WARP_NMAX, L <= NMF_WARP_LMAX,
// k <= NMF_WARP_KMAX): one warp per fit, NMF_WARP_FITS fits per block, no
// __syncthreads on the iteration path.  Lane i owns rows i, i + 32, ...
// (7 a lane at N = 200, the last partly masked) with their X and W in
// registers; H, H H^T, W^T W and W^T X sit in a per-warp shared slab
// read as broadcasts, and three __syncwarp order the passes.  Each fit
// runs over its own rank kr, found at load: the last component whose
// column of W0 or row of H0 holds a nonzero, plus one.  A rank sweep pads
// every fit to its top rank, and a padded component stays exactly 0 (its
// Hessian is the L2 penalty, its gradient the L1 penalty >= 0, its step
// clipped at 0), so skipping it drops only exact zeros: a padded fit
// computes the bits of the same fit launched at k = kr, and the parent
// design's bits (every sum keeps its order).  The KMAX-4 kernels (the
// main paths' sweeps) take kr as a compile-time constant, their loops
// straight-line code; the KMAX-8 kernels bound them at run time (with
// the compile-time kernels' registers they would spill).  H H^T and W^T W
// are symmetric: a lane computes one entry of the lower triangle and
// writes it and its mirror.  W^T W's lower triangle and W^T X are each
// lane's partial sums over its rows, packed component by component into
// cd_slot0(kr) slots (9 at rank 1, L = 8; 42 at rank 4) and combined by a
// reduce-scatter by recursive halving that pairs lanes by xor 16, 8, 4,
// 2, 1 (31 shuffles a group of 32 slots, 16 for a last group of 16 or
// fewer); the violation is a warp sum.  What bounds it: one fit alone is
// bound by the dependent chain of an iteration.  In the parent design
// that chain was the cyclic loop's 28 steps (7 rows x KMAX 4), each an
// IEEE division whose slow-path branch kept the rows' steps from
// overlapping: ~260-280 cycles a step, 69-71% of an iteration, a padded
// step (0/0) as dear as a real one (H100, scripts/torch_warp_profile.py).
// The KMAX-4 kernels run a component's step on all 7 rows at once, the
// quotients from the component's reciprocal, taken before the loop, by
// cd_div (no branch, the division's bits): a lone rank-1 200 x 8 fit
// 5.1 -> 0.74 us an iteration, rank 4 4.6 -> 2.3.  Across the ~1,000
// fits of a main path, the SM's issue rate.  Device memory is touched
// only at the start and the end of the solve.

#include "nmf_common.cuh"

// ---------------------------- block entry ----------------------------

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

// ---------------------------- warp entry -----------------------------

// One fit's small matrices, row strides KMAX and LMAX: H, H H^T, and the
// H pass's W^T W and W^T X in one plane (gw).  The Gram entries past the
// fit's rank are zeroed at load and never written.
template <int KMAX, int LMAX>
struct __align__(16) CdWarpSlab {
  float h[KMAX * LMAX];
  float hht[KMAX * KMAX];
  float gw[KMAX * KMAX + KMAX * LMAX];  // W^T W, then W^T X
};

// The slots of the reduce-scatter, by component: component i owns i + 1
// entries of W^T W's lower triangle (j <= i), then its LMAX of W^T X, so a
// rank-kr fit fills the first cd_slot0(kr) slots whatever the launch's k.
__host__ __device__ constexpr int cd_slot0(int i, int lmax) { return i * (i + 1) / 2 + i * lmax; }

// The fit's own rank and, for each lane, where its entries of H H^T and
// its slots of the reduce-scatter go in the slab (offsets; -1 for none).
template <int KMAX, int LMAX>
struct CdWarpRank {
  static constexpr int NT = (KMAX * (KMAX + 1) / 2 + 31) / 32;  // rounds of H H^T
  static constexpr int NG = (cd_slot0(KMAX, LMAX) + 31) / 32;   // groups of 32 slots
  int kr;  // the last component with a nonzero in W0's column or H0's row, + 1
  int nv;  // slots of the fit, cd_slot0(kr)
  int hi[NT], hj[NT], ho[NT], hm[NT];  // H H^T entry: rows of H, place, mirror
  int so[NG], sm[NG];  // slot 32 g + lane of the groups of 32: place, mirror
  int so16, sm16;      // slot 32 g + lane / 2 of a last group of 16 or fewer
};

// Slot q of a rank-kr fit to its place in gw and its mirror in W^T W.
template <int KMAX, int LMAX>
__device__ inline void cd_slot_place(int q, int kr, int& o, int& m) {
  o = m = -1;
  for (int i = 0; i < kr; ++i) {
    const int t = q - cd_slot0(i, LMAX);
    if (t < 0 || t > i + LMAX) continue;
    if (t <= i) {
      o = i * KMAX + t;
      m = t == i ? -1 : t * KMAX + i;
    } else {
      o = KMAX * KMAX + i * LMAX + (t - i - 1);
    }
  }
}

// The fit's rank from W0 (the lanes' rows) and H0 (the slab), the same in
// every lane, and the lane's places; zeroes the slab's Gram planes.
template <int KMAX, int LMAX>
__device__ inline CdWarpRank<KMAX, LMAX> cd_warp_rank(
    CdWarpSlab<KMAX, LMAX>& sl, const float (&wr)[NMF_WARP_ROWS][KMAX], int lane) {
  using Rank = CdWarpRank<KMAX, LMAX>;
  unsigned bits = 0;
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) bits |= wr[r][i] != 0.0f ? 1u << i : 0u;
  }
  for (int q = lane; q < KMAX * LMAX; q += 32) bits |= sl.h[q] != 0.0f ? 1u << (q / LMAX) : 0u;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) bits |= __shfl_xor_sync(NMF_FULL_MASK, bits, off);
  Rank rk;
  rk.kr = 32 - __clz((int)bits);
  rk.nv = cd_slot0(rk.kr, LMAX);
#pragma unroll
  for (int t = 0; t < Rank::NT; ++t) {
    int e = lane + 32 * t, i = 0;
    while (e > i) e -= ++i;  // entry lane + 32 t of the triangle is (i, e)
    const bool on = lane + 32 * t < rk.kr * (rk.kr + 1) / 2;
    rk.hi[t] = on ? i * LMAX : -1;
    rk.hj[t] = e * LMAX;
    rk.ho[t] = i * KMAX + e;
    rk.hm[t] = e * KMAX + i;
  }
#pragma unroll
  for (int g = 0; g < Rank::NG; ++g) {
    cd_slot_place<KMAX, LMAX>(32 * g + lane, rk.kr, rk.so[g], rk.sm[g]);
  }
  cd_slot_place<KMAX, LMAX>(32 * ((rk.nv - 1) / 32) + lane / 2, rk.kr, rk.so16, rk.sm16);
  for (int q = lane; q < KMAX * KMAX; q += 32) sl.hht[q] = 0.0f;
  for (int q = lane; q < KMAX * (KMAX + LMAX); q += 32) sl.gw[q] = 0.0f;
  __syncwarp();
  return rk;
}

// The reduce-scatter of 16 values a[0..16) over the warp, pairing lanes
// as nmf_warp_halve does (16, 8, 4, 2, then 1), so each sum associates as
// there: after it lanes 2v and 2v + 1 hold the warp's sum of a[v].
template <int O, int H>
__device__ __forceinline__ void cd_warp_halve16(float (&a)[32], int lane) {
  if constexpr (H == 0) {
    a[0] += __shfl_xor_sync(NMF_FULL_MASK, a[0], O);
  } else {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? a[i] : a[i + H];
      const float keep = up ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(NMF_FULL_MASK, send, O);
    }
    cd_warp_halve16<O / 2, H / 2>(a, lane);
  }
}

// H H^T or W^T W for the cyclic loops, g(j, s) = G[j][s]: copied into
// registers at KMAX <= 4, read from the slab above (the KMAX-8 kernels'
// registers hold their rows).
template <int KMAX>
struct CdWarpGram {
  static constexpr bool REGS = KMAX <= 4;
  float v[REGS ? KMAX : 1][REGS ? KMAX : 1];
  const float* p;
  __device__ __forceinline__ explicit CdWarpGram(const float* src) : p(src) {
    if constexpr (REGS) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
#pragma unroll
        for (int s = 0; s < KMAX; ++s) v[j][s] = src[j * KMAX + s];
      }
    }
  }
  __device__ __forceinline__ float operator()(int j, int s) const {
    if constexpr (REGS) {
      return v[j][s];
    } else {
      return p[j * KMAX + s];
    }
  }
};

// grad / hess from y = 1 / hess, correctly rounded: the quotient grad * y
// corrected twice by its exact residual (Markstein: from a reciprocal
// within half an ulp and a quotient within an ulp, one correction rounds
// correctly; the first brings grad * y within an ulp), so the bits are
// the IEEE division's wherever cd_div_ok holds for both operands (no step
// overflows or underflows), without the division's slow-path branch; a
// zero grad returns itself, sign and all.
__device__ __forceinline__ float cd_div(float grad, float hess, float y) {
  float q = __fmul_rn(grad, y);
  float r = __fmaf_rn(-hess, q, grad);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-hess, q, grad);
  q = __fmaf_rn(r, y, q);
  return grad == 0.0f ? grad : q;
}

__device__ __forceinline__ bool cd_div_ok(float v) {
  const float m = fabsf(v);
  return m == 0.0f || (m >= 0x1p-60f && m <= 0x1p60f);
}

// 1 / (G[s][s] + l2) for each of the fit's KR components: the
// reciprocals of the cyclic loops' Hessians, taken before the loops so
// that no division sits in their steps.
template <int KMAX, int KR>
__device__ __forceinline__ void cd_warp_recips(const CdWarpGram<KMAX>& g, float l2,
                                               float (&y)[KR]) {
#pragma unroll
  for (int s = 0; s < KR; ++s) y[s] = 1.0f / (g(s, s) + l2);
}

// sklearn's cyclic loop on every row of the lane at once, a component
// at a time (the rows are independent given G and X H^T): the rows'
// steps of one component share the reciprocal y[s] and carry no branch,
// so they overlap; a step whose operands leave cd_div_ok's range divides.
// Each row's |projected gradient| of each step goes to pp[r][s], which
// the caller adds in the row-by-row order of the parent design.
template <int KMAX, int KR, bool WITH_VIOL>
__device__ __forceinline__ void cd_warp_rows(float (&wr)[NMF_WARP_ROWS][KMAX],
                                             const CdWarpGram<KMAX>& g,
                                             const float (&xh)[NMF_WARP_ROWS][KMAX],
                                             const float (&y)[KR], float l1, float l2,
                                             float (&pp)[NMF_WARP_ROWS][KR]) {
  constexpr int R = NMF_WARP_ROWS;
#pragma unroll
  for (int s = 0; s < KR; ++s) {
    const float hess = g(s, s) + l2;
    float grad[R], q[R];
    bool ok = hess != 0.0f && cd_div_ok(hess);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      grad[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < KR; ++j) grad[r] += (g(j, s) + (j == s ? l2 : 0.0f)) * wr[r][j];
      grad[r] -= xh[r][s] - l1;
      if (WITH_VIOL) pp[r][s] = fabsf(wr[r][s] == 0.0f ? fminf(grad[r], 0.0f) : grad[r]);
      ok = ok && cd_div_ok(grad[r]);
    }
    if (ok) {
#pragma unroll
      for (int r = 0; r < R; ++r) q[r] = cd_div(grad[r], hess, y[s]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) q[r] = grad[r] / hess;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float step = fmaxf(wr[r][s] - q[r], 0.0f);
      wr[r][s] = hess != 0.0f ? step : wr[r][s];
    }
  }
}

// sklearn's cyclic component loop on one row of W (or column of H) over
// the fit's components: for each component s in order, the gradient
// sum_j G[j][s] v[j] - c[s] with the penalties, its projected value added
// to `part`, and the Newton step grad / hess clipped at 0 unless the
// Hessian G[s][s] + l2 is 0.  At a compile-time rank KR the loops stop at
// KR and the quotients come from the reciprocals y[s] (cd_div) where in
// range; else (KR = 0) they run over KMAX components to the run-time
// rank kr (past kr, G and v are 0, which adds exact zeros) and divide.
template <int KMAX, int KR, bool WITH_VIOL>
__device__ __forceinline__ void cd_warp_cyclic(float (&v)[KMAX], const CdWarpGram<KMAX>& g,
                                               const float (&c)[KMAX], int kr,
                                               const float (&y)[KR > 0 ? KR : 1], float l1,
                                               float l2, float& part) {
  constexpr int K = KR > 0 ? KR : KMAX;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s >= kr) break;
    float grad = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) grad += (g(j, s) + (j == s ? l2 : 0.0f)) * v[j];
    grad -= c[s] - l1;
    if (WITH_VIOL) part += fabsf(v[s] == 0.0f ? fminf(grad, 0.0f) : grad);
    const float hess = g(s, s) + l2;
    float q;
    if (KR > 0 && hess != 0.0f && cd_div_ok(hess) && cd_div_ok(grad)) {
      q = cd_div(grad, hess, y[KR > 0 ? s : 0]);
    } else {
      q = grad / hess;
    }
    const float step = fmaxf(v[s] - q, 0.0f);
    v[s] = hess != 0.0f ? step : v[s];
  }
}

// One outer iteration of one fit on one warp, W pass then H pass, over
// the fit's own rank kr (KR when it is given, a compile-time rank whose
// loops unroll without branches; else rk.kr): the components past it (a
// rank sweep's padding) hold exact zeros in W and H that stay 0, so every
// sum the parent design took over them gains nothing from them, and
// every sum here associates as there (the rows in order, then the lanes
// by xor 16, 8, 4, 2, 1).  Returns the summed |projected gradient| to
// every lane when WITH_VIOL.
template <int KMAX, int LMAX, int KR, bool WITH_VIOL>
__device__ __forceinline__ float cd_warp_iteration(
    CdWarpSlab<KMAX, LMAX>& sl, const CdWarpRank<KMAX, LMAX>& rk,
    const float (&xr)[NMF_WARP_ROWS][LMAX], float (&wr)[NMF_WARP_ROWS][KMAX], int lane,
    const NmfPenalty& pen) {
  using Rank = CdWarpRank<KMAX, LMAX>;
  constexpr int R = NMF_WARP_ROWS;
  const int kr = KR > 0 ? KR : rk.kr;
  const int nv = KR > 0 ? cd_slot0(KR, LMAX) : rk.nv;
  float part = 0.0f;

  // ---- H H^T: its lower triangle, a lane an entry, mirrored ----
#pragma unroll
  for (int t = 0; t < Rank::NT; ++t) {
    if (rk.hi[t] >= 0) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < LMAX; ++m) s += sl.h[rk.hi[t] + m] * sl.h[rk.hj[t] + m];
      sl.hht[rk.ho[t]] = s;
      sl.hht[rk.hm[t]] = s;
    }
  }
  __syncwarp();

  // ---- W pass on the lane's rows, H fixed: X H^T a component at a
  // time over every row, then the rows' cyclic loops ----
  const CdWarpGram<KMAX> hht(sl.hht);
  float y[KR > 0 ? KR : 1];
  if constexpr (KR > 0) cd_warp_recips<KMAX, KR>(hht, pen.l2_w, y);
  float xh[R][KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i >= kr) break;
#pragma unroll
    for (int r = 0; r < R; ++r) xh[r][i] = 0.0f;
#pragma unroll
    for (int m = 0; m < LMAX; ++m) {
      const float hv = sl.h[i * LMAX + m];
#pragma unroll
      for (int r = 0; r < R; ++r) xh[r][i] += xr[r][m] * hv;
    }
  }
  if constexpr (KR > 0) {
    float pp[R][KR];
    cd_warp_rows<KMAX, KR, WITH_VIOL>(wr, hht, xh, y, pen.l1_w, pen.l2_w, pp);
    if (WITH_VIOL) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int s = 0; s < KR; ++s) part += pp[r][s];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cd_warp_cyclic<KMAX, KR, WITH_VIOL>(wr[r], hht, xh[r], kr, y, pen.l1_w, pen.l2_w, part);
    }
  }

  // ---- W^T W and W^T X: the lane's partial sums over its rows, slot by
  // slot, a group of 32 slots at a time; the components past kr skipped ----
#pragma unroll
  for (int grp = 0; grp < Rank::NG; ++grp) {
    if (32 * grp >= nv) break;
    float a[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) a[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i >= kr) break;
#pragma unroll
      for (int t = 0; t <= i + LMAX; ++t) {
        const int v = cd_slot0(i, LMAX) + t - 32 * grp;
        if (v < 0 || v >= 32) continue;
        float s = 0.0f;  // W^T W (i, t) for t <= i, else W^T X (i, t - i - 1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s += wr[r][i] * (t <= i ? wr[r][t < KMAX ? t : 0] : xr[r][t > i ? t - i - 1 : 0]);
        }
        a[v] = s;
      }
    }
    // ---- the reduce-scatter: 31 shuffles for a group of 32 slots, 15 + 1
    // for a last group of 16 or fewer ----
    if (nv - 32 * grp > 16) {
      nmf_warp_halve<16>(a, lane);
      if (rk.so[grp] >= 0) sl.gw[rk.so[grp]] = a[0];
      if (rk.sm[grp] >= 0) sl.gw[rk.sm[grp]] = a[0];
    } else {
      cd_warp_halve16<16, 8>(a, lane);
      if ((lane & 1) == 0 && rk.so16 >= 0) sl.gw[rk.so16] = a[0];
      if ((lane & 1) == 0 && rk.sm16 >= 0) sl.gw[rk.sm16] = a[0];
    }
  }
  __syncwarp();

  // ---- H pass on the LMAX columns, W fixed ----
  if (lane < LMAX) {
    float hc[KMAX], cc[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      hc[i] = sl.h[i * LMAX + lane];
      cc[i] = sl.gw[KMAX * KMAX + i * LMAX + lane];
    }
    const CdWarpGram<KMAX> wtw(sl.gw);
    if constexpr (KR > 0) cd_warp_recips<KMAX, KR>(wtw, pen.l2_h, y);
    cd_warp_cyclic<KMAX, KR, WITH_VIOL>(hc, wtw, cc, kr, y, pen.l1_h, pen.l2_h, part);
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i >= kr) break;
      sl.h[i * LMAX + lane] = hc[i];
    }
  }
  __syncwarp();

  // ---- the violation: a warp sum ----
  const float viol = WITH_VIOL ? nmf_warp_sum(part) : 0.0f;
  return viol;
}

// One fit's solve on its warp at rank KR (0: the fit's own rk.kr at run
// time): sklearn's loop with the stop, or `iters` iterations without it.
template <int KMAX, int LMAX, int KR, bool WITH_STOP>
__device__ __forceinline__ void cd_warp_solve(
    CdWarpSlab<KMAX, LMAX>& sl, const CdWarpRank<KMAX, LMAX>& rk,
    const float (&xr)[NMF_WARP_ROWS][LMAX], float (&wr)[NMF_WARP_ROWS][KMAX], int lane,
    size_t fit, int* n_iter_out, float* viol_init_out, int* converged_out, int iters,
    float tol, const NmfPenalty& pen) {
  if (WITH_STOP) {
    int n_iter = 0;
    float viol_init = 0.0f;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const float viol = cd_warp_iteration<KMAX, LMAX, KR, true>(sl, rk, xr, wr, lane, pen);
      n_iter += 1;
      if (n_iter == 1) viol_init = viol;
      converged = viol_init == 0.0f || viol / viol_init <= tol;
    }
    if (lane == 0) {
      n_iter_out[fit] = n_iter;
      viol_init_out[fit] = viol_init;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) {
      cd_warp_iteration<KMAX, LMAX, KR, false>(sl, rk, xr, wr, lane, pen);
    }
  }
}

// The KMAX-4 kernels run a fit at its rank as a compile-time constant
// (the main paths' sweeps of ranks 1-4: straight-line loops); the KMAX-8
// kernels bound their loops by the rank at run time.
template <int KMAX, int LMAX, bool WITH_STOP>
__global__ void __launch_bounds__(32 * NMF_WARP_FITS) cd_warp_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w,
    float* __restrict__ h, int* __restrict__ n_iter_out,
    float* __restrict__ viol_init_out, int* __restrict__ converged_out,
    int batch, int n, int l, int k, int iters, float tol, NmfPenalty pen) {
  __shared__ CdWarpSlab<KMAX, LMAX> slabs[NMF_WARP_FITS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t fit = (size_t)blockIdx.x * NMF_WARP_FITS + warp;
  if (fit >= (size_t)batch) return;  // whole warps only: no block barrier
  CdWarpSlab<KMAX, LMAX>& sl = slabs[warp];
  float xr[NMF_WARP_ROWS][LMAX], wr[NMF_WARP_ROWS][KMAX];
  nmf_warp_load<KMAX, LMAX>(x + fit * n * l, w0 + fit * n * k,
                            h0 + fit * k * l, n, l, k, lane, xr, wr, sl.h);
  const CdWarpRank<KMAX, LMAX> rk = cd_warp_rank(sl, wr, lane);
#define CD_WARP_SOLVE(KR)                                                                \
  cd_warp_solve<KMAX, LMAX, KR, WITH_STOP>(sl, rk, xr, wr, lane, fit, n_iter_out,         \
                                           viol_init_out, converged_out, iters, tol, pen)
  if constexpr (KMAX <= 4) {
    if (rk.kr <= 1) {
      CD_WARP_SOLVE(1);  // rank 0 too: its component 0 stays 0
    } else if (rk.kr == 2) {
      CD_WARP_SOLVE(2);
    } else if (rk.kr == 3) {
      CD_WARP_SOLVE(3);
    } else {
      CD_WARP_SOLVE(KMAX);
    }
  } else {
    CD_WARP_SOLVE(0);
  }
#undef CD_WARP_SOLVE
  nmf_warp_store<KMAX, LMAX>(w + fit * n * k, h + fit * k * l, n, l, k, lane,
                             wr, sl.h);
}

template <int KMAX, int LMAX>
static int cd_warp_dispatch(bool with_stop, const float* x, const float* w0,
                            const float* h0, float* w, float* h, int* n_iter,
                            float* viol_init, int* converged, int batch, int n,
                            int l, int k, int iters, float tol, NmfPenalty pen,
                            cudaStream_t stream) {
  const int blocks = (batch + NMF_WARP_FITS - 1) / NMF_WARP_FITS;
  if (with_stop) {
    cd_warp_kernel<KMAX, LMAX, true><<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
        x, w0, h0, w, h, n_iter, viol_init, converged, batch, n, l, k, iters,
        tol, pen);
  } else {
    cd_warp_kernel<KMAX, LMAX, false><<<blocks, 32 * NMF_WARP_FITS, 0, stream>>>(
        x, w0, h0, w, h, n_iter, viol_init, converged, batch, n, l, k, iters,
        tol, pen);
  }
  return (int)cudaGetLastError();
}

// The warp entry: cd_nmf_f32's arguments and results, for frames with
// n <= NMF_WARP_NMAX, l <= NMF_WARP_LMAX and k <= NMF_WARP_KMAX
// (models/kernels/cd_cuda.py: route); anything else is refused.
extern "C" int cd_nmf_warp_f32(const float* x, const float* w0,
                               const float* h0, float* w, float* h,
                               int* n_iter, float* viol_init, int* converged,
                               int batch, int n, int l, int k, int iters,
                               float tol, float l1_w, float l2_w, float l1_h,
                               float l2_h, int with_stop, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || n > NMF_WARP_NMAX ||
      l > NMF_WARP_LMAX || k > NMF_WARP_KMAX || iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const bool st = with_stop != 0;
  if (k <= 4) {
    return l <= 8 ? cd_warp_dispatch<4, 8>(st, x, w0, h0, w, h, n_iter,
                                           viol_init, converged, batch, n, l,
                                           k, iters, tol, pen, s)
                  : cd_warp_dispatch<4, 16>(st, x, w0, h0, w, h, n_iter,
                                            viol_init, converged, batch, n, l,
                                            k, iters, tol, pen, s);
  }
  return l <= 8 ? cd_warp_dispatch<8, 8>(st, x, w0, h0, w, h, n_iter,
                                         viol_init, converged, batch, n, l, k,
                                         iters, tol, pen, s)
                : cd_warp_dispatch<8, 16>(st, x, w0, h0, w, h, n_iter,
                                          viol_init, converged, batch, n, l, k,
                                          iters, tol, pen, s);
}

// --------------------------- cluster entry ---------------------------
//
// cd_nmf_cluster_f32: the entry for frames past the warp entry, from 225
// rows (a subject's concatenated cycles, a trial resampled longer) to a
// whole capture's envelope for find_synergies or `analyze --reduce-to
// 0`, replacing `fit_cd_pallas` / `cd_iterations_pallas` there; above one
// block's shared memory at any batch, within it at every batch but the
// block entry's.  One fit is spread over P blocks of the whole card
// (nmf_common.cuh: the grid entries), at most SMs / batch, as K1's
// cluster entry (mu_nmf.cu).  An iteration follows the block entry's
// order: H H^T in every block; sklearn's cyclic component loop on the
// block's rows of W (row-local given H H^T and the row's X H^T), each
// row's |projected gradient| added to the block's violation; the block's
// share of W^T W and W^T X summed in registers; the fit's one barrier in
// device memory; the P partial sets (and W-pass violations) added in
// block order; the H pass on the same numbers in every block, so H and
// its violation are the same bits everywhere.  The stopping ratio
// violation / violation_init is thus the same value in every block of a
// fit and every block takes the same branch.  What bounds it: as K1's,
// the latency of an iteration's chain (the barrier's round trip through
// L2, the P sets read back, the block's barriers around the H pass), not
// its bytes or operations; the rank-1 fits of a capture sweep, which run
// all 100,000 iterations, pay it each time.

// sklearn's cyclic component loop on one row of W against its row of
// X H^T and t.gram = H H^T; returns the row's summed |projected
// gradient| when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
struct CdClusterRows {
  NmfPenalty pen;
  __device__ float operator()(float (&wr)[KMAX], const float (&xh)[KMAX],
                              const NmfBlock& t) const {
    float part = 0.0f;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < t.k) {
        float grad = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < t.k) {
            grad += (t.gram[j * t.k + s] + (j == s ? pen.l2_w : 0.0f)) * wr[j];
          }
        }
        grad -= xh[s] - pen.l1_w;
        if (WITH_VIOL) part += fabsf(wr[s] == 0.0f ? fminf(grad, 0.0f) : grad);
        const float hess = t.gram[s * t.k + s] + pen.l2_w;
        if (hess != 0.0f) wr[s] = fmaxf(wr[s] - grad / hess, 0.0f);
      }
    }
    return part;
  }
};

// sklearn's cyclic loop on each column of H, one thread a column (b.gram
// holds W^T W and b.cross W^T X, the fit's sums); returns the
// block's summed |projected gradient| when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
__device__ float cd_cluster_cols(const NmfBlock& b, const NmfPenalty& pen) {
  float part = 0.0f;
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

// The fit's own rank, the same in every block of the fit: the last
// component whose column of W0 or row of H0 holds a nonzero, plus one
// (at least 1).  Each block scans its rows of W0 (rows of `ldw` floats,
// the launch's k) and all of H0, and the blocks' ranks meet in the fit's
// stopping-statistic slots (which CD leaves unused) at one barrier.
__device__ int cd_grid_rank(const NmfGrid& g, const float* w0f, const float* h0f, int ldw,
                            unsigned& syncs) {
  const NmfBlock& b = g.b;
  int mine = 1;
  const float* wb = w0f + g.r0 * ldw;
  for (size_t e = threadIdx.x; e < (size_t)g.rows * ldw; e += blockDim.x) {
    if (wb[e] != 0.0f) mine = max(mine, (int)(e % ldw) + 1);
  }
  for (int e = threadIdx.x; e < ldw * b.l; e += blockDim.x) {
    if (h0f[e] != 0.0f) mine = max(mine, e / b.l + 1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mine = max(mine, __shfl_xor_sync(NMF_FULL_MASK, mine, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) b.red[warp] = (float)mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    float top = 1.0f;
    for (int v = 0; v < (int)(blockDim.x >> 5); ++v) top = fmaxf(top, b.red[v]);
    if (g.blocks > 1) {
      __stcg(g.err + g.rank, top);
    } else {
      b.red[32] = top;
    }
  }
  if (g.blocks > 1) {
    syncs += 1;
    nmf_grid_barrier(g.counter, syncs * g.blocks);
    if (threadIdx.x == 0) {
      float top = 1.0f;
      for (int r = 0; r < g.blocks; ++r) top = fmaxf(top, __ldcg(g.err + r));
      b.red[32] = top;
    }
  }
  __syncthreads();
  const int kr = (int)b.red[32];
  __syncthreads();
  return kr;
}

// `cnt` rows of the first `cols` of `ld_src` floats at src, into dst
// column-major (stride ld), and back: the W columns of a fit whose own
// rank is below the launch's k.
__device__ inline void cd_grid_gather_w(float* dst, int ld, const float* src, int ld_src,
                                        int cnt, int cols) {
  for (int e = threadIdx.x; e < cnt * cols; e += blockDim.x) {
    dst[(size_t)(e % cols) * ld + e / cols] = __ldcg(src + (size_t)(e / cols) * ld_src + e % cols);
  }
}

__device__ inline void cd_grid_scatter_w(float* dst, int ld_dst, const float* src, int ld,
                                         int cnt, int cols) {
  for (int e = threadIdx.x; e < cnt * cols; e += blockDim.x) {
    __stcg(dst + (size_t)(e / cols) * ld_dst + e % cols, src[(size_t)(e % cols) * ld + e / cols]);
  }
}

// nmf_grid_load for a fit held at its own rank g.b.k: H0's first k rows;
// resident, the block's rows of X and of W0's first k columns (of ldw);
// streamed, its rows of W0 copied whole to W in device memory.
__device__ inline void cd_grid_load(const NmfGrid& g, const float* xf, const float* w0f,
                                    float* wf, const float* h0f, int ldw) {
  const NmfBlock& b = g.b;
  for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) b.h[i] = h0f[i];
  if (g.resident) {
    nmf_grid_gather(g.y + (size_t)b.k * g.tile, g.tile, xf + g.r0 * b.l, g.rows, b.l);
    if (b.k == ldw) {
      nmf_grid_gather(g.y, g.tile, w0f + g.r0 * ldw, g.rows, ldw);
    } else {
      cd_grid_gather_w(g.y, g.tile, w0f + g.r0 * ldw, ldw, g.rows, b.k);
    }
  } else {
    const float* ws = w0f + g.r0 * ldw;
    float* wd = wf + g.r0 * ldw;
    for (size_t i = threadIdx.x; i < (size_t)g.rows * ldw; i += blockDim.x) wd[i] = ws[i];
  }
  __syncthreads();
}

// nmf_grid_chunks<true> for a fit held at its own rank: streamed tiles
// take the first g.b.k columns of W's rows of ldw floats in device memory.
template <typename Body>
__device__ void cd_grid_chunks(const NmfGrid& g, const float* xf, float* wf, int ldw,
                               Body body) {
  if (g.resident || g.b.k == ldw) {
    nmf_grid_chunks<true>(g, xf, wf, body);
    return;
  }
  const int k = g.b.k, l = g.b.l;
  for (int i = 0; i * g.tile < g.rows; ++i) {
    const size_t row = g.r0 + (size_t)i * g.tile;
    const NmfGridRows c{g.y, g.tile, min(g.tile, g.rows - i * g.tile)};
    nmf_grid_gather(c.y + (size_t)k * c.ld, c.ld, xf + row * l, c.n, l);
    cd_grid_gather_w(c.y, c.ld, wf + row * ldw, ldw, c.n, k);
    __syncthreads();
    body(c);
    __syncthreads();
    cd_grid_scatter_w(wf + row * ldw, ldw, c.y, c.ld, c.n, k);
    __syncthreads();  // before the next tile's copy refills the buffer
  }
}

// nmf_grid_store for a fit held at its own rank: its W rows and, from
// rank 0, H, each with zeros past the fit's rank up to the launch's k.
__device__ inline void cd_grid_store(const NmfGrid& g, float* wf, float* hf, int ldw) {
  const NmfBlock& b = g.b;
  if (b.k == ldw) {
    nmf_grid_store(g, wf, hf);
    return;
  }
  if (g.resident) {
    float* wd = wf + g.r0 * ldw;
    for (size_t e = threadIdx.x; e < (size_t)g.rows * ldw; e += blockDim.x) {
      const int c = (int)(e % ldw);
      wd[e] = c < b.k ? g.y[(size_t)c * g.tile + e / ldw] : 0.0f;
    }
  }
  if (g.rank == 0) {
    for (int i = threadIdx.x; i < ldw * b.l; i += blockDim.x) hf[i] = i < b.k * b.l ? b.h[i] : 0.0f;
  }
}

// One outer CD iteration of the fit, W pass then H pass; `parity` picks
// the partial-set buffer.  Returns the fit's violation (every block's
// W-pass share in block order, then the H pass's) to every thread of
// every block when WITH_VIOL.
template <int KMAX, bool WITH_VIOL>
__device__ float cd_grid_iteration(const NmfGrid& g, const float* xf, float* wf, int ldw,
                                   int parity, unsigned& syncs, const NmfPenalty& pen) {
  const NmfBlock& b = g.b;
  for (int q = threadIdx.x; q <= g.nq; q += blockDim.x) g.bpart[q] = 0.0f;
  nmf_hht(b);  // its closing barrier also orders the zeroing
  float viol = 0.0f;
  cd_grid_chunks(g, xf, wf, ldw, [&](const NmfGridRows& c) {
    viol += nmf_grid_w_pass<KMAX>(b, c, CdClusterRows<KMAX, WITH_VIOL>{pen});
    nmf_grid_gram_pass(g, c);
  });
  if (WITH_VIOL) {
    const float mine = nmf_block_sum(b, viol);
    if (threadIdx.x == 0) g.bpart[g.nq] = mine;
  }
  const float viol_w = nmf_grid_sum(g, parity, syncs);
  const float viol_h = cd_cluster_cols<KMAX, WITH_VIOL>(b, pen);
  return viol_w + viol_h;
}

// Every block of a fit holds it at the fit's own rank kr (cd_grid_rank):
// its state is laid out as a launch at k = kr would lay it out, within
// the plan's shared memory and partial sets (sized for the launch's k),
// so a rank sweep's padded components cost nothing and a padded fit
// computes the same bits as the same fit launched at k = kr on the same
// plan.
template <int KMAX, bool WITH_STOP>
__global__ void __launch_bounds__(NMF_GRID_THREADS) cd_cluster_kernel(
    NmfGridPlan p, const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ h0, float* __restrict__ w, float* __restrict__ h,
    int* __restrict__ n_iter_out, float* __restrict__ viol_init_out,
    int* __restrict__ converged_out, float* __restrict__ ws, int batch, int iters,
    float tol, NmfPenalty pen) {
  extern __shared__ float smem[];
  const size_t fit = blockIdx.x / p.blocks;
  NmfGrid g = nmf_grid(smem, p, ws, batch, fit, (int)(blockIdx.x % p.blocks));
  const float* xf = x + fit * p.n * p.l;
  const float* w0f = w0 + fit * p.n * p.k;
  const float* h0f = h0 + fit * p.k * p.l;
  float* wf = w + fit * p.n * p.k;
  unsigned syncs = 0;
  g.b.k = cd_grid_rank(g, w0f, h0f, p.k, syncs);
  g.nq = nmf_grid_nq(p.l, g.b.k);
  cd_grid_load(g, xf, w0f, wf, h0f, p.k);
  int parity = 0;
  if (WITH_STOP) {
    int n_iter = 0;
    float viol_init = 0.0f;
    bool converged = false;
    while (n_iter < iters && !converged) {
      const float viol = cd_grid_iteration<KMAX, true>(g, xf, wf, p.k, parity, syncs, pen);
      parity ^= 1;
      n_iter += 1;
      if (n_iter == 1) viol_init = viol;
      converged = viol_init == 0.0f || viol / viol_init <= tol;
    }
    if (g.rank == 0 && threadIdx.x == 0) {
      n_iter_out[fit] = n_iter;
      viol_init_out[fit] = viol_init;
      converged_out[fit] = converged ? 1 : 0;
    }
  } else {
    for (int t = 0; t < iters; ++t) {
      cd_grid_iteration<KMAX, false>(g, xf, wf, p.k, parity, syncs, pen);
      parity ^= 1;
    }
  }
  cd_grid_store(g, wf, h + fit * p.k * p.l, p.k);
}

// The cluster entry: cd_nmf_f32's arguments and results, for frames over
// one block's shared memory and for small batches of smaller frames
// (models/kernels/cd_cuda.py: route), and
// `ws`, a zeroed workspace of `ws_floats` floats (at least
// nmf_grid_workspace_floats).  Writes the plan it took to `plan_out`
// (NMF_GRID_PLAN_INTS host ints), launches once on `stream` and returns
// cudaGetLastError(), or the error that refused the plan.
extern "C" int cd_nmf_cluster_f32(const float* x, const float* w0,
                                  const float* h0, float* w, float* h,
                                  int* n_iter, float* viol_init,
                                  int* converged, int batch, int n, int l,
                                  int k, int iters, float tol, float l1_w,
                                  float l2_w, float l1_h, float l2_h,
                                  int with_stop, float* ws, long long ws_floats,
                                  int* plan_out, void* stream) {
  if (batch < 1 || n < 1 || l < 1 || k < 1 || k > NMF_KMAX || iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const NmfPenalty pen = {l1_w, l2_w, l1_h, l2_h};
  const cudaStream_t s = (cudaStream_t)stream;
#define CD_CLUSTER_RUN(KM, ST)                                                   \
  nmf_grid_run(cd_cluster_kernel<KM, ST>, batch, n, l, k, ws_floats, plan_out, s, \
               x, w0, h0, w, h, n_iter, viol_init, converged, ws, batch, iters,  \
               tol, pen)
#define CD_CLUSTER_CALL(KM) \
  (with_stop ? CD_CLUSTER_RUN(KM, true) : CD_CLUSTER_RUN(KM, false))
  return NMF_CLUSTER_DISPATCH(k, CD_CLUSTER_CALL);
#undef CD_CLUSTER_CALL
#undef CD_CLUSTER_RUN
}
