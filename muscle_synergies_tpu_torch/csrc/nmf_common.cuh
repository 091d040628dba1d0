// Shared pieces of the batched NMF kernels (cd_nmf.cu, mu_nmf.cu,
// beta_nmf.cu; cnmf.cu takes the reductions and the launcher).
//
// One thread block owns one fit: X (N, L), W (N, K) and H (K, L) of its
// trial live in shared memory for the whole solve, so device memory is
// read once and written once per fit, whatever the iteration count.
// Row strides are padded to odd values so that threads walking rows
// (one row each) or columns (one lane per row) hit distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define NMF_THREADS 128
#define NMF_KMAX 16
// Shared memory one block may use on sm_90 (227 KB).
#define NMF_SMEM_LIMIT (227 * 1024)

struct NmfBlock {
  int n, l, k;
  int ldx, ldw;
  float* x;      // (n, ldx)
  float* w;      // (n, ldw)
  float* h;      // (k, l)
  float* gram;   // (k, k): H H^T in the W half-step, W^T W in the H half
  float* cross;  // (k, l): W^T X
  float* red;    // 33 floats of block-reduction scratch
};

// sklearn's dimension-scaled L1/L2 penalties of W and H (all 0 without
// regularization, which leaves every update bit for bit unchanged).
struct NmfPenalty {
  float l1_w, l2_w, l1_h, l2_h;
};

__host__ __device__ inline int nmf_odd(int v) { return v | 1; }

__host__ __device__ inline size_t nmf_smem_floats(int n, int l, int k) {
  return (size_t)n * (nmf_odd(l) + nmf_odd(k)) + 2 * (size_t)k * l +
         (size_t)k * k + 33;
}

__device__ inline NmfBlock nmf_block(float* smem, int n, int l, int k) {
  NmfBlock b;
  b.n = n;
  b.l = l;
  b.k = k;
  b.ldx = nmf_odd(l);
  b.ldw = nmf_odd(k);
  b.x = smem;
  b.w = b.x + (size_t)n * b.ldx;
  b.h = b.w + (size_t)n * b.ldw;
  b.gram = b.h + k * l;
  b.cross = b.gram + k * k;
  b.red = b.cross + k * l;
  return b;
}

// Copy one fit's X, W and H from device memory (row-major, unpadded).
__device__ inline void nmf_load(const NmfBlock& b, const float* x,
                                const float* w, const float* h) {
  for (int i = threadIdx.x; i < b.n * b.l; i += blockDim.x) {
    b.x[(i / b.l) * b.ldx + i % b.l] = x[i];
  }
  for (int i = threadIdx.x; i < b.n * b.k; i += blockDim.x) {
    b.w[(i / b.k) * b.ldw + i % b.k] = w[i];
  }
  for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) b.h[i] = h[i];
  __syncthreads();
}

__device__ inline void nmf_store(const NmfBlock& b, float* w, float* h) {
  for (int i = threadIdx.x; i < b.n * b.k; i += blockDim.x) {
    w[i] = b.w[(i / b.k) * b.ldw + i % b.k];
  }
  for (int i = threadIdx.x; i < b.k * b.l; i += blockDim.x) h[i] = b.h[i];
}

__device__ inline float nmf_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of `v` over the block, returned to every thread.
__device__ inline float nmf_block_sum(const NmfBlock& b, float v) {
  v = nmf_warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) b.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? b.red[lane] : 0.0f;
    v = nmf_warp_sum(v);
    if (lane == 0) b.red[32] = v;
  }
  __syncthreads();
  const float total = b.red[32];
  __syncthreads();
  return total;
}

// Sum of `v` over the block in float64, returned to every thread;
// `red` is 33 doubles of scratch.  The stopping statistics of the
// beta and convolutive kernels use it.
__device__ inline double nmf_block_sum_d(double* red, double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
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

// gram <- H H^T: K*K sums over L, one thread per entry.
__device__ inline void nmf_hht(const NmfBlock& b) {
  for (int q = threadIdx.x; q < b.k * b.k; q += blockDim.x) {
    const float* hi = b.h + (q / b.k) * b.l;
    const float* hj = b.h + (q % b.k) * b.l;
    float s = 0.0f;
    for (int m = 0; m < b.l; ++m) s += hi[m] * hj[m];
    b.gram[q] = s;
  }
  __syncthreads();
}

// gram <- W^T W and cross <- W^T X: K*K + K*L sums over N, one warp
// per entry with its lanes striding over the rows.
__device__ inline void nmf_wtw_wtx(const NmfBlock& b) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int kk = b.k * b.k;
  for (int q = threadIdx.x >> 5; q < kk + b.k * b.l; q += n_warps) {
    const float* a;
    const float* c;
    int ldc;
    if (q < kk) {
      a = b.w + q / b.k;
      c = b.w + q % b.k;
      ldc = b.ldw;
    } else {
      a = b.w + (q - kk) / b.l;
      c = b.x + (q - kk) % b.l;
      ldc = b.ldx;
    }
    float s = 0.0f;
    for (int r = lane; r < b.n; r += 32) s += a[r * b.ldw] * c[r * ldc];
    s = nmf_warp_sum(s);
    if (lane == 0) {
      if (q < kk) {
        b.gram[q] = s;
      } else {
        b.cross[q - kk] = s;
      }
    }
  }
  __syncthreads();
}

// Row n of X H^T into xr[0..K).
template <int KMAX>
__device__ inline void nmf_xht_row(const NmfBlock& b, int n, float* xr) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) xr[i] = 0.0f;
  const float* xn = b.x + n * b.ldx;
  for (int m = 0; m < b.l; ++m) {
    const float v = xn[m];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < b.k) xr[i] += v * b.h[i * b.l + m];
    }
  }
}

// ---- the warp entries (cd_nmf.cu, mu_nmf.cu, beta_nmf.cu) ----
//
// One warp per fit, NMF_WARP_FITS fits a block, no __syncthreads on the
// iteration path.  Lane i owns rows i, i + 32, ... (NMF_WARP_ROWS of
// them) with their X and W in registers; the fit's small matrices sit in
// a per-warp shared slab read as broadcasts.  Every loop runs over the
// padded extents (KMAX components, LMAX columns, all the lane's rows),
// whose exact zeros change no sum, so nothing branches on the fit's own
// N, L or k inside an iteration.  The limits are mirrored by
// models/kernels/mu_cuda.py: WARP_NMAX, WARP_LMAX, WARP_KMAX.

#define NMF_WARP_FITS 4   // fits (warps) per block
#define NMF_WARP_ROWS 7   // rows a lane owns
#define NMF_WARP_NMAX (32 * NMF_WARP_ROWS)
#define NMF_WARP_LMAX 16
#define NMF_WARP_KMAX 8
#define NMF_FULL_MASK 0xffffffffu

// Reduce-scatter by recursive halving: after the steps O = 16, 8, .., 1
// lane i holds in a[0] the warp's sum of a[i].  Each step sends half of
// what is left to the partner lane, 31 shuffles in all.
template <int O>
__device__ __forceinline__ void nmf_warp_halve(float (&a)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? a[i] : a[i + O];
    const float keep = up ? a[i + O] : a[i];
    a[i] = keep + __shfl_xor_sync(NMF_FULL_MASK, send, O);
  }
  if constexpr (O > 1) nmf_warp_halve<O / 2>(a, lane);
}

// One fit's small matrices (K2's and K1's warp entries), row strides
// KMAX and LMAX, zero-padded.
template <int KMAX, int LMAX>
struct __align__(16) NmfWarpSlab {
  float h[KMAX * LMAX];    // H
  float hht[KMAX * KMAX];  // H H^T
  float wtw[KMAX * KMAX];  // W^T W
  float wtx[KMAX * LMAX];  // W^T X
};

// slab.hht <- H H^T, K*K sums over L, one lane per entry.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_hht(NmfWarpSlab<KMAX, LMAX>& sl,
                                             int lane) {
  for (int q = lane; q < KMAX * KMAX; q += 32) {
    const float* hi = sl.h + (q / KMAX) * LMAX;
    const float* hj = sl.h + (q % KMAX) * LMAX;
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < LMAX; ++m) s += hi[m] * hj[m];
    sl.hht[q] = s;
  }
}

// One row of X H^T from the row of X in registers and the slab's H.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_xht_row(
    const NmfWarpSlab<KMAX, LMAX>& sl, const float (&xrow)[LMAX],
    float (&xh)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) xh[i] = 0.0f;
#pragma unroll
  for (int m = 0; m < LMAX; ++m) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) xh[i] += xrow[m] * sl.h[i * LMAX + m];
  }
}

// Every lane's a[v] summed over the warp, for every v, each by the
// butterfly of nmf_warp_sum: every lane ends with every sum, and each sum
// associates exactly as the block entries' one-warp-per-entry reductions
// (nmf_wtw_wtx, beta_step) associate theirs.
template <int NV>
__device__ __forceinline__ void nmf_warp_allsum(float (&a)[NV]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v) a[v] += __shfl_xor_sync(NMF_FULL_MASK, a[v], off);
  }
}

// slab.wtw <- W^T W and slab.wtx <- W^T X: each lane's partial sums over
// its rows, then per group of 32 entries either a reduce-scatter (K2: 31
// shuffles, one sum per lane) or, with BLOCK_ORDER (K1), butterflies
// that add the partial sums in the block entry's order (160 shuffles),
// so that the warp entry computes the block entry's iterates bit for
// bit.  A lane's rows i, i + 32, ... are the rows a lane of the block
// entry's reduction walks, in the same order.
template <int KMAX, int LMAX, bool BLOCK_ORDER = false>
__device__ __forceinline__ void nmf_warp_wtw_wtx(
    NmfWarpSlab<KMAX, LMAX>& sl, const float (&xr)[NMF_WARP_ROWS][LMAX],
    const float (&wr)[NMF_WARP_ROWS][KMAX], int lane) {
  constexpr int NWW = KMAX * KMAX;
  constexpr int NV = NWW + KMAX * LMAX;
#pragma unroll
  for (int g = 0; g < (NV + 31) / 32; ++g) {
    float a[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int q = 32 * g + v;
      float s = 0.0f;
      if (q < NWW) {
#pragma unroll
        for (int r = 0; r < NMF_WARP_ROWS; ++r) s += wr[r][q / KMAX] * wr[r][q % KMAX];
      } else if (q < NV) {
        const int u = q - NWW;
#pragma unroll
        for (int r = 0; r < NMF_WARP_ROWS; ++r) s += wr[r][u / LMAX] * xr[r][u % LMAX];
      }
      a[v] = s;
    }
    if constexpr (BLOCK_ORDER) {
      nmf_warp_allsum(a);
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int q = 32 * g + v;
        if (q < NWW) {
          sl.wtw[q] = a[v];
        } else if (q < NV) {
          sl.wtx[q - NWW] = a[v];
        }
      }
    } else {
      nmf_warp_halve<16>(a, lane);
      const int q = 32 * g + lane;
      if (q < NWW) {
        sl.wtw[q] = a[0];
      } else if (q < NV) {
        sl.wtx[q - NWW] = a[0];
      }
    }
  }
}

// Load one fit's X and W rows (lane's rows, zero-padded to LMAX columns
// and KMAX components, rows past n zero) into registers and H into the
// slab's (KMAX, LMAX) plane `hs`; ends with a __syncwarp.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_load(
    const float* xf, const float* wf, const float* hf, int n, int l, int k,
    int lane, float (&xr)[NMF_WARP_ROWS][LMAX],
    float (&wr)[NMF_WARP_ROWS][KMAX], float* hs) {
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    const int row = lane + 32 * r;
#pragma unroll
    for (int m = 0; m < LMAX; ++m) {
      xr[r][m] = row < n && m < l ? xf[row * l + m] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      wr[r][i] = row < n && i < k ? wf[row * k + i] : 0.0f;
    }
  }
  for (int q = lane; q < KMAX * LMAX; q += 32) {
    const int i = q / LMAX, m = q % LMAX;
    hs[q] = i < k && m < l ? hf[i * l + m] : 0.0f;
  }
  __syncwarp();
}

// Store the lane's rows of W and the slab's H back, unpadded.
template <int KMAX, int LMAX>
__device__ __forceinline__ void nmf_warp_store(
    float* wo, float* ho, int n, int l, int k, int lane,
    const float (&wr)[NMF_WARP_ROWS][KMAX], const float* hs) {
#pragma unroll
  for (int r = 0; r < NMF_WARP_ROWS; ++r) {
    const int row = lane + 32 * r;
    if (row < n) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) wo[row * k + i] = wr[r][i];
      }
    }
  }
  for (int q = lane; q < k * l; q += 32) ho[q] = hs[(q / l) * LMAX + q % l];
}

// Launch `kernel` with one block per fit, raising the dynamic shared
// memory limit first when the fit needs more than the default 48 KB.
template <typename Kernel, typename... Args>
inline int nmf_launch(Kernel kernel, int batch, size_t smem,
                      cudaStream_t stream, Args... args) {
  if (smem > NMF_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<batch, NMF_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}
