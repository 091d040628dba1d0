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
