// Second-order-section filtering of float32 signals, one thread per
// signal column.  Two entry points share the cascade:
//   sosfiltfilt_f32  zero-phase (scipy.signal.sosfiltfilt), K3 below;
//   sosfilt_f32      one causal pass from given states (scipy.signal.sosfilt
//                    with zi, returning zf), K6 at the end of the file.
//
// K3 replaces the TPU kernel `sosfiltfilt_pallas`
// (muscle_synergies_tpu/ops/filter_pallas.py: _build_filtfilt, body
// _filtfilt_kernel).  The Pallas kernel cut time into chunks laid across
// the 128-wide lanes and composed the chunks' entry states with a
// log-doubling prefix, because a TPU core has one wide vector unit and
// a short signal-channel axis would leave it idle.  On the H100 the
// columns themselves give the parallelism: a dataset of B trials x C
// channels is B*C independent recurrences, so each thread runs one
// column's whole recurrence sequentially, in registers.
//
// Layout.  The wrapper (ops/filter_cuda.py) writes the edge-extended
// signal time-major as `ext` (n_ext, n_cols) with column = trial *
// channels + channel, so at each time step a warp reads 32 neighbouring
// columns: one 128-byte line.  The forward pass overwrites `ext` with
// its output; the backward pass reads it back in reverse and writes
// only the unpadded samples, straight into `out` (B, n_out, channels).
//
// Semantics (scipy's, as _sosfiltfilt_jit in ops/filters.py): the
// forward pass starts from zi_unit * ext[0], the backward pass from
// zi_unit * y_forward[n_ext - 1], both per section.  Sections use the
// transposed direct form II recurrence
//     y = b0 x + s1;  s1 <- -a1 s1 + s2 + (b1 - a1 b0) x;
//     s2 <- -a2 s1 + (b2 - a2 b0) x
// with the filter state and coefficients in float64: a 4 Hz pole pair
// at 2 kHz sits within 2% of the unit circle, and float64 keeps the
// state's rounding from accumulating over 10^5 samples.  Samples are
// stored in float32 between the passes, as the Pallas kernel does.
//
// What bounds it on this card: the sequential dependency chain of the
// recurrence (a few float64 FMA latencies per sample and section) and
// the latency of each column's loads, since B*C columns give only
// B*C/32 warps.  Each thread therefore double-buffers its loads: while
// it runs the recurrence over one tile of TILE samples, the next tile's
// TILE loads are in flight.  Each block is one warp, so that the few
// warps spread over as many SMs (and load pipelines) as there are.  The
// section count is a template parameter, so the coefficients and states
// of exactly NS sections live in registers (no spills).

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_SECTIONS 8
#define COEFS 7  // b0, b1 - a1 b0, b2 - a2 b0, a1, a2, zi1, zi2
#define THREADS 32
#define TILE 32

// One pass of the NS-section cascade over TILE samples held in `buf`
// (samples that lie outside the signal are skipped by `valid`).
template <int NS>
__device__ __forceinline__ void cascade_tile(float* buf, int valid,
                                             const double (&c)[NS][COEFS],
                                             double (&s1)[NS],
                                             double (&s2)[NS]) {
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (i < valid) {
      double v = (double)buf[i];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const double y = c[s][0] * v + s1[s];
        const double n1 = -c[s][3] * s1[s] + s2[s] + c[s][1] * v;
        s2[s] = -c[s][4] * s1[s] + c[s][2] * v;
        s1[s] = n1;
        v = y;
      }
      buf[i] = (float)v;
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS) sosfiltfilt_kernel(
    float* __restrict__ ext, float* __restrict__ out,
    const double* __restrict__ coef, int n_ext, int n_out, int padlen,
    int n_cols, int channels) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  double c[NS][COEFS], s1[NS], s2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int j = 0; j < COEFS; ++j) c[s][j] = coef[s * COEFS + j];
  }
  float* p = ext + col;
  const size_t stride = (size_t)n_cols;
  float cur[TILE], nxt[TILE];

  // ---- forward pass, in place, seeded with zi_unit * ext[0] ----
  const double first = (double)p[0];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    s1[s] = c[s][5] * first;
    s2[s] = c[s][6] * first;
  }
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (i < n_ext) cur[i] = p[(size_t)i * stride];
  }
  for (int t0 = 0; t0 < n_ext; t0 += TILE) {
    const int next = t0 + TILE;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (next + i < n_ext) nxt[i] = p[(size_t)(next + i) * stride];
    }
    const int valid = min(TILE, n_ext - t0);
    cascade_tile<NS>(cur, valid, c, s1, s2);
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (i < valid) p[(size_t)(t0 + i) * stride] = cur[i];
      cur[i] = nxt[i];
    }
  }

  // ---- backward pass, seeded with zi_unit * y_forward[n_ext - 1],
  // writing only the unpadded span ----
  const double last = (double)p[(size_t)(n_ext - 1) * stride];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    s1[s] = c[s][5] * last;
    s2[s] = c[s][6] * last;
  }
  const int trial = col / channels;
  const int chan = col - trial * channels;
  float* o = out + (size_t)trial * n_out * channels + chan;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (n_ext - 1 - i >= 0) cur[i] = p[(size_t)(n_ext - 1 - i) * stride];
  }
  for (int t0 = n_ext - 1; t0 >= 0; t0 -= TILE) {
    const int next = t0 - TILE;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (next - i >= 0) nxt[i] = p[(size_t)(next - i) * stride];
    }
    const int valid = min(TILE, t0 + 1);
    cascade_tile<NS>(cur, valid, c, s1, s2);
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      const int t = t0 - i;
      if (i < valid && t >= padlen && t < padlen + n_out) {
        o[(size_t)(t - padlen) * channels] = cur[i];
      }
      cur[i] = nxt[i];
    }
  }
}

template <int NS>
static void launch(int blocks, cudaStream_t stream, float* ext, float* out,
                   const double* coef, int n_ext, int n_out, int padlen,
                   int n_cols, int channels) {
  sosfiltfilt_kernel<NS><<<blocks, THREADS, 0, stream>>>(
      ext, out, coef, n_ext, n_out, padlen, n_cols, channels);
}

// ext: (n_ext, n_cols) float32, overwritten; out: (n_cols / channels,
// n_out, channels) float32; coef: (n_sections, 7) float64, all on the
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sosfiltfilt_f32(float* ext, float* out, const double* coef,
                               int n_sections, int n_ext, int n_out,
                               int padlen, int n_cols, int channels,
                               void* stream) {
  if (n_sections < 1 || n_sections > MAX_SECTIONS || n_ext < 1 ||
      n_cols < 1 || channels < 1 || n_cols % channels != 0 ||
      padlen < 0 || padlen + n_out > n_ext) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_cols + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_sections) {
    case 1: launch<1>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    case 2: launch<2>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    case 3: launch<3>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    case 4: launch<4>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    case 5: launch<5>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    case 6: launch<6>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    case 7: launch<7>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
    default: launch<8>(blocks, s, ext, out, coef, n_ext, n_out, padlen, n_cols, channels); break;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K6: the causal cascade from given per-section states.
//
// Replaces the TPU kernel `cascade_pallas`
// (muscle_synergies_tpu/ops/filter_pallas.py: _make_apply, body
// _cascade_kernel), which computes ops.filters.sosfilt with zi.  The
// Pallas kernel laid time chunks across the lanes and composed their
// entry states by log-doubling, to fill a TPU core's 1,024 lanes; here
// the B*C columns of a batch are the parallelism, one thread each, and
// time runs sequentially in registers with the same double-buffered
// TILE-sample loads and the same float64 state as K3's passes.
//
// Layout.  There is no edge extension, so nothing has to be copied
// before the pass: column col = trial * channels + channel is read in
// place from x (B, n, channels) and written to y in the same layout.
// At each time step a warp's 32 columns cover 32 / channels trials,
// each a run of `channels` neighbouring floats; at 8 channels that is
// four full 32-byte sectors, as many as one 128-byte line of a
// time-major fold.  zi and zf are (n_sections, 2, n_cols) float64 here;
// the Python wrapper hands zf back in the samples' float32, so a stream
// of chunks through it continues from states rounded to float32.
//
// What bounds it on this card: as K3, the recurrence's dependency chain
// and each column's load latency, with B*C/32 warps; the bytes it must
// move are one read of x and one write of y.
template <int NS>
__global__ void __launch_bounds__(THREADS) sosfilt_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const double* __restrict__ coef, const double* __restrict__ zi,
    double* __restrict__ zf, int n, int n_cols, int channels) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  double c[NS][COEFS], s1[NS], s2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int j = 0; j < COEFS; ++j) c[s][j] = coef[s * COEFS + j];
    s1[s] = zi[(size_t)(2 * s) * n_cols + col];
    s2[s] = zi[(size_t)(2 * s + 1) * n_cols + col];
  }
  const int trial = col / channels;
  const int chan = col - trial * channels;
  const size_t base = (size_t)trial * n * channels + chan;
  const float* p = x + base;
  float* o = y + base;
  const size_t stride = (size_t)channels;
  float cur[TILE], nxt[TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (i < n) cur[i] = p[(size_t)i * stride];
  }
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int next = t0 + TILE;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (next + i < n) nxt[i] = p[(size_t)(next + i) * stride];
    }
    const int valid = min(TILE, n - t0);
    cascade_tile<NS>(cur, valid, c, s1, s2);
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (i < valid) o[(size_t)(t0 + i) * stride] = cur[i];
      cur[i] = nxt[i];
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    zf[(size_t)(2 * s) * n_cols + col] = s1[s];
    zf[(size_t)(2 * s + 1) * n_cols + col] = s2[s];
  }
}

template <int NS>
static void launch_causal(int blocks, cudaStream_t stream, const float* x,
                          float* y, const double* coef, const double* zi,
                          double* zf, int n, int n_cols, int channels) {
  sosfilt_kernel<NS><<<blocks, THREADS, 0, stream>>>(x, y, coef, zi, zf, n,
                                                     n_cols, channels);
}

// x, y: (n_cols / channels, n, channels) float32, distinct buffers;
// coef: (n_sections, 7) float64 as for sosfiltfilt_f32 (its zi_unit
// columns are unused); zi, zf: (n_sections, 2, n_cols) float64, all on
// the device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sosfilt_f32(const float* x, float* y, const double* coef,
                           const double* zi, double* zf, int n_sections,
                           int n, int n_cols, int channels, void* stream) {
  if (n_sections < 1 || n_sections > MAX_SECTIONS || n < 1 || n_cols < 1 ||
      channels < 1 || n_cols % channels != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_cols + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_sections) {
    case 1: launch_causal<1>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    case 2: launch_causal<2>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    case 3: launch_causal<3>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    case 4: launch_causal<4>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    case 5: launch_causal<5>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    case 6: launch_causal<6>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    case 7: launch_causal<7>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
    default: launch_causal<8>(blocks, s, x, y, coef, zi, zf, n, n_cols, channels); break;
  }
  return (int)cudaGetLastError();
}
