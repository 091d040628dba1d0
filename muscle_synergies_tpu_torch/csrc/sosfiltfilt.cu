// Second-order-section filtering of float32 signals as chunked scans.
// Two entry points share one templated chunked cascade:
//   sosfiltfilt_f32  zero-phase (scipy.signal.sosfiltfilt) over a padded
//                    batch of trials of their own lengths, K3;
//   sosfilt_f32      one causal pass from given states (scipy.signal.sosfilt
//                    with zi, returning zf), K6.
//
// K3 replaces the TPU kernel `sosfiltfilt_pallas`
// (muscle_synergies_tpu/ops/filter_pallas.py: _build_filtfilt, body
// _filtfilt_kernel), K6 replaces `cascade_pallas` (same file:
// _make_apply, body _cascade_kernel).  Both Pallas kernels cut time into
// chunks and composed the chunks' entry states (compose_entry).  This
// file does the same for the H100: a batch has only B*C columns (512 at
// 64 trials x 8 channels, 16 warps for 132 SMs), so one thread walking a
// column's whole recurrence leaves the card idle and sets the time by
// one serial float64 chain of ~250,000 steps.
//
// Algebra.  The NS sections form one linear system with state z of size
// 2*NS, ordered (s1, s2) per section: one sample steps it as
// z' = A z + b x, y = c z + d x, with A block lower-triangular.  Over a
// chunk of Lc samples z_end = A^Lc z_start + r, where r is the chunk's
// final state from a zero start.  The host builds P = A^Lc in float64
// (ops/filter_cuda.py), so each pass is three phases, each a kernel
// launched here on the caller's stream:
//   1. local sweep: each thread owns one (column, chunk), runs the cascade
//      from zero over its chunk and writes only r to a float64 workspace
//      ws (n_chunks, 2*NS, n_cols); no samples are stored.  The column's
//      last chunk needs no r and exits;
//   2. compose: one thread per column walks its chunks, entry_0 = the
//      pass's seed, entry_j = P entry_{j-1} + r_{j-1}, writing each entry
//      over r in ws;
//   3. emit sweep: each (column, chunk) reruns from its entry state and
//      writes its samples; K6's zf is the state at the end of the last
//      chunk.
//
// Layout.  Column col = trial * channels + channel is read in place from
// the (B, N, C) batch; a warp holds 32 neighbouring columns of one chunk,
// so at each time step it reads whole 32-byte sectors (4 trials x 8
// channels at C = 8).  K3's trials may be ragged: `lengths` (B,) gives
// each trial's true length n_b inside the padded N_max.  K3 builds the
// edge extension by index (odd, even, constant or none, against each
// trial's own first and last sample, padlen samples at each end), keeps
// the forward output in float32 in a scratch `fwd` (B, N_max + 2 padlen,
// C), as the Pallas kernel keeps samples in float32 between the passes,
// and runs the backward pass in reversed per-trial time u = n_ext_b - 1
// - t, so its chunk grid is anchored at each trial's own end and the one
// P serves every chunk.  It writes the n_b unpadded samples into `out`
// (B, N_max, C) and zeros past them.  Chunks past a trial's end exit.
//
// Semantics (scipy's): the forward pass starts from zi_unit * ext[0],
// the backward pass from zi_unit * y_forward[n_ext_b - 1], both per
// section.  Sections use the transposed direct form II recurrence
//     y = b0 x + s1;  s1 <- -a1 s1 + s2 + (b1 - a1 b0) x;
//     s2 <- -a2 s1 + (b2 - a2 b0) x
// with state and coefficients in float64: a 4 Hz pole pair at 2 kHz
// sits within about 1% of the unit circle, and float64 keeps the
// state's rounding from accumulating over 10^5 samples.
//
// What bounds it on this card: the bytes.  A pass reads its input twice
// (local and emit sweeps) and writes once; K3's two passes and its
// scratch come to about six sweeps of the batch.  The float64 work
// doubles with the two sweeps but stays below the bytes at NS <= 4.
// Each thread loads a tile of TILE samples of its chunk at once, then
// runs them; the many (column, chunk) warps hide the load latency, and
// double-buffering the tiles (the next tile's loads in flight while one
// runs) measured no faster on the H100 (PERF.md).  The section count is
// a template parameter, so the coefficients and states of exactly NS
// sections live in registers.

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_SECTIONS 8
#define COEFS 7  // b0, b1 - a1 b0, b2 - a2 b0, a1, a2, zi1, zi2
#define LANES 32          // columns per block
#define CHUNKS_PER_BLOCK 4  // chunks per block: blocks of 32 x 4 threads
#define COMPOSE_THREADS 128
#define TILE 16

enum Padtype { PAD_NONE = 0, PAD_ODD = 1, PAD_EVEN = 2, PAD_CONST = 3 };

template <int NS>
struct Cascade {
  double b0[NS], bb1[NS], bb2[NS], a1[NS], a2[NS];

  __device__ __forceinline__ void load(const double* __restrict__ coef) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      b0[s] = coef[s * COEFS + 0];
      bb1[s] = coef[s * COEFS + 1];
      bb2[s] = coef[s * COEFS + 2];
      a1[s] = coef[s * COEFS + 3];
      a2[s] = coef[s * COEFS + 4];
    }
  }

  // One sample through the NS sections; returns the cascade's output.
  __device__ __forceinline__ double step(double (&z)[2 * NS], double v) const {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const double y = b0[s] * v + z[2 * s];
      const double n1 = -a1[s] * z[2 * s] + z[2 * s + 1] + bb1[s] * v;
      z[2 * s + 1] = -a2[s] * z[2 * s] + bb2[s] * v;
      z[2 * s] = n1;
      v = y;
    }
    return v;
  }
};

// zi_unit * v for every section: the steady state of a constant input v.
template <int NS>
__device__ __forceinline__ void steady_state(const double* __restrict__ coef,
                                             double v, double (&e)[2 * NS]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    e[2 * s] = coef[s * COEFS + 5] * v;
    e[2 * s + 1] = coef[s * COEFS + 6] * v;
  }
}

// A tile of TILE samples from t0, sample by sample (valid of them).
template <class Col>
__device__ __forceinline__ void load_by_sample(const Col& c, int t0, int valid,
                                               float (&buf)[TILE]) {
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (i < valid) buf[i] = c.in(t0 + i);
  }
}

// ---- the three passes, each a description of one column's signal ----

// K6: column col of x (B, n, C), written to y in the same layout, from
// the caller's states zi, final states to zf ((2 * NS, n_cols) each).
struct CausalPass {
  const float* x;
  float* y;
  const double* zi;
  double* zf;
  int n, n_cols, channels;

  struct Col {
    const float* p;
    float* o;
    int channels, len;
    __device__ __forceinline__ float in(int k) const {
      return p[(size_t)k * channels];
    }
    __device__ __forceinline__ void load(int t0, int valid, float (&buf)[TILE]) const {
      load_by_sample(*this, t0, valid, buf);
    }
    __device__ __forceinline__ void out(int k, float v) const {
      o[(size_t)k * channels] = v;
    }
    __device__ __forceinline__ void tail(int, int) const {}
  };

  __device__ __forceinline__ Col column(int col) const {
    const int trial = col / channels;
    const size_t base = (size_t)trial * n * channels + (col - trial * channels);
    return Col{x + base, y + base, channels, n};
  }
  template <int NS>
  __device__ __forceinline__ void seed(const Col&, int col, const double*,
                                       double (&e)[2 * NS]) const {
#pragma unroll
    for (int i = 0; i < 2 * NS; ++i) e[i] = zi[(size_t)i * n_cols + col];
  }
  template <int NS>
  __device__ __forceinline__ void final_state(int col,
                                              const double (&z)[2 * NS]) const {
#pragma unroll
    for (int i = 0; i < 2 * NS; ++i) zf[(size_t)i * n_cols + col] = z[i];
  }
};

// K3's forward pass: the edge-extended trial, built by index from x
// (B, n_max, C) and the trial's length, into fwd (B, n_max + 2 padlen, C).
struct ForwardPass {
  const float* x;
  float* fwd;
  const int* lengths;
  int n_max, padlen, mode, channels;

  struct Col {
    const float* p;
    float* o;
    int channels, n, padlen, mode, len;
    float first, last;
    // sample t of the extended signal (scipy's odd_ext / even_ext / const_ext)
    __device__ __forceinline__ float in(int t) const {
      const int i = t - padlen;
      if (i < 0) {
        if (mode == PAD_CONST) return first;
        const float v = p[(size_t)(-i) * channels];
        return mode == PAD_ODD ? 2.0f * first - v : v;
      }
      if (i >= n) {
        if (mode == PAD_CONST) return last;
        const float v = p[(size_t)(2 * n - 2 - i) * channels];
        return mode == PAD_ODD ? 2.0f * last - v : v;
      }
      return p[(size_t)i * channels];
    }
    // a tile inside the trial's own samples takes no edge rule
    __device__ __forceinline__ void load(int t0, int valid, float (&buf)[TILE]) const {
      const int i0 = t0 - padlen;
      if (i0 >= 0 && i0 + TILE <= n) {
#pragma unroll
        for (int i = 0; i < TILE; ++i) buf[i] = p[(size_t)(i0 + i) * channels];
      } else {
        load_by_sample(*this, t0, valid, buf);
      }
    }
    __device__ __forceinline__ void out(int t, float v) const {
      o[(size_t)t * channels] = v;
    }
    __device__ __forceinline__ void tail(int, int) const {}
  };

  __device__ __forceinline__ Col column(int col) const {
    const int trial = col / channels;
    const int chan = col - trial * channels;
    const int n = lengths[trial];
    const float* p = x + (size_t)trial * n_max * channels + chan;
    float* o = fwd + (size_t)trial * (n_max + 2 * padlen) * channels + chan;
    return Col{p, o, channels, n, padlen, mode, n + 2 * padlen, p[0],
               p[(size_t)(n - 1) * channels]};
  }
  template <int NS>
  __device__ __forceinline__ void seed(const Col& c, int, const double* coef,
                                       double (&e)[2 * NS]) const {
    steady_state<NS>(coef, (double)c.in(0), e);
  }
  template <int NS>
  __device__ __forceinline__ void final_state(int, const double (&)[2 * NS]) const {}
};

// K3's backward pass: the forward output read from the trial's end,
// u = n_ext - 1 - t, over the n + padlen steps that reach out's first
// sample; writes out (B, n_max, C), and zeros past the trial's length.
struct BackwardPass {
  const float* fwd;
  float* dst;
  const int* lengths;
  int n_max, padlen, channels;

  struct Col {
    const float* p;  // fwd at the trial's last extended sample
    float* o;
    int channels, n, padlen, n_max, len;
    __device__ __forceinline__ float in(int u) const {
      return p[-(ptrdiff_t)u * channels];
    }
    __device__ __forceinline__ void load(int t0, int valid, float (&buf)[TILE]) const {
      load_by_sample(*this, t0, valid, buf);
    }
    __device__ __forceinline__ void out(int u, float v) const {
      const int i = n + padlen - 1 - u;
      if (i < n) o[(size_t)i * channels] = v;
    }
    // chunk j of the grid zeroes its share of out's rows [n, n_max)
    __device__ __forceinline__ void tail(int j, int chunk) const {
      const int stop = min(n_max, n + (j + 1) * chunk);
      for (int i = n + j * chunk; i < stop; ++i) o[(size_t)i * channels] = 0.0f;
    }
  };

  __device__ __forceinline__ Col column(int col) const {
    const int trial = col / channels;
    const int chan = col - trial * channels;
    const int n = lengths[trial];
    const float* p = fwd + (size_t)trial * (n_max + 2 * padlen) * channels + chan +
                     (size_t)(n + 2 * padlen - 1) * channels;
    float* o = dst + (size_t)trial * n_max * channels + chan;
    return Col{p, o, channels, n, padlen, n_max, n + padlen};
  }
  template <int NS>
  __device__ __forceinline__ void seed(const Col& c, int, const double* coef,
                                       double (&e)[2 * NS]) const {
    steady_state<NS>(coef, (double)c.in(0), e);
  }
  template <int NS>
  __device__ __forceinline__ void final_state(int, const double (&)[2 * NS]) const {}
};

// ---- the three phases ----

// Phases 1 (EMIT false) and 3 (EMIT true): thread (lane, y) of block
// (x, y) owns column blockIdx.y * 32 + lane and chunk blockIdx.x * 4 + y.
template <int NS, bool EMIT, class Pass>
__global__ void __launch_bounds__(LANES * CHUNKS_PER_BLOCK) sweep_kernel(
    Pass pass, const double* __restrict__ coef, double* __restrict__ ws,
    int n_cols, int chunk) {
  const int col = blockIdx.y * LANES + threadIdx.x;
  const int j = blockIdx.x * CHUNKS_PER_BLOCK + threadIdx.y;
  if (col >= n_cols) return;
  const typename Pass::Col c = pass.column(col);
  if (EMIT) c.tail(j, chunk);
  const int n_chunks = (c.len + chunk - 1) / chunk;
  if (EMIT ? j >= n_chunks : j >= n_chunks - 1) return;
  Cascade<NS> k;
  k.load(coef);
  double z[2 * NS];
  double* w = ws + (size_t)j * 2 * NS * n_cols + col;
#pragma unroll
  for (int i = 0; i < 2 * NS; ++i) z[i] = EMIT ? w[(size_t)i * n_cols] : 0.0;
  const int start = j * chunk;
  const int end = min(start + chunk, c.len);
  for (int t0 = start; t0 < end; t0 += TILE) {
    float buf[TILE];
    const int valid = min(TILE, end - t0);
    c.load(t0, valid, buf);
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (i < valid) {
        const double y = k.step(z, (double)buf[i]);
        if (EMIT) c.out(t0 + i, (float)y);
      }
    }
  }
  if (!EMIT) {
#pragma unroll
    for (int i = 0; i < 2 * NS; ++i) w[(size_t)i * n_cols] = z[i];
  } else if (j == n_chunks - 1) {
    pass.template final_state<NS>(col, z);
  }
}

// Phase 2: one thread per column turns the chunks' r into entry states,
// loading G chunks' r at once so that their loads overlap (fewer at
// large NS, where G * 2 * NS doubles would not stay in registers).
template <int NS, class Pass>
__global__ void __launch_bounds__(COMPOSE_THREADS) compose_kernel(
    Pass pass, const double* __restrict__ coef, const double* __restrict__ power,
    double* __restrict__ ws, int n_cols, int chunk) {
  constexpr int D = 2 * NS;
  constexpr int G = NS <= 2 ? 16 : (NS <= 4 ? 8 : 2);
  __shared__ double P[D * D];
  for (int i = threadIdx.x; i < D * D; i += blockDim.x) P[i] = power[i];
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  const typename Pass::Col c = pass.column(col);
  const int n_chunks = (c.len + chunk - 1) / chunk;
  double e[D];
  pass.template seed<NS>(c, col, coef, e);
  const size_t row = (size_t)D * n_cols;
  for (int j0 = 0; j0 < n_chunks; j0 += G) {
    double r[G][D];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (j0 + g < n_chunks - 1) {
#pragma unroll
        for (int i = 0; i < D; ++i) r[g][i] = ws[(j0 + g) * row + (size_t)i * n_cols + col];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (j0 + g < n_chunks) {
#pragma unroll
        for (int i = 0; i < D; ++i) ws[(j0 + g) * row + (size_t)i * n_cols + col] = e[i];
        if (j0 + g < n_chunks - 1) {
          double next[D];
#pragma unroll
          for (int a = 0; a < D; ++a) {
            double acc = r[g][a];
#pragma unroll
            for (int b = 0; b < D; ++b) acc += P[a * D + b] * e[b];
            next[a] = acc;
          }
#pragma unroll
          for (int a = 0; a < D; ++a) e[a] = next[a];
        }
      }
    }
  }
}

// One pass: local sweep, compose, emit sweep, each checked at launch.
template <int NS, class Pass>
static int run_pass(const Pass& pass, const double* coef, const double* power,
                    double* ws, int n_cols, int chunk, int n_chunks,
                    cudaStream_t stream) {
  const dim3 block(LANES, CHUNKS_PER_BLOCK);
  const dim3 grid((n_chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK,
                  (n_cols + LANES - 1) / LANES);
  sweep_kernel<NS, false, Pass><<<grid, block, 0, stream>>>(pass, coef, ws,
                                                            n_cols, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compose_kernel<NS, Pass>
      <<<(n_cols + COMPOSE_THREADS - 1) / COMPOSE_THREADS, COMPOSE_THREADS, 0,
         stream>>>(pass, coef, power, ws, n_cols, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<NS, true, Pass><<<grid, block, 0, stream>>>(pass, coef, ws,
                                                           n_cols, chunk);
  return (int)cudaGetLastError();
}

static bool bad_grid(int n_cols, int chunk, int n_chunks, long long n_steps) {
  // n_chunks must cover n_steps in chunks of `chunk` exactly
  return chunk < 1 || n_chunks < 1 || (long long)n_chunks * chunk < n_steps ||
         (long long)(n_chunks - 1) * chunk >= n_steps ||
         (n_cols + LANES - 1) / LANES > 65535;
}

template <int NS>
static int filtfilt(const float* x, float* out, float* fwd, double* ws,
                    const int* lengths, const double* coef, const double* power,
                    int batch, int n_max, int channels, int padlen, int mode,
                    int chunk, int n_chunks, cudaStream_t stream) {
  const int n_cols = batch * channels;
  const ForwardPass f{x, fwd, lengths, n_max, padlen, mode, channels};
  int err = run_pass<NS>(f, coef, power, ws, n_cols, chunk, n_chunks, stream);
  if (err != 0) return err;
  const BackwardPass b{fwd, out, lengths, n_max, padlen, channels};
  return run_pass<NS>(b, coef, power, ws, n_cols, chunk, n_chunks, stream);
}

// K3.  x, out: (batch, n_max, channels) float32, distinct; fwd: (batch,
// n_max + 2 padlen, channels) float32 scratch; ws: (n_chunks, 2
// n_sections, batch * channels) float64 workspace, n_chunks = ceil((n_max
// + 2 padlen) / chunk); lengths: (batch,) int32, each in (padlen, n_max]
// (checked by the caller); coef: (n_sections, 7) float64; power: the
// (2 n_sections)^2 float64 matrix A^chunk, row-major; mode: Padtype
// (padlen 0 for PAD_NONE).  All on the device.  Launches six kernels on
// `stream` and returns the first launch error, or 0.
extern "C" int sosfiltfilt_f32(const float* x, float* out, float* fwd,
                               double* ws, const int* lengths,
                               const double* coef, const double* power,
                               int n_sections, int batch, int n_max,
                               int channels, int padlen, int mode, int chunk,
                               int n_chunks, void* stream) {
  if (n_sections < 1 || n_sections > MAX_SECTIONS || batch < 1 || n_max < 1 ||
      channels < 1 || (long long)batch * channels >= (1LL << 31) ||
      padlen < 0 || mode < PAD_NONE || mode > PAD_CONST ||
      (mode == PAD_NONE && padlen != 0) ||
      (long long)n_max + 2LL * padlen >= (1LL << 31) ||
      bad_grid(batch * channels, chunk, n_chunks, (long long)n_max + 2 * padlen)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define K3_CASE(NS)                                                           \
  case NS:                                                                    \
    return filtfilt<NS>(x, out, fwd, ws, lengths, coef, power, batch, n_max, \
                        channels, padlen, mode, chunk, n_chunks, s);
  switch (n_sections) {
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4)
    K3_CASE(5) K3_CASE(6) K3_CASE(7) K3_CASE(8)
  }
#undef K3_CASE
  return (int)cudaErrorInvalidValue;
}

// K6.  x, y: (n_cols / channels, n, channels) float32, distinct; ws:
// (n_chunks, 2 n_sections, n_cols) float64 workspace, n_chunks =
// ceil(n / chunk); coef and power as for sosfiltfilt_f32 (coef's zi_unit
// columns unused); zi, zf: (n_sections, 2, n_cols) float64.  All on the
// device.  Launches three kernels on `stream` and returns the first
// launch error, or 0.
extern "C" int sosfilt_f32(const float* x, float* y, double* ws,
                           const double* coef, const double* power,
                           const double* zi, double* zf, int n_sections, int n,
                           int n_cols, int channels, int chunk, int n_chunks,
                           void* stream) {
  if (n_sections < 1 || n_sections > MAX_SECTIONS || n < 1 || n_cols < 1 ||
      channels < 1 || n_cols % channels != 0 || bad_grid(n_cols, chunk, n_chunks, n)) {
    return (int)cudaErrorInvalidValue;
  }
  const CausalPass pass{x, y, zi, zf, n, n_cols, channels};
  cudaStream_t s = (cudaStream_t)stream;
#define K6_CASE(NS) \
  case NS:          \
    return run_pass<NS>(pass, coef, power, ws, n_cols, chunk, n_chunks, s);
  switch (n_sections) {
    K6_CASE(1) K6_CASE(2) K6_CASE(3) K6_CASE(4)
    K6_CASE(5) K6_CASE(6) K6_CASE(7) K6_CASE(8)
  }
#undef K6_CASE
  return (int)cudaErrorInvalidValue;
}
