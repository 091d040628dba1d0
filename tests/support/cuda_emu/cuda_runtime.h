// A CPU stand-in for the CUDA runtime, for functional checks of the grid
// and warp entries (tests/test_torch_grid_emulated.py,
// tests/test_torch_warp_emulated.py): every block of a launch runs at
// once, a std::thread per CUDA thread; __syncthreads is a barrier a block,
// __syncwarp a barrier a warp, and the shuffles go through a per-warp
// exchange, double-buffered so that each takes one barrier.  The sources
// are compiled with g++ after a few substitutions (tests/support/
// cuda_emu/build.py: kernel<<<...>>>(...) launches, extern and static
// __shared__ arrays, the PTX acquire load and release store), and the
// shared memory is filled with NaN, so a read before a write shows in the
// results.  It says nothing about speed, registers or what nvcc accepts.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 82
};
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative };
struct cudaLaunchAttributeValue {
  int cooperative;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline int emu_sms = 4;  // the SM count the stand-in card reports
struct EmuBlock {
  std::vector<double> smem;
  std::vector<double> statics;  // the kernel's static __shared__ arrays
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<double> xchg;  // two buffers of a value a thread
};
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local size_t emu_statics_used = 0;  // bytes of statics handed out
inline thread_local int emu_parity = 0;           // the exchange buffer of the next shuffle
extern "C" void emu_set_sms(int s) { emu_sms = s; }

inline float* emu_smem() { return reinterpret_cast<float*>(emu_block->smem.data()); }
// A static __shared__ array of type A: every thread of a block takes its
// kernel's declarations in the same order, so each gets the same object.
template <class A>
A& emu_static() {
  const size_t at = emu_statics_used;
  emu_statics_used += (sizeof(A) + 15) & ~(size_t)15;
  return *reinterpret_cast<A*>(reinterpret_cast<char*>(emu_block->statics.data()) + at);
}
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->wbar[threadIdx.x / 32]->arrive_and_wait();
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
// A shuffle writes one buffer and reads it after the warp's barrier; the
// next shuffle uses the other, which every lane finished reading before it
// reached that barrier.
template <class T>
T emu_shfl(T v, int src) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* buf = emu_block->xchg.data() + (size_t)emu_parity * blockDim.x;
  emu_parity ^= 1;
  buf[w * 32 + lane] = (double)v;
  __syncwarp();
  return (T)buf[w * 32 + src];
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int off) {
  return emu_shfl(v, (threadIdx.x % 32) ^ off);
}
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
T __ldcg(const T* p) {
  std::atomic_thread_fence(std::memory_order_acquire);
  return *p;
}
template <class T>
void __stcg(T* p, T v) {
  *p = v;
}
inline float fmaxf(float a, float b) { return a > b ? a : b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float sqrtf(float a) { return std::sqrt(a); }
inline float powf(float a, float b) { return std::pow(a, b); }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_sms;
  return 0;
}
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...), A... args) {
  const unsigned nb = cfg->gridDim.x, nt = cfg->blockDim.x;
  gridDim = cfg->gridDim;
  blockDim = cfg->blockDim;
  std::vector<EmuBlock> blocks(nb);
  for (auto& b : blocks) {
    b.smem.assign(cfg->dynamicSmemBytes / 8 + 8, std::nan(""));
    b.bar = std::make_unique<std::barrier<>>(nt);
    for (unsigned w = 0; w < nt / 32; ++w) b.wbar.push_back(std::make_unique<std::barrier<>>(32));
    b.statics.assign(64 * 1024 / 8, std::nan(""));
    b.xchg.assign(2 * nt, 0.0);
  }
  std::vector<std::thread> threads;
  for (unsigned bi = 0; bi < nb; ++bi) {
    for (unsigned ti = 0; ti < nt; ++ti) {
      threads.emplace_back([&, bi, ti]() {
        blockIdx = dim3(bi);
        threadIdx = dim3(ti);
        emu_block = &blocks[bi];
        emu_statics_used = 0;
        emu_parity = 0;
        k(args...);
      });
    }
  }
  for (auto& t : threads) t.join();
  return 0;
}

// kernel<<<grid, block, smem, stream>>>(args...) as the substitution
// writes it: emu_launch(kernel, grid, block, smem, stream)(args...).
template <class... P>
auto emu_launch(void (*k)(P...), dim3 grid, dim3 block, size_t smem = 0,
                cudaStream_t stream = nullptr) {
  return [=](auto... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchKernelEx(&cfg, k, (P)args...);
  };
}
