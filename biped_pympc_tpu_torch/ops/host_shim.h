// A host build of the port's CUDA sources, for tests on a machine without a
// card: g++ compiles a .cu file with this header included first
// (`ops/host_build.py`, which also rewrites the two pieces of CUDA syntax
// g++ cannot read: the `extern __shared__` array and the <<<>>> launch).
// Every CUDA thread of a block is a std::thread; the blocks of a launch run
// one after another. __syncthreads is a barrier over the block, __syncwarp
// one over the thread's warp, a named barrier one per id, and __shfl_sync /
// __shfl_xor_sync pass values through a per-warp slot array between two
// warp barriers. The _rn intrinsics are the plain operators (build with
// -ffp-contract=off, so that nothing is fused). It runs the kernels' own
// arithmetic and control flow; it says nothing about their speed.

#pragma once

#include <math.h>
#include <stddef.h>
#include <string.h>

#include <barrier>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>

#define PDIPM_HOST_SHIM 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __maxnreg__(...)
#define __align__(n) alignas(n)

// A kernel's static __shared__ array is one array, which the threads of a
// block share and the blocks of a launch, run one after another, reuse.
#define __shared__ static

struct dim3 {
  unsigned int x = 1, y = 1, z = 1;
};
struct int4 {
  int x, y, z, w;
};
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline thread_local dim3 threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100,
};

template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e == 0 ? "no error" : "error"; }
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <typename T>
inline cudaError_t cudaMemcpyFromSymbol(void* dst, const T& sym, size_t n) {
  memcpy(dst, &sym, n);
  return cudaSuccess;
}
template <typename T>
inline cudaError_t cudaGetSymbolAddress(void** p, T& sym) {
  *p = (void*)&sym;
  return cudaSuccess;
}
inline cudaError_t cudaMemset(void* p, int v, size_t n) {
  memset(p, v, n);
  return cudaSuccess;
}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline long long clock64() { return 0; }
// One block runs at a time and the kernels add from one thread only.
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}

// The running block's shared memory, barriers and shuffle slots.
struct ShimBlock {
  unsigned char* smem = nullptr;
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<std::unique_ptr<std::barrier<>>> named;
  std::vector<unsigned char> slots;  // 8 bytes per thread
  std::mutex lock;
};
inline ShimBlock* shim_block = nullptr;

inline unsigned char* shim_smem() { return shim_block->smem; }
inline void __syncthreads() { shim_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline void shim_named_barrier(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> hold(shim_block->lock);
    auto& slot = shim_block->named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(n);
    b = slot.get();
  }
  b->arrive_and_wait();
}

template <typename T>
inline T shim_shfl(T v, int src) {
  static_assert(sizeof(T) <= 8, "shuffles of up to 8 bytes");
  const int warp = threadIdx.x / 32;
  unsigned char* row = shim_block->slots.data() + warp * 32 * 8;
  memcpy(row + (threadIdx.x % 32) * 8, &v, sizeof(T));
  __syncwarp();
  T r;
  memcpy(&r, row + (src & 31) * 8, sizeof(T));
  __syncwarp();
  return r;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int lane) { return shim_shfl(v, lane); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return shim_shfl(v, (int)(threadIdx.x % 32) ^ mask);
}

// kernel<<<grid, threads, smem, stream>>>(args...), block after block.
template <typename K, typename... A>
inline void shim_launch(unsigned grid, unsigned threads, size_t smem, cudaStream_t, K kernel,
                        A... args) {
  std::vector<unsigned char> buf(smem + 64);
  for (unsigned b = 0; b < grid; ++b) {
    ShimBlock blk;
    blk.smem = buf.data() + (64 - (size_t)buf.data() % 64) % 64;
    memset(blk.smem, 0xff, smem);  // NaN in every value nobody wrote
    blk.block = std::make_unique<std::barrier<>>(threads);
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      blk.warps.push_back(std::make_unique<std::barrier<>>(threads - 32 * w < 32 ? threads - 32 * w : 32));
    blk.named.resize(16);
    blk.slots.assign((size_t)threads * 8 + 32 * 8, 0);
    shim_block = &blk;
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
    shim_block = nullptr;
  }
}
