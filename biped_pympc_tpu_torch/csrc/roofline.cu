// Two roofline probes of one card: the peak rate of fused multiply-adds with
// their operands in registers (K6), and the rate when every multiply-add
// reads its operands from on-chip memory and writes its result back (K7).
//
// Replaces: bench/ab_roofline.py `peak_kernel` (:77, launched at :88) and
// `stream_kernel` (:107, launched at :117), the two Pallas kernels of
// `measure_vpu_roofline`. They compute what `fma_peak_plain` and
// `stream_plain` of biped_pympc_tpu_torch/bench/ab_roofline.py compute (the
// plain versions), in float or double.
//
// K6, `fma_peak_kernel`: x is (8 n, 128) and a is (8, 128); every entry
// e of x is one chain x <- x * a[e % 1024] + c, `iters` times, and
// out[e] is its end (`peak_kernel`: n (8, 128) accumulators against one
// (8, 128) a, c = 1e-7). What bounds it on an H100 is the FMA pipes: 128
// lanes per SM each cycle, each FMA's result ready ~4 cycles later, so an
// SM needs ~512 independent chains in flight. What the design does about
// it: one chain per element, CHAINS (1, 2, 4 or 8) of them per thread in
// registers, unrolled, so each thread issues CHAINS independent FMAs per
// step; the caller sweeps CHAINS and the block size. With n = 16 there are
// 16,384 chains, about 124 per SM: latency-bound whatever the knobs; the
// sweep's larger n fill the card. The step loop is unrolled PEAK_UNROLL =
// 16 times, so its counter and branch cost 3 instructions per 16 CHAINS
// FMAs: unrolled 4 times they cost 12% of the f32 rate (53.6 against 61.0
// TFLOP/s at 4 chains a thread, one run on an H100 SXM at 700 W). The loop
// body must be FMAs only, neither dropped (every chain is stored) nor
// folded (`iters` and c are runtime values): chip_smoke.py counts the
// FFMA / DFMA in the SASS.
//
// K7, `stream_kernel`: x, a and b are (256, 512) in the script, any n
// entries here; x <- x * a + b, `iters` times, over the whole array. Every
// pass reads x, a and b from shared memory and writes x back, so each FMA
// moves 3 loads and 1 store through the SM's shared-memory pipe (128 B per
// cycle): at most 8 FMAs per SM and cycle, 1/16 of K6's rate. The TPU
// kernel's tile sits in VMEM; here the array is cut into tiles of
// STREAM_TILE = 1024 entries, one block of STREAM_THREADS = 256 threads per
// tile (4 entries a thread), 3 x 1024 values of shared memory per block
// (12 KB float, 24 KB double): the (256, 512) array is 128 blocks, about
// one per SM. The shared arrays are read and written through `volatile`,
// so the compiler cannot keep x, a or b in registers across passes (each
// pass is LDS, LDS, LDS, FFMA, STS per entry; chip_smoke.py counts them in
// the SASS). No barrier: each thread touches only its own entries.
//
// Numerics: one rounding per step (the fused multiply-add), as XLA gives on
// the CPU where the Pallas kernels run interpreted. Build without
// --use_fast_math.

#include <cuda_runtime.h>

constexpr int STREAM_TILE = 1024;
constexpr int STREAM_THREADS = 256;
constexpr int PEAK_UNROLL = 16;  // steps per trip of the peak loop

__device__ __forceinline__ float fma_t(float x, float a, float b) { return fmaf(x, a, b); }
__device__ __forceinline__ double fma_t(double x, double a, double b) { return fma(x, a, b); }

template <typename T, int CHAINS>
__global__ void fma_peak_kernel(const T* __restrict__ a, const T* __restrict__ x,
                                T* __restrict__ out, int n, int iters, T c) {
  const int stride = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T v[CHAINS], m[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    const int e = t + k * stride;
    v[k] = e < n ? x[e] : T(0);
    m[k] = e < n ? a[e % 1024] : T(0);  // a[(e / 128) % 8][e % 128]
  }
#pragma unroll PEAK_UNROLL
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) v[k] = fma_t(v[k], m[k], c);
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    const int e = t + k * stride;
    if (e < n) out[e] = v[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ x,
              T* __restrict__ out, int n, int iters) {
  __shared__ T tile_x[STREAM_TILE], tile_a[STREAM_TILE], tile_b[STREAM_TILE];
  volatile T* sx = tile_x;
  volatile T* sa = tile_a;
  volatile T* sb = tile_b;
  const int base = blockIdx.x * STREAM_TILE;
  const int live = min(STREAM_TILE, n - base);
  constexpr int PER_THREAD = STREAM_TILE / STREAM_THREADS;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = threadIdx.x + k * STREAM_THREADS;
    if (j < live) {
      sx[j] = x[base + j];
      sa[j] = a[base + j];
      sb[j] = b[base + j];
    }
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int j = threadIdx.x + k * STREAM_THREADS;
      if (j < live) {
        const T xv = sx[j], av = sa[j], bv = sb[j];
        sx[j] = fma_t(xv, av, bv);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = threadIdx.x + k * STREAM_THREADS;
    if (j < live) out[base + j] = sx[j];
  }
}

namespace {

template <typename T, int CHAINS>
int launch_fma_peak(const void* a, const void* x, void* out, int n, int iters, double c,
                    int threads, cudaStream_t stream) {
  const int chains_total = (n + CHAINS - 1) / CHAINS;
  const int blocks = (chains_total + threads - 1) / threads;
  fma_peak_kernel<T, CHAINS><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(out), n, iters,
      static_cast<T>(c));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_fma_peak(const void* a, const void* x, void* out, int n, int iters, double c, int chains,
                 int threads, void* stream) {
  if (n < 0 || iters < 0 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch_fma_peak<T, 1>(a, x, out, n, iters, c, threads, s);
    case 2: return launch_fma_peak<T, 2>(a, x, out, n, iters, c, threads, s);
    case 4: return launch_fma_peak<T, 4>(a, x, out, n, iters, c, threads, s);
    case 8: return launch_fma_peak<T, 8>(a, x, out, n, iters, c, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run_stream(const void* a, const void* b, const void* x, void* out, int n, int iters,
               void* stream) {
  if (n < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + STREAM_TILE - 1) / STREAM_TILE;
  stream_kernel<T><<<blocks, STREAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(x),
      static_cast<T*>(out), n, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6 on `stream`: out[e] = `iters`-fold x <- fma(x, a[e % 1024], c) from
// x[e], for the n entries of x ((8 m, 128), contiguous) against a ((8, 128),
// contiguous); `chains` (1, 2, 4, 8) chains per thread, `threads` (a
// multiple of 32, at most 1024) per block. Returns a cudaError_t; an
// invalid argument launches nothing.
int roofline_fma_peak_f32(const void* a, const void* x, void* out, int n, int iters, double c,
                          int chains, int threads, void* stream) {
  return run_fma_peak<float>(a, x, out, n, iters, c, chains, threads, stream);
}

int roofline_fma_peak_f64(const void* a, const void* x, void* out, int n, int iters, double c,
                          int chains, int threads, void* stream) {
  return run_fma_peak<double>(a, x, out, n, iters, c, chains, threads, stream);
}

// K7 on `stream`: out = `iters`-fold x <- fma(x, a, b) over n contiguous
// entries of each. Returns a cudaError_t.
int roofline_stream_f32(const void* a, const void* b, const void* x, void* out, int n, int iters,
                        void* stream) {
  return run_stream<float>(a, b, x, out, n, iters, stream);
}

int roofline_stream_f64(const void* a, const void* b, const void* x, void* out, int n, int iters,
                        void* stream) {
  return run_stream<double>(a, b, x, out, n, iters, stream);
}

const char* roofline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
