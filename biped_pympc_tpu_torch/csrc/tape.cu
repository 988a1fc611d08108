// A straight-line instruction tape evaluated for every env by an
// interpreter, one thread per env: the first port of K8, kept as the build
// K8 is compared with (`run_tape_interpreted` in
// biped_pympc_tpu_torch/bench/bench_synthetic.py). K8 itself is now one
// straight-line kernel generated from each tape (bench/tape_codegen.py), as
// the Pallas kernel unrolls the tape when it is traced and CusADi generates
// a kernel per function.
//
// Twin of: bench/bench_synthetic.py, the kernel of `pallas_fn` (:154,
// launched at :158): `apply_tape_rows` over a (16, B) state in VMEM. It
// computes what `apply_tape_rows` of
// biped_pympc_tpu_torch/bench/bench_synthetic.py computes (the plain
// version), in float or double.
//
// The tape is data: row i of `code` is (op, dst, a, b) and c[i] its
// constant, with op 0 fma (x y + c), 1 mul, 2 add, 3 sub, 4 div1p
// (x / (1 + y y)), x = s[a], y = s[b]; then s[dst] = s[dst] / 2 + r / 2.
//
// What bounds it on an H100: each op depends on the ones before it through
// the state, so every env runs n_ops dependent steps (a tape load, two state
// loads, the op, the blend, a state store); with one thread per env that is
// instruction latency, not the FMA pipes or memory (the state is read and
// written once). What the design does about it: the state lives in shared
// memory, s[16][blockDim.x] with one column per thread (consecutive threads
// on consecutive banks: no conflicts), since registers cannot be indexed
// by a runtime row. The tape rows are read through the read-only cache at
// the same address by every thread of a warp (one transaction, a broadcast),
// so the branch on op is uniform across the warp. THREADS = 128 per block:
// 8 KB of shared memory in float (16 KB double); B need not be a multiple.
//
// Numerics: fma is one fused multiply-add, and so is 1 + y y, written out
// as the generated kernels write it (nvcc contracted it before), so that
// the two give the same bits on the card and in a host build; the division
// is IEEE (no --use_fast_math). The blend's halves are exact, so it rounds
// once either way.

#include <cuda_runtime.h>

constexpr int N_STATE = 16;
constexpr int TAPE_THREADS = 128;

__device__ __forceinline__ float fma_t(float x, float y, float c) { return fmaf(x, y, c); }
__device__ __forceinline__ double fma_t(double x, double y, double c) { return fma(x, y, c); }

template <typename T>
__global__ void __launch_bounds__(TAPE_THREADS)
tape_kernel(const int4* __restrict__ code, const T* __restrict__ c, int n_ops,
            const T* __restrict__ s_in, T* __restrict__ s_out, int batch) {
  __shared__ T s[N_STATE * TAPE_THREADS];
  const int env = blockIdx.x * TAPE_THREADS + threadIdx.x;
  if (env >= batch) return;  // no barrier follows: each thread owns its column
  T* col = s + threadIdx.x;
#pragma unroll
  for (int r = 0; r < N_STATE; ++r) col[r * TAPE_THREADS] = s_in[r * batch + env];
  for (int i = 0; i < n_ops; ++i) {
    const int4 ins = __ldg(code + i);
    const T x = col[ins.z * TAPE_THREADS], y = col[ins.w * TAPE_THREADS];
    T r;
    switch (ins.x) {
      case 0: r = fma_t(x, y, __ldg(c + i)); break;
      case 1: r = x * y; break;
      case 2: r = x + y; break;
      case 3: r = x - y; break;
      default: r = x / fma_t(y, y, T(1)); break;
    }
    T& d = col[ins.y * TAPE_THREADS];
    d = T(0.5) * d + T(0.5) * r;
  }
#pragma unroll
  for (int r = 0; r < N_STATE; ++r) s_out[r * batch + env] = col[r * TAPE_THREADS];
}

namespace {

template <typename T>
int run_tape(const void* code, const void* c, int n_ops, const void* s_in, void* s_out, int batch,
             void* stream) {
  if (n_ops < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int blocks = (batch + TAPE_THREADS - 1) / TAPE_THREADS;
  tape_kernel<T><<<blocks, TAPE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(code), static_cast<const T*>(c), n_ops,
      static_cast<const T*>(s_in), static_cast<T*>(s_out), batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K8 on `stream`: s_out = the tape (`code`: n_ops rows of 4 int32, 16-byte
// aligned, every index in [0, 16); `c`: n_ops constants) applied to every
// column of s_in ((16, batch), contiguous, batch-last). Returns a
// cudaError_t; an invalid argument launches nothing.
int tape_run_f32(const void* code, const void* c, int n_ops, const void* s_in, void* s_out,
                 int batch, void* stream) {
  return run_tape<float>(code, c, n_ops, s_in, s_out, batch, stream);
}

int tape_run_f64(const void* code, const void* c, int n_ops, const void* s_in, void* s_out,
                 int batch, void* stream) {
  return run_tape<double>(code, c, n_ops, s_in, s_out, batch, stream);
}

const char* tape_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
