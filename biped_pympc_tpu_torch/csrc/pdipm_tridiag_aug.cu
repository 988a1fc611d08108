// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the augmented
// block-Thomas route (K5b), one thread block per env.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="tridiag_aug" route: `factor_aug` (:1134) and `thomas_solve_aug`
// (:1183), the augmented reduced solve of `iteration_base` (:1276-1385) with
// both refinement residuals ("f32" and the compensated "df"), the delta
// corrector, and the warm entry (`warm=True`, :316-319). It computes what the
// "tridiag_aug" route of `ops/pdipm.py` computes (the plain version).
//
// Per stage the x_{t+1} rows (diagonal pivot Q + beta) are eliminated in
// closed form and the 42-wide block on [u (12), z (16), nu (2), y (12)]
//
//     [[R + beta, G^T, e^T, -Bd^T], [G, -W_t, 0, 0], [e, 0, -delta I, 0],
//      [-Bd, 0, 0, -delta I - Ad M_{t-1} Ad^T - Q~^-1]]
//
// is inverted whole, with partial pivoting, T stages in order.
//
// What bounds it on an H100: operations, and the latency of their order. A
// Newton step inverts T pivoted 42-wide blocks (2 * 42^3 = 148k flops each,
// ~1.85M flops per env and step at T = 10 with the sweeps, refinement and
// residuals); at b4096, 20 steps, that is 1.5e11 flops, 2.3 ms at the f32
// peak of 67 TFLOP/s, while the env reads 1,260 values and writes 704 (32 MB
// in f32, ~10 us at 3.35 TB/s). The elimination is 420 dependent steps per
// Newton step (T x 42), each three barrier-separated phases over 128 threads.
//
// What the design does about that: every value of an env lives in the
// block's dynamic shared memory for the whole solve, device memory read once
// and written once; each block is built and inverted in its own S_t^-1 slot
// (no second tableau), so T = 10 fits in f64 (198 KB; 99 KB in f32, two
// blocks per SM). Each elimination step spreads the 42 x 42 rank-1 update
// over the block's threads; warp 0 finds the pivot with shuffles, no extra
// barrier. A (T, dtype) whose layout exceeds an H100 block's shared memory is
// refused before any launch (ops/pdipm_cuda.py).
//
// Numerics: -W_t reaches ~1e8 on its own diagonal beside R + beta ~ 1e-5, so
// the pivot search is load-bearing (natural order gives NaN on stress
// problems); the pivot is the first row >= k of largest |a_ik|, NaN above
// every number, as argmax picks in the plain version. The inverse's pivot
// entry is written as 1/pivot directly. Build without --use_fast_math.

#include "pdipm_tridiag.cuh"

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_tridiag_aug_smem_bytes(int T, int value_size) {
  return TridiagAug::make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), refine_df included.
int pdipm_tridiag_aug_f32(const void* hd, const void* f, const void* ad, const void* bd,
                          const void* b, const void* gu, const void* d, const void* x0,
                          const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                          void* y, void* res, const void* go, void* ran, int batch, int T,
                          const PdipmArgs* args, void* stream) {
  return launch<TridiagAug, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                   ran, batch, T, args, stream);
}

int pdipm_tridiag_aug_f64(const void* hd, const void* f, const void* ad, const void* bd,
                          const void* b, const void* gu, const void* d, const void* x0,
                          const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                          void* y, void* res, const void* go, void* ran, int batch, int T,
                          const PdipmArgs* args, void* stream) {
  return launch<TridiagAug, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                    ran, batch, T, args, stream);
}

const char* pdipm_tridiag_aug_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
