// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the condensed
// block-Thomas route (K5a), one thread block per env.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="tridiag" route, the kernel's original algorithm: `factor` (:424)
// and `thomas_solve` (:478), the condensed reduced solve of `iteration_base`
// (:1386-1400), the delta corrector, and the warm entry (`warm=True`,
// :316-319). It computes what the "tridiag" route of `ops/pdipm.py` computes
// (the plain version).
//
// z is eliminated with W^-1 = Sigma / (1 + delta Sigma), the x_{t+1} rows
// (diagonal pivot Q + beta) in closed form, and the 26-wide block on
// [u (12), nu (2), y (12)]
//
//     [[R + beta + G^T W_t^-1 G, e^T, -Bd^T], [e, -delta I, 0],
//      [-Bd, 0, -delta I - Ad M_{t-1} Ad^T - Q~^-1]]
//
// is inverted whole, with partial pivoting, T stages in order.
//
// What bounds it on an H100: operations, and the latency of their order. A
// Newton step inverts T pivoted 26-wide blocks (2 * 26^3 = 35k flops each,
// ~0.68M flops per env and step at T = 10 with the block builds, sweeps,
// refinement and residuals); at b4096, 20 steps, 5.6e10 flops, 0.8 ms at the
// f32 peak of 67 TFLOP/s, against 32 MB of device memory traffic in f32
// (~10 us at 3.35 TB/s). The elimination is 260 dependent steps per Newton
// step (T x 26), each three barrier-separated phases over 128 threads.
//
// What the design does about that: as pdipm_tridiag_aug.cu (K5b): the env in
// dynamic shared memory for the whole solve (55 KB f32, 110 KB f64 at
// T = 10), each block inverted in its own S_t^-1 slot, the rank-1 updates
// spread over the block's threads, the pivot found by warp 0 with shuffles.
//
// Numerics: the u block carries G^T W^-1 G with W^-1 up to ~1e8, so this
// condensed route amplifies roundoff as K2 does; the block is inverted with
// the same pivot search as K5b (the Pallas kernel pivots it too), and the
// pivot entry is written as 1/pivot directly. Build without --use_fast_math.

#include "pdipm_tridiag.cuh"

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_tridiag_smem_bytes(int T, int value_size) {
  return Tridiag::make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), except that refine_df must be 0:
// any other value returns cudaErrorInvalidValue and launches nothing.
int pdipm_tridiag_f32(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      const PdipmArgs* args, void* stream) {
  return launch<Tridiag, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                ran, batch, T, args, stream);
}

int pdipm_tridiag_f64(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      const PdipmArgs* args, void* stream) {
  return launch<Tridiag, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                 ran, batch, T, args, stream);
}

const char* pdipm_tridiag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
