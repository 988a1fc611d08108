// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the unsplit
// augmented Riccati route (K5d-a), one thread block per env.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="ric_aug", foot_split=False route: `factor_ric_aug` (:1007) and
// `ric_solve_aug` (:1061), the augmented reduced solve of `iteration_base`
// (:1276-1385) with both refinement residuals ("f32" and the compensated
// "df", `df_resid` :1290-1369), the delta corrector, the warm entry
// (`warm=True`, :316-319) and kkt_scale="jacobi" on the 30-wide blocks
// (`jacobi_scaled`, :333, applied at :1038). It computes what the "ric_aug"
// route of `ops/pdipm.py` computes with foot_split=False (the plain version):
// the dense cross-check of K1's split.
//
// Per stage the dense 30-wide [u, z, nu] block
//
//     K_t = [[R + beta, G^T, e^T], [G, -W_t, 0], [e, 0, -delta I]]
//
// is inverted with partial pivoting (`aug_pivot=True`, the default: natural
// order gives NaN on every stress problem); the T blocks are eliminated
// together (30 barrier steps, one thread per block searching its pivot) and
// stored whole, T x 900 values.
//
// What bounds it on an H100: the latency and barriers of small dependent
// eliminations (2 * 30^3 = 54k flops per stage block), not bandwidth. Shared
// memory holds the env: ~80 KB in f32 and ~160 KB in f64 at T = 10, so 2
// blocks per SM in f32 and 1 in f64; horizons whose layout exceeds a block's
// 232,448 B are refused before any launch (ops/pdipm_cuda.py).
//
// Numerics: -W_t reaches ~1e8 on its own diagonal beside R + beta ~ 1e-5, so
// the pivot search is load-bearing; the pivot is the first row >= k of
// largest |a_ik|, as K1's. The Jordan step writes the inverse's pivot entry
// as 1/pivot directly. Build without --use_fast_math.

#include "pdipm_riccati.cuh"

struct RicAugDense : RicDenseRoute<true> {};

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_aug_dense_smem_bytes(int T, int value_size) {
  return RicAugDense::make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), refine_df included.

int pdipm_ric_aug_dense_f32(const void* hd, const void* f, const void* ad, const void* bd,
                            const void* b, const void* gu, const void* d, const void* x0,
                            const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                            void* y, void* res, const void* go, void* ran, int batch, int T,
                            const PdipmArgs* args, void* stream) {
  return launch<RicAugDense, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                    ran, batch, T, args, stream);
}

int pdipm_ric_aug_dense_f64(const void* hd, const void* f, const void* ad, const void* bd,
                            const void* b, const void* gu, const void* d, const void* x0,
                            const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                            void* y, void* res, const void* go, void* ran, int batch, int T,
                            const PdipmArgs* args, void* stream) {
  return launch<RicAugDense, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                     ran, batch, T, args, stream);
}

const char* pdipm_ric_aug_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
