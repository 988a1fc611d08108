// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the unsplit
// condensed Riccati route (K5d-c), one thread block per env.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="ric", foot_split=False route: `factor_ric` (:896) and `ric_solve`
// (:929), the condensed reduced solve of `iteration_base` (:1252-1274), the
// delta corrector, the warm entry (`warm=True`, :316-319) and
// kkt_scale="jacobi" on the 14-wide blocks (`jacobi_scaled`, :333, applied at
// :922). It computes what the "ric" route of `ops/pdipm.py` computes with
// foot_split=False (the plain version): the dense cross-check of K2's split.
//
// Per stage the dense 14-wide [u, nu] block
//
//     K_t = [[R + beta + G^T W_t^-1 G, e^T], [e, -delta I]]
//
// is symmetric quasi-definite (an SPD u block, then a negative definite
// Schur complement), so it is inverted without pivoting (`:916-921`); the T
// blocks are eliminated together (14 barrier steps) and stored whole.
//
// What bounds it on an H100: as the other Riccati routes, the latency and
// barriers of small dependent eliminations, not bandwidth (an env reads
// 1,260 values and writes 704). Its stage work is T dense 14-wide inverses
// per step (2 * 14^3 flops each) against K2's 2T 4x4 ones.
//
// Numerics: the u block carries W^-1 up to ~1e8 beside R + beta ~ 1e-5, the
// spread that makes the condensed routes amplify roundoff (K2, K5a); the
// Jordan step writes the inverse's pivot entry as 1/pivot directly. Build
// without --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_riccati.cuh"

struct RicDense : RicDenseRoute<false> {};

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_dense_smem_bytes(int T, int value_size) {
  return RicDense::make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), except that refine_df must be 0:
// any other value returns cudaErrorInvalidValue and launches nothing.

int pdipm_ric_dense_f32(const void* hd, const void* f, const void* ad, const void* bd,
                        const void* b, const void* gu, const void* d, const void* x0,
                        const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                        void* y, void* res, const void* go, void* ran, int batch, int T,
                        const PdipmArgs* args, void* stream) {
  return launch<RicDense, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                 ran, batch, T, args, stream);
}

int pdipm_ric_dense_f64(const void* hd, const void* f, const void* ad, const void* bd,
                        const void* b, const void* gu, const void* d, const void* x0,
                        const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                        void* y, void* res, const void* go, void* ran, int batch, int T,
                        const PdipmArgs* args, void* stream) {
  return launch<RicDense, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                  ran, batch, T, args, stream);
}

const char* pdipm_ric_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
