// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the unsplit
// condensed Riccati route (K5d-c): one warp per env (`RicDenseWarp`,
// pdipm_riccati.cuh), or, for comparison, one 128-thread block per env
// (`RicDense`, the kernel before).
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
// Schur complement), so it is inverted without pivoting (`:916-921`) unless
// `k_pivot`, and stored whole.
//
// What bounds it on an H100: as the other Riccati routes, the latency of
// one env's chain of small dependent eliminations, not bandwidth (an env
// reads 1,260 values and writes 704). In the block group the T blocks were
// eliminated together in 14 steps of two block barriers each, one thread a
// block forming each pivot row (2 * 14^3 flops a block), and the y-chain
// took two barriers a step.
//
// What the design does about that: one warp an env, in K2's lean layout
// (26,800 B at h10 in f32), the T stored 14 x 14 inverses (7,840 B) in a
// device-memory workspace wherever that puts more envs on an SM (8 against
// 6 at h10 in f32; the block group holds 4), so every horizon runs up to 94
// (f32) and 46 (f64), against 50 and 24 in the block layout, which stays in
// this library for comparison. The warp builds and eliminates two stage
// blocks at a time in registers, a row a lane, the pivot (`k_pivot`: a
// shuffle argmax over the block's lanes) and the pivot row passed by
// shuffle (`gj_pair_regs`, no barrier in the chain), forms P_t and Y'_t in
// registers (the rows of (K^-1)_uu broadcast by shuffle; pivoted, read back
// from the stored inverse), and runs the y-chain and the sweeps in
// registers.
//
// Numerics: the u block carries W^-1 up to ~1e8 beside R + beta ~ 1e-5, the
// spread that makes the condensed routes amplify roundoff (K2, K5a); the
// Jordan step writes the inverse's pivot entry as 1/pivot directly. Build
// without --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_riccati.cuh"

struct RicDense : RicDenseRoute<false> {};
// The warp group: one warp an env, two stage blocks at a time (pdipm_riccati.cuh).
struct RicDenseWarp : RicCondWarp<false> {};

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

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric_dense_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// One env's shared memory in the warp group, in bytes, and the workspace
// per env in bytes: 0 when the stage records stay in shared memory
// (`uses_workspace`, pdipm_common.cuh), unless `force`.
size_t pdipm_ric_dense_lean_bytes(int T, int value_size) {
  return lean_bytes<RicDenseWarp, WarpGroup<1>>(T, value_size);
}

size_t pdipm_ric_dense_work_bytes(int T, int value_size, int force) {
  return work_bytes<RicDenseWarp, WarpGroup<1>>(T, value_size, force != 0);
}

// Resident envs per SM of the block group (mode 0), of the warp group as it
// launches (1) or with the stage records in the workspace (2), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int pdipm_ric_dense_envs_per_sm(int T, int value_size, int mode) {
  if (mode == 0)
    return value_size == 4 ? envs_per_sm<RicDense, float, BlockGroup>(T)
                           : envs_per_sm<RicDense, double, BlockGroup>(T);
  const bool work = mode == 2 || work_bytes<RicDenseWarp, WarpGroup<1>>(T, value_size, false) > 0;
  return value_size == 4 ? envs_per_sm<RicDenseWarp, float, WarpGroup<1>>(T, work)
                         : envs_per_sm<RicDenseWarp, double, WarpGroup<1>>(T, work);
}

// The same solve in the route's warp group, one warp per env, one env per
// block, in its lean layout; `work` is batch x `pdipm_ric_dense_work_bytes`
// bytes of device memory for the stage records, or null to keep them in
// shared memory. refine_df must be 0, as on the block entry.
int pdipm_ric_dense_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream, void* work) {
  return launch<RicDenseWarp, float, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y,
                                        res, go, ran, batch, T, args, stream, work);
}

int pdipm_ric_dense_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream, void* work) {
  return launch<RicDenseWarp, double, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z,
                                         y, res, go, ran, batch, T, args, stream, work);
}

const char* pdipm_ric_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
