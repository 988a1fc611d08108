// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the augmented
// block-Thomas route (K5b): one warp per env (`TridiagAugWarp`,
// pdipm_tridiag.cuh), or, for comparison, one 128-thread block per env
// (`TridiagAug`, the kernel before).
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
// What bounds it on an H100: the latency of one env's chain of dependent
// steps, not operations or bandwidth. A Newton step inverts T pivoted
// 42-wide blocks in order, T x 42 dependent elimination steps (420 at h10);
// the least work of a step runs in 0.383 ms at b4096 (chip_smoke.py's
// bound), and the env reads 1,260 values and writes 704. In the block group
// a step took ~4,800 cycles of three barrier-separated phases over 128
// threads, 90% of a Newton step (PERF.md, Findings).
//
// What the design does about that: each elimination step stays in one warp,
// the block's rows in registers (lane l: rows l and l + 32), the pivot found
// by a shuffle argmax and passed through a shared-memory row, so no block
// barrier sits in the chain (`gj_warp`, pdipm_common.cuh); and more envs
// run at once: the lean layout keeps f, b and d in device memory, and the T
// stored inverses (70.6 KB an env at h10 in f32) in a device-memory
// workspace wherever that puts more envs on an SM (8 against 2 at h10 in
// f32) or they do not fit; so every horizon runs up to 103 (f32) and 50
// (f64), against 24 and 11 in the block layout, which stays in this
// library for comparison. Beyond those the lean layout without the
// inverses outgrows a block and ops/pdipm_cuda.py refuses the launch.
//
// Numerics: -W_t reaches ~1e8 on its own diagonal beside R + beta ~ 1e-5, so
// the pivot search is load-bearing (natural order gives NaN on stress
// problems); the pivot is the first row >= k of largest |a_ik|, NaN above
// every number, as argmax picks in the plain version. The pivot row is
// divided by the pivot, and the inverse's pivot entry written as 1/pivot
// directly. Build without --use_fast_math.

#include "pdipm_tridiag.cuh"

extern "C" {

// Dynamic shared memory of one block of the block group, in bytes, for
// horizon T and a value size of 4 (float) or 8 (double).
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

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_tridiag_aug_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// One env's shared memory in the warp group, in bytes, and the workspace
// per env in bytes: 0 when the stored inverses stay in shared memory
// (`uses_workspace`, pdipm_common.cuh), unless `force`.
size_t pdipm_tridiag_aug_lean_bytes(int T, int value_size) {
  return lean_bytes<TridiagAugWarp, WarpGroup<1>>(T, value_size);
}

size_t pdipm_tridiag_aug_work_bytes(int T, int value_size, int force) {
  return work_bytes<TridiagAugWarp, WarpGroup<1>>(T, value_size, force != 0);
}

// Resident envs per SM of the block group (mode 0), of the warp group as it
// launches (1) or with the stored inverses in the workspace (2), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int pdipm_tridiag_aug_envs_per_sm(int T, int value_size, int mode) {
  if (mode == 0)
    return value_size == 4 ? envs_per_sm<TridiagAug, float, BlockGroup>(T)
                           : envs_per_sm<TridiagAug, double, BlockGroup>(T);
  const bool work =
      mode == 2 || work_bytes<TridiagAugWarp, WarpGroup<1>>(T, value_size, false) > 0;
  return value_size == 4 ? envs_per_sm<TridiagAugWarp, float, WarpGroup<1>>(T, work)
                         : envs_per_sm<TridiagAugWarp, double, WarpGroup<1>>(T, work);
}

// The same solve in the route's warp group, one warp per env, one env per
// block, in its lean layout; `work` is batch x `pdipm_tridiag_aug_work_bytes`
// bytes of device memory for the stored inverses, or null to keep them in
// shared memory.
int pdipm_tridiag_aug_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                               const void* b, const void* gu, const void* d, const void* x0,
                               const void* s0, const void* z0, const void* y0, void* x, void* s,
                               void* z, void* y, void* res, const void* go, void* ran, int batch,
                               int T, const PdipmArgs* args, void* stream, void* work) {
  return launch<TridiagAugWarp, float, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x,
                                                     s, z, y, res, go, ran, batch, T, args,
                                                     stream, work);
}

int pdipm_tridiag_aug_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                               const void* b, const void* gu, const void* d, const void* x0,
                               const void* s0, const void* z0, const void* y0, void* x, void* s,
                               void* z, void* y, void* res, const void* go, void* ran, int batch,
                               int T, const PdipmArgs* args, void* stream, void* work) {
  return launch<TridiagAugWarp, double, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x,
                                                      s, z, y, res, go, ran, batch, T, args,
                                                      stream, work);
}

const char* pdipm_tridiag_aug_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
