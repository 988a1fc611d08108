// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the unsplit
// augmented Riccati route (K5d-a): four warps per env (`RicAugDenseWarp`,
// pdipm_riccati.cuh), or, for comparison, one 128-thread block per env
// (`RicAugDense`, the kernel before).
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
// order gives NaN on every stress problem) and stored whole, T x 900 values;
// the 12-wide y-chain and its sweeps follow, as on every Riccati route.
//
// What bounds it on an H100: the latency and barriers of small dependent
// eliminations (2 * 30^3 = 54k flops per stage block), not bandwidth. In the
// block group the T blocks were eliminated together in 30 block-barrier
// steps, one thread per block searching its pivot: 75% of a Newton step,
// the block-barrier y-chain 16% (PERF.md, Findings).
//
// What the design does about that: the T blocks are independent, so each
// goes to one warp, a row per lane in registers, the pivot by a shuffle
// argmax and the pivot row through a shared-memory row (`gj_warp`,
// pdipm_common.cuh), the four warps taking the stages in turn with no
// barrier between blocks; the y-chain and sweeps run in registers in one
// warp as K1's. The lean layout keeps f, b and d in device memory and
// shares one region between the factor's P_t / Y'_t and the solve's
// buffers; the stored inverses go to a device-memory workspace wherever
// that puts more envs on an SM (f64 at h10: 2 against 1) or they do not
// fit, so every horizon runs up to 86 (f32) and 42 (f64), against 30 and 14
// in the block layout, which stays in this library for comparison. Beyond
// those ops/pdipm_cuda.py refuses the launch.
//
// Numerics: -W_t reaches ~1e8 on its own diagonal beside R + beta ~ 1e-5, so
// the pivot search is load-bearing; the pivot is the first row >= k of
// largest |a_ik|, as K1's. The Jordan step writes the inverse's pivot entry
// as 1/pivot directly. Build without --use_fast_math.

#include "pdipm_riccati.cuh"

struct RicAugDense : RicDenseRoute<true> {};
// The warp group: four warps an env, one stage block per warp at a time.
struct RicAugDenseLean : RicAugDenseWarp {};
using KdaGroup = WarpGroup<RicAugDenseWarp::NW>;

extern "C" {

// Dynamic shared memory of one block of the block group, in bytes, for
// horizon T and a value size of 4 (float) or 8 (double).
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

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric_aug_dense_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// One env's shared memory in the warp group, in bytes, and the workspace
// per env in bytes: 0 when the stored inverses stay in shared memory
// (`uses_workspace`, pdipm_common.cuh), unless `force`.
size_t pdipm_ric_aug_dense_lean_bytes(int T, int value_size) {
  return lean_bytes<RicAugDenseLean, KdaGroup>(T, value_size);
}

size_t pdipm_ric_aug_dense_work_bytes(int T, int value_size, int force) {
  return work_bytes<RicAugDenseLean, KdaGroup>(T, value_size, force != 0);
}

// Resident envs per SM of the block group (mode 0), of the warp group as it
// launches (1) or with the stored inverses in the workspace (2), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int pdipm_ric_aug_dense_envs_per_sm(int T, int value_size, int mode) {
  if (mode == 0)
    return value_size == 4 ? envs_per_sm<RicAugDense, float, BlockGroup>(T)
                           : envs_per_sm<RicAugDense, double, BlockGroup>(T);
  const bool work =
      mode == 2 || work_bytes<RicAugDenseLean, KdaGroup>(T, value_size, false) > 0;
  return value_size == 4 ? envs_per_sm<RicAugDenseLean, float, KdaGroup>(T, work)
                         : envs_per_sm<RicAugDenseLean, double, KdaGroup>(T, work);
}

// The same solve in the route's warp group, four warps per env, one env per
// block, in its lean layout; `work` is batch x
// `pdipm_ric_aug_dense_work_bytes` bytes of device memory for the stored
// inverses, or null to keep them in shared memory.
int pdipm_ric_aug_dense_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                                 const void* b, const void* gu, const void* d, const void* x0,
                                 const void* s0, const void* z0, const void* y0, void* x,
                                 void* s, void* z, void* y, void* res, const void* go, void* ran,
                                 int batch, int T, const PdipmArgs* args, void* stream,
                                 void* work) {
  return launch<RicAugDenseLean, float, KdaGroup>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s,
                                                  z, y, res, go, ran, batch, T, args, stream,
                                                  work);
}

int pdipm_ric_aug_dense_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                                 const void* b, const void* gu, const void* d, const void* x0,
                                 const void* s0, const void* z0, const void* y0, void* x,
                                 void* s, void* z, void* y, void* res, const void* go, void* ran,
                                 int batch, int T, const PdipmArgs* args, void* stream,
                                 void* work) {
  return launch<RicAugDenseLean, double, KdaGroup>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x,
                                                   s, z, y, res, go, ran, batch, T, args, stream,
                                                   work);
}

const char* pdipm_ric_aug_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
