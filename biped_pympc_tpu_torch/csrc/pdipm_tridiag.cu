// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the condensed
// block-Thomas route (K5a): one warp per env (`TridiagWarp`,
// pdipm_tridiag.cuh), or, for comparison, one 128-thread block per env
// (`Tridiag`, the kernel before).
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
// What bounds it on an H100: the latency of one env's chain of dependent
// steps, not operations or bandwidth. A Newton step inverts T pivoted
// 26-wide blocks in order, T x 26 dependent elimination steps (260 at h10);
// the least work of a step runs in 0.383 ms at b4096 (chip_smoke.py's
// bound), and the env reads 1,260 values and writes 704. In the block group
// each elimination step is three barrier-separated phases over 128 threads.
//
// What the design does about that: as K5b's warp group
// (pdipm_tridiag_aug.cu): each elimination step stays in one warp, a row a
// lane in registers (26 of 32 lanes), the pivot found by a shuffle argmax
// and passed through a shared-memory row (`gj_warp`, pdipm_common.cuh);
// the u block's 16-term sums are spread over the whole warp before the
// block is built, not left to the 12 lanes of its rows; and more envs run
// at once: the lean layout keeps f, b and d in device memory, forms the KKT
// residuals where it reads them, shares one region between the factor's
// scratch and the solve's buffers (17,976 B an env at h10 in f32), and
// keeps the T stored inverses (27,040 B) in a device-memory workspace
// wherever that puts more envs on an SM (12 against 5 at h10 in f32, under
// a 168-register cap; the block group holds 4) or they do not fit; so every
// horizon runs up to 145 (f32) and 72 (f64), against 44 and 22 in the
// block layout, which stays in this library for comparison. Beyond those
// the lean layout without the inverses outgrows a block and
// ops/pdipm_cuda.py refuses the launch.
//
// Numerics: the u block carries G^T W^-1 G with W^-1 up to ~1e8, so this
// condensed route amplifies roundoff as K2 does; the block is inverted with
// the same pivot search as K5b (the Pallas kernel pivots it too), the u
// block's sums taken in the block group's order, and the pivot entry
// written as 1/pivot directly. Build without --use_fast_math.

#include "pdipm_tridiag.cuh"

extern "C" {

// Dynamic shared memory of one block of the block group, in bytes, for
// horizon T and a value size of 4 (float) or 8 (double).
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

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_tridiag_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// One env's shared memory in the warp group, in bytes, and the workspace
// per env in bytes: 0 when the stored inverses stay in shared memory
// (`uses_workspace`, pdipm_common.cuh), unless `force`.
size_t pdipm_tridiag_lean_bytes(int T, int value_size) {
  return lean_bytes<TridiagWarp, WarpGroup<1>>(T, value_size);
}

size_t pdipm_tridiag_work_bytes(int T, int value_size, int force) {
  return work_bytes<TridiagWarp, WarpGroup<1>>(T, value_size, force != 0);
}

// Resident envs per SM of the block group (mode 0), of the warp group as it
// launches (1) or with the stored inverses in the workspace (2), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int pdipm_tridiag_envs_per_sm(int T, int value_size, int mode) {
  if (mode == 0)
    return value_size == 4 ? envs_per_sm<Tridiag, float, BlockGroup>(T)
                           : envs_per_sm<Tridiag, double, BlockGroup>(T);
  const bool work = mode == 2 || work_bytes<TridiagWarp, WarpGroup<1>>(T, value_size, false) > 0;
  return value_size == 4 ? envs_per_sm<TridiagWarp, float, WarpGroup<1>>(T, work)
                         : envs_per_sm<TridiagWarp, double, WarpGroup<1>>(T, work);
}

// The same solve in the route's warp group, one warp per env, one env per
// block, in its lean layout; `work` is batch x `pdipm_tridiag_work_bytes`
// bytes of device memory for the stored inverses, or null to keep them in
// shared memory. refine_df must be 0, as on the block entry.
int pdipm_tridiag_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                           const void* b, const void* gu, const void* d, const void* x0,
                           const void* s0, const void* z0, const void* y0, void* x, void* s,
                           void* z, void* y, void* res, const void* go, void* ran, int batch,
                           int T, const PdipmArgs* args, void* stream, void* work) {
  return launch<TridiagWarp, float, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s,
                                                  z, y, res, go, ran, batch, T, args, stream,
                                                  work);
}

int pdipm_tridiag_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                           const void* b, const void* gu, const void* d, const void* x0,
                           const void* s0, const void* z0, const void* y0, void* x, void* s,
                           void* z, void* y, void* res, const void* go, void* ran, int batch,
                           int T, const PdipmArgs* args, void* stream, void* work) {
  return launch<TridiagWarp, double, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s,
                                                   z, y, res, go, ran, batch, T, args, stream,
                                                   work);
}

const char* pdipm_tridiag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
