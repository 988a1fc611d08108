// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the condensed
// route, one env per warp in the route's lean layout, or, for comparison,
// per 128-thread block in its block layout.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` on its
// backend="ric", foot_split=True route (`factor_ric_split`, `ric_solve`, the
// condensed reduced solve of `iteration_base`; delta corrector), with its
// warm entry (`warm=True`, :316-319). It computes what `ops/pdipm.py` of this
// package computes on that route (the plain version): `iterations` Newton
// steps of every env's QP in one launch, from the cold start x = 0,
// s = max(d, 1), z = 1, y = 1 or from a given (x0, s0, z0, y0).
//
// The condensed route eliminates z with W^-1 = Sigma / (1 + delta Sigma):
// per stage the [u (12), nu (2)] block is
//
//     K_t = [[R + beta + G^T W_t^-1 G, e^T], [e, -delta I]],
//
// which splits exactly by foot into two 4x4 SPD blocks on u columns
// {0,1,2,7} / {3,4,5,10}, two W-independent [M_x, nu] 2x2 pairs and two M_z
// scalars. Eliminating [u, nu] leaves the same 12-wide dual-Riccati y-chain
// as the augmented route (pdipm_common.cuh).
//
// What bounds it on an H100: as for pdipm_ric_aug.cu, each env reads 1,260
// values and writes 704, so the kernel is bound by instruction latency and
// barriers of small dependent eliminations, not by bandwidth. Its stage work
// is 2T 4x4 inverses per step in place of 2T pivoted 12x12 ones.
//
// What the design does about that: every value of an env lives in shared
// memory for the whole solve, but f, b and d, which a Newton step reads once
// and the lean layout (`RicLean`, 28,160 B f32 / 56,320 B f64 at T = 10,
// against the block layout's 40,240 / 80,480 B) leaves in device memory; a
// one-warp group per env lets 8 envs (f32) share an SM, against 4 blocks.
// The 2T foot blocks are built and inverted one per lane, in registers; the
// y-chain and the sweeps run in the warp with a 12 x 12 block in registers
// (pdipm_ric_aug.cu says how); the operator applies spread their entries
// over the 32 lanes, synchronized by __syncwarp. The block group (`Ric`) is
// the configuration before, kept bit for bit.
//
// Numerics: the foot blocks hold G^T W^-1 G with W^-1 up to ~1e8. They are
// SPD, so natural-order elimination needs no pivot (the JAX kernel's
// k_pivot=False); the Jordan step writes the inverse's pivot entry as
// 1/pivot directly, never through a blended update that would absorb it at
// that scale, and scales the pivot row by it (gj_form="inplace", the
// default) or divides it by the pivot ("tableau"). kkt_scale="jacobi"
// equilibrates each foot block in the thread's registers around its
// inverse. Build without --use_fast_math: division and sqrt stay IEEE.
//
// The route's policies are `RicSplit<false>` (block layout) and
// `RicSplit<false, true>` (lean) of pdipm_split.cuh, for the Newton-step
// kernel of pdipm_common.cuh.

#include "pdipm_split.cuh"

// The route's policies for the shared Newton-step kernel (pdipm_common.cuh):
// the block layout (block group) and the lean one (the warp group).
struct Ric : RicSplit<false> {};
struct RicLean : RicSplit<false, true> {};

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_smem_bytes(int T, int value_size) {
  return Ric::make_layout(T, value_size).bytes;
}

// Dynamic shared memory of one env (one block) in the lean layout of the
// warp group, in bytes.
size_t pdipm_ric_lean_bytes(int T, int value_size) {
  return RicLean::make_layout(T, value_size).bytes;
}

// Resident envs per SM of the block group (lean 0) or of the warp group
// (lean 1), from cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative
// cudaError_t on failure.
int pdipm_ric_envs_per_sm(int T, int value_size, int lean) {
  if (lean)
    return value_size == 4 ? envs_per_sm<RicLean, float, WarpGroup<1>>(T)
                           : envs_per_sm<RicLean, double, WarpGroup<1>>(T);
  return value_size == 4 ? envs_per_sm<Ric, float, BlockGroup>(T)
                         : envs_per_sm<Ric, double, BlockGroup>(T);
}

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), except that refine_df must be 0:
// any other value returns cudaErrorInvalidValue and launches nothing.
int pdipm_ric_f32(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream) {
  return launch<Ric, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                            ran, batch, T, args, stream);
}

int pdipm_ric_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream) {
  return launch<Ric, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                             ran, batch, T, args, stream);
}

// The same solve in the route's warp group, one warp per env, one env per
// block, in its lean layout (`pdipm_ric_lean_bytes`).
int pdipm_ric_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream) {
  return launch<RicLean, float, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0,
                                         x, s, z, y, res, go, ran, batch, T, args, stream);
}

int pdipm_ric_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream) {
  return launch<RicLean, double, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0,
                                          x, s, z, y, res, go, ran, batch, T, args, stream);
}

const char* pdipm_ric_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
