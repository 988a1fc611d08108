// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the packed condensed
// split route (K5e-c), one env per warp in the route's lean layout
// (`RicPackLean`), or, for comparison, per 128-thread block in its block
// layout (`RicPack`, the kernel before).
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="ric", foot_split=True route with foot_pack True or "apply"
// (`factor_ric_split:675-709`): the paired no-pivot elimination
// `_gj_pair_inplace` (:191), the packed K^-1 apply and `_split_bkb_pack`
// (:630), with every step variant of the Newton-step kernel. It computes what
// the packed "ric" route of `ops/pdipm.py` computes (the plain version).
//
// Per stage the two feet's 4x4 SPD blocks are one row-major 4 x 8 pair
// [K_L | K_R] (pdipm_split.cuh). With foot_pack True each half is inverted
// as the paired elimination inverts it, the pivot row scaled by its
// reciprocal whatever gj_form says (`_gj_pair_inplace`); with "apply" each
// half is inverted as K2 inverts it (gj_form as given). Either way it is
// stored packed, so that a stage row of the inverse is 8 contiguous values.
//
// What bounds it on an H100: as K2 (pdipm_ric.cu), the latency of one env's
// chain of small dependent eliminations and sweeps; an env reads 1,260
// values and writes 704, so not bandwidth. The block group adds the paired
// elimination's 4 x 2 block barriers a Newton step, and 4 envs share an SM.
//
// What the design does about that: K2's warp group (`WarpGroup<1>`) and
// K2's lean layout, whose values the packing only reorders (28,160 B an env
// at h10 in f32, 56,320 B in f64: 8 and 4 envs an SM against 4 and 2
// blocks); the 2T halves inverted one a lane in registers with the paired
// form's arithmetic (`inverse4_nopivot` with the reciprocal, one inlined
// copy for both forms), so no barrier and no elimination scratch; the
// y-chain and the sweeps in the warp's registers, as K2's.
//
// Numerics: per half the paired elimination is K2's inverse with gj_form
// "inplace", and the packed Bd K^-1 Bd^T is K2's sum in K2's order. The warp
// group sums mu, mu_aff and the residual norms in the block group's order
// (`BLOCK_ORDER_SUMS`), so with the default form both forms give the bits
// of the block group, K5e-c's and K2's. kkt_scale is ignored (`:680`, the
// JAX kernel does not equilibrate the packed blocks).
// Build without --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_split.cuh"

// The route's policies for the shared Newton-step kernel (pdipm_common.cuh):
// the block layout (block group) and the lean one (the warp group).
struct RicPack : RicSplit<true> {};
struct RicPackLean : RicSplit<true, true> {};

extern "C" {

// Dynamic shared memory of one block of the block group, in bytes, for
// horizon T and a value size of 4 (float) or 8 (double).
size_t pdipm_ric_pack_smem_bytes(int T, int value_size) {
  return RicPack::make_layout(T, value_size).bytes;
}

// Dynamic shared memory of one env (one block) in the lean layout of the
// warp group, in bytes: K2's (`pdipm_ric_lean_bytes`).
size_t pdipm_ric_pack_lean_bytes(int T, int value_size) {
  return RicPackLean::make_layout(T, value_size).bytes;
}

// Resident envs per SM of the block group (lean 0) or of the warp group
// (lean 1), from cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative
// cudaError_t on failure.
int pdipm_ric_pack_envs_per_sm(int T, int value_size, int lean) {
  if (lean)
    return value_size == 4 ? envs_per_sm<RicPackLean, float, WarpGroup<1>>(T)
                           : envs_per_sm<RicPackLean, double, WarpGroup<1>>(T);
  return value_size == 4 ? envs_per_sm<RicPack, float, BlockGroup>(T)
                         : envs_per_sm<RicPack, double, BlockGroup>(T);
}

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric_pack_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), except that refine_df must be 0:
// any other value returns cudaErrorInvalidValue and launches nothing.
// args->foot_pack: FOOT_PACK_PAIR (True) or FOOT_PACK_APPLY ("apply").
int pdipm_ric_pack_f32(const void* hd, const void* f, const void* ad, const void* bd,
                       const void* b, const void* gu, const void* d, const void* x0,
                       const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                       void* y, void* res, const void* go, void* ran, int batch, int T,
                       const PdipmArgs* args, void* stream) {
  return launch<RicPack, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                ran, batch, T, args, stream);
}

int pdipm_ric_pack_f64(const void* hd, const void* f, const void* ad, const void* bd,
                       const void* b, const void* gu, const void* d, const void* x0,
                       const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                       void* y, void* res, const void* go, void* ran, int batch, int T,
                       const PdipmArgs* args, void* stream) {
  return launch<RicPack, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                 ran, batch, T, args, stream);
}

// The same solve in the route's warp group, one warp per env, one env per
// block, in its lean layout (`pdipm_ric_pack_lean_bytes`).
int pdipm_ric_pack_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                            const void* b, const void* gu, const void* d, const void* x0,
                            const void* s0, const void* z0, const void* y0, void* x, void* s,
                            void* z, void* y, void* res, const void* go, void* ran, int batch,
                            int T, const PdipmArgs* args, void* stream) {
  return launch<RicPackLean, float, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s,
                                                  z, y, res, go, ran, batch, T, args, stream);
}

int pdipm_ric_pack_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                            const void* b, const void* gu, const void* d, const void* x0,
                            const void* s0, const void* z0, const void* y0, void* x, void* s,
                            void* z, void* y, void* res, const void* go, void* ran, int batch,
                            int T, const PdipmArgs* args, void* stream) {
  return launch<RicPackLean, double, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x,
                                                   s, z, y, res, go, ran, batch, T, args, stream);
}

const char* pdipm_ric_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
