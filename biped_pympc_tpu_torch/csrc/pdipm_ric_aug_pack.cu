// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the packed augmented
// split route (K5e-a), one env per group of 64 threads (two warps) in the
// route's lean layout (`RicAugPackLean`), or, for comparison, per 128-thread
// block in its block layout (`RicAugPack`, the kernel before).
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="ric_aug", foot_split=True route with foot_pack True or "apply"
// (`factor_ric_aug_split:791-823`): the paired elimination `_gj_pair_pivot`
// (:239) or, with aug_pivot=False, `_gj_pair_inplace` (:191), the packed K^-1
// apply (`apply_lr`, :814) and `_split_bkb_pack` (:630) over the [0:4, 0:4]
// corners of the pair (`k8_like`, :820), with every step variant of the
// Newton-step kernel (the compensated residual included). It computes what
// the packed "ric_aug" route of `ops/pdipm.py` computes (the plain version).
//
// Per stage the two feet's 12x12 blocks [F (3), M_y (1), z_f (8)] are one
// row-major 12 x 24 pair [K_L | K_R] in shared memory (pdipm_split.cuh). With
// foot_pack True the T pairs are inverted by one paired elimination: twelve
// barrier steps for all 2T halves, each half with its own pivot search and
// row swaps (a swap moves only its half's 12 columns, and the swaps are undone
// per half), the pivot row scaled by its reciprocal (`_gj_pair_pivot`:
// `row_p * (1 / pivot)`). With "apply" each half is eliminated as K1 does
// (pivoted: divided by the pivot; not: gj_form), in place in the pair.
//
// What bounds it on an H100: as K1 (pdipm_ric_aug.cu), the latency and
// barriers of small dependent eliminations, not bandwidth. The block
// layout's shared memory is K1's plus the 144 values of yc.
//
// What the design does about that: K1's warp group (`WarpGroup<2>`, its
// 168-register cap in f32): the lean layout (37,472 B an env at h10 in f32,
// 6 envs an SM against 4 blocks: the packed P_t is 8 columns a row, so yc
// and Ad Q~^-1 Ad^T, formed anew each factor, fit in the union K1 leaves),
// each stage pair eliminated in one warp (`gj_pair_warp`: 24 of its 32
// lanes, one row of a half a lane, both halves in one elimination with no
// group barrier, both forms), and the y-chain and its sweeps in one warp's
// registers.
//
// Numerics: "apply" is K1's arithmetic per half, so it differs from K1 only
// in the order of the Bd K^-1 Bd^T sum (the packed 8-column sum here, K1's
// 12-column P_t Bd^T there); True differs further by the reciprocal scaling
// of the pivot row. kkt_scale is ignored (`:800-812`). Build without
// --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_split.cuh"

// The route's policies for the shared Newton-step kernel (pdipm_common.cuh):
// the block layout (block group) and the lean one (the warp group).
struct RicAugPack : RicAugSplit<true> {};
struct RicAugPackLean : RicAugSplit<true, true> {};

extern "C" {

// Dynamic shared memory of one block of the block group, in bytes, for
// horizon T and a value size of 4 (float) or 8 (double).
size_t pdipm_ric_aug_pack_smem_bytes(int T, int value_size) {
  return RicAugPack::make_layout(T, value_size).bytes;
}

// Dynamic shared memory of one env (one block) in the lean layout of the
// warp group, in bytes.
size_t pdipm_ric_aug_pack_lean_bytes(int T, int value_size) {
  return RicAugPackLean::make_layout(T, value_size).bytes;
}

// Resident envs per SM of the block group (lean 0) or of the warp group
// (lean 1), from cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative
// cudaError_t on failure.
int pdipm_ric_aug_pack_envs_per_sm(int T, int value_size, int lean) {
  if (lean)
    return value_size == 4 ? envs_per_sm<RicAugPackLean, float, WarpGroup<2>>(T)
                           : envs_per_sm<RicAugPackLean, double, WarpGroup<2>>(T);
  return value_size == 4 ? envs_per_sm<RicAugPack, float, BlockGroup>(T)
                         : envs_per_sm<RicAugPack, double, BlockGroup>(T);
}

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric_aug_pack_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), refine_df included.
// args->foot_pack: FOOT_PACK_PAIR (True) or FOOT_PACK_APPLY ("apply").
int pdipm_ric_aug_pack_f32(const void* hd, const void* f, const void* ad, const void* bd,
                           const void* b, const void* gu, const void* d, const void* x0,
                           const void* s0, const void* z0, const void* y0, void* x, void* s,
                           void* z, void* y, void* res, const void* go, void* ran, int batch,
                           int T, const PdipmArgs* args, void* stream) {
  return launch<RicAugPack, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                   ran, batch, T, args, stream);
}

int pdipm_ric_aug_pack_f64(const void* hd, const void* f, const void* ad, const void* bd,
                           const void* b, const void* gu, const void* d, const void* x0,
                           const void* s0, const void* z0, const void* y0, void* x, void* s,
                           void* z, void* y, void* res, const void* go, void* ran, int batch,
                           int T, const PdipmArgs* args, void* stream) {
  return launch<RicAugPack, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res,
                                    go, ran, batch, T, args, stream);
}

// The same solve in the route's warp group, two warps per env, one env per
// block, in its lean layout (`pdipm_ric_aug_pack_lean_bytes`).
int pdipm_ric_aug_pack_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                                const void* b, const void* gu, const void* d, const void* x0,
                                const void* s0, const void* z0, const void* y0, void* x, void* s,
                                void* z, void* y, void* res, const void* go, void* ran,
                                int batch, int T, const PdipmArgs* args, void* stream) {
  return launch<RicAugPackLean, float, WarpGroup<2>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x,
                                                     s, z, y, res, go, ran, batch, T, args,
                                                     stream);
}

int pdipm_ric_aug_pack_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                                const void* b, const void* gu, const void* d, const void* x0,
                                const void* s0, const void* z0, const void* y0, void* x, void* s,
                                void* z, void* y, void* res, const void* go, void* ran,
                                int batch, int T, const PdipmArgs* args, void* stream) {
  return launch<RicAugPackLean, double, WarpGroup<2>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0,
                                                      x, s, z, y, res, go, ran, batch, T, args,
                                                      stream);
}

const char* pdipm_ric_aug_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
