// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the packed augmented
// split route (K5e-a), one thread block per env.
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
// barriers of small dependent eliminations, not bandwidth. Its shared memory
// is K1's plus the 144 values of yc.
//
// Numerics: "apply" is K1's arithmetic per half, so it differs from K1 only
// in the order of the Bd K^-1 Bd^T sum (the packed 8-column sum here, K1's
// 12-column P_t Bd^T there); True differs further by the reciprocal scaling
// of the pivot row. kkt_scale is ignored (`:800-812`). Build without
// --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_split.cuh"

// The route's policy for the shared Newton-step kernel (pdipm_common.cuh).
struct RicAugPack : RicAugSplit<true> {};

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_aug_pack_smem_bytes(int T, int value_size) {
  return RicAugPack::make_layout(T, value_size).bytes;
}

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

const char* pdipm_ric_aug_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
