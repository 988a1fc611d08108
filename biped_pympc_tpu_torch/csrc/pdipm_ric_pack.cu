// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the packed condensed
// split route (K5e-c), one thread block per env.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="ric", foot_split=True route with foot_pack True or "apply"
// (`factor_ric_split:675-709`): the paired no-pivot elimination
// `_gj_pair_inplace` (:191), the packed K^-1 apply and `_split_bkb_pack`
// (:630), with every step variant of the Newton-step kernel. It computes what
// the packed "ric" route of `ops/pdipm.py` computes (the plain version).
//
// Per stage the two feet's 4x4 SPD blocks are one row-major 4 x 8 pair
// [K_L | K_R] in shared memory (pdipm_split.cuh). With foot_pack True the T
// pairs are inverted by one paired elimination, four barrier steps for all
// 2T halves, the pivot row scaled by its reciprocal whatever gj_form says (as
// `_gj_pair_inplace`); with "apply" each half is inverted in a thread's
// registers as K2 inverts it (gj_form as given) and stored packed.
//
// What bounds it on an H100: as K2 (pdipm_ric.cu), the latency and barriers
// of small dependent eliminations; an env reads 1,260 values and writes 704.
// The paired form adds 4 x 2 barriers per Newton step against K2's in-register
// inverses. Its shared memory is K2's plus the pair's elimination scratch.
//
// Numerics: per half the paired elimination is K2's inverse with gj_form
// "inplace", so with the default form this route gives K2's bits; the packed
// Bd K^-1 Bd^T is K2's sum in K2's order. kkt_scale is ignored (`:680`, the
// JAX kernel does not equilibrate the packed blocks). Build without
// --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_split.cuh"

// The route's policy for the shared Newton-step kernel (pdipm_common.cuh).
struct RicPack : RicSplit<true> {};

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_pack_smem_bytes(int T, int value_size) {
  return RicPack::make_layout(T, value_size).bytes;
}

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

const char* pdipm_ric_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
