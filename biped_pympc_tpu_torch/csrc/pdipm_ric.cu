// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the condensed
// route, one thread block per env.
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
// What the design does about that: every value of an env lives in the
// block's dynamic shared memory for the whole solve (40,240 B f32 / 80,480 B
// f64 at T = 10). The 2T foot blocks are built and inverted one per thread,
// in registers; the y-chain, the sweeps and the operator applies spread
// their entries over the block's threads as in the augmented kernel.
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
// The route's policy is `RicSplit<false>` of pdipm_split.cuh, for the
// Newton-step kernel of pdipm_common.cuh.

#include "pdipm_split.cuh"

// The route's policy for the shared Newton-step kernel (pdipm_common.cuh).
struct Ric : RicSplit<false> {};

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_smem_bytes(int T, int value_size) {
  return Ric::make_layout(T, value_size).bytes;
}

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

const char* pdipm_ric_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
