// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP, one env per group of
// 64 threads (two warps) in the route's lean layout, or, for comparison, per
// 128-thread block in its block layout.
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` on its
// backend="ric_aug", foot_split=True route (delta corrector), with its warm
// entry (`warm=True`, :316-319) and both refinement residuals ("f32" and the
// compensated "df", `df_resid` :1290-1369). It computes what `ops/pdipm.py` of
// this package computes (the plain version): `iterations` Newton steps of
// every env's QP in one launch, from the cold start x = 0, s = max(d, 1),
// z = 1, y = 1 or from a given (x0, s0, z0, y0).
//
// What bounds it on an H100: at T = 10 an env reads 1,260 values and writes
// 704, so a b4096 solve moves ~32 MB (f32) to and from device memory, ~10 us
// at 3.35 TB/s, against tens of ms for the whole solve (PERF.md). The work is
// 20 Newton steps of small dependent eliminations (twenty 12-wide pivoted
// Gauss-Jordan inverses, a T-long chain of 12-wide inverses, and four
// forward/backward 12-wide sweeps per step): the kernel is bound by the
// latency of one env's chain of phases and by how many envs an SM holds,
// not by bandwidth or arithmetic.
//
// What the design does about that: every value of an env (QP data, iterates,
// residuals, factors, directions) lives in shared memory for the whole solve;
// device memory is read once and written once. In the warp group
// (`RicAugLean`, pdipm_split.cuh) the lean layout (37,584 B in f32 at T = 10
// against the block layout's 54,928 B) lets 6 envs share an SM, against 4
// blocks; the y-chain's inverses and the sweeps run in one warp with a
// stage's 12 x 12 block in registers, a lane per row, the pivot row or the
// vector passed by __shfl_sync, so a chain step costs no barrier; the two
// foot blocks of a stage are eliminated together in one warp, a lane per
// row in registers, each block's pivot found by a shuffle argmax and its
// pivot row passed by shuffles (`gj_pair_warp`, K5e-a's elimination), the
// warps taking alternate stages, so the 12 pivot steps cost no barrier; the
// phases' independent items spread over the group's 64 lanes, synchronized
// by named barrier 1; the reductions are shuffle trees. The block group
// (`RicAug`) is the configuration before, kept bit for bit. mu, the residual
// norms and the fraction-to-boundary minima are reductions in a fixed
// order, so the result does not depend on scheduling.
//
// Numerics (ROADMAP Queue 3): the 12-wide augmented foot blocks are inverted
// with a per-block partial-pivot search (natural order overflows to NaN on
// stress problems; aug_pivot=False keeps it for diagnostics); the y-chain
// blocks are negative definite and are inverted without pivoting, in the
// form of gj_form; both are in-place Jordan eliminations that write the
// inverse's pivot entry as 1/pivot directly. With kkt_scale="jacobi"
// (`jacobi_scaled`, :333, applied at :826) the foot blocks are equilibrated
// around their inverse; the 2x2 pairs and the M_z scalars are not. Build
// without --use_fast_math: division and sqrt stay IEEE.
//
// The route's policies (layout, factor, stage-inverse apply) are
// `RicAugSplit<false>` (block layout) and `RicAugSplit<false, true>` (lean)
// of pdipm_split.cuh, for the Newton-step kernel of pdipm_common.cuh; this
// file adds the refinement residual's own entry (block layout) and the
// entries of the warp group, its layout and its occupancy.

#include "pdipm_split.cuh"

// The route's policies for the shared Newton-step kernel (pdipm_common.cuh):
// the block layout (block group) and the lean one (the warp group).
struct RicAug : RicAugSplit<false> {};
struct RicAugLean : RicAugSplit<false, true> {};

using Layout = RicAug::Layout;

// The refinement residual alone, one block per env: loads hd, Ad, Bd, G_u,
// W, the direction (dx, dz, dy) and the rhs (r1, rz, r4) into the solve's
// layout and runs `refine_residual`, the code every refinement step of the
// solve runs. It holds K4's compensated arithmetic against its plain version
// on inputs whose residual cancels nearly every digit.
template <typename S>
__global__ void __launch_bounds__(PDIPM_THREADS) pdipm_ric_aug_residual_kernel(
    const S* __restrict__ hd_in, const S* __restrict__ ad_in, const S* __restrict__ bd_in,
    const S* __restrict__ gu_in, const S* __restrict__ w_in, const S* __restrict__ dx_in,
    const S* __restrict__ dz_in, const S* __restrict__ dy_in, const S* __restrict__ r1_in,
    const S* __restrict__ rz_in, const S* __restrict__ r4_in, S* __restrict__ e1_out,
    S* __restrict__ ez_out, S* __restrict__ e4_out, int T, int refine_df, S beta, S delta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const Layout L = RicAug::make_layout(T, (int)sizeof(S));
  const int tid = threadIdx.x, nt = blockDim.x;
  const long env = blockIdx.x;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  for (int i = tid; i < nz; i += nt) {
    sm[L.hd + i] = hd_in[env * nz + i];
    sm[L.dxa + i] = dx_in[env * nz + i];
    sm[L.r1 + i] = r1_in[env * nz + i];
  }
  for (int i = tid; i < 144; i += nt) {
    sm[L.ad + i] = ad_in[env * 144 + i];
    sm[L.bd + i] = bd_in[env * 144 + i];
  }
  for (int i = tid; i < NI_ * NU_; i += nt) sm[L.gu + i] = gu_in[env * NI_ * NU_ + i];
  for (int i = tid; i < ni; i += nt) {
    sm[L.w + i] = w_in[env * ni + i];
    sm[L.dza + i] = dz_in[env * ni + i];
    sm[L.rz + i] = rz_in[env * ni + i];
  }
  for (int i = tid; i < ne; i += nt) {
    sm[L.dya + i] = dy_in[env * ne + i];
    sm[L.r4 + i] = r4_in[env * ne + i];
  }
  __syncthreads();
  refine_residual(BlockGroup{}, sm, L, refine_df != 0, beta, delta, sm + L.dxa, sm + L.dza,
                  sm + L.dya);
  for (int i = tid; i < nz; i += nt) e1_out[env * nz + i] = sm[L.e1 + i];
  for (int i = tid; i < ni; i += nt) ez_out[env * ni + i] = sm[L.ez + i];
  for (int i = tid; i < ne; i += nt) e4_out[env * ne + i] = sm[L.e4 + i];
}

template <typename S>
static int launch_residual(const void* hd, const void* ad, const void* bd, const void* gu,
                           const void* w, const void* dx, const void* dz, const void* dy,
                           const void* r1, const void* rz, const void* r4, void* e1, void* ez,
                           void* e4, int batch, int T, int refine_df, double beta, double delta,
                           void* stream) {
  const Layout L = RicAug::make_layout(T, (int)sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(pdipm_ric_aug_residual_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  pdipm_ric_aug_residual_kernel<S><<<batch, PDIPM_THREADS, L.bytes, (cudaStream_t)stream>>>(
      (const S*)hd, (const S*)ad, (const S*)bd, (const S*)gu, (const S*)w, (const S*)dx,
      (const S*)dz, (const S*)dy, (const S*)r1, (const S*)rz, (const S*)r4, (S*)e1, (S*)ez,
      (S*)e4, T, refine_df, (S)beta, (S)delta);
  return (int)cudaGetLastError();
}

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_aug_smem_bytes(int T, int value_size) {
  return RicAug::make_layout(T, value_size).bytes;
}

// Dynamic shared memory of one env (one block) in the lean layout of the
// warp group, in bytes.
size_t pdipm_ric_aug_lean_bytes(int T, int value_size) {
  return RicAugLean::make_layout(T, value_size).bytes;
}

// Resident envs per SM of the block group (lean 0) or of the warp group
// (lean 1), from cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative
// cudaError_t on failure.
int pdipm_ric_aug_envs_per_sm(int T, int value_size, int lean) {
  if (lean)
    return value_size == 4 ? envs_per_sm<RicAugLean, float, WarpGroup<2>>(T)
                           : envs_per_sm<RicAugLean, double, WarpGroup<2>>(T);
  return value_size == 4 ? envs_per_sm<RicAug, float, BlockGroup>(T)
                         : envs_per_sm<RicAug, double, BlockGroup>(T);
}

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric_aug_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// Solve `batch` QPs on `stream`. All arrays are batch-first and contiguous:
// hd, f, x0, x (B, 24T); ad, bd (B, 12, 12); b, y0, y (B, 14T); gu (B, 16, 12);
// d, s0, z0, s, z (B, 16T); res (B, 4). x0, s0, z0, y0 are the warm start, or
// all null for the cold start; the outputs may be the same buffers. go (one
// int) gates the launch when non-null: 0 leaves every output untouched. ran
// (one int), when non-null, gets one added per launch that ran. `args` holds
// the options (`PdipmArgs`). Returns a cudaError_t (0 = success).
int pdipm_ric_aug_f32(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      const PdipmArgs* args, void* stream) {
  return launch<RicAug, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                               ran, batch, T, args, stream);
}

int pdipm_ric_aug_f64(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      const PdipmArgs* args, void* stream) {
  return launch<RicAug, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                                ran, batch, T, args, stream);
}

// The refinement residual of `batch` augmented reduced systems on `stream`:
// hd, dx, r1, e1 (B, 24T); ad, bd (B, 12, 12); gu (B, 16, 12); w, dz, rz, ez
// (B, 16T); dy, r4, e4 (B, 14T). refine_df selects the compensated residual.
// Returns a cudaError_t (0 = success).
int pdipm_ric_aug_residual_f32(const void* hd, const void* ad, const void* bd, const void* gu,
                               const void* w, const void* dx, const void* dz, const void* dy,
                               const void* r1, const void* rz, const void* r4, void* e1,
                               void* ez, void* e4, int batch, int T, int refine_df, double beta,
                               double delta, void* stream) {
  return launch_residual<float>(hd, ad, bd, gu, w, dx, dz, dy, r1, rz, r4, e1, ez, e4, batch, T,
                                refine_df, beta, delta, stream);
}

int pdipm_ric_aug_residual_f64(const void* hd, const void* ad, const void* bd, const void* gu,
                               const void* w, const void* dx, const void* dz, const void* dy,
                               const void* r1, const void* rz, const void* r4, void* e1,
                               void* ez, void* e4, int batch, int T, int refine_df, double beta,
                               double delta, void* stream) {
  return launch_residual<double>(hd, ad, bd, gu, w, dx, dz, dy, r1, rz, r4, e1, ez, e4, batch, T,
                                 refine_df, beta, delta, stream);
}

// The same solve in the route's warp group, two warps per env, one env per
// block, in its lean layout (`pdipm_ric_aug_lean_bytes`).
int pdipm_ric_aug_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream) {
  return launch<RicAugLean, float, WarpGroup<2>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0,
                                            x, s, z, y, res, go, ran, batch, T, args, stream);
}

int pdipm_ric_aug_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream) {
  return launch<RicAugLean, double, WarpGroup<2>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0,
                                             x, s, z, y, res, go, ran, batch, T, args, stream);
}

const char* pdipm_ric_aug_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
