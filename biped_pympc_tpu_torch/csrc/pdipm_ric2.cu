// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP on the rank-2
// condensed route (K5c): one warp per env (`Ric2Warp`, pdipm_riccati.cuh),
// or, for comparison, one 128-thread block per env (`Ric2`, the kernel
// before).
//
// Replaces: biped_pympc_tpu/ops/pdipm_pallas.py `_pdipm_kernel` (:308) on its
// backend="ric2" route: `factor_ric2` (:839) and `_kinv2_apply` (:885), the
// condensed reduced solve of `iteration_base` (:1252-1274) through
// `ric_solve` (:929), the delta corrector, the warm entry (`warm=True`,
// :316-319) and kkt_scale="jacobi" on Ru (:860). It computes what the "ric2"
// route of `ops/pdipm.py` computes (the plain version).
//
// Per stage the 12-wide SPD block Ru = G^T W_t^-1 G + diag(r + beta) is
// inverted without pivoting, in the form of gj_form; the 2-wide nu block
// (diagonal -delta) is eliminated by the Schur identity instead of sitting
// in the elimination:
// with E selecting u columns 6 and 9, S = -delta I - E Ru^-1 E^T (2x2,
// negative definite) is inverted in closed form, and
//
//     K^-1 = [[Ru^-1 + Ru^-1 E^T S^-1 E Ru^-1, -Ru^-1 E^T S^-1],
//             [-S^-1 E Ru^-1,                   S^-1]],
//
// applied row by row through that formula, never assembled. kuu = Ru^-1 +
// (E Ru^-1)^T S^-1 (E Ru^-1), a rank-2 update, feeds the y-chain.
//
// What bounds it on an H100: as the other Riccati routes (pdipm_ric_aug.cu),
// an env reads 1,260 values and writes 704, so the kernel is bound by the
// latency of one env's chain of small dependent eliminations, not by
// bandwidth. In the block group the T 12-wide inverses were eliminated
// together in 12 steps of two block barriers each, one thread a block
// forming each pivot row, and the y-chain took two barriers a step.
//
// What the design does about that: one warp an env, in K2's lean layout
// (f, b, d in device memory, the refinement in place, a factor / solve
// union; 26,880 B at h10 in f32), the T stage records (Ru^-1, E Ru^-1 and
// S^-1, 6,880 B) in a device-memory workspace wherever that puts more envs
// on an SM (8 against 6 at h10 in f32; the block group holds 4), so every
// horizon runs up to 94 (f32) and 46 (f64), against 46 and 23 in the block
// layout, which stays in this library for comparison. The warp builds and
// eliminates two stage blocks at a time in registers, a row a lane, the
// pivot row passed by shuffle (`gj_pair_regs`, no barrier in the chain),
// forms S^-1, (K^-1)_uu, P_t and Y'_t in registers (rows 6 and 9 of Ru^-1
// and the rows of (K^-1)_uu broadcast by shuffle), runs the y-chain and the
// sweeps in registers, and forms S^-1 (r_nu - E Ru^-1 r_u) once a stage
// before each K^-1 apply (`prep`) rather than once a row.
//
// Numerics: the 2x2 determinant sa * sc - sb * sb, with Ru^-1[6,6] ~
// 1 / (r + beta) ~ 1e4, follows the JAX formula as written. Ru carries
// G^T W^-1 G with W^-1 up to ~1e8, as K2's foot blocks do; the Jordan step
// writes the inverse's pivot entry as 1/pivot directly. Build without
// --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_riccati.cuh"

// The route's policy for the Newton-step kernel of pdipm_common.cuh. Layout:
// ka holds the T Ru^-1 (12x12), kuu the T (K^-1)_uu, sn the T S^-1 (2x2).
struct Ric2 {
  static constexpr bool AUG = false;
  using Layout = RicLayout;

  static __host__ __device__ Layout make_layout(int T, int size_of_s) {
    return make_ric_layout(T, size_of_s, NU_, false, true, false);
  }

  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<false, false>(g, sm, L, beta, delta);
  }

  // Row o (< 14) of K_t^-1 r, r = [u (12), nu (2)], by the block formula
  // (`_kinv2_apply`): t1 = Ru^-1 r_u, eta = S^-1 (r_nu - E t1) is the nu part,
  // du = t1 - (E Ru^-1)^T eta.
  template <typename S>
  static __device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o,
                                               const S* r) {
    const S* ri = sm + L.ka + t * 144;
    const S* sn = sm + L.sn + t * 4;
    S t6 = S(0), t9 = S(0);
    for (int j = 0; j < NU_; ++j) t6 += ri[6 * NU_ + j] * r[j];
    for (int j = 0; j < NU_; ++j) t9 += ri[9 * NU_ + j] * r[j];
    const S e0 = r[NU_] - t6, e1 = r[NU_ + 1] - t9;
    const S eta0 = sn[0] * e0 + sn[1] * e1;
    const S eta1 = sn[2] * e0 + sn[3] * e1;
    if (o == NU_) return eta0;
    if (o == NU_ + 1) return eta1;
    S t1 = S(0);
    for (int j = 0; j < NU_; ++j) t1 += ri[o * NU_ + j] * r[j];
    return t1 - (ri[6 * NU_ + o] * eta0 + ri[9 * NU_ + o] * eta1);
  }

  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags ff) {
    const int tid = g.rank(), nt = g.size(), T = L.T;
    const S* hd = sm + L.hd;
    const S* gu = sm + L.gu;
    const S* w = sm + L.w;
    S* ka = sm + L.ka;
    S* kuu = sm + L.kuu;
    S* sn = sm + L.sn;
    // Ru_t = G^T diag(W_t^-1) G + diag(r + beta), all T stages.
    for (int it = tid; it < T * 144; it += nt) {
      const int t = it / 144, r = (it % 144) / NU_, c = it % NU_;
      const S* wt = w + t * NI_;
      S acc = S(0);
      for (int q = 0; q < NI_; ++q) acc += gu[q * NU_ + r] * gu[q * NU_ + c] * wt[q];
      ka[it] = r == c ? acc + (hd[NX_ * T + r] + beta) : acc;
    }
    g.sync();
    stage_inverse<NU_>(g, ka, T, false, ff.gj_inplace, ff.jacobi, sm + L.colk, sm + L.prow, piv,
                       sm + L.run);
    // S^-1 in closed form, S = [[sa, sb], [sb, sc]].
    for (int t = tid; t < T; t += nt) {
      const S* ri = ka + t * 144;
      const S sa = -delta - ri[6 * NU_ + 6];
      const S sb = -ri[6 * NU_ + 9];
      const S sc = -delta - ri[9 * NU_ + 9];
      const S det = sa * sc - sb * sb;
      sn[t * 4 + 0] = sc / det;
      sn[t * 4 + 1] = -sb / det;
      sn[t * 4 + 2] = -sb / det;
      sn[t * 4 + 3] = sa / det;
    }
    g.sync();
    // kuu = Ru^-1 + (E Ru^-1)^T S^-1 (E Ru^-1); E Ru^-1 is rows 6 and 9 of Ru^-1.
    for (int it = tid; it < T * 144; it += nt) {
      const int t = it / 144, i = (it % 144) / NU_, j = it % NU_;
      const S* ri = ka + t * 144;
      const S* s4 = sn + t * 4;
      const S e6j = ri[6 * NU_ + j], e9j = ri[9 * NU_ + j];
      const S si0 = s4[0] * e6j + s4[1] * e9j;
      const S si1 = s4[2] * e6j + s4[3] * e9j;
      kuu[it] = ri[i * NU_ + j] + (ri[6 * NU_ + i] * si0 + ri[9 * NU_ + i] * si1);
    }
    g.sync();
    PDIPM_MARK(g, PH_FOOT);
    y_chain_from_kuu(g, sm, L, kuu, 144, NU_, delta, ff.gj_inplace, piv);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    riccati_solve<Ric2>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};

// The warp group: one warp an env, two stage blocks at a time (pdipm_riccati.cuh).
struct Ric2Warp : RicCondWarp<true> {};

extern "C" {

// Dynamic shared memory of one block of the block group, in bytes, for
// horizon T and a value size of 4 (float) or 8 (double).
size_t pdipm_ric2_smem_bytes(int T, int value_size) {
  return Ric2::make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), except that refine_df must be 0:
// any other value returns cudaErrorInvalidValue and launches nothing.

int pdipm_ric2_f32(const void* hd, const void* f, const void* ad, const void* bd,
                   const void* b, const void* gu, const void* d, const void* x0,
                   const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                   void* y, void* res, const void* go, void* ran, int batch, int T,
                   const PdipmArgs* args, void* stream) {
  return launch<Ric2, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                             ran, batch, T, args, stream);
}

int pdipm_ric2_f64(const void* hd, const void* f, const void* ad, const void* bd,
                   const void* b, const void* gu, const void* d, const void* x0,
                   const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                   void* y, void* res, const void* go, void* ran, int batch, int T,
                   const PdipmArgs* args, void* stream) {
  return launch<Ric2, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go,
                              ran, batch, T, args, stream);
}

#ifdef PDIPM_PROFILE
// The clock64() breakdown of the last launch (a PDIPM_PROFILE build): n envs
// x PH_COUNT cycles into `out`, then cleared; a cudaError_t.
int pdipm_ric2_profile_read(void* out, int n) { return prof_read(out, n); }
#endif

// One env's shared memory in the warp group, in bytes, and the workspace
// per env in bytes: 0 when the stage records stay in shared memory
// (`uses_workspace`, pdipm_common.cuh), unless `force`.
size_t pdipm_ric2_lean_bytes(int T, int value_size) {
  return lean_bytes<Ric2Warp, WarpGroup<1>>(T, value_size);
}

size_t pdipm_ric2_work_bytes(int T, int value_size, int force) {
  return work_bytes<Ric2Warp, WarpGroup<1>>(T, value_size, force != 0);
}

// Resident envs per SM of the block group (mode 0), of the warp group as it
// launches (1) or with the stage records in the workspace (2), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int pdipm_ric2_envs_per_sm(int T, int value_size, int mode) {
  if (mode == 0)
    return value_size == 4 ? envs_per_sm<Ric2, float, BlockGroup>(T)
                           : envs_per_sm<Ric2, double, BlockGroup>(T);
  const bool work = mode == 2 || work_bytes<Ric2Warp, WarpGroup<1>>(T, value_size, false) > 0;
  return value_size == 4 ? envs_per_sm<Ric2Warp, float, WarpGroup<1>>(T, work)
                         : envs_per_sm<Ric2Warp, double, WarpGroup<1>>(T, work);
}

// The same solve in the route's warp group, one warp per env, one env per
// block, in its lean layout; `work` is batch x `pdipm_ric2_work_bytes`
// bytes of device memory for the stage records, or null to keep them in
// shared memory. refine_df must be 0, as on the block entry.
int pdipm_ric2_warp_f32(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream, void* work) {
  return launch<Ric2Warp, float, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y,
                                        res, go, ran, batch, T, args, stream, work);
}

int pdipm_ric2_warp_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  const PdipmArgs* args, void* stream, void* work) {
  return launch<Ric2Warp, double, WarpGroup<1>>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z,
                                         y, res, go, ran, batch, T, args, stream, work);
}

const char* pdipm_ric2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
