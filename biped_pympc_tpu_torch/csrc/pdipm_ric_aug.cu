// Fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP, one thread block per env.
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
// at 3.35 TB/s, against 43 ms measured for the whole solve (H100 80GB HBM3,
// 700 W). The work is 20 Newton steps of small dependent eliminations (twenty
// 12-wide pivoted Gauss-Jordan inverses, a T-long chain of 12-wide inverses,
// and four forward/backward 12-wide sweeps per step), so the kernel is bound
// by instruction latency and barriers, not by bandwidth.
//
// What the design does about that: every value of an env (QP data, iterates,
// residuals, factors, directions) lives in the block's dynamic shared memory
// for the whole solve; device memory is read once and written once. The
// block's threads share each phase's independent items: the 2T foot blocks'
// entries during the factorization, the 144 entries of each y-chain step, the
// T x 30 rows of the block-diagonal applies, the entries of every matvec.
// Sequential recurrences (the y-chain, the sweeps) parallelize only over the
// entries of one 12-wide step. mu, the residual norms and the
// fraction-to-boundary minima are block reductions in a fixed order, so the
// result does not depend on scheduling.
//
// Numerics (ROADMAP Queue 3): the 12-wide augmented foot blocks are inverted
// with a per-block partial-pivot search (natural order overflows to NaN on
// stress problems); the y-chain blocks are negative definite and are inverted
// without pivoting; both are in-place Jordan eliminations that write the
// inverse's pivot entry as 1/pivot directly. With kkt_scale="jacobi"
// (`jacobi_scaled`, :333, applied at :826) the foot blocks are equilibrated
// around their inverse; the 2x2 pairs and the M_z scalars are not. Build
// without --use_fast_math: division and sqrt stay IEEE.
//
// This file supplies the route's policy (layout, factor, stage-inverse
// apply) for the Newton-step kernel of pdipm_common.cuh, and the refinement
// residual's own entry.

#include "pdipm_riccati.cuh"

static constexpr int NF_ = 12;  // width of a foot block [F (3), M_y (1), z_f (8)]

// The route's policy for the shared Newton-step kernel (pdipm_common.cuh).
struct RicAug {
  static constexpr bool AUG = true;

  // Index layout of all per-env buffers in shared memory (in values of S).
  struct Layout {
    int T, nz, ni, ne;
    // inputs
    int hd, f, ad, bd, b, gu, d;
    // iterates and residuals
    int x, s, z, y, rx, rs, re, sig, w;
    // constants of the solve: q_inv, S = Q~^-1 Ad^T, Ad Q~^-1 Ad^T, 2x2 / 1x1 coefficients
    int qinv, sc, adqad, cf;
    // factors: 2T foot-block inverses, T y-chain inverses, elimination scratch
    int ka, m, p, colk, prow, q1;
    // reduced-solve rhs / directions
    int r1, rz, r4, r2, e1, ez, e4, ex, ezz, ey;
    int dxa, dsa, dza, dya, dxc, dsc, dzc, dyc;
    // sweep scratch; `run` also holds Jacobi's D during the factor
    int run, kr, g, wy, v12, red;
    int total;      // values of S
    int piv;        // byte offset of the int pivot table
    size_t bytes;   // total bytes
  };

  static __host__ __device__ Layout make_layout(int T, int size_of_s) {
    Layout L;
    L.T = T;
    L.nz = 24 * T;
    L.ni = 16 * T;
    L.ne = 14 * T;
    int o = 0;
    L.hd = take(o, L.nz); L.f = take(o, L.nz); L.ad = take(o, 144); L.bd = take(o, 144);
    L.b = take(o, L.ne); L.gu = take(o, NI_ * NU_); L.d = take(o, L.ni);
    L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
    L.rx = take(o, L.nz); L.rs = take(o, L.ni); L.re = take(o, L.ne);
    L.sig = take(o, L.ni); L.w = take(o, L.ni);
    L.qinv = take(o, NX_); L.sc = take(o, 144); L.adqad = take(o, 144); L.cf = take(o, 8);
    L.ka = take(o, 2 * T * 144); L.m = take(o, T * 144); L.p = take(o, T * 144);
    L.colk = take(o, 2 * T * NF_); L.prow = take(o, 2 * T * NF_); L.q1 = take(o, 144);
    L.r1 = take(o, L.nz); L.rz = take(o, L.ni); L.r4 = take(o, L.ne); L.r2 = take(o, L.ni);
    L.e1 = take(o, L.nz); L.ez = take(o, L.ni); L.e4 = take(o, L.ne);
    L.ex = take(o, L.nz); L.ezz = take(o, L.ni); L.ey = take(o, L.ne);
    L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
    L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
    L.run = take(o, T * NKA_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
    L.wy = take(o, T * NX_); L.v12 = take(o, NX_); L.red = take(o, PDIPM_THREADS);
    L.total = o;
    L.piv = o * size_of_s;
    L.bytes = (size_t)L.piv + sizeof(int) * 2 * T * NF_;
    return L;
  }

  // q_inv, S, Ad Q~^-1 Ad^T, and the [M_x, nu] pair / M_z coefficients.
  template <typename S>
  static __device__ void setup(S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<true, false>(sm, L, beta, delta);
  }

  // -------------------------------------------------------------------------
  // Stage block inverse apply: row o (< 30) of K_t^-1 r, r = [u(12), z(16), nu(2)].
  // K_t^-1 is the two foot-block inverses, the [M_x, nu] 2x2 pairs and the
  // M_z scalars.
  // -------------------------------------------------------------------------
  template <typename S>
  static __device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o,
                                               const S* r) {
    const S* cf = sm + L.cf;
    int foot = -1, a = 0;
    if (o < NU_) {
      switch (o) {
        case 0: case 1: case 2: foot = 0; a = o; break;
        case 7: foot = 0; a = 3; break;
        case 3: case 4: case 5: foot = 1; a = o - 3; break;
        case 10: foot = 1; a = 3; break;
        case 6: return cf[0] * r[6] + cf[1] * r[28];
        case 9: return cf[3] * r[9] + cf[4] * r[29];
        case 8: return cf[6] * r[8];
        default: return cf[7] * r[11];  // 11
      }
    } else if (o < 20) {
      foot = 0; a = 4 + (o - 12);
    } else if (o < 28) {
      foot = 1; a = 4 + (o - 20);
    } else if (o == 28) {
      return cf[1] * r[6] + cf[2] * r[28];
    } else {
      return cf[4] * r[9] + cf[5] * r[29];
    }
    const S* k = sm + L.ka + (foot * L.T + t) * 144 + a * NF_;
    const int zoff = 12 + 8 * foot;
    S acc = S(0);
    for (int bb = 0; bb < 4; ++bb) acc += k[bb] * r[foot_col(foot, bb)];
    for (int bb = 0; bb < 8; ++bb) acc += k[4 + bb] * r[zoff + bb];
    return acc;
  }

  // -------------------------------------------------------------------------
  // Factorization of the reduced KKT at the current W.
  // -------------------------------------------------------------------------
  template <typename S>
  static __device__ void factor(S* sm, const Layout& L, int* piv, S beta, S delta, bool jacobi) {
    const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
    const S* hd = sm + L.hd;
    const S* gu = sm + L.gu;
    const S* w = sm + L.w;
    const S* bd = sm + L.bd;
    const S* cf = sm + L.cf;
    S* ka = sm + L.ka;
    S* p = sm + L.p;

    // Foot blocks [[diag(r + beta), G_f^T], [G_f, -diag(W_f)]], block index foot*T + t.
    for (int it = tid; it < 2 * T * 144; it += nt) {
      const int blk = it / 144, foot = blk / T, t = blk % T;
      const int r = (it % 144) / NF_, c = it % NF_;
      S v;
      if (r < 4 && c < 4) {
        v = r == c ? hd[NX_ * T + foot_col(foot, r)] + beta : S(0);
      } else if (r < 4) {
        v = gu[(8 * foot + c - 4) * NU_ + foot_col(foot, r)];
      } else if (c < 4) {
        v = gu[(8 * foot + r - 4) * NU_ + foot_col(foot, c)];
      } else {
        v = r == c ? -w[t * NI_ + 8 * foot + r - 4] : S(0);
      }
      ka[it] = v;
    }
    __syncthreads();
    stage_inverse<NF_>(ka, 2 * T, true, jacobi, sm + L.colk, sm + L.prow, piv, sm + L.run);

    // P_t = Bd (K_t^-1)_uu, using the sparsity of (K^-1)_uu.
    for (int it = tid; it < T * 144; it += nt) {
      const int t = it / 144, i = (it % 144) / NX_, j = it % NX_;
      S v;
      if (j == 6) v = bd[i * NU_ + 6] * cf[0];
      else if (j == 9) v = bd[i * NU_ + 9] * cf[3];
      else if (j == 8) v = bd[i * NU_ + 8] * cf[6];
      else if (j == 11) v = bd[i * NU_ + 11] * cf[7];
      else {
        const int foot = (j >= 3 && j <= 5) || j == 10 ? 1 : 0;
        const int bcol = j == 7 || j == 10 ? 3 : (foot == 0 ? j : j - 3);
        const S* k = ka + (foot * T + t) * 144;
        v = S(0);
        for (int a = 0; a < 4; ++a) v += bd[i * NU_ + foot_col(foot, a)] * k[a * NF_ + bcol];
      }
      p[it] = v;
    }
    __syncthreads();
    // Y'_t and the dual-Riccati chain: Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S, inverted in place.
    y_chain_from_p(sm, L, delta, piv);
  }

  template <typename S>
  static __device__ void solve(S* sm, const Layout& L, const S* r1, const S* rz, const S* r4,
                               S* dx, S* dz, S* dy) {
    riccati_solve<RicAug>(sm, L, r1, rz, r4, dx, dz, dy);
  }
};

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
  refine_residual(sm, L, refine_df != 0, beta, delta, sm + L.dxa, sm + L.dza, sm + L.dya);
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

// Solve `batch` QPs on `stream`. All arrays are batch-first and contiguous:
// hd, f, x0, x (B, 24T); ad, bd (B, 12, 12); b, y0, y (B, 14T); gu (B, 16, 12);
// d, s0, z0, s, z (B, 16T); res (B, 4). x0, s0, z0, y0 are the warm start, or
// all null for the cold start; the outputs may be the same buffers. go (one
// int) gates the launch when non-null: 0 leaves every output untouched. ran
// (one int), when non-null, gets one added per launch that ran. refine_df
// selects the compensated refinement residual, kkt_jacobi the Jacobi
// equilibration of the stage inverses. Returns a cudaError_t (0 = success).
int pdipm_ric_aug_f32(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      int iterations, int refine_steps, int refine_df, int kkt_jacobi,
                      double beta, double delta, void* stream) {
  return launch<RicAug, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran,
                               batch, T, iterations, refine_steps, refine_df, kkt_jacobi, beta,
                               delta, stream);
}

int pdipm_ric_aug_f64(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      int iterations, int refine_steps, int refine_df, int kkt_jacobi,
                      double beta, double delta, void* stream) {
  return launch<RicAug, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran,
                                batch, T, iterations, refine_steps, refine_df, kkt_jacobi, beta,
                                delta, stream);
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

const char* pdipm_ric_aug_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
