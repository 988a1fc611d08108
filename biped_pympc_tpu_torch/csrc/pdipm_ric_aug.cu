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
// inverse's pivot entry as 1/pivot directly. Build without --use_fast_math:
// division and sqrt stay IEEE.

#include "pdipm_common.cuh"

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
  // sweep scratch
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
  L.colk = take(o, 2 * T * NB_); L.prow = take(o, 2 * T * NB_); L.q1 = take(o, 144);
  L.r1 = take(o, L.nz); L.rz = take(o, L.ni); L.r4 = take(o, L.ne); L.r2 = take(o, L.ni);
  L.e1 = take(o, L.nz); L.ez = take(o, L.ni); L.e4 = take(o, L.ne);
  L.ex = take(o, L.nz); L.ezz = take(o, L.ni); L.ey = take(o, L.ne);
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.run = take(o, T * 30); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
  L.wy = take(o, T * NX_); L.v12 = take(o, NX_); L.red = take(o, PDIPM_THREADS);
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv + sizeof(int) * 2 * T * NB_;
  return L;
}

// ---------------------------------------------------------------------------
// Stage block inverse apply: row o (< 30) of K_t^-1 r, r = [u(12), z(16), nu(2)].
// K_t^-1 is the two foot-block inverses, the [M_x, nu] 2x2 pairs and the
// M_z scalars.
// ---------------------------------------------------------------------------
template <typename S>
__device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o, const S* r) {
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
  const S* k = sm + L.ka + (foot * L.T + t) * 144 + a * NB_;
  const int zoff = 12 + 8 * foot;
  S acc = S(0);
  for (int bb = 0; bb < 4; ++bb) acc += k[bb] * r[foot_col(foot, bb)];
  for (int bb = 0; bb < 8; ++bb) acc += k[4 + bb] * r[zoff + bb];
  return acc;
}

// ---------------------------------------------------------------------------
// Factorization of the reduced KKT at the current W.
// ---------------------------------------------------------------------------
template <typename S>
__device__ void factor(S* sm, const Layout& L, int* piv, S beta, S delta) {
  const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
  const S* hd = sm + L.hd;
  const S* gu = sm + L.gu;
  const S* w = sm + L.w;
  const S* bd = sm + L.bd;
  const S* qinv = sm + L.qinv;
  const S* sc = sm + L.sc;
  const S* cf = sm + L.cf;
  S* ka = sm + L.ka;
  S* m = sm + L.m;
  S* p = sm + L.p;

  // Foot blocks [[diag(r + beta), G_f^T], [G_f, -diag(W_f)]], block index foot*T + t.
  for (int it = tid; it < 2 * T * 144; it += nt) {
    const int blk = it / 144, foot = blk / T, t = blk % T;
    const int r = (it % 144) / NB_, c = it % NB_;
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
  gj_inverse_inplace(ka, 2 * T, true, sm + L.colk, sm + L.prow, piv);

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
      for (int a = 0; a < 4; ++a) v += bd[i * NU_ + foot_col(foot, a)] * k[a * NB_ + bcol];
    }
    p[it] = v;
  }
  __syncthreads();
  // Y'_t = -delta I - Q~^-1 - Bd K_uu^-1 Bd^T - [t >= 1] Ad Q~^-1 Ad^T
  for (int it = tid; it < T * 144; it += nt) {
    const int t = it / 144, i = (it % 144) / NX_, l = it % NX_;
    const S* pt = p + t * 144 + i * NX_;
    S bkb = S(0);
    for (int j = 0; j < NU_; ++j) bkb += pt[j] * bd[l * NU_ + j];
    S v = i == l ? -delta - qinv[i] : S(0);
    v -= bkb;
    if (t >= 1) v -= sm[L.adqad + i * NX_ + l];
    m[it] = v;
  }
  __syncthreads();
  // Dual-Riccati chain: Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S, inverted in place.
  dual_riccati_chain(m, sc, T, sm + L.q1, sm + L.colk, sm + L.prow, piv);
}

// ---------------------------------------------------------------------------
// One augmented reduced solve: (r1, rz, r4) -> (dx, dz, dy).
// ---------------------------------------------------------------------------
template <typename S>
__device__ void solve_aug(S* sm, const Layout& L, const S* r1, const S* rz, const S* r4,
                          S* dx, S* dz, S* dy) {
  const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
  const S* ad = sm + L.ad;
  const S* bd = sm + L.bd;
  const S* qinv = sm + L.qinv;
  const S* sc = sm + L.sc;
  const S* m = sm + L.m;
  S* run = sm + L.run;
  S* kr = sm + L.kr;
  S* g = sm + L.g;
  S* wy = sm + L.wy;
  S* v12 = sm + L.v12;

  // Stage rhs [u, z, nu] and the x-eliminated y rows
  // ry_t = g_t - Q~^-1 c_t + [t >= 1] Ad Q~^-1 c_{t-1}.
  for (int it = tid; it < T * 30 + T * NX_; it += nt) {
    if (it < T * 30) {
      const int t = it / 30, r = it % 30;
      run[it] = r < NU_ ? r1[NX_ * T + NU_ * t + r]
              : r < 28 ? rz[NI_ * t + r - NU_]
              : r4[NX_ * T + NMX_ * t + r - 28];
    } else {
      const int k = it - T * 30, t = k / NX_, i = k % NX_;
      S v = r4[k] - qinv[i] * r1[k];
      if (t >= 1) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * (qinv[l] * r1[(t - 1) * NX_ + l]);
        v += acc;
      }
      g[k] = v;
    }
  }
  __syncthreads();
  // u rows of K^-1 r_un
  for (int it = tid; it < T * NU_; it += nt) {
    const int t = it / NU_, o = it % NU_;
    kr[it] = kinv_row(sm, L, t, o, run + t * 30);
  }
  __syncthreads();
  // r'_y = ry + Bd (K^-1 r_un)_u
  for (int it = tid; it < T * NX_; it += nt) {
    const int t = it / NX_, i = it % NX_;
    S acc = S(0);
    for (int j = 0; j < NU_; ++j) acc += bd[i * NU_ + j] * kr[t * NU_ + j];
    g[it] += acc;
  }
  __syncthreads();
  y_sweeps(m, sc, T, g, wy, v12);
  // u rhs += Bd^T y_t
  for (int it = tid; it < T * NU_; it += nt) {
    const int t = it / NU_, r = it % NU_;
    S acc = S(0);
    for (int l = 0; l < NX_; ++l) acc += wy[t * NX_ + l] * bd[l * NU_ + r];
    run[t * 30 + r] += acc;
  }
  __syncthreads();
  // [u, z, nu] = K^-1 rhs; x_{t+1} = Q~^-1 (c_t - y_t + Ad^T y_{t+1}); y.
  for (int it = tid; it < T * 30 + T * NX_; it += nt) {
    if (it < T * 30) {
      const int t = it / 30, o = it % 30;
      const S v = kinv_row(sm, L, t, o, run + t * 30);
      if (o < NU_) dx[NX_ * T + NU_ * t + o] = v;
      else if (o < 28) dz[NI_ * t + o - NU_] = v;
      else dy[NX_ * T + NMX_ * t + o - 28] = v;
    } else {
      const int k = it - T * 30, t = k / NX_, i = k % NX_;
      S v = qinv[i] * (r1[k] - wy[k]);
      if (t + 1 < T) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += wy[(t + 1) * NX_ + l] * ad[l * NX_ + i];
        v += qinv[i] * acc;
      }
      dx[k] = v;
      dy[k] = wy[k];
    }
  }
  __syncthreads();
}

// Reduced solve with refinement: from (r1, r2, r3, r4) in (r1, r2, -, r4)
// buffers with rz = r3 - r2 / sigma already formed, to directions (dx, ds, dz, dy).
template <typename S>
__device__ void reduced_solve(S* sm, const Layout& L, int refine_steps, bool refine_df, S beta,
                              S delta, S* dx, S* ds, S* dz, S* dy) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const S* r1 = sm + L.r1;
  const S* rz = sm + L.rz;
  const S* r4 = sm + L.r4;
  const S* r2 = sm + L.r2;
  const S* sig = sm + L.sig;
  S* ex = sm + L.ex;
  S* ezz = sm + L.ezz;
  S* ey = sm + L.ey;
  const int nz = L.nz, ni = L.ni, ne = L.ne;

  solve_aug(sm, L, r1, rz, r4, dx, dz, dy);
  for (int rs = 0; rs < refine_steps; ++rs) {
    refine_residual(sm, L, refine_df, beta, delta, dx, dz, dy);
    solve_aug(sm, L, sm + L.e1, sm + L.ez, sm + L.e4, ex, ezz, ey);
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) dx[it] += ex[it];
      else if (it < nz + ni) dz[it - nz] += ezz[it - nz];
      else dy[it - nz - ni] += ey[it - nz - ni];
    }
    __syncthreads();
  }
  for (int k = tid; k < ni; k += nt) ds[k] = (r2[k] - dz[k]) / sig[k];
  __syncthreads();
}

// The outputs may alias the warm state x0, s0, z0, y0 (load_env), so none of
// those pointers is __restrict__.
template <typename S>
__global__ void __launch_bounds__(PDIPM_THREADS) __maxnreg__(MaxRegs<S>::value)
pdipm_ric_aug_kernel(
    const S* __restrict__ hd_in, const S* __restrict__ f_in, const S* __restrict__ ad_in,
    const S* __restrict__ bd_in, const S* __restrict__ b_in, const S* __restrict__ gu_in,
    const S* __restrict__ d_in, const S* x0, const S* s0, const S* z0, const S* y0,
    S* x_out, S* s_out, S* z_out, S* y_out, S* res_out, const int* go, int* ran,
    int T, int iterations, int refine_steps, int refine_df, S beta, S delta) {
  if (!gate_open(go, ran)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const Layout L = make_layout(T, (int)sizeof(S));
  int* piv = reinterpret_cast<int*>(smem_raw + L.piv);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long env = blockIdx.x;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  S* red = sm + L.red;

  load_env(sm, L, env, hd_in, f_in, ad_in, bd_in, b_in, gu_in, d_in, x0, s0, z0, y0);
  // Constants: q_inv = 1 / (Q + beta), S = Q~^-1 Ad^T, Ad Q~^-1 Ad^T, and the
  // [M_x, nu] = [[r + beta, 1], [1, -delta]]^-1 and M_z = 1 / (r + beta) entries.
  for (int i = tid; i < NX_; i += nt) sm[L.qinv + i] = S(1) / (sm[L.hd + i] + beta);
  if (tid == 0) {
    S* cf = sm + L.cf;
    const S* rr = sm + L.hd + NX_ * T;
    for (int q = 0; q < 2; ++q) {
      const S rj = rr[q == 0 ? 6 : 9] + beta;
      const S det = -rj * delta - S(1);
      cf[3 * q + 0] = -delta / det;
      cf[3 * q + 1] = -S(1) / det;
      cf[3 * q + 2] = rj / det;
    }
    cf[6] = S(1) / (rr[8] + beta);
    cf[7] = S(1) / (rr[11] + beta);
  }
  __syncthreads();
  for (int it = tid; it < 288; it += nt) {
    const int k = it % 144, i = k / NX_, j = k % NX_;
    const S* ad = sm + L.ad;
    const S* qinv = sm + L.qinv;
    if (it < 144) {
      sm[L.sc + k] = qinv[i] * ad[j * NX_ + i];
    } else {
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * qinv[l] * ad[j * NX_ + l];
      sm[L.adqad + k] = acc;
    }
  }
  __syncthreads();

  S* x = sm + L.x;
  S* s = sm + L.s;
  S* z = sm + L.z;
  S* y = sm + L.y;
  S* rx = sm + L.rx;
  S* rsb = sm + L.rs;
  S* re = sm + L.re;
  S* sig = sm + L.sig;
  S* w = sm + L.w;
  S* r1 = sm + L.r1;
  S* rz = sm + L.rz;
  S* r4 = sm + L.r4;
  S* r2 = sm + L.r2;
  S* dxa = sm + L.dxa; S* dsa = sm + L.dsa; S* dza = sm + L.dza; S* dya = sm + L.dya;
  S* dxc = sm + L.dxc; S* dsc = sm + L.dsc; S* dzc = sm + L.dzc; S* dyc = sm + L.dyc;
  const S nif = S(ni);
  const bool df = refine_df != 0;

  for (int iter = 0; iter < iterations; ++iter) {
    // KKT residuals at the current iterate, Sigma and W.
    S part = S(0);
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        const int i = it;
        rx[i] = sm[L.hd + i] * x[i] + sm[L.f + i] + gT_entry(sm, L, i, z) + aT_entry(sm, L, i, y);
      } else if (it < nz + ni) {
        const int k = it - nz;
        rsb[k] = g_entry(sm, L, k, x) + s[k] - sm[L.d + k];
        const S sg = z[k] / s[k] + delta;
        sig[k] = sg;
        w[k] = S(1) / sg + delta;
        part += s[k] * z[k];
      } else {
        const int e = it - nz - ni;
        re[e] = a_entry(sm, L, e, x) - sm[L.b + e];
      }
    }
    const S mu = block_sum(part, red) / nif;  // syncs

    factor(sm, L, piv, beta, delta);

    // Affine direction: rhs (-rx, -(s z)/s, -rs, -re).
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        r1[it] = -rx[it];
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S v2 = -(s[k] * z[k]) / s[k];
        r2[k] = v2;
        rz[k] = -rsb[k] - v2 / sig[k];
      } else {
        r4[it - nz - ni] = -re[it - nz - ni];
      }
    }
    __syncthreads();
    reduced_solve(sm, L, refine_steps, df, beta, delta, dxa, dsa, dza, dya);
    const S ap = frac_to_boundary(s, dsa, ni, red);
    const S adl = frac_to_boundary(z, dza, ni, red);
    part = S(0);
    for (int k = tid; k < ni; k += nt) part += (s[k] + ap * dsa[k]) * (z[k] + adl * dza[k]);
    const S mu_aff = block_sum(part, red) / nif;
    const S ratio = mu_aff / mu;
    const S sigma = ratio * ratio * ratio;

    // Corrector: rhs (0, -rc/s, 0, 0), rc = s z + ds_a dz_a - sigma mu.
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        r1[it] = S(0);
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S rc = s[k] * z[k] + dsa[k] * dza[k] - sigma * mu;
        const S v2 = -rc / s[k];
        r2[k] = v2;
        rz[k] = S(0) - v2 / sig[k];
      } else {
        r4[it - nz - ni] = S(0);
      }
    }
    __syncthreads();
    reduced_solve(sm, L, refine_steps, df, beta, delta, dxc, dsc, dzc, dyc);
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        dxa[it] += dxc[it];
      } else if (it < nz + ni) {
        const int k = it - nz;
        dsa[k] += dsc[k];
        dza[k] += dzc[k];
      } else {
        dya[it - nz - ni] += dyc[it - nz - ni];
      }
    }
    __syncthreads();
    const S alp = frac_to_boundary(s, dsa, ni, red);
    const S ald = frac_to_boundary(z, dza, ni, red);
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        x[it] += alp * dxa[it];
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S sn = s[k] + alp * dsa[k];
        const S zn = z[k] + ald * dza[k];
        s[k] = sn > S(1e-8) || sn != sn ? sn : S(1e-8);
        z[k] = zn > S(1e-8) || zn != zn ? zn : S(1e-8);
      } else {
        y[it - nz - ni] += ald * dya[it - nz - ni];
      }
    }
    __syncthreads();
  }

  // Residual norms of the last step's start, and mu after it.
  S p0 = S(0), p1 = S(0), p2 = S(0), p3 = S(0);
  if (iterations > 0) {
    for (int i = tid; i < nz; i += nt) p0 += rx[i] * rx[i];
    for (int k = tid; k < ni; k += nt) {
      p1 += rsb[k] * rsb[k];
      p3 += s[k] * z[k];
    }
    for (int e = tid; e < ne; e += nt) p2 += re[e] * re[e];
  }
  p0 = block_sum(p0, red);
  p1 = block_sum(p1, red);
  p2 = block_sum(p2, red);
  p3 = block_sum(p3, red);
  for (int i = tid; i < nz; i += nt) x_out[env * nz + i] = x[i];
  for (int k = tid; k < ni; k += nt) {
    s_out[env * ni + k] = s[k];
    z_out[env * ni + k] = z[k];
  }
  for (int e = tid; e < ne; e += nt) y_out[env * ne + e] = y[e];
  if (tid == 0) {
    res_out[env * 4 + 0] = sqrt(p0);
    res_out[env * 4 + 1] = sqrt(p1);
    res_out[env * 4 + 2] = sqrt(p2);
    res_out[env * 4 + 3] = p3 / nif;
  }
}

template <typename S>
static int launch(const void* hd, const void* f, const void* ad, const void* bd, const void* b,
                  const void* gu, const void* d, const void* x0, const void* s0, const void* z0,
                  const void* y0, void* x, void* s, void* z, void* y, void* res, const void* go,
                  void* ran, int batch, int T, int iterations, int refine_steps, int refine_df,
                  double beta, double delta, void* stream) {
  const Layout L = make_layout(T, (int)sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(pdipm_ric_aug_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  pdipm_ric_aug_kernel<S><<<batch, PDIPM_THREADS, L.bytes, (cudaStream_t)stream>>>(
      (const S*)hd, (const S*)f, (const S*)ad, (const S*)bd, (const S*)b, (const S*)gu,
      (const S*)d, (const S*)x0, (const S*)s0, (const S*)z0, (const S*)y0, (S*)x, (S*)s, (S*)z,
      (S*)y, (S*)res, (const int*)go, (int*)ran, T, iterations, refine_steps, refine_df,
      (S)beta, (S)delta);
  return (int)cudaGetLastError();
}

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
  const Layout L = make_layout(T, (int)sizeof(S));
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
  const Layout L = make_layout(T, (int)sizeof(S));
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
  return make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`. All arrays are batch-first and contiguous:
// hd, f, x0, x (B, 24T); ad, bd (B, 12, 12); b, y0, y (B, 14T); gu (B, 16, 12);
// d, s0, z0, s, z (B, 16T); res (B, 4). x0, s0, z0, y0 are the warm start, or
// all null for the cold start; the outputs may be the same buffers. go (one
// int) gates the launch when non-null: 0 leaves every output untouched. ran
// (one int), when non-null, gets one added per launch that ran. refine_df
// selects the compensated refinement residual. Returns a cudaError_t
// (0 = success).
int pdipm_ric_aug_f32(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      int iterations, int refine_steps, int refine_df, double beta, double delta,
                      void* stream) {
  return launch<float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran, batch,
                       T, iterations, refine_steps, refine_df, beta, delta, stream);
}

int pdipm_ric_aug_f64(const void* hd, const void* f, const void* ad, const void* bd,
                      const void* b, const void* gu, const void* d, const void* x0,
                      const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                      void* y, void* res, const void* go, void* ran, int batch, int T,
                      int iterations, int refine_steps, int refine_df, double beta, double delta,
                      void* stream) {
  return launch<double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran, batch,
                        T, iterations, refine_steps, refine_df, beta, delta, stream);
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
