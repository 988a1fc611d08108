// The Riccati routes' shared pieces: the solve's constants, the one reduced
// solve through the stage inverses and the 12-wide dual-Riccati y-chain, the
// y-chain's factor from P_t = Bd (K_t^-1)_uu, the layout and policy of the
// unsplit routes (K5d), K5d-a's warp group, and the one-warp groups of the
// condensed dense-stage routes (K5c, K5d-c). Included by pdipm_ric_aug.cu (K1),
// pdipm_ric.cu (K2), pdipm_ric2.cu (K5c), pdipm_ric_dense.cu (K5d-c) and
// pdipm_ric_aug_dense.cu (K5d-a).
//
// Per stage the [u (12), nu (2)] block (condensed; z eliminated with
// W^-1 = Sigma / (1 + delta Sigma)) or the [u (12), z (16), nu (2)] block
// (augmented; W = Sigma^-1 + delta) couples to the dual y_t only through
// Bd. Each route inverts (or factors) the T stage blocks, all independent;
// folding them in leaves the y-chain Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S
// with S = Q~^-1 Ad^T and Y'_t = -delta I - Q~^-1 - Bd (K_t^-1)_uu Bd^T
// - [t >= 1] Ad Q~^-1 Ad^T (`pdipm_pallas.py:542-570`). A route supplies
// `kinv_row(sm, L, t, o, r)`, row o of K_t^-1 r.

#pragma once

#include "pdipm_common.cuh"

static constexpr int NUN_ = NU_ + NMX_;        // 14: [u, nu] per stage
static constexpr int NKA_ = NU_ + NI_ + NMX_;  // 30: [u, z, nu] per stage

// Entry (i, j) of Ad Q~^-1 Ad^T, and of the W-independent
// yc = -delta I - Q~^-1 - sum_j c_j Bd_j Bd_j^T over the columns 6, 8, 9, 11.
template <typename S, typename Layout>
__device__ __forceinline__ S adqad_entry(const S* sm, const Layout& L, int i, int j) {
  const S* ad = sm + L.ad;
  const S* qinv = sm + L.qinv;
  S acc = S(0);
  for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * qinv[l] * ad[j * NX_ + l];
  return acc;
}

template <typename S, typename Layout>
__device__ __forceinline__ S yc_entry(const S* sm, const Layout& L, int i, int j, S delta) {
  const S* bd = sm + L.bd;
  const S* cf = sm + L.cf;
  const S couter = cf[0] * bd[i * NU_ + 6] * bd[j * NU_ + 6]
                 + cf[6] * bd[i * NU_ + 8] * bd[j * NU_ + 8]
                 + cf[3] * bd[i * NU_ + 9] * bd[j * NU_ + 9]
                 + cf[7] * bd[i * NU_ + 11] * bd[j * NU_ + 11];
  return (i == j ? -delta - sm[L.qinv + i] : S(0)) - couter;
}

// q_inv = 1 / (Q + beta), S = Q~^-1 Ad^T and Ad Q~^-1 Ad^T; with PAIRS
// (foot split) also the [M_x, nu] = [[r + beta, 1], [1, -delta]]^-1 and
// M_z = 1 / (r + beta) coefficients cf, and with YC (K2) yc (`yc_entry`).
template <bool PAIRS, bool YC, typename S, typename Layout, typename G>
__device__ void riccati_setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
  const int tid = g.rank(), nt = g.size(), T = L.T;
  for (int i = tid; i < NX_; i += nt) sm[L.qinv + i] = S(1) / (sm[L.hd + i] + beta);
  if constexpr (PAIRS) {
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
  }
  g.sync();
  for (int it = tid; it < (YC ? 3 : 2) * 144; it += nt) {
    const int k = it % 144, i = k / NX_, j = k % NX_;
    if (it < 144) {
      sm[L.sc + k] = sm[L.qinv + i] * sm[L.ad + j * NX_ + i];
    } else if (it < 288) {
      sm[L.adqad + k] = adqad_entry(sm, L, i, j);
    } else if constexpr (YC) {
      sm[L.yc + k] = yc_entry(sm, L, i, j, delta);
    }
  }
  g.sync();
}

// Y'_t from P_t = Bd (K_t^-1)_uu at L.p (T x 144), then the dual-Riccati
// chain in the no-pivot form of `gj_inplace`: L.m holds Yhat_t^-1 on exit.
template <typename S, typename Layout, typename G>
__device__ void y_chain_from_p(const G& g, S* sm, const Layout& L, S delta, bool gj_inplace,
                               int* piv) {
  const int tid = g.rank(), nt = g.size(), T = L.T;
  const S* bd = sm + L.bd;
  const S* qinv = sm + L.qinv;
  const S* p = sm + L.p;
  S* m = sm + L.yp;  // the block layouts' yp is their m
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
  g.sync();
  PDIPM_MARK(g, PH_PT);
  if constexpr (G::WARP) {
    dual_riccati_chain_regs(g, m, sm + L.m, sm + L.sc, T, gj_inplace, sm + L.q1);
  } else {
    dual_riccati_chain(g, m, sm + L.sc, T, gj_inplace, sm + L.q1, sm + L.colk, sm + L.prow, piv);
  }
  PDIPM_MARK(g, PH_YCHAIN);
}

// P_t = Bd kuu_t for a dense (K_t^-1)_uu, entry (j, c) of stage t at
// kuu[t * stage_stride + j * row_stride + c]; then `y_chain_from_p`.
template <typename S, typename Layout, typename G>
__device__ void y_chain_from_kuu(const G& g, S* sm, const Layout& L, const S* kuu,
                                 int stage_stride, int row_stride, S delta, bool gj_inplace,
                                 int* piv) {
  const int tid = g.rank(), nt = g.size(), T = L.T;
  const S* bd = sm + L.bd;
  S* p = sm + L.p;
  for (int it = tid; it < T * 144; it += nt) {
    const int t = it / 144, i = (it % 144) / NX_, c = it % NX_;
    const S* k = kuu + t * stage_stride + c;
    S v = S(0);
    for (int j = 0; j < NU_; ++j) v += bd[i * NU_ + j] * k[j * row_stride];
    p[it] = v;
  }
  g.sync();
  y_chain_from_p(g, sm, L, delta, gj_inplace, piv);
}

// ---------------------------------------------------------------------------
// One reduced solve of route P through its stage inverses (P::kinv_row) and
// the y-chain: (r1, r4) -> (dx, dy) condensed, (r1, rz, r4) -> (dx, dz, dy)
// augmented (`ric_solve:929`, `ric_solve_aug:1061`). A policy with
// STAGE_PREP (K5c's warp group) forms what every row of a stage shares,
// `P::prep(g, sm, L, run, NR)`, before each pass of kinv_row over the stage
// rhs `run`; every other policy has no such member.
// ---------------------------------------------------------------------------
template <typename P, typename = void>
struct StagePrep {
  static constexpr bool value = false;
};
template <typename P>
struct StagePrep<P, std::void_t<decltype(P::STAGE_PREP)>> {
  static constexpr bool value = P::STAGE_PREP;
};

template <typename P, typename S, typename Layout, typename G>
__device__ void riccati_solve(const G& grp, S* sm, const Layout& L, const S* r1, const S* rz,
                              const S* r4, S* dx, S* dz, S* dy) {
  constexpr int NZS = P::AUG ? NI_ : 0;  // z rows of the stage rhs
  constexpr int NR = NU_ + NZS + NMX_;   // stage rhs width: 30 or 14
  const int tid = grp.rank(), nt = grp.size(), T = L.T;
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

  // Stage rhs [u, (z,) nu] and the x-eliminated y rows
  // ry_t = g_t - Q~^-1 c_t + [t >= 1] Ad Q~^-1 c_{t-1}.
  for (int it = tid; it < T * NR + T * NX_; it += nt) {
    if (it < T * NR) {
      const int t = it / NR, r = it % NR;
      run[it] = r < NU_ ? r1[NX_ * T + NU_ * t + r]
              : r < NU_ + NZS ? rz[NI_ * t + r - NU_]
              : r4[NX_ * T + NMX_ * t + r - NU_ - NZS];
    } else {
      const int k = it - T * NR, t = k / NX_, i = k % NX_;
      S v = r4[k] - qinv[i] * r1[k];
      if (t >= 1) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * (qinv[l] * r1[(t - 1) * NX_ + l]);
        v += acc;
      }
      g[k] = v;
    }
  }
  grp.sync();
  if constexpr (StagePrep<P>::value) P::prep(grp, sm, L, run, NR);
  // u rows of K^-1 r_un
  for (int it = tid; it < T * NU_; it += nt) {
    const int t = it / NU_, o = it % NU_;
    kr[it] = P::kinv_row(sm, L, t, o, run + t * NR);
  }
  grp.sync();
  // r'_y = ry + Bd (K^-1 r_un)_u
  for (int it = tid; it < T * NX_; it += nt) {
    const int t = it / NX_, i = it % NX_;
    S acc = S(0);
    for (int j = 0; j < NU_; ++j) acc += bd[i * NU_ + j] * kr[t * NU_ + j];
    g[it] += acc;
  }
  grp.sync();
  PDIPM_MARK(grp, PH_STAGE);
  if constexpr (G::WARP) {
    y_sweeps_regs(grp, m, sc, T, g, wy);
  } else {
    y_sweeps(grp, m, sc, T, g, wy, v12);
  }
  PDIPM_MARK(grp, PH_SWEEP);
  // u rhs += Bd^T y_t
  for (int it = tid; it < T * NU_; it += nt) {
    const int t = it / NU_, r = it % NU_;
    S acc = S(0);
    for (int l = 0; l < NX_; ++l) acc += wy[t * NX_ + l] * bd[l * NU_ + r];
    run[t * NR + r] += acc;
  }
  grp.sync();
  if constexpr (StagePrep<P>::value) P::prep(grp, sm, L, run, NR);
  // [u, (z,) nu] = K^-1 rhs; x_{t+1} = Q~^-1 (c_t - y_t + Ad^T y_{t+1}); y.
  for (int it = tid; it < T * NR + T * NX_; it += nt) {
    if (it < T * NR) {
      const int t = it / NR, o = it % NR;
      const S v = P::kinv_row(sm, L, t, o, run + t * NR);
      if (o < NU_) dx[NX_ * T + NU_ * t + o] = v;
      else if (o < NU_ + NZS) dz[NI_ * t + o - NU_] = v;
      else dy[NX_ * T + NMX_ * t + o - NU_ - NZS] = v;
    } else {
      const int k = it - T * NR, t = k / NX_, i = k % NX_;
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
  grp.sync();
  PDIPM_MARK(grp, PH_STAGE);
}

// ---------------------------------------------------------------------------
// Shared-memory layout of the routes that keep dense stage inverses: K5c
// (`ric2`, the T 12-wide Ru^-1 with kuu and the 2x2 S^-1 per stage) and K5d
// (T dense n-wide K_t^-1, n = 14 or 30). Buffers a route does not use have
// length 0.
// ---------------------------------------------------------------------------
struct RicLayout {
  int T, nz, ni, ne;
  // inputs
  int hd, f, ad, bd, b, gu, d;
  // iterates, residuals, Sigma and W (augmented) or W^-1 (condensed)
  int x, s, z, y, rx, rs, re, sig, w;
  // constants of the solve: q_inv, S = Q~^-1 Ad^T, Ad Q~^-1 Ad^T
  int qinv, sc, adqad;
  // factors: T stage inverses, ric2's kuu and S^-1, T y-chain inverses
  // (yp: where Y'_t is formed, here m itself), P_t = Bd (K_t^-1)_uu,
  // elimination scratch
  int ka, kuu, sn, m, yp, p, colk, prow, q1;
  // reduced-solve rhs (rz augmented; r3, tmp, r1h condensed), refinement,
  // directions
  int r1, r2, r3, r4, rz, tmp, r1h, e1, ez, e4, ex, ezz, ey;
  int dxa, dsa, dza, dya, dxc, dsc, dzc, dyc;
  // sweep scratch; `run` (T stage rhs) also holds Jacobi's D during the factor
  int run, kr, g, wy, v12, red;
  int total;      // values of S
  int piv;        // byte offset of the int pivot table
  size_t bytes;   // total bytes
};

// n: stage-block width; aug: z kept (augmented); ric2: kuu and S^-1 stored;
// pivot: the stage inverses may pivot (their int table).
static __host__ __device__ RicLayout make_ric_layout(int T, int size_of_s, int n, bool aug,
                                                     bool ric2, bool pivot) {
  RicLayout L;
  L.T = T;
  L.nz = 24 * T;
  L.ni = 16 * T;
  L.ne = 14 * T;
  const int nia = aug ? L.ni : 0, nic = aug ? 0 : L.ni;
  int o = 0;
  L.hd = take(o, L.nz); L.f = take(o, L.nz); L.ad = take(o, 144); L.bd = take(o, 144);
  L.b = take(o, L.ne); L.gu = take(o, NI_ * NU_); L.d = take(o, L.ni);
  L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
  L.rx = take(o, L.nz); L.rs = take(o, L.ni); L.re = take(o, L.ne);
  L.sig = take(o, L.ni); L.w = take(o, L.ni);
  L.qinv = take(o, NX_); L.sc = take(o, 144); L.adqad = take(o, 144);
  L.ka = take(o, T * n * n); L.kuu = take(o, ric2 ? T * 144 : 0); L.sn = take(o, ric2 ? T * 4 : 0);
  L.m = take(o, T * 144); L.p = take(o, T * 144);
  L.yp = L.m;
  L.colk = take(o, T * n); L.prow = take(o, T * n); L.q1 = take(o, 144);
  L.r1 = take(o, L.nz); L.r2 = take(o, L.ni); L.r3 = take(o, nic); L.r4 = take(o, L.ne);
  L.rz = take(o, nia); L.tmp = take(o, nic); L.r1h = take(o, aug ? 0 : L.nz);
  L.e1 = take(o, L.nz); L.ez = take(o, nia); L.e4 = take(o, L.ne);
  L.ex = take(o, L.nz); L.ezz = take(o, nia); L.ey = take(o, L.ne);
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.run = take(o, T * (aug ? NKA_ : NUN_)); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
  L.wy = take(o, T * NX_); L.v12 = take(o, NX_); L.red = take(o, PDIPM_THREADS);
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv + (pivot ? sizeof(int) * T * n : 0);
  return L;
}

// ---------------------------------------------------------------------------
// K5d: the unsplit Riccati routes (`factor_ric:896`, `factor_ric_aug:1007`,
// foot_split=False). Stage t's dense block
//   condensed (n = 14): [[R + beta + G^T W_t^-1 G, e^T], [e, -delta I]],
//     symmetric quasi-definite: inverted without pivoting unless `k_pivot`
//     (`:916-921`);
//   augmented (n = 30): [[R + beta, G^T, e^T], [G, -W_t, 0], [e, 0, -delta I]],
//     inverted with partial pivoting unless `aug_pivot` is off (natural
//     order gives NaN on stress problems, `biped_pympc_tpu/ops/pdipm.py:150-155`),
// all T blocks eliminated together, equilibrated when `jacobi`; the
// no-pivot inverses in the form of `gj_inplace`.
// ---------------------------------------------------------------------------
template <bool AUG_>
struct RicDenseRoute {
  static constexpr bool AUG = AUG_;
  static constexpr int N = AUG ? NKA_ : NUN_;
  using Layout = RicLayout;

  static __host__ __device__ Layout make_layout(int T, int size_of_s) {
    return make_ric_layout(T, size_of_s, N, AUG, false, true);
  }

  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<false, false>(g, sm, L, beta, delta);
  }

  // Row o of K_t^-1 r, the stored inverse's row.
  template <typename S>
  static __device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o,
                                               const S* r) {
    const S* k = sm + L.ka + t * N * N + o * N;
    S acc = S(0);
    for (int j = 0; j < N; ++j) acc += k[j] * r[j];
    return acc;
  }

  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags ff) {
    const int tid = g.rank(), nt = g.size(), T = L.T;
    const S* hd = sm + L.hd;
    const S* gu = sm + L.gu;
    const S* w = sm + L.w;
    S* ka = sm + L.ka;
    for (int it = tid; it < T * N * N; it += nt) {
      const int t = it / (N * N), r = (it / N) % N, c = it % N;
      const S* wt = w + t * NI_;
      S v = S(0);
      if (r < NU_ && c < NU_) {
        if constexpr (AUG) {
          if (r == c) v = hd[NX_ * T + r] + beta;
        } else {
          S acc = S(0);
          for (int q = 0; q < NI_; ++q) acc += gu[q * NU_ + r] * gu[q * NU_ + c] * wt[q];
          v = r == c ? acc + (hd[NX_ * T + r] + beta) : acc;
        }
      } else if (r < NU_ && c >= N - NMX_) {  // e^T: u6 -> nu0, u9 -> nu1
        v = (r == 6 && c == N - 2) || (r == 9 && c == N - 1) ? S(1) : S(0);
      } else if (c < NU_ && r >= N - NMX_) {  // e
        v = (c == 6 && r == N - 2) || (c == 9 && r == N - 1) ? S(1) : S(0);
      } else if (r >= N - NMX_ && c >= N - NMX_) {  // nu block
        v = r == c ? -delta : S(0);
      } else if constexpr (AUG) {
        if (r < NU_ && c < NU_ + NI_) v = gu[(c - NU_) * NU_ + r];       // G^T
        else if (c < NU_ && r < NU_ + NI_) v = gu[(r - NU_) * NU_ + c];  // G
        else if (r == c) v = -wt[r - NU_];                               // -W_t
      }
      ka[it] = v;
    }
    g.sync();
    stage_inverse<N>(g, ka, T, AUG ? ff.aug_pivot : ff.k_pivot, ff.gj_inplace, ff.jacobi,
                     sm + L.colk, sm + L.prow, piv, sm + L.run);
    PDIPM_MARK(g, PH_FOOT);
    y_chain_from_kuu(g, sm, L, ka, N * N, N, delta, ff.gj_inplace, piv);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    riccati_solve<RicDenseRoute>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};

// The T stored stage inverses of a lean layout with a workspace (K5d-a's,
// K5c's and K5d-c's): the env's workspace slice `wk`, or ka in shared memory.
template <typename S, typename Layout>
__device__ __forceinline__ S* stage_inverses(S* sm, const Layout& L) {
  return L.wk != nullptr ? reinterpret_cast<S*>(L.wk) : sm + L.ka;
}

// ---------------------------------------------------------------------------
// K5d-a in its warp group (`RicAugDenseWarp`, four warps an env): the T stage
// blocks are independent, so warp w builds and inverts stages w, w + 4, ...
// in registers, a lane per row (30 of 32 lanes), with `gj_warp` (the pivot
// by a shuffle argmax, the pivot row through the warp's shared-memory row,
// no block barrier between blocks or steps), equilibrated around the
// inverse when `jacobi`, and stores each inverse with the row swaps undone,
// transposed (entry (r, c) at c 30 + r); the y-chain and the sweeps then
// run in registers in the first warp (pdipm_common.cuh). The lean layout
// leaves f, b and d in device memory, and the T inverses in shared memory
// or in the caller's workspace (`WORKSPACE`, pdipm_common.cuh).
// ---------------------------------------------------------------------------
struct RicDenseLeanLayout : RicLayout {
  int gjr;            // `gj_warp`'s pivot row, 32 values per warp
  size_t work_bytes;  // the T stored inverses' bytes when in the workspace
  unsigned char* wk;  // this env's workspace slice; null: inverses at ka
};

// f, b and d left in device memory; the T inverses at ka, or (work) in the
// workspace; the refinement solved in place (ex = e1, ezz = ez, ey = e4);
// and one union region, as K1's lean layout has, for what a Newton step
// needs only inside the factor (P_t and Y'_t; Yhat_t^-1 stays in m) and only
// after it (the rhs, refinement, directions and sweep buffers).
static __host__ __device__ RicDenseLeanLayout make_ric_aug_dense_lean_layout(int T, int size_of_s,
                                                                          int nwarps, bool work) {
  constexpr int n = NKA_;
  RicDenseLeanLayout L;
  L.T = T;
  L.nz = 24 * T;
  L.ni = 16 * T;
  L.ne = 14 * T;
  int o = 0;
  L.hd = take(o, L.nz); L.f = take(o, 0); L.ad = take(o, 144); L.bd = take(o, 144);
  L.b = take(o, 0); L.gu = take(o, NI_ * NU_); L.d = take(o, 0);
  L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
  L.rx = take(o, L.nz); L.rs = take(o, L.ni); L.re = take(o, L.ne);
  L.sig = take(o, L.ni); L.w = take(o, L.ni);
  L.qinv = take(o, NX_); L.sc = take(o, 144); L.adqad = take(o, 144);
  L.ka = take(o, work ? 0 : T * n * n); L.kuu = take(o, 0); L.sn = take(o, 0);
  L.m = take(o, T * 144); L.q1 = take(o, 144); L.red = take(o, 32);
  L.gjr = take(o, 32 * nwarps);
  L.colk = L.prow = take(o, 0);
  const int u = o;
  L.r1 = take(o, L.nz); L.r2 = take(o, L.ni); L.r3 = take(o, 0); L.r4 = take(o, L.ne);
  L.rz = take(o, L.ni); L.tmp = take(o, 0); L.r1h = take(o, 0);
  L.e1 = take(o, L.nz); L.ez = take(o, L.ni); L.e4 = take(o, L.ne);
  L.ex = L.e1; L.ezz = L.ez; L.ey = L.e4;  // the refinement solved in place, as K1's
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.run = take(o, T * NKA_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
  L.wy = take(o, T * NX_); L.v12 = take(o, NX_);
  int f = u;  // the factor's side of the union
  L.p = take(f, T * 144); L.yp = take(f, T * 144);
  o = o > f ? o : f;
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv + sizeof(int) * nwarps * n;
  L.work_bytes = work ? (size_t)T * n * n * size_of_s : 0;
  L.wk = nullptr;
  return L;
}

// Entry (r, c) of stage t's augmented block (RicDenseRoute<true>::factor's),
// hd_u = hd + 12 T, wt = W_t.
template <typename S>
__device__ __forceinline__ S ric_aug_entry(int r, int c, const S* hd_u, const S* gu, const S* wt,
                                           S beta, S delta) {
  constexpr int N = NKA_;
  S v = S(0);
  if (r < NU_ && c < NU_) {
    if (r == c) v = hd_u[r] + beta;
  } else if (r < NU_ && c >= N - NMX_) {  // e^T: u6 -> nu0, u9 -> nu1
    v = (r == 6 && c == N - 2) || (r == 9 && c == N - 1) ? S(1) : S(0);
  } else if (c < NU_ && r >= N - NMX_) {  // e
    v = (c == 6 && r == N - 2) || (c == 9 && r == N - 1) ? S(1) : S(0);
  } else if (r >= N - NMX_ && c >= N - NMX_) {  // nu block
    v = r == c ? -delta : S(0);
  } else if (r < NU_ && c < NU_ + NI_) {
    v = gu[(c - NU_) * NU_ + r];  // G^T
  } else if (c < NU_ && r < NU_ + NI_) {
    v = gu[(r - NU_) * NU_ + c];  // G
  } else if (r == c) {
    v = -wt[r - NU_];  // -W_t
  }
  return v;
}

struct RicAugDenseWarp {
  static constexpr bool AUG = true;
  static constexpr int N = NKA_;
  static constexpr int NW = 4;  // warps an env: a stage block per warp at a time
  // pdipm_common.cuh's LeanPolicy (f, b, d in device memory) and WorkPolicy
  static constexpr bool INPUTS_IN_GLOBAL = true, RESIDUALS_FORMED = false;
  static constexpr bool WORKSPACE = true;
  using Layout = RicDenseLeanLayout;

  static __host__ __device__ Layout make_layout(int T, int size_of_s, bool work = false) {
    return make_ric_aug_dense_lean_layout(T, size_of_s, NW, work);
  }

  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<false, false>(g, sm, L, beta, delta);
  }

  // Row o of K_t^-1 r through the transposed stored inverse.
  template <typename S>
  static __device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o,
                                               const S* r) {
    const S* k = stage_inverses(sm, L) + (size_t)t * N * N + o;
    S acc = S(0);
    for (int j = 0; j < N; ++j) acc += k[j * N] * r[j];
    return acc;
  }

  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags ff) {
    static_assert(G::THREADS == 32 * NW, "one warp per stage block");
    const int tid = g.rank(), nt = g.size(), T = L.T;
    const int warp = tid >> 5, lane = tid & 31;
    const S* hd_u = sm + L.hd + NX_ * T;
    const S* gu = sm + L.gu;
    const S* bd = sm + L.bd;
    S* kb = stage_inverses(sm, L);
    const bool pivot = ff.aug_pivot, jacobi = ff.jacobi;
    int* wpiv = piv + warp * N;
    const int rr = lane < N ? lane : N - 1;  // idle lanes read row N - 1
    for (int t = warp; t < T; t += NW) {
      const S* wt = sm + L.w + t * NI_;
      S a[1][N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const S v = ric_aug_entry(rr, c, hd_u, gu, wt, beta, delta);
        a[0][c] = lane < N ? v : S(0);
      }
      // Jacobi: K^-1 = D (D K D)^-1 D, D = 1 / sqrt(max(|diag K|, 1e-30)),
      // each entry scaled as (k_ij d_i) d_j (`jacobi_apply`).
      const S dl = jacobi ? jacobi_d(ric_aug_entry(rr, rr, hd_u, gu, wt, beta, delta)) : S(1);
      if (jacobi) {
#pragma unroll
        for (int c = 0; c < N; ++c) a[0][c] = a[0][c] * dl * __shfl_sync(0xffffffffu, dl, c);
      }
      int pos[1], q[1];
      gj_warp<N, 1>(a, pos, pivot, !pivot && ff.gj_inplace, wpiv, sm + L.gjr + 32 * warp);
      gj_warp_columns<N, 1>(q, pivot, wpiv);
      const int r = pos[0];
      const S dr = __shfl_sync(0xffffffffu, dl, r < N ? r : 0);
      S* kt = kb + (size_t)t * N * N;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = pivot ? __shfl_sync(0xffffffffu, q[0], j) : j;
        const S dc = __shfl_sync(0xffffffffu, dl, c);
        if (r < N) kt[c * N + r] = jacobi ? a[0][j] * dr * dc : a[0][j];
      }
      __syncwarp();  // wpiv before the warp's next block
    }
    g.sync();
    PDIPM_MARK(g, PH_FOOT);
    // P_t = Bd (K_t^-1)_uu from the transposed inverses, then Y'_t and the
    // y-chain (`y_chain_from_kuu`'s sums).
    S* p = sm + L.p;
    for (int it = tid; it < T * 144; it += nt) {
      const int t = it / 144, i = (it % 144) / NX_, c = it % NX_;
      const S* k = kb + (size_t)t * N * N + c * N;
      S v = S(0);
      for (int j = 0; j < NU_; ++j) v += bd[i * NU_ + j] * k[j];
      p[it] = v;
    }
    g.sync();
    y_chain_from_p(g, sm, L, delta, ff.gj_inplace, piv);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    riccati_solve<RicAugDenseWarp>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};

// ---------------------------------------------------------------------------
// K5c and K5d-c in their warp group (`RicCondWarp<true>` = `Ric2Warp`,
// `RicCondWarp<false>` = `RicDenseWarp`; `WarpGroup<1>`, one warp an env):
// the T stage blocks are independent, so the warp builds and eliminates two
// at a time in registers, lane 16 h + i holding row i of stage t0 + h
// (`gj_pair_regs`: no shared memory and no barrier in the N-step chain; an
// odd T leaves the second half idle on the last pair), equilibrated around
// the inverse when `jacobi`, K5d-c pivoted when `k_pivot`. Each stage's
// record goes to shared memory or to the caller's workspace (`WORKSPACE`,
// pdipm_common.cuh), transposed (entry (r, c) at c N + r) so that a warp's
// lanes read neighbouring values in the K^-1 applies: K5c's Ru^-1 with E
// Ru^-1 (its rows 6 and 9) and the closed-form 2x2 S^-1, K5d-c's 14 x 14
// K^-1. Then, still in registers, (K^-1)_uu (K5c: the rank-2 update of Ru^-1
// from rows 6 and 9, broadcast by shuffle), P_t = Bd (K^-1)_uu (the rows of
// (K^-1)_uu passed by shuffle) and Y'_t, row i in lane i, into the union;
// the y-chain and the sweeps run in registers (`dual_riccati_chain_regs`,
// `y_sweeps_regs`). Every sum runs in the block group's order. K5c forms
// S^-1 (r_nu - E Ru^-1 r_u) once a stage before each pass of kinv_row
// (`prep`), where the block group forms it again for each row. Two blocks a
// warp, not one (`gj_warp`): both fit 16 lanes, so each elimination step
// serves two stages, as one warp a stage pair did for K5e-a (PERF.md,
// Findings). No register cap (`REGS32`): shared memory admits 8 envs an SM
// in f32, and 8 one-warp blocks fit the register file at 255 a thread.
// ---------------------------------------------------------------------------
struct RicCondLeanLayout : RicLayout {
  int eta;            // K5c: the T stages' S^-1 (r_nu - E Ru^-1 r_u), 2 values each
  size_t work_bytes;  // the T stage records' bytes when in the workspace
  unsigned char* wk;  // this env's workspace slice; null: the records at ka
};

// The condensed lean layout of K5c and K5d-c, as K2's (`RicSplit<false,
// true>`): f, b and d left in device memory; the refinement solved in place
// (ex = e1, ey = e4); r1_hat in r1, r2 and r3 in dsc and dzc (each read entry
// by entry where the solve writes the entry that replaces it); the T stage
// records of `rec` values at ka, or (`work`) in the workspace; and one union
// region for what a Newton step needs only inside the factor (Y'_t, Ad Q~^-1
// Ad^T, formed anew each factor, and the chain's q1) and only after it (the
// rhs, refinement, directions and sweep buffers, K5c's `eta`).
static __host__ __device__ RicCondLeanLayout make_ric_cond_lean_layout(int T, int size_of_s,
                                                                     int rec, bool eta,
                                                                     bool work) {
  RicCondLeanLayout L;
  L.T = T;
  L.nz = 24 * T;
  L.ni = 16 * T;
  L.ne = 14 * T;
  int o = 0;
  L.hd = take(o, L.nz); L.f = take(o, 0); L.ad = take(o, 144); L.bd = take(o, 144);
  L.b = take(o, 0); L.gu = take(o, NI_ * NU_); L.d = take(o, 0);
  L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
  L.rx = take(o, L.nz); L.rs = take(o, L.ni); L.re = take(o, L.ne);
  L.sig = take(o, L.ni); L.w = take(o, L.ni);
  L.qinv = take(o, NX_); L.sc = take(o, 144);
  L.ka = take(o, work ? 0 : T * rec); L.kuu = L.sn = take(o, 0);
  L.m = take(o, T * 144); L.red = take(o, 4);
  L.colk = L.prow = L.p = L.rz = L.ez = L.ezz = take(o, 0);
  const int u = o;
  L.r1 = take(o, L.nz); L.r1h = L.r1; L.r4 = take(o, L.ne); L.tmp = take(o, L.ni);
  L.e1 = take(o, L.nz); L.e4 = take(o, L.ne); L.ex = L.e1; L.ey = L.e4;
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.r2 = L.dsc; L.r3 = L.dzc;
  L.run = take(o, T * NUN_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
  L.wy = take(o, T * NX_); L.v12 = take(o, 0); L.eta = take(o, eta ? 2 * T : 0);
  int f = u;  // the factor's side of the union
  L.yp = take(f, T * 144); L.q1 = take(f, 144); L.adqad = take(f, 144);
  o = o > f ? o : f;
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv;
  L.work_bytes = work ? (size_t)T * rec * size_of_s : 0;
  L.wk = nullptr;
  return L;
}

// Entry (r, c) < 12 of stage t's condensed u block R + beta + G^T W_t^-1 G,
// term for term the block group's (`Ric2::factor`, `RicDenseRoute::factor`);
// hd_u = hd + 12 T, wt = W_t^-1.
template <typename S>
__device__ __forceinline__ S ric_u_entry(int r, int c, const S* hd_u, const S* gu, const S* wt,
                                         S beta) {
  S acc = S(0);
  for (int q = 0; q < NI_; ++q) acc += gu[q * NU_ + r] * gu[q * NU_ + c] * wt[q];
  return r == c ? acc + (hd_u[r] + beta) : acc;
}

// Entry (r, c) of stage t's eliminated block: Ru (K5c, 12 wide) or the
// [u, nu] block [[Ru, e^T], [e, -delta I]] (K5d-c, 14 wide).
template <bool RIC2, typename S>
__device__ __forceinline__ S ric_cond_entry(int r, int c, const S* hd_u, const S* gu,
                                            const S* wt, S beta, S delta) {
  constexpr int N = NUN_;
  if (RIC2 || (r < NU_ && c < NU_)) return ric_u_entry(r, c, hd_u, gu, wt, beta);
  if (r < NU_) return (r == 6 && c == N - 2) || (r == 9 && c == N - 1) ? S(1) : S(0);  // e^T
  if (c < NU_) return (c == 6 && r == N - 2) || (c == 9 && r == N - 1) ? S(1) : S(0);  // e
  return r == c ? -delta : S(0);  // nu block
}

template <bool RIC2>
struct RicCondWarp {
  static constexpr bool AUG = false;
  static constexpr int N = RIC2 ? NU_ : NUN_;  // the eliminated block's width
  // A stage's record: K5c's Ru^-1, E Ru^-1 and S^-1; K5d-c's K^-1.
  static constexpr int EROW = N * N, SINV = EROW + 2 * NU_;
  static constexpr int REC = RIC2 ? SINV + 4 : N * N;
  // pdipm_common.cuh's LeanPolicy (f, b, d in device memory), WorkPolicy and
  // StagePrep above (K5c)
  static constexpr bool INPUTS_IN_GLOBAL = true, RESIDUALS_FORMED = false;
  static constexpr bool WORKSPACE = true;
  static constexpr bool STAGE_PREP = RIC2;
  using Layout = RicCondLeanLayout;

  static __host__ __device__ Layout make_layout(int T, int size_of_s, bool work = false) {
    return make_ric_cond_lean_layout(T, size_of_s, REC, RIC2, work);
  }

  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<false, false>(g, sm, L, beta, delta);
  }

  // K5c: eta_t = S^-1 (r_nu - E Ru^-1 r_u) of every stage (`_kinv2_apply`'s
  // nu part), the block group's sums; ends synchronized.
  template <typename S, typename G>
  static __device__ void prep(const G& g, S* sm, const Layout& L, const S* run, int nr) {
    const S* rec = stage_inverses(sm, L);
    for (int t = g.rank(); t < L.T; t += g.size()) {
      const S* er = rec + (size_t)t * REC + EROW;
      const S* sn = rec + (size_t)t * REC + SINV;
      const S* r = run + t * nr;
      S t6 = S(0), t9 = S(0);
      for (int j = 0; j < NU_; ++j) t6 += er[j] * r[j];
      for (int j = 0; j < NU_; ++j) t9 += er[NU_ + j] * r[j];
      const S e0 = r[NU_] - t6, e1 = r[NU_ + 1] - t9;
      sm[L.eta + 2 * t] = sn[0] * e0 + sn[1] * e1;
      sm[L.eta + 2 * t + 1] = sn[2] * e0 + sn[3] * e1;
    }
    g.sync();
  }

  // Row o (< 14) of K_t^-1 r through the transposed record: K5c by the
  // block formula, du = Ru^-1 r_u - (E Ru^-1)^T eta, with eta from `prep`.
  template <typename S>
  static __device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o,
                                               const S* r) {
    const S* k = stage_inverses(sm, L) + (size_t)t * REC;
    if constexpr (RIC2) {
      const S* eta = sm + L.eta + 2 * t;
      if (o >= NU_) return eta[o - NU_];
      S t1 = S(0);
      for (int j = 0; j < NU_; ++j) t1 += k[j * N + o] * r[j];
      return t1 - (k[EROW + o] * eta[0] + k[EROW + NU_ + o] * eta[1]);
    } else {
      S acc = S(0);
      for (int j = 0; j < N; ++j) acc += k[j * N + o] * r[j];
      return acc;
    }
  }

  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags ff) {
    static_assert(G::THREADS == 32, "one warp an env, two stage blocks at a time");
    const int lane = g.rank(), h = lane >> 4, i = lane & 15, T = L.T;
    const int row = i < N ? i : N - 1;     // idle lanes hold a copy of row N - 1
    const int yi = i < NX_ ? i : NX_ - 1;  // ... and of Y'_t's row 11
    const S* hd_u = sm + L.hd + NX_ * T;
    const S* gu = sm + L.gu;
    const S* bd = sm + L.bd;
    const S* qinv = sm + L.qinv;
    S* rec = stage_inverses(sm, L);
    const bool pivot = !RIC2 && ff.k_pivot, jacobi = ff.jacobi;
    // Ad Q~^-1 Ad^T into the union, as riccati_setup forms it.
    for (int k = lane; k < 144; k += 32) sm[L.adqad + k] = adqad_entry(sm, L, k / NX_, k % NX_);
    for (int t0 = 0; t0 < T; t0 += 2) {
      const bool on = t0 + h < T;      // an idle half (odd T) redoes stage t0 and stores nothing
      const int t = on ? t0 + h : t0;
      const S* wt = sm + L.w + t * NI_;
      S a[N];
#pragma unroll
      for (int c = 0; c < N; ++c) a[c] = ric_cond_entry<RIC2>(row, c, hd_u, gu, wt, beta, delta);
      // Jacobi: K^-1 = D (D K D)^-1 D, D = 1 / sqrt(max(|diag K|, 1e-30)),
      // each entry scaled as (k_ij d_i) d_j (`jacobi_apply`).
      S dl = S(1);
      if (jacobi) {
        S dg = S(0);
#pragma unroll
        for (int c = 0; c < N; ++c) dg = c == row ? a[c] : dg;
        dl = jacobi_d(dg);
#pragma unroll
        for (int c = 0; c < N; ++c)
          a[c] = a[c] * dl * __shfl_sync(0xffffffffu, dl, (h << 4) | c);
      }
      int pos, q;
      gj_pair_regs<N>(a, pivot, !pivot && ff.gj_inplace, pos, q);
      // The record: entry (pos, column q of lane j) is a[j], scaled back.
      const S dr = jacobi ? __shfl_sync(0xffffffffu, dl, (h << 4) | (pos < N ? pos : 0)) : S(1);
      S* kt = rec + (size_t)t * REC;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = pivot ? __shfl_sync(0xffffffffu, q, (h << 4) | j) : j;
        if (jacobi) a[j] = a[j] * dr * __shfl_sync(0xffffffffu, dl, (h << 4) | c);
        if (on && pos < N) kt[c * N + pos] = a[j];
      }
      // Row yi of (K^-1)_uu.
      S ku[NU_];
      if constexpr (RIC2) {
        // S = -delta I - E Ru^-1 E^T in closed form; (K^-1)_uu = Ru^-1 +
        // (E Ru^-1)^T S^-1 (E Ru^-1), rows 6 and 9 of Ru^-1 from their lanes.
        S r6[NU_], r9[NU_];
#pragma unroll
        for (int j = 0; j < NU_; ++j) {
          r6[j] = __shfl_sync(0xffffffffu, a[j], (h << 4) | 6);
          r9[j] = __shfl_sync(0xffffffffu, a[j], (h << 4) | 9);
        }
        const S sa = -delta - r6[6];
        const S sb = -r6[9];
        const S sc = -delta - r9[9];
        const S det = sa * sc - sb * sb;
        const S s0 = sc / det, s1 = -sb / det, s2 = -sb / det, s3 = sa / det;
        S e6 = S(0), e9 = S(0);  // Ru^-1[6][yi], Ru^-1[9][yi]
#pragma unroll
        for (int j = 0; j < NU_; ++j) {
          e6 = j == yi ? r6[j] : e6;
          e9 = j == yi ? r9[j] : e9;
        }
        if (on && i < NU_) {
          kt[EROW + i] = e6;
          kt[EROW + NU_ + i] = e9;
        }
        if (on && i < 4) kt[SINV + i] = i == 0 ? s0 : (i == 1 ? s1 : (i == 2 ? s2 : s3));
#pragma unroll
        for (int j = 0; j < NU_; ++j) {
          const S si0 = s0 * r6[j] + s1 * r9[j];
          const S si1 = s2 * r6[j] + s3 * r9[j];
          ku[j] = a[j] + (e6 * si0 + e9 * si1);
        }
      } else if (pivot) {
        // The rows are permuted in the lanes: read row yi back from the record.
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NU_; ++j) ku[j] = kt[j * N + yi];
      } else {
#pragma unroll
        for (int j = 0; j < NU_; ++j) ku[j] = a[j];
      }
      PDIPM_MARK(g, PH_FOOT);
      // P_t = Bd (K^-1)_uu, row yi, and Y'_t = -delta I - Q~^-1 - P_t Bd^T -
      // [t >= 1] Ad Q~^-1 Ad^T (`y_chain_from_kuu`, `y_chain_from_p`).
      S p[NX_];
#pragma unroll
      for (int c = 0; c < NX_; ++c) p[c] = S(0);
#pragma unroll
      for (int j = 0; j < NU_; ++j) {
        const S b = bd[yi * NU_ + j];
#pragma unroll
        for (int c = 0; c < NX_; ++c) p[c] += b * __shfl_sync(0xffffffffu, ku[c], (h << 4) | j);
      }
      __syncwarp();  // Ad Q~^-1 Ad^T
      S* yt = sm + L.yp + t * 144 + yi * NX_;
#pragma unroll
      for (int l = 0; l < NX_; ++l) {
        S bkb = S(0);
#pragma unroll
        for (int j = 0; j < NU_; ++j) bkb += p[j] * bd[l * NU_ + j];
        S v = yi == l ? -delta - qinv[yi] : S(0);
        v -= bkb;
        if (t >= 1) v -= sm[L.adqad + yi * NX_ + l];
        if (on && i < NX_) yt[l] = v;
      }
      PDIPM_MARK(g, PH_PT);
    }
    g.sync();
    dual_riccati_chain_regs(g, sm + L.yp, sm + L.m, sm + L.sc, T, ff.gj_inplace, sm + L.q1);
    PDIPM_MARK(g, PH_YCHAIN);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    riccati_solve<RicCondWarp>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};
