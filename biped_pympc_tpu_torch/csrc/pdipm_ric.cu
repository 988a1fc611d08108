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
// that scale. Build without --use_fast_math: division and sqrt stay IEEE.

#include "pdipm_common.cuh"

static constexpr int NUN_ = 14;  // [u (12), nu (2)] per stage

// Index layout of all per-env buffers in shared memory (in values of S).
struct Layout {
  int T, nz, ni, ne;
  // inputs
  int hd, f, ad, bd, b, gu, d;
  // iterates, residuals, Sigma and W^-1
  int x, s, z, y, rx, rs, re, sig, w;
  // constants of the solve: q_inv, S = Q~^-1 Ad^T, Ad Q~^-1 Ad^T,
  // -delta I - Q~^-1 - sum_j c_j Bd_j Bd_j^T over the 2x2 / 1x1 columns, and
  // the 2x2 / 1x1 inverse coefficients
  int qinv, sc, adqad, yc, cf;
  // factors: 2T foot-block inverses (4x4), T y-chain inverses, P_t = Bd_f K_f^-1,
  // elimination scratch
  int k4, m, p, colk, prow, q1;
  // reduced-solve rhs, refinement, directions
  int r1, r2, r3, r4, r1h, tmp, e1, e4, ex, ey;
  int dxa, dsa, dza, dya, dxc, dsc, dzc, dyc;
  // sweep scratch
  int run, kr, g, wy, v12, red;
  int total;      // values of S
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
  L.qinv = take(o, NX_); L.sc = take(o, 144); L.adqad = take(o, 144); L.yc = take(o, 144);
  L.cf = take(o, 8);
  L.k4 = take(o, 2 * T * 16); L.m = take(o, T * 144); L.p = take(o, T * NX_ * 8);
  L.colk = take(o, NX_); L.prow = take(o, NX_); L.q1 = take(o, 144);
  L.r1 = take(o, L.nz); L.r2 = take(o, L.ni); L.r3 = take(o, L.ni); L.r4 = take(o, L.ne);
  L.r1h = take(o, L.nz); L.tmp = take(o, L.ni);
  L.e1 = take(o, L.nz); L.e4 = take(o, L.ne); L.ex = take(o, L.nz); L.ey = take(o, L.ne);
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.run = take(o, T * NUN_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
  L.wy = take(o, T * NX_); L.v12 = take(o, NX_); L.red = take(o, PDIPM_THREADS);
  L.total = o;
  L.bytes = (size_t)o * size_of_s;
  return L;
}

// In-place Jordan inverse of one 4x4 SPD matrix held by the calling thread,
// natural pivot order; the pivot entry of the inverse is written as 1/pivot.
template <typename S>
__device__ __forceinline__ void inverse4_nopivot(S* a) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const S pv = a[k * 4 + k];
    S colk[4], prow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) colk[i] = a[i * 4 + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) prow[j] = j == k ? S(1) / pv : a[k * 4 + j] / pv;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i == k) a[i * 4 + j] = prow[j];
        else if (j == k) a[i * 4 + j] = -colk[i] * prow[k];
        else a[i * 4 + j] -= colk[i] * prow[j];
      }
  }
}

// ---------------------------------------------------------------------------
// Stage block inverse apply: row o (< 14) of K_t^-1 r, r = [u(12), nu(2)].
// ---------------------------------------------------------------------------
template <typename S>
__device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o, const S* r) {
  const S* cf = sm + L.cf;
  int foot, a;
  switch (o) {
    case 0: case 1: case 2: foot = 0; a = o; break;
    case 7: foot = 0; a = 3; break;
    case 3: case 4: case 5: foot = 1; a = o - 3; break;
    case 10: foot = 1; a = 3; break;
    case 6: return cf[0] * r[6] + cf[1] * r[12];
    case 9: return cf[3] * r[9] + cf[4] * r[13];
    case 8: return cf[6] * r[8];
    case 11: return cf[7] * r[11];
    case 12: return cf[1] * r[6] + cf[2] * r[12];
    default: return cf[4] * r[9] + cf[5] * r[13];  // 13
  }
  const S* k = sm + L.k4 + (foot * L.T + t) * 16 + a * 4;
  S acc = S(0);
  for (int bb = 0; bb < 4; ++bb) acc += k[bb] * r[foot_col(foot, bb)];
  return acc;
}

// ---------------------------------------------------------------------------
// Factorization of the condensed KKT at the current W^-1.
// ---------------------------------------------------------------------------
template <typename S>
__device__ void factor(S* sm, const Layout& L, S beta) {
  const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
  const S* hd = sm + L.hd;
  const S* gu = sm + L.gu;
  const S* w = sm + L.w;
  const S* bd = sm + L.bd;
  S* k4 = sm + L.k4;
  S* m = sm + L.m;
  S* p = sm + L.p;

  // Foot blocks G_f^T diag(W^-1_f) G_f + diag(r_f + beta), block foot*T + t.
  for (int blk = tid; blk < 2 * T; blk += nt) {
    const int foot = blk / T, t = blk % T;
    const S* wf = w + t * NI_ + 8 * foot;
    const S* gf = gu + 8 * foot * NU_;
    S a[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = foot_col(foot, i), cj = foot_col(foot, j);
        S acc = S(0);
        for (int r = 0; r < 8; ++r) acc += gf[r * NU_ + ci] * gf[r * NU_ + cj] * wf[r];
        a[i * 4 + j] = i == j ? acc + (hd[NX_ * T + ci] + beta) : acc;
      }
    inverse4_nopivot(a);
#pragma unroll
    for (int e = 0; e < 16; ++e) k4[blk * 16 + e] = a[e];
  }
  __syncthreads();
  // P_t[i][a] = (Bd_f K_f,t^-1)[i][a % 4], foot f = a / 4.
  for (int it = tid; it < T * NX_ * 8; it += nt) {
    const int t = it / (NX_ * 8), i = (it / 8) % NX_, a = it % 8, foot = a / 4;
    const S* k = k4 + (foot * T + t) * 16;
    S v = S(0);
    for (int bb = 0; bb < 4; ++bb) v += bd[i * NU_ + foot_col(foot, bb)] * k[bb * 4 + a % 4];
    p[it] = v;
  }
  __syncthreads();
  // Y'_t = -delta I - Q~^-1 - Bd K_uu^-1 Bd^T - [t >= 1] Ad Q~^-1 Ad^T; the
  // W-independent columns of Bd K_uu^-1 Bd^T are in yc.
  for (int it = tid; it < T * 144; it += nt) {
    const int t = it / 144, i = (it % 144) / NX_, l = it % NX_;
    const S* pt = p + (t * NX_ + i) * 8;
    S bkb = S(0);
    for (int a = 0; a < 8; ++a) bkb += pt[a] * bd[l * NU_ + foot_col(a / 4, a % 4)];
    S v = sm[L.yc + i * NX_ + l] - bkb;
    if (t >= 1) v -= sm[L.adqad + i * NX_ + l];
    m[it] = v;
  }
  __syncthreads();
  dual_riccati_chain(m, sm + L.sc, T, sm + L.q1, sm + L.colk, sm + L.prow, (int*)nullptr);
}

// ---------------------------------------------------------------------------
// One condensed solve of [[H~, A^T], [A, -delta I]] (dx, dy) = (r1, r4).
// ---------------------------------------------------------------------------
template <typename S>
__device__ void solve_ric(S* sm, const Layout& L, const S* r1, const S* r4, S* dx, S* dy) {
  const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
  const S* ad = sm + L.ad;
  const S* bd = sm + L.bd;
  const S* qinv = sm + L.qinv;
  const S* m = sm + L.m;
  S* run = sm + L.run;
  S* kr = sm + L.kr;
  S* g = sm + L.g;
  S* wy = sm + L.wy;

  // Stage rhs [u, nu] and the x-eliminated y rows
  // ry_t = g_t - Q~^-1 c_t + [t >= 1] Ad Q~^-1 c_{t-1}.
  for (int it = tid; it < T * NUN_ + T * NX_; it += nt) {
    if (it < T * NUN_) {
      const int t = it / NUN_, r = it % NUN_;
      run[it] = r < NU_ ? r1[NX_ * T + NU_ * t + r] : r4[NX_ * T + NMX_ * t + r - NU_];
    } else {
      const int k = it - T * NUN_, t = k / NX_, i = k % NX_;
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
    kr[it] = kinv_row(sm, L, t, o, run + t * NUN_);
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
  y_sweeps(m, sm + L.sc, T, g, wy, sm + L.v12);
  // u rhs += Bd^T y_t
  for (int it = tid; it < T * NU_; it += nt) {
    const int t = it / NU_, r = it % NU_;
    S acc = S(0);
    for (int l = 0; l < NX_; ++l) acc += wy[t * NX_ + l] * bd[l * NU_ + r];
    run[t * NUN_ + r] += acc;
  }
  __syncthreads();
  // [u, nu] = K^-1 rhs; x_{t+1} = Q~^-1 (c_t - y_t + Ad^T y_{t+1}); y.
  for (int it = tid; it < T * NUN_ + T * NX_; it += nt) {
    if (it < T * NUN_) {
      const int t = it / NUN_, o = it % NUN_;
      const S v = kinv_row(sm, L, t, o, run + t * NUN_);
      if (o < NU_) dx[NX_ * T + NU_ * t + o] = v;
      else dy[NX_ * T + NMX_ * t + o - NU_] = v;
    } else {
      const int k = it - T * NUN_, t = k / NX_, i = k % NX_;
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

// Reduced solve with refinement: from (r1, r2, r3, r4), with
// tmp = W^-1 (r3 - r2 / Sigma) already formed, to directions (dx, ds, dz, dy).
template <typename S>
__device__ void reduced_solve(S* sm, const Layout& L, int refine_steps, S beta, S delta,
                              S* dx, S* ds, S* dz, S* dy) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const S* r1 = sm + L.r1;
  const S* r2 = sm + L.r2;
  const S* r3 = sm + L.r3;
  const S* r4 = sm + L.r4;
  const S* hd = sm + L.hd;
  const S* w = sm + L.w;
  const S* sig = sm + L.sig;
  S* r1h = sm + L.r1h;
  S* tmp = sm + L.tmp;
  S* e1 = sm + L.e1;
  S* e4 = sm + L.e4;
  S* ex = sm + L.ex;
  S* ey = sm + L.ey;
  const int nz = L.nz, ni = L.ni, ne = L.ne;

  // r1_hat = r1 + G^T (W^-1 (r3 - r2 / Sigma))
  for (int i = tid; i < nz; i += nt) r1h[i] = r1[i] + gT_entry(sm, L, i, tmp);
  __syncthreads();
  solve_ric(sm, L, r1h, r4, dx, dy);
  for (int rs = 0; rs < refine_steps; ++rs) {
    for (int k = tid; k < ni; k += nt) tmp[k] = w[k] * g_entry(sm, L, k, dx);
    __syncthreads();
    for (int it = tid; it < nz + ne; it += nt) {
      if (it < nz) {
        const int i = it;
        S mv = (hd[i] + beta) * dx[i] + gT_entry(sm, L, i, tmp) + aT_entry(sm, L, i, dy);
        e1[i] = r1h[i] - mv;
      } else {
        const int e = it - nz;
        S mv = a_entry(sm, L, e, dx) - delta * dy[e];
        e4[e] = r4[e] - mv;
      }
    }
    __syncthreads();
    solve_ric(sm, L, e1, e4, ex, ey);
    for (int it = tid; it < nz + ne; it += nt) {
      if (it < nz) dx[it] += ex[it];
      else dy[it - nz] += ey[it - nz];
    }
    __syncthreads();
  }
  // dz = W^-1 (G dx + r2 / Sigma - r3), ds = (r2 - dz) / Sigma
  for (int k = tid; k < ni; k += nt) {
    const S v = w[k] * (g_entry(sm, L, k, dx) + r2[k] / sig[k] - r3[k]);
    dz[k] = v;
    ds[k] = (r2[k] - v) / sig[k];
  }
  __syncthreads();
}

// The outputs may alias the warm state x0, s0, z0, y0 (load_env), so none of
// those pointers is __restrict__.
template <typename S>
__global__ void __launch_bounds__(PDIPM_THREADS) __maxnreg__(MaxRegs<S>::value)
pdipm_ric_kernel(
    const S* __restrict__ hd_in, const S* __restrict__ f_in, const S* __restrict__ ad_in,
    const S* __restrict__ bd_in, const S* __restrict__ b_in, const S* __restrict__ gu_in,
    const S* __restrict__ d_in, const S* x0, const S* s0, const S* z0, const S* y0,
    S* x_out, S* s_out, S* z_out, S* y_out, S* res_out, const int* go, int* ran,
    int T, int iterations, int refine_steps, S beta, S delta) {
  if (!gate_open(go, ran)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const Layout L = make_layout(T, (int)sizeof(S));
  const int tid = threadIdx.x, nt = blockDim.x;
  const long env = blockIdx.x;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  S* red = sm + L.red;

  load_env(sm, L, env, hd_in, f_in, ad_in, bd_in, b_in, gu_in, d_in, x0, s0, z0, y0);
  // Constants: q_inv = 1 / (Q + beta), the [M_x, nu] = [[r + beta, 1], [1, -delta]]^-1
  // and M_z = 1 / (r + beta) entries, S = Q~^-1 Ad^T, Ad Q~^-1 Ad^T, and
  // yc = -delta I - Q~^-1 - sum_j c_j Bd_j Bd_j^T over the columns j = 6, 8, 9, 11.
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
  for (int it = tid; it < 3 * 144; it += nt) {
    const int k = it % 144, i = k / NX_, j = k % NX_;
    const S* ad = sm + L.ad;
    const S* bd = sm + L.bd;
    const S* qinv = sm + L.qinv;
    const S* cf = sm + L.cf;
    if (it < 144) {
      sm[L.sc + k] = qinv[i] * ad[j * NX_ + i];
    } else if (it < 288) {
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * qinv[l] * ad[j * NX_ + l];
      sm[L.adqad + k] = acc;
    } else {
      const S couter = cf[0] * bd[i * NU_ + 6] * bd[j * NU_ + 6]
                     + cf[6] * bd[i * NU_ + 8] * bd[j * NU_ + 8]
                     + cf[3] * bd[i * NU_ + 9] * bd[j * NU_ + 9]
                     + cf[7] * bd[i * NU_ + 11] * bd[j * NU_ + 11];
      sm[L.yc + k] = (i == j ? -delta - qinv[i] : S(0)) - couter;
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
  S* r2 = sm + L.r2;
  S* r3 = sm + L.r3;
  S* r4 = sm + L.r4;
  S* tmp = sm + L.tmp;
  S* dxa = sm + L.dxa; S* dsa = sm + L.dsa; S* dza = sm + L.dza; S* dya = sm + L.dya;
  S* dxc = sm + L.dxc; S* dsc = sm + L.dsc; S* dzc = sm + L.dzc; S* dyc = sm + L.dyc;
  const S nif = S(ni);

  for (int iter = 0; iter < iterations; ++iter) {
    // KKT residuals at the current iterate, Sigma and W^-1 = Sigma / (1 + delta Sigma).
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
        w[k] = sg / (S(1) + delta * sg);
        part += s[k] * z[k];
      } else {
        const int e = it - nz - ni;
        re[e] = a_entry(sm, L, e, x) - sm[L.b + e];
      }
    }
    const S mu = block_sum(part, red) / nif;  // syncs

    factor(sm, L, beta);

    // Affine direction: rhs (-rx, -(s z)/s, -rs, -re).
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        r1[it] = -rx[it];
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S v2 = -(s[k] * z[k]) / s[k];
        const S v3 = -rsb[k];
        r2[k] = v2;
        r3[k] = v3;
        tmp[k] = w[k] * (v3 - v2 / sig[k]);
      } else {
        r4[it - nz - ni] = -re[it - nz - ni];
      }
    }
    __syncthreads();
    reduced_solve(sm, L, refine_steps, beta, delta, dxa, dsa, dza, dya);
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
        r3[k] = S(0);
        tmp[k] = w[k] * (S(0) - v2 / sig[k]);
      } else {
        r4[it - nz - ni] = S(0);
      }
    }
    __syncthreads();
    reduced_solve(sm, L, refine_steps, beta, delta, dxc, dsc, dzc, dyc);
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
  // The compensated residual is an augmented-route option. The entries keep
  // K1's argument list; `pdipm.check_options` refuses df on this route
  // before any launch, so this guard fires only for a direct C caller.
  if (refine_df != 0) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(T, (int)sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(pdipm_ric_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  pdipm_ric_kernel<S><<<batch, PDIPM_THREADS, L.bytes, (cudaStream_t)stream>>>(
      (const S*)hd, (const S*)f, (const S*)ad, (const S*)bd, (const S*)b, (const S*)gu,
      (const S*)d, (const S*)x0, (const S*)s0, (const S*)z0, (const S*)y0, (S*)x, (S*)s, (S*)z,
      (S*)y, (S*)res, (const int*)go, (int*)ran, T, iterations, refine_steps, (S)beta,
      (S)delta);
  return (int)cudaGetLastError();
}

extern "C" {

// Dynamic shared memory of one block, in bytes, for horizon T and a value
// size of 4 (float) or 8 (double).
size_t pdipm_ric_smem_bytes(int T, int value_size) {
  return make_layout(T, value_size).bytes;
}

// Solve `batch` QPs on `stream`; the interface of pdipm_ric_aug_f32 /
// pdipm_ric_aug_f64 (pdipm_ric_aug.cu), except that refine_df must be 0:
// any other value returns cudaErrorInvalidValue and launches nothing.
int pdipm_ric_f32(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  int iterations, int refine_steps, int refine_df, double beta, double delta,
                  void* stream) {
  return launch<float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran, batch,
                       T, iterations, refine_steps, refine_df, beta, delta, stream);
}

int pdipm_ric_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  int iterations, int refine_steps, int refine_df, double beta, double delta,
                  void* stream) {
  return launch<double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran, batch,
                        T, iterations, refine_steps, refine_df, beta, delta, stream);
}

const char* pdipm_ric_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
