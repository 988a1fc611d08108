// The block-Thomas PDIPM, one thread block per env: the kernel that
// pdipm_tridiag.cu (condensed, 26-wide stage blocks, K5a) and
// pdipm_tridiag_aug.cu (augmented, 42-wide, K5b) instantiate, one width each.
// Those sources carry the notes on what each replaces and what bounds it.
//
// Per Newton step: the KKT residuals, Sigma and W (or W^-1); the Thomas
// factor, T stages in order, each building its N x N block on
// [u (12), z (16, augmented only), nu (2), y (12)] in its own slot of
// shared memory and inverting it there with partial pivoting; then the
// affine and corrector reduced solves with refinement, the step rule and
// the update, as in pdipm_ric_aug.cu / pdipm_ric.cu.

#pragma once

#include "pdipm_common.cuh"

template <bool AUG>
struct Thomas {
  static constexpr int NZS = AUG ? NI_ : 0;  // z rows kept in the stage block
  static constexpr int NNU = NU_ + NZS;      // first nu row
  static constexpr int NY = NNU + NMX_;      // first y row
  static constexpr int N = NY + NX_;         // block width: 42 or 26
};

// Index layout of all per-env buffers in shared memory (in values of S).
// Buffers one route does not use have length 0.
struct Layout {
  int T, nz, ni, ne;
  // inputs
  int hd, f, ad, bd, b, gu, d;
  // iterates and residuals, Sigma and W (augmented) or W^-1 (condensed)
  int x, s, z, y, rx, rs, re, sig, w;
  // q_inv = 1 / (Q + beta); the T stored inverses S_t^-1; M_{t-1} and
  // Ad M_{t-1}; the elimination step's column, scaled pivot row and old row k
  int qinv, sinv, mp, adm, colk, prow, rowk;
  // reduced-solve rhs (rz augmented; r3, tmp, r1h condensed) and refinement
  int r1, r2, r4, rz, r3, tmp, r1h, e1, ez, e4, ex, ezz, ey;
  int dxa, dsa, dza, dya, dxc, dsc, dzc, dyc;
  // sweep scratch: the forward g_t, Ad^T w_y(t+1) per stage, x_{t-1}
  int g, adtw, xp, red;
  int total;      // values of S
  int piv;        // byte offset of the int pivot table
  size_t bytes;   // total bytes
};

template <bool AUG>
static __host__ __device__ Layout make_layout(int T, int size_of_s) {
  constexpr int N = Thomas<AUG>::N;
  Layout L;
  L.T = T;
  L.nz = 24 * T;
  L.ni = 16 * T;
  L.ne = 14 * T;
  const int nia = AUG ? L.ni : 0, nic = AUG ? 0 : L.ni;
  int o = 0;
  L.hd = take(o, L.nz); L.f = take(o, L.nz); L.ad = take(o, 144); L.bd = take(o, 144);
  L.b = take(o, L.ne); L.gu = take(o, NI_ * NU_); L.d = take(o, L.ni);
  L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
  L.rx = take(o, L.nz); L.rs = take(o, L.ni); L.re = take(o, L.ne);
  L.sig = take(o, L.ni); L.w = take(o, L.ni);
  L.qinv = take(o, NX_); L.sinv = take(o, T * N * N); L.mp = take(o, 144); L.adm = take(o, 144);
  L.colk = take(o, N); L.prow = take(o, N); L.rowk = take(o, N);
  L.r1 = take(o, L.nz); L.r2 = take(o, L.ni); L.r4 = take(o, L.ne); L.rz = take(o, nia);
  L.r3 = take(o, nic); L.tmp = take(o, nic); L.r1h = take(o, AUG ? 0 : L.nz);
  L.e1 = take(o, L.nz); L.ez = take(o, nia); L.e4 = take(o, L.ne);
  L.ex = take(o, L.nz); L.ezz = take(o, nia); L.ey = take(o, L.ne);
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.g = take(o, T * N); L.adtw = take(o, T * NX_); L.xp = take(o, NX_);
  L.red = take(o, PDIPM_THREADS);
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv + sizeof(int) * N;
  return L;
}

// (v, i) ranks before (best, p) in the pivot search: the largest |entry|,
// NaN above every number, the lower row on ties (what argmax picks, in
// torch and jnp); p = N means no candidate yet.
template <typename S, int N>
__device__ __forceinline__ bool pivot_before(S v, int i, S best, int p) {
  if (p == N) return i < N;
  if (best != best) return v != v && i < p;
  if (v != v) return true;
  return v > best || (v == best && i < p);
}

// ---------------------------------------------------------------------------
// In-place Gauss-Jordan inverse of one N x N block `a` with partial pivoting:
// step k swaps the first row >= k of largest |a_ik| into row k (warp 0
// searches), writes the inverse's pivot entry as 1/pivot, and updates every
// entry directly; the row swaps are undone as column swaps at the end, last
// first. colk, prow, rowk hold N values each, piv N ints.
// ---------------------------------------------------------------------------
template <typename S, int N>
__device__ void gj_inverse_pivot(S* a, S* colk, S* prow, S* rowk, int* piv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 0; k < N; ++k) {
    if (tid < 32) {
      S best = S(0);
      int p = N;
      for (int i = k + tid; i < N; i += 32) {
        S v = a[i * N + k];
        v = v < S(0) ? -v : v;
        if (pivot_before<S, N>(v, i, best, p)) { best = v; p = i; }
      }
      for (int m = 16; m > 0; m >>= 1) {
        const S ob = __shfl_xor_sync(0xffffffffu, best, m);
        const int op = __shfl_xor_sync(0xffffffffu, p, m);
        if (pivot_before<S, N>(ob, op, best, p)) { best = ob; p = op; }
      }
      if (tid == 0) piv[k] = p;
    }
    __syncthreads();
    const int p = piv[k];
    const S pv = a[p * N + k];
    // Scaled pivot row, the old row k, and column k of the swapped block.
    for (int j = tid; j < N; j += nt) {
      prow[j] = j == k ? S(1) / pv : a[p * N + j] / pv;
      rowk[j] = a[k * N + j];
      colk[j] = j == k ? pv : (j == p ? a[k * N + k] : a[j * N + k]);
    }
    __syncthreads();
    // Jordan step: row k <- scaled row; column k <- -col / pivot; rest rank-1.
    for (int it = tid; it < N * N; it += nt) {
      const int i = it / N, j = it % N;
      if (i == k) a[it] = prow[j];
      else if (j == k) a[it] = -colk[i] * prow[k];
      else a[it] = (i == p ? rowk[j] : a[it]) - colk[i] * prow[j];
    }
    __syncthreads();
  }
  // inv(A) = inv(P A) P: undo the row swaps as column swaps, last first.
  for (int i = tid; i < N; i += nt) {
    S* row = a + i * N;
    for (int k = N - 1; k >= 0; --k) {
      const int p = piv[k];
      if (p != k) {
        const S tmp = row[k];
        row[k] = row[p];
        row[p] = tmp;
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Thomas factor at the current W (augmented) or W^-1 (condensed): stage t's
// block
//   [[R+beta (+ G^T W_t^-1 G), G^T, e^T, -Bd^T], [G, -W_t, 0, 0],
//    [e, 0, -delta I, 0], [-Bd, 0, 0, -delta I - Ad M_{t-1} Ad^T - Q~^-1]]
// inverted in place in S_t^-1's slot; M_t = Q~^-1 + Q~^-1 N_yy Q~^-1 from its
// y block N_yy. The stages are sequential: S_t needs M_{t-1}.
// ---------------------------------------------------------------------------
template <typename S, bool AUG>
__device__ void factor(S* sm, const Layout& L, int* piv, S beta, S delta) {
  using K = Thomas<AUG>;
  constexpr int N = K::N, NNU = K::NNU, NY = K::NY;
  const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
  const S* hd = sm + L.hd;
  const S* gu = sm + L.gu;
  const S* w = sm + L.w;
  const S* ad = sm + L.ad;
  const S* bd = sm + L.bd;
  const S* qinv = sm + L.qinv;
  S* mp = sm + L.mp;
  S* adm = sm + L.adm;
  for (int t = 0; t < T; ++t) {
    S* a = sm + L.sinv + t * N * N;
    if (t >= 1) {
      for (int it = tid; it < 144; it += nt) {
        const int i = it / NX_, k = it % NX_;
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * mp[l * NX_ + k];
        adm[it] = acc;
      }
      __syncthreads();
    }
    const S* wt = w + t * NI_;
    for (int it = tid; it < N * N; it += nt) {
      const int r = it / N, c = it % N;
      S v = S(0);
      if (r < NU_ && c < NU_) {
        if constexpr (!AUG) {
          for (int q = 0; q < NI_; ++q) v += gu[q * NU_ + r] * wt[q] * gu[q * NU_ + c];
        }
        if (r == c) v += hd[NX_ * T + r] + beta;
      } else if (r >= NY && c >= NY) {
        const int i = r - NY, j = c - NY;
        if (i == j) v = -delta;
        if (t >= 1) {
          S acc = S(0);
          for (int k = 0; k < NX_; ++k) acc += adm[i * NX_ + k] * ad[j * NX_ + k];
          v -= acc;
        }
        if (i == j) v -= qinv[i];
      } else if (r < NU_ && c >= NY) {
        v = -bd[(c - NY) * NU_ + r];
      } else if (r >= NY && c < NU_) {
        v = -bd[(r - NY) * NU_ + c];
      } else if (r < NU_ && c >= NNU) {  // e^T: u6 -> nu0, u9 -> nu1
        v = (r == 6 && c == NNU) || (r == 9 && c == NNU + 1) ? S(1) : S(0);
      } else if (c < NU_ && r >= NNU) {  // e (r < NY here)
        v = (c == 6 && r == NNU) || (c == 9 && r == NNU + 1) ? S(1) : S(0);
      } else if (r >= NNU && c >= NNU) {  // nu block (both < NY here)
        v = r == c ? -delta : S(0);
      } else if constexpr (AUG) {
        if (r < NU_) v = gu[(c - NU_) * NU_ + r];          // G^T
        else if (c < NU_) v = gu[(r - NU_) * NU_ + c];     // G
        else if (r == c) v = -wt[r - NU_];                 // -W_t
      }
      a[it] = v;
    }
    __syncthreads();
    gj_inverse_pivot<S, N>(a, sm + L.colk, sm + L.prow, sm + L.rowk, piv);
    for (int it = tid; it < 144; it += nt) {
      const int i = it / NX_, j = it % NX_;
      const S v = qinv[i] * a[(NY + i) * N + NY + j] * qinv[j];
      mp[it] = i == j ? qinv[i] + v : v;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// One two-sweep solve through the stored inverses: (r1, rz, r4) -> (dx, dz,
// dy); rz and dz only on the augmented route.
// ---------------------------------------------------------------------------
template <typename S, bool AUG>
__device__ void thomas_solve(S* sm, const Layout& L, const S* r1, const S* rz, const S* r4,
                             S* dx, S* dz, S* dy) {
  using K = Thomas<AUG>;
  constexpr int N = K::N, NNU = K::NNU, NY = K::NY;
  const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
  const S* ad = sm + L.ad;
  const S* qinv = sm + L.qinv;
  const S* sinv = sm + L.sinv;
  S* g = sm + L.g;
  S* adtw = sm + L.adtw;
  S* xp = sm + L.xp;

  // Stage rhs [u, z, nu, y - Q~^-1 x].
  for (int it = tid; it < T * N; it += nt) {
    const int t = it / N, r = it % N;
    S v;
    if (r < NU_) v = r1[NX_ * T + NU_ * t + r];
    else if (r < NNU) v = rz[NI_ * t + r - NU_];
    else if (r < NY) v = r4[NX_ * T + NMX_ * t + r - NNU];
    else v = r4[NX_ * t + r - NY] - qinv[r - NY] * r1[NX_ * t + r - NY];
    g[it] = v;
  }
  __syncthreads();
  // Forward: g_t[y] += Ad x_{t-1}; x_t = Q~^-1 (r_x - (S_t^-1 g_t)[y]).
  for (int t = 0; t < T; ++t) {
    S* gt = g + t * N;
    if (t >= 1) {
      for (int i = tid; i < NX_; i += nt) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * xp[l];
        gt[NY + i] += acc;
      }
      __syncthreads();
    }
    if (t + 1 < T) {
      for (int i = tid; i < NX_; i += nt) {
        const S* row = sinv + t * N * N + (NY + i) * N;
        S acc = S(0);
        for (int j = 0; j < N; ++j) acc += row[j] * gt[j];
        xp[i] = qinv[i] * (r1[NX_ * t + i] - acc);
      }
      __syncthreads();
    }
  }
  // Backward: g_t[y] -= Q~^-1 Ad^T w_y(t+1); w_t = S_t^-1 g_t, scattered
  // into (dx_u, dz, dy_nu, dy_y).
  for (int t = T - 1; t >= 0; --t) {
    S* gt = g + t * N;
    if (t + 1 < T) {
      for (int i = tid; i < NX_; i += nt) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[l * NX_ + i] * dy[NX_ * (t + 1) + l];
        adtw[NX_ * t + i] = acc;
        gt[NY + i] -= qinv[i] * acc;
      }
      __syncthreads();
    }
    for (int o = tid; o < N; o += nt) {
      const S* row = sinv + t * N * N + o * N;
      S acc = S(0);
      for (int j = 0; j < N; ++j) acc += row[j] * gt[j];
      if (o < NU_) dx[NX_ * T + NU_ * t + o] = acc;
      else if (o < NNU) dz[NI_ * t + o - NU_] = acc;
      else if (o < NY) dy[NX_ * T + NMX_ * t + o - NNU] = acc;
      else dy[NX_ * t + o - NY] = acc;
    }
    __syncthreads();
  }
  // x_{t+1} = Q~^-1 (r_x + Ad^T w_y(t+1) - w_y(t)).
  for (int k = tid; k < NX_ * T; k += nt) {
    const int t = k / NX_, i = k % NX_;
    const S rxa = t + 1 < T ? r1[k] + adtw[k] : r1[k];
    dx[k] = qinv[i] * (rxa - dy[k]);
  }
  __syncthreads();
}

// Reduced solve with refinement, from the layout's rhs buffers to directions
// (dx, ds, dz, dy). Augmented: rz = r3 - r2 / Sigma already formed, the
// refinement residual of the [x, z, y] system (`refine_residual`).
// Condensed: tmp = W^-1 (r3 - r2 / Sigma) already formed, z eliminated.
template <typename S, bool AUG>
__device__ void reduced_solve(S* sm, const Layout& L, int refine_steps, bool refine_df, S beta,
                              S delta, S* dx, S* ds, S* dz, S* dy) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const S* r1 = sm + L.r1;
  const S* r2 = sm + L.r2;
  const S* r4 = sm + L.r4;
  const S* sig = sm + L.sig;
  const S* w = sm + L.w;
  S* ex = sm + L.ex;
  S* ey = sm + L.ey;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  if constexpr (AUG) {
    S* ezz = sm + L.ezz;
    thomas_solve<S, true>(sm, L, r1, sm + L.rz, r4, dx, dz, dy);
    for (int rs = 0; rs < refine_steps; ++rs) {
      refine_residual(sm, L, refine_df, beta, delta, dx, dz, dy);
      thomas_solve<S, true>(sm, L, sm + L.e1, sm + L.ez, sm + L.e4, ex, ezz, ey);
      for (int it = tid; it < nz + ni + ne; it += nt) {
        if (it < nz) dx[it] += ex[it];
        else if (it < nz + ni) dz[it - nz] += ezz[it - nz];
        else dy[it - nz - ni] += ey[it - nz - ni];
      }
      __syncthreads();
    }
    for (int k = tid; k < ni; k += nt) ds[k] = (r2[k] - dz[k]) / sig[k];
    __syncthreads();
  } else {
    const S* r3 = sm + L.r3;
    const S* hd = sm + L.hd;
    S* r1h = sm + L.r1h;
    S* tmp = sm + L.tmp;
    S* e1 = sm + L.e1;
    S* e4 = sm + L.e4;
    // r1_hat = r1 + G^T (W^-1 (r3 - r2 / Sigma))
    for (int i = tid; i < nz; i += nt) r1h[i] = r1[i] + gT_entry(sm, L, i, tmp);
    __syncthreads();
    thomas_solve<S, false>(sm, L, r1h, nullptr, r4, dx, nullptr, dy);
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
      thomas_solve<S, false>(sm, L, e1, nullptr, e4, ex, nullptr, ey);
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
}

// The outputs may alias the warm state x0, s0, z0, y0 (load_env), so none of
// those pointers is __restrict__.
template <typename S, bool AUG>
__global__ void __launch_bounds__(PDIPM_THREADS) __maxnreg__(MaxRegs<S>::value)
pdipm_tridiag_kernel(
    const S* __restrict__ hd_in, const S* __restrict__ f_in, const S* __restrict__ ad_in,
    const S* __restrict__ bd_in, const S* __restrict__ b_in, const S* __restrict__ gu_in,
    const S* __restrict__ d_in, const S* x0, const S* s0, const S* z0, const S* y0,
    S* x_out, S* s_out, S* z_out, S* y_out, S* res_out, const int* go, int* ran,
    int T, int iterations, int refine_steps, int refine_df, S beta, S delta) {
  if (!gate_open(go, ran)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const Layout L = make_layout<AUG>(T, (int)sizeof(S));
  int* piv = reinterpret_cast<int*>(smem_raw + L.piv);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long env = blockIdx.x;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  S* red = sm + L.red;

  load_env(sm, L, env, hd_in, f_in, ad_in, bd_in, b_in, gu_in, d_in, x0, s0, z0, y0);
  for (int i = tid; i < NX_; i += nt) sm[L.qinv + i] = S(1) / (sm[L.hd + i] + beta);
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
  S* r4 = sm + L.r4;
  S* dxa = sm + L.dxa; S* dsa = sm + L.dsa; S* dza = sm + L.dza; S* dya = sm + L.dya;
  S* dxc = sm + L.dxc; S* dsc = sm + L.dsc; S* dzc = sm + L.dzc; S* dyc = sm + L.dyc;
  const S nif = S(ni);
  const bool df = refine_df != 0;

  for (int iter = 0; iter < iterations; ++iter) {
    // KKT residuals at the current iterate, Sigma, and W = 1 / Sigma + delta
    // (augmented) or W^-1 = Sigma / (1 + delta Sigma) (condensed).
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
        w[k] = AUG ? S(1) / sg + delta : sg / (S(1) + delta * sg);
        part += s[k] * z[k];
      } else {
        const int e = it - nz - ni;
        re[e] = a_entry(sm, L, e, x) - sm[L.b + e];
      }
    }
    const S mu = block_sum(part, red) / nif;  // syncs

    factor<S, AUG>(sm, L, piv, beta, delta);

    // Affine direction: rhs (-rx, -(s z)/s, -rs, -re).
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        r1[it] = -rx[it];
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S v2 = -(s[k] * z[k]) / s[k];
        r2[k] = v2;
        if constexpr (AUG) {
          sm[L.rz + k] = -rsb[k] - v2 / sig[k];
        } else {
          const S v3 = -rsb[k];
          sm[L.r3 + k] = v3;
          sm[L.tmp + k] = w[k] * (v3 - v2 / sig[k]);
        }
      } else {
        r4[it - nz - ni] = -re[it - nz - ni];
      }
    }
    __syncthreads();
    reduced_solve<S, AUG>(sm, L, refine_steps, df, beta, delta, dxa, dsa, dza, dya);
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
        if constexpr (AUG) {
          sm[L.rz + k] = S(0) - v2 / sig[k];
        } else {
          sm[L.r3 + k] = S(0);
          sm[L.tmp + k] = w[k] * (S(0) - v2 / sig[k]);
        }
      } else {
        r4[it - nz - ni] = S(0);
      }
    }
    __syncthreads();
    reduced_solve<S, AUG>(sm, L, refine_steps, df, beta, delta, dxc, dsc, dzc, dyc);
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

template <typename S, bool AUG>
static int launch_tridiag(const void* hd, const void* f, const void* ad, const void* bd,
                          const void* b, const void* gu, const void* d, const void* x0,
                          const void* s0, const void* z0, const void* y0, void* x, void* s,
                          void* z, void* y, void* res, const void* go, void* ran, int batch,
                          int T, int iterations, int refine_steps, int refine_df, double beta,
                          double delta, void* stream) {
  // The compensated residual is an augmented-route option; the condensed
  // entries keep the common argument list, and `pdipm.check_options` refuses
  // df there before any launch, so this guard fires only for a direct C caller.
  if (!AUG && refine_df != 0) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout<AUG>(T, (int)sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(pdipm_tridiag_kernel<S, AUG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  pdipm_tridiag_kernel<S, AUG><<<batch, PDIPM_THREADS, L.bytes, (cudaStream_t)stream>>>(
      (const S*)hd, (const S*)f, (const S*)ad, (const S*)bd, (const S*)b, (const S*)gu,
      (const S*)d, (const S*)x0, (const S*)s0, (const S*)z0, (const S*)y0, (S*)x, (S*)s, (S*)z,
      (S*)y, (S*)res, (const int*)go, (int*)ran, T, iterations, refine_steps, refine_df,
      (S)beta, (S)delta);
  return (int)cudaGetLastError();
}
