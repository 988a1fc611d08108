// The block-Thomas routes' policy for the Newton-step kernel of
// pdipm_common.cuh: pdipm_tridiag.cu (condensed, 26-wide stage blocks, K5a)
// and pdipm_tridiag_aug.cu (augmented, 42-wide, K5b) instantiate one width
// each. Those sources carry the notes on what each replaces and what bounds
// it.
//
// The factor runs T stages in order, each building its N x N block on
// [u (12), z (16, augmented only), nu (2), y (12)] in its own slot of
// shared memory and inverting it there with partial pivoting; the solve is
// the two sweeps through the stored inverses. These routes ignore
// kkt_scale, as the JAX kernel's `factor` / `factor_aug` do.
//
// The clock64() breakdown (`PDIPM_PROFILE` builds) books the factor's
// Ad M_{t-1} and M_t (the chain from stage to stage) to PH_YCHAIN, the stage
// block's build to PH_PT (K5a's warp group: with Ad M_{t-1} Ad^T, formed in
// one pass with the u block), its pivoted elimination to PH_FOOT; the
// solve's forward and backward sweeps to PH_SWEEP and its stage rhs and x
// recovery to PH_STAGE.

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
static __host__ __device__ Layout make_tridiag_layout(int T, int size_of_s) {
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
template <typename S, bool AUG, typename G>
__device__ void thomas_factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta) {
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
    PDIPM_MARK(g, PH_YCHAIN);
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
    PDIPM_MARK(g, PH_PT);
    gj_inverse_pivot<S, N>(a, sm + L.colk, sm + L.prow, sm + L.rowk, piv);
    PDIPM_MARK(g, PH_FOOT);
    for (int it = tid; it < 144; it += nt) {
      const int i = it / NX_, j = it % NX_;
      const S v = qinv[i] * a[(NY + i) * N + NY + j] * qinv[j];
      mp[it] = i == j ? qinv[i] + v : v;
    }
    __syncthreads();
    PDIPM_MARK(g, PH_YCHAIN);
  }
}

// ---------------------------------------------------------------------------
// One two-sweep solve through the stored inverses: (r1, rz, r4) -> (dx, dz,
// dy); rz and dz only on the augmented route.
// ---------------------------------------------------------------------------
template <typename S, bool AUG, typename G>
__device__ void thomas_solve(const G& grp, S* sm, const Layout& L, const S* r1, const S* rz,
                             const S* r4, S* dx, S* dz, S* dy) {
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
  PDIPM_MARK(grp, PH_STAGE);
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
  PDIPM_MARK(grp, PH_SWEEP);
  // x_{t+1} = Q~^-1 (r_x + Ad^T w_y(t+1) - w_y(t)).
  for (int k = tid; k < NX_ * T; k += nt) {
    const int t = k / NX_, i = k % NX_;
    const S rxa = t + 1 < T ? r1[k] + adtw[k] : r1[k];
    dx[k] = qinv[i] * (rxa - dy[k]);
  }
  __syncthreads();
  PDIPM_MARK(grp, PH_STAGE);
}

template <bool AUG_>
struct ThomasRoute {
  static constexpr bool AUG = AUG_;
  using Layout = ::Layout;

  static __host__ __device__ Layout make_layout(int T, int size_of_s) {
    return make_tridiag_layout<AUG>(T, size_of_s);
  }

  // The block group only (its device functions spread over the block).
  template <typename S, typename G>
  static __device__ void setup(const G&, S* sm, const Layout& L, S beta, S delta) {
    static_assert(!G::WARP, "the block-Thomas routes run in the block group");
    for (int i = threadIdx.x; i < NX_; i += blockDim.x) sm[L.qinv + i] = S(1) / (sm[L.hd + i] + beta);
    __syncthreads();
  }

  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags) {
    thomas_factor<S, AUG>(g, sm, L, piv, beta, delta);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    thomas_solve<S, AUG>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};

struct Tridiag : ThomasRoute<false> {};    // K5a, 26-wide, condensed
struct TridiagAug : ThomasRoute<true> {};  // K5b, 42-wide, augmented

// ---------------------------------------------------------------------------
// K5a and K5b in their warp groups (`TridiagWarp`, `TridiagAugWarp`): one
// warp an env, the same factor and solve. Per stage the warp builds the
// N-wide block in registers, lane l holding row l (K5a, N = 26) or rows l
// and l + 32 (K5b, N = 42) (`thomas_entry`, `thomas_aug_entry`), and
// eliminates it with `gj_warp` (a shuffle argmax per pivot, the pivot row
// passed through a shared-memory row, no block barrier in the N-step chain);
// it stores the inverse with the row swaps undone, transposed (entry (r, c)
// at c N + r, so that the lanes of a warp read and write neighbouring
// values), and forms M_t from the y block as it stores it. The lean layouts
// leave f, b and d in device memory, and the T inverses in shared memory or
// in the caller's workspace (`WORKSPACE`, pdipm_common.cuh).
// ---------------------------------------------------------------------------
struct ThomasLeanLayout : Layout {
  int aat;                 // Ad M_{t-1} Ad^T (144)
  int gjr;                 // `gj_warp`'s pivot row (64 / 32 values)
  int uu;                  // the condensed u block R + beta + G^T W_t^-1 G (144)
  size_t work_bytes;       // the T stored inverses' bytes when in the workspace
  unsigned char* wk;       // this env's workspace slice; null: inverses at sinv
};

static __host__ __device__ ThomasLeanLayout make_tridiag_aug_lean_layout(int T, int size_of_s,
                                                                       bool work) {
  constexpr int N = Thomas<true>::N;
  ThomasLeanLayout L;
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
  L.qinv = take(o, NX_); L.sinv = take(o, work ? 0 : T * N * N); L.mp = take(o, 144);
  L.adm = take(o, 144); L.aat = take(o, 144); L.gjr = take(o, 64); L.uu = take(o, 0);
  L.colk = L.prow = L.rowk = take(o, 0);
  L.r1 = take(o, L.nz); L.r2 = take(o, L.ni); L.r4 = take(o, L.ne); L.rz = take(o, L.ni);
  L.r3 = L.tmp = L.r1h = take(o, 0);
  L.e1 = take(o, L.nz); L.ez = take(o, L.ni); L.e4 = take(o, L.ne);
  L.ex = take(o, L.nz); L.ezz = take(o, L.ni); L.ey = take(o, L.ne);
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.g = take(o, T * N); L.adtw = take(o, T * NX_); L.xp = take(o, NX_);
  L.red = take(o, 32);
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv + sizeof(int) * N;
  L.work_bytes = work ? (size_t)T * N * N * size_of_s : 0;
  L.wk = nullptr;
  return L;
}

// K5a's lean layout, condensed and leaner than K5b's: no KKT residual
// buffers (the step forms rx, rs, re where it reads them, `RESIDUALS_FORMED`);
// the refinement solved in place (ex = e1, ey = e4: the solve reads each
// rhs entry before it writes the entry that replaces it); r1_hat in r1 and
// r2, r3 in dsc, dzc, as K2's lean layout has them (`RicSplit`); and one
// union region for what a Newton step needs only inside the factor (M_{t-1},
// Ad M_{t-1}, Ad M_{t-1} Ad^T, the u block, the pivot row) and only after
// it (the rhs, refinement, directions and sweep buffers). At h10 in f32
// that is 17,976 B an env without the stored inverses, 12 envs an SM.
static __host__ __device__ ThomasLeanLayout make_tridiag_lean_layout(int T, int size_of_s,
                                                                   bool work) {
  constexpr int N = Thomas<false>::N;
  ThomasLeanLayout L;
  L.T = T;
  L.nz = 24 * T;
  L.ni = 16 * T;
  L.ne = 14 * T;
  int o = 0;
  L.hd = take(o, L.nz); L.f = take(o, 0); L.ad = take(o, 144); L.bd = take(o, 144);
  L.b = take(o, 0); L.gu = take(o, NI_ * NU_); L.d = take(o, 0);
  L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
  L.rx = L.rs = L.re = take(o, 0);
  L.sig = take(o, L.ni); L.w = take(o, L.ni);
  L.qinv = take(o, NX_); L.sinv = take(o, work ? 0 : T * N * N); L.red = take(o, 4);
  L.colk = L.prow = L.rowk = L.rz = L.ez = L.ezz = take(o, 0);
  const int u = o;
  L.r1 = take(o, L.nz); L.r1h = L.r1; L.r4 = take(o, L.ne); L.tmp = take(o, L.ni);
  L.e1 = take(o, L.nz); L.e4 = take(o, L.ne); L.ex = L.e1; L.ey = L.e4;
  L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
  L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
  L.r2 = L.dsc; L.r3 = L.dzc;
  L.g = take(o, T * N); L.adtw = take(o, T * NX_); L.xp = take(o, NX_);
  int f = u;  // the factor's scratch
  L.mp = take(f, 144); L.adm = take(f, 144); L.aat = take(f, 144); L.gjr = take(f, 32);
  L.uu = take(f, 144);
  o = o > f ? o : f;
  L.total = o;
  L.piv = o * size_of_s;
  L.bytes = (size_t)L.piv + sizeof(int) * N;
  L.work_bytes = work ? (size_t)T * N * N * size_of_s : 0;
  L.wk = nullptr;
  return L;
}

// Entry (r, c) < 12 of stage t's condensed u block R + beta + G^T W_t^-1 G
// (`thomas_factor`'s, term for term: the 16-term sum in the same order, then
// R + beta on its diagonal); hd_u = hd + 12 T, wt = W_t^-1.
template <typename S>
__device__ __forceinline__ S thomas_u_entry(int r, int c, const S* hd_u, const S* gu,
                                            const S* wt, S beta) {
  S v = S(0);
  for (int q = 0; q < NI_; ++q) v += gu[q * NU_ + r] * wt[q] * gu[q * NU_ + c];
  if (r == c) v += hd_u[r] + beta;
  return v;
}

// Entry (r, c) of stage t's condensed block (`thomas_factor`'s): the u block
// from uu (`thomas_u_entry`, formed before), aat = Ad M_{t-1} Ad^T (t >= 1).
template <typename S>
__device__ __forceinline__ S thomas_entry(int r, int c, bool chained, const S* uu, const S* bd,
                                          const S* qinv, const S* aat, S delta) {
  using K = Thomas<false>;
  constexpr int NNU = K::NNU, NY = K::NY;
  S v = S(0);
  if (r < NU_ && c < NU_) {
    v = uu[r * NU_ + c];
  } else if (r >= NY && c >= NY) {
    const int i = r - NY, j = c - NY;
    if (i == j) v = -delta;
    if (chained) v -= aat[i * NX_ + j];
    if (i == j) v -= qinv[i];
  } else if (r < NU_ && c >= NY) {
    v = -bd[(c - NY) * NU_ + r];
  } else if (r >= NY && c < NU_) {
    v = -bd[(r - NY) * NU_ + c];
  } else if (r < NU_ && c >= NNU) {
    v = (r == 6 && c == NNU) || (r == 9 && c == NNU + 1) ? S(1) : S(0);
  } else if (c < NU_ && r >= NNU) {
    v = (c == 6 && r == NNU) || (c == 9 && r == NNU + 1) ? S(1) : S(0);
  } else if (r >= NNU && c >= NNU) {
    v = r == c ? -delta : S(0);
  }
  return v;
}

// Entry (r, c) of stage t's augmented block (`thomas_factor`'s, term for
// term); hd_u = hd + 12 T, wt = W_t, aat = Ad M_{t-1} Ad^T (t >= 1).
template <typename S>
__device__ __forceinline__ S thomas_aug_entry(int r, int c, bool chained, const S* hd_u,
                                              const S* gu, const S* wt, const S* bd,
                                              const S* qinv, const S* aat, S beta, S delta) {
  using K = Thomas<true>;
  constexpr int NNU = K::NNU, NY = K::NY;
  S v = S(0);
  if (r < NU_ && c < NU_) {
    if (r == c) v += hd_u[r] + beta;
  } else if (r >= NY && c >= NY) {
    const int i = r - NY, j = c - NY;
    if (i == j) v = -delta;
    if (chained) v -= aat[i * NX_ + j];
    if (i == j) v -= qinv[i];
  } else if (r < NU_ && c >= NY) {
    v = -bd[(c - NY) * NU_ + r];
  } else if (r >= NY && c < NU_) {
    v = -bd[(r - NY) * NU_ + c];
  } else if (r < NU_ && c >= NNU) {
    v = (r == 6 && c == NNU) || (r == 9 && c == NNU + 1) ? S(1) : S(0);
  } else if (c < NU_ && r >= NNU) {
    v = (c == 6 && r == NNU) || (c == 9 && r == NNU + 1) ? S(1) : S(0);
  } else if (r >= NNU && c >= NNU) {
    v = r == c ? -delta : S(0);
  } else if (r < NU_) {
    v = gu[(c - NU_) * NU_ + r];
  } else if (c < NU_) {
    v = gu[(r - NU_) * NU_ + c];
  } else if (r == c) {
    v = -wt[r - NU_];
  }
  return v;
}

// The stored inverses: in the workspace slice, or at sinv.
template <typename S>
__device__ __forceinline__ S* thomas_inverses(S* sm, const ThomasLeanLayout& L) {
  return L.wk != nullptr ? reinterpret_cast<S*>(L.wk) : sm + L.sinv;
}

template <bool AUG, typename S, typename G>
__device__ void thomas_factor_warp(const G& g, S* sm, const ThomasLeanLayout& L, int* piv, S beta,
                                   S delta) {
  static_assert(G::THREADS == 32, "the block-Thomas warp groups are one warp");
  using K = Thomas<AUG>;
  constexpr int N = K::N, NY = K::NY;
  constexpr int R = AUG ? 2 : 1;  // rows a lane holds
  const int lane = g.rank(), T = L.T;
  const S* hd_u = sm + L.hd + NX_ * T;
  const S* gu = sm + L.gu;
  const S* w = sm + L.w;
  const S* ad = sm + L.ad;
  const S* bd = sm + L.bd;
  const S* qinv = sm + L.qinv;
  S* mp = sm + L.mp;
  S* adm = sm + L.adm;
  S* aat = sm + L.aat;
  S* uu = sm + L.uu;
  S* sinv = thomas_inverses(sm, L);
  for (int t = 0; t < T; ++t) {
    const S* wt = w + t * NI_;
    if (t >= 1) {
      for (int it = lane; it < 144; it += 32) {
        const int i = it / NX_, k = it % NX_;
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * mp[l * NX_ + k];
        adm[it] = acc;
      }
      g.sync();
    }
    if constexpr (AUG) {
      if (t >= 1) {
        for (int it = lane; it < 144; it += 32) {
          const int i = it / NX_, j = it % NX_;
          S acc = S(0);
          for (int k = 0; k < NX_; ++k) acc += adm[i * NX_ + k] * ad[j * NX_ + k];
          aat[it] = acc;
        }
        g.sync();
      }
      PDIPM_MARK(g, PH_YCHAIN);
    } else {
      // Ad M_{t-1} Ad^T (t >= 1) and the u block in one pass (booked to the
      // build, pt), spread over the warp (`thomas_u_entry`), not summed by
      // the 12 lanes of its rows.
      PDIPM_MARK(g, PH_YCHAIN);
      for (int it = (t >= 1 ? 0 : 144) + lane; it < 288; it += 32) {
        const int k = it % 144, i = k / NX_, j = k % NX_;
        if (it < 144) {
          S acc = S(0);
          for (int l = 0; l < NX_; ++l) acc += adm[i * NX_ + l] * ad[j * NX_ + l];
          aat[k] = acc;
        } else {
          uu[k] = thomas_u_entry(i, j, hd_u, gu, wt, beta);
        }
      }
      g.sync();
    }
    S a[R][N];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int r = lane + 32 * s, rr = r < N ? r : N - 1;  // idle slots read row N - 1
#pragma unroll
      for (int c = 0; c < N; ++c) {
        S v;
        if constexpr (AUG) {
          v = thomas_aug_entry(rr, c, t >= 1, hd_u, gu, wt, bd, qinv, aat, beta, delta);
        } else {
          v = thomas_entry(rr, c, t >= 1, uu, bd, qinv, aat, delta);
        }
        a[s][c] = r < N ? v : S(0);
      }
    }
    PDIPM_MARK(g, PH_PT);
    int pos[R], q[R];
    gj_warp<N, R>(a, pos, true, false, piv, sm + L.gjr);
    gj_warp_columns<N, R>(q, true, piv);
    // Store row pos[s], column q(j) at c N + r; M_t = Q~^-1 + Q~^-1 N_yy Q~^-1
    // from the y block as it passes.
    S* inv = sinv + (size_t)t * N * N;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = __shfl_sync(0xffffffffu, q[j >> 5], j & 31);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int r = pos[s];
        if (r < N) {
          inv[c * N + r] = a[s][j];
          if (r >= NY && c >= NY) {
            const int i = r - NY, k = c - NY;
            const S v = qinv[i] * a[s][j] * qinv[k];
            mp[i * NX_ + k] = i == k ? qinv[i] + v : v;
          }
        }
      }
    }
    g.sync();
    PDIPM_MARK(g, PH_FOOT);
  }
}

// `thomas_solve` in the warp group, through the transposed stored inverses.
template <bool AUG, typename S, typename G>
__device__ void thomas_solve_warp(const G& grp, S* sm, const ThomasLeanLayout& L, const S* r1,
                                  const S* rz, const S* r4, S* dx, S* dz, S* dy) {
  using K = Thomas<AUG>;
  constexpr int N = K::N, NNU = K::NNU, NY = K::NY;
  const int tid = grp.rank(), nt = grp.size(), T = L.T;
  const S* ad = sm + L.ad;
  const S* qinv = sm + L.qinv;
  const S* sinv = thomas_inverses(sm, L);
  S* g = sm + L.g;
  S* adtw = sm + L.adtw;
  S* xp = sm + L.xp;

  // Stage rhs [u, z, nu, y - Q~^-1 x].
  for (int it = tid; it < T * N; it += nt) {
    const int t = it / N, r = it % N;
    S v;
    if (r < NU_) v = r1[NX_ * T + NU_ * t + r];
    else if (AUG && r < NNU) v = rz[NI_ * t + r - NU_];
    else if (r < NY) v = r4[NX_ * T + NMX_ * t + r - NNU];
    else v = r4[NX_ * t + r - NY] - qinv[r - NY] * r1[NX_ * t + r - NY];
    g[it] = v;
  }
  grp.sync();
  PDIPM_MARK(grp, PH_STAGE);
  // Forward: g_t[y] += Ad x_{t-1}; x_t = Q~^-1 (r_x - (S_t^-1 g_t)[y]).
  for (int t = 0; t < T; ++t) {
    S* gt = g + t * N;
    if (t >= 1) {
      for (int i = tid; i < NX_; i += nt) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += ad[i * NX_ + l] * xp[l];
        gt[NY + i] += acc;
      }
      grp.sync();
    }
    if (t + 1 < T) {
      for (int i = tid; i < NX_; i += nt) {
        const S* col = sinv + (size_t)t * N * N + NY + i;
        S acc = S(0);
        for (int j = 0; j < N; ++j) acc += col[j * N] * gt[j];
        xp[i] = qinv[i] * (r1[NX_ * t + i] - acc);
      }
      grp.sync();
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
      grp.sync();
    }
    for (int o = tid; o < N; o += nt) {
      const S* col = sinv + (size_t)t * N * N + o;
      S acc = S(0);
      for (int j = 0; j < N; ++j) acc += col[j * N] * gt[j];
      if (o < NU_) dx[NX_ * T + NU_ * t + o] = acc;
      else if (AUG && o < NNU) dz[NI_ * t + o - NU_] = acc;
      else if (o < NY) dy[NX_ * T + NMX_ * t + o - NNU] = acc;
      else dy[NX_ * t + o - NY] = acc;
    }
    grp.sync();
  }
  PDIPM_MARK(grp, PH_SWEEP);
  // x_{t+1} = Q~^-1 (r_x + Ad^T w_y(t+1) - w_y(t)).
  for (int k = tid; k < NX_ * T; k += nt) {
    const int t = k / NX_, i = k % NX_;
    const S rxa = t + 1 < T ? r1[k] + adtw[k] : r1[k];
    dx[k] = qinv[i] * (rxa - dy[k]);
  }
  grp.sync();
  PDIPM_MARK(grp, PH_STAGE);
}

// The block-Thomas policies in their warp group (`WarpGroup<1>`), the lean
// layouts above: K5b's (AUG) keeps its KKT residual buffers, K5a's forms
// them where read.
template <bool AUG_>
struct ThomasWarp {
  static constexpr bool AUG = AUG_;
  // pdipm_common.cuh's LeanPolicy (f, b, d in device memory) and WorkPolicy
  static constexpr bool INPUTS_IN_GLOBAL = true, RESIDUALS_FORMED = !AUG_;
  static constexpr bool WORKSPACE = true;
  using Layout = ThomasLeanLayout;

  static __host__ __device__ Layout make_layout(int T, int size_of_s, bool work = false) {
    return AUG ? make_tridiag_aug_lean_layout(T, size_of_s, work)
               : make_tridiag_lean_layout(T, size_of_s, work);
  }

  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    for (int i = g.rank(); i < NX_; i += g.size()) sm[L.qinv + i] = S(1) / (sm[L.hd + i] + beta);
    g.sync();
  }

  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags) {
    thomas_factor_warp<AUG>(g, sm, L, piv, beta, delta);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    thomas_solve_warp<AUG>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};

struct TridiagAugWarp : ThomasWarp<true> {};  // K5b
struct TridiagWarp : ThomasWarp<false> {      // K5a, capped for 12 envs an SM in f32
  static constexpr int REGS32 = 168;
};
