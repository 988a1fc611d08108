// The foot-split Riccati routes, unpacked and packed: the route policies of
// K2 (`Ric`, pdipm_ric.cu) and K1 (`RicAug`, pdipm_ric_aug.cu), and of their
// packed twins K5e-c (`RicPack`, pdipm_ric_pack.cu) and K5e-a (`RicAugPack`,
// pdipm_ric_aug_pack.cu), one template each with the packing a compile-time
// flag, so that K1's and K2's builds hold none of the packed code. A second
// flag, LEAN, gives all four the layout of their warp groups (`RicLean`,
// `RicAugLean`, `RicPackLean`, `RicAugPackLean`; pdipm_common.cuh's
// `WarpGroup`): the same factor and solve, with the buffers one step does
// not need at once sharing memory (`make_layout` says which).
//
// Split (`foot_split=True`, `factor_ric_split:647`, `factor_ric_aug_split:735`):
// per stage the [u, nu] (condensed) or [u, z, nu] (augmented) block splits
// exactly by foot into two blocks on u columns {0,1,2,7} / {3,4,5,10} (with
// that foot's 8 z rows when augmented), two W-independent [M_x, nu] 2x2 pairs
// and two M_z scalars. The unpacked routes store the 2T foot-block inverses
// one after another, block foot * T + t.
//
// Packed (`foot_pack`, `:675-709`, `:791-823`): per stage the two feet's
// blocks are one row-major (N, 2N) pair [K_L | K_R], N = 4 or 12, so that a
// stage row of the inverse is 2N contiguous values; on the TPU packing was a
// sublane-occupancy lever, and the card's counterpart is this layout. With
// foot_pack True the pair is inverted by one paired elimination (`gj_pair`:
// both halves of every stage in each barrier step, per-half pivot search and
// row swaps, the pivot row scaled by its reciprocal, as `_gj_pair_inplace`
// and `_gj_pair_pivot` do; in the warp groups K5e-c inverts each 4x4 half in
// one lane's registers and K5e-a each 12 x 12 pair in one warp, with that
// arithmetic); with "apply" each half is inverted as the unpacked route
// inverts its block and stored packed. The K^-1 apply reads a
// stage row's half as one contiguous run, and Bd K^-1 Bd^T is the packed
// contraction of `_split_bkb_pack` (`:630-645`): P_t = [Bd_L K_L^-1 |
// Bd_R K_R^-1] over the {F, M_y} corners, summed over its 8 columns against
// [Bd_L | Bd_R], plus the W-independent columns. K2 sums it in that order
// too, so K5e-c and K2 differ only where their inverses do. As in the JAX
// kernel, the packed routes ignore kkt_scale.

#pragma once

#include "pdipm_riccati.cuh"

// In-place Jordan inverse of one 4x4 SPD matrix held by the calling thread,
// natural pivot order; the pivot entry of the inverse is written as 1/pivot
// and the pivot row is scaled by it (`recip`, gj_form="inplace") or divided
// by the pivot ("tableau").
template <typename S>
__device__ __forceinline__ void inverse4_nopivot(S* a, bool recip) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const S pv = a[k * 4 + k];
    const S ipv = S(1) / pv;
    S colk[4], prow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) colk[i] = a[i * 4 + k];
    if (recip) {
#pragma unroll
      for (int j = 0; j < 4; ++j) prow[j] = j == k ? ipv : ipv * a[k * 4 + j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) prow[j] = j == k ? ipv : a[k * 4 + j] / pv;
    }
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

// (a_ij d_i) d_j over one 4x4 block held by the calling thread.
template <typename S>
__device__ __forceinline__ void scale4(S* a, const S* dj) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i * 4 + j] = a[i * 4 + j] * dj[i] * dj[j];
}

// Y'_t from the feet's {F, M_y} inverse corners, the packed contraction of
// `_split_bkb_pack`: P_t[i][a] = (Bd_f K_f^-1)[i][a % 4], f = a / 4, then
// Y'_t = yc - P_t [Bd_L | Bd_R]^T - [t >= 1] Ad Q~^-1 Ad^T (yc holds -delta I
// - Q~^-1 and the W-independent columns, `riccati_setup`), then the y-chain.
// Row r of foot f's inverse at stage t starts at L.ka + P::krow(T, f, t, r).
template <typename P, typename S, typename Layout, typename G>
__device__ void y_chain_packed(const G& g, S* sm, const Layout& L, bool gj_inplace, int* piv) {
  const int tid = g.rank(), nt = g.size(), T = L.T;
  const S* bd = sm + L.bd;
  const S* k = sm + L.ka;
  S* m = sm + L.yp;  // Y'_t: m itself in the block layouts
  S* p = sm + L.p;
  for (int it = tid; it < T * NX_ * 8; it += nt) {
    const int t = it / (NX_ * 8), i = (it / 8) % NX_, a = it % 8, foot = a / 4;
    S v = S(0);
    for (int bb = 0; bb < 4; ++bb)
      v += bd[i * NU_ + foot_col(foot, bb)] * k[P::krow(T, foot, t, bb) + a % 4];
    p[it] = v;
  }
  g.sync();
  for (int it = tid; it < T * 144; it += nt) {
    const int t = it / 144, i = (it % 144) / NX_, l = it % NX_;
    const S* pt = p + (t * NX_ + i) * 8;
    S bkb = S(0);
    for (int a = 0; a < 8; ++a) bkb += pt[a] * bd[l * NU_ + foot_col(a / 4, a % 4)];
    S v = sm[L.yc + i * NX_ + l] - bkb;
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

// ---------------------------------------------------------------------------
// Condensed split: K2 (PACK false) and K5e-c (PACK true). Per foot the 4x4
// SPD block G_f^T diag(W^-1_f) G_f + diag(r_f + beta), inverted without
// pivoting (k_pivot does not apply to the split). The lean layouts of both
// hold the same values: the packing moves only where a stage row of an
// inverse starts (`krow`).
// ---------------------------------------------------------------------------
template <bool PACK, bool LEAN = false>
struct RicSplit {
  static constexpr bool AUG = false;
  // pdipm_common.cuh's LeanPolicy: f, b, d in device memory when lean
  static constexpr bool INPUTS_IN_GLOBAL = LEAN, RESIDUALS_FORMED = false;
  // pdipm_common.cuh's BlockOrderPolicy: K5e-c's warp group sums mu and the
  // residual norms as its block group does, so that it gives that group's
  // bits (the arithmetic is otherwise the same entry for entry). Summed in
  // the warp's own order, as K2's warp group sums, the f64 result read
  // 4.1e-8 from the plain version on the converged envs of chip_smoke's
  // batch, over the condensed class's 3e-8; the block group's order reads
  // 2.2e-8 (PERF.md, Findings). K2's warp group keeps its own order.
  static constexpr bool BLOCK_ORDER_SUMS = PACK && LEAN;

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
    // factors: 2T foot-block inverses (4x4; packed, T pairs of 4 x 8), T
    // y-chain inverses, Y'_t (m itself but in the lean layout), P_t =
    // Bd_f K_f^-1, elimination scratch
    int ka, m, yp, p, colk, prow, q1;
    // reduced-solve rhs, refinement, directions
    int r1, r2, r3, r4, r1h, tmp, e1, e4, ex, ey;
    int dxa, dsa, dza, dya, dxc, dsc, dzc, dyc;
    // sweep scratch
    int run, kr, g, wy, v12, red;
    int total;      // values of S
    int piv;        // byte offset of the (empty) int pivot table
    size_t bytes;   // total bytes
  };

  // Offset in `ka` of row r of foot's inverse at stage t (4 values).
  static __host__ __device__ __forceinline__ int krow(int T, int foot, int t, int r) {
    return PACK ? t * 32 + r * 8 + foot * 4 : (foot * T + t) * 16 + r * 4;
  }

  // The block layout (every buffer its own), or with LEAN the warp group's:
  // f, b and d left in device memory, the refinement solved in place
  // (ex = e1, ey = e4), r2, r3 and r1_hat in dsc, dzc and r1 (each read
  // entry by entry where the solve writes the entry that replaces it), and
  // one union region for what a Newton step needs only
  // inside the factor (P_t, Y'_t, Ad Q~^-1 Ad^T, yc and the chain's q1) and
  // only after it (the rhs, refinement, directions and sweep buffers).
  static __host__ __device__ Layout make_layout(int T, int size_of_s) {
    Layout L;
    L.T = T;
    L.nz = 24 * T;
    L.ni = 16 * T;
    L.ne = 14 * T;
    // the paired elimination's scratch: one column and one row per half
    const int nk = PACK && 8 * T > NX_ ? 8 * T : NX_;
    const int fbd = LEAN ? 0 : 1;
    int o = 0;
    L.hd = take(o, L.nz); L.f = take(o, fbd * L.nz); L.ad = take(o, 144); L.bd = take(o, 144);
    L.b = take(o, fbd * L.ne); L.gu = take(o, NI_ * NU_); L.d = take(o, fbd * L.ni);
    L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
    L.rx = take(o, L.nz); L.rs = take(o, L.ni); L.re = take(o, L.ne);
    L.sig = take(o, L.ni); L.w = take(o, L.ni);
    L.qinv = take(o, NX_); L.sc = take(o, 144);
    L.adqad = take(o, LEAN ? 0 : 144); L.yc = take(o, LEAN ? 0 : 144);
    L.cf = take(o, 8);
    if constexpr (LEAN) {
      L.ka = take(o, 2 * T * 16); L.m = take(o, T * 144); L.red = take(o, 4);
      const int u = o;
      L.r1 = take(o, L.nz); L.r4 = take(o, L.ne);
      L.r1h = L.r1;  // r1 is read once, entry by entry, where r1_hat is formed
      L.tmp = take(o, L.ni);
      L.e1 = take(o, L.nz); L.e4 = take(o, L.ne); L.ex = L.e1; L.ey = L.e4;
      L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
      L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
      L.r2 = L.dsc; L.r3 = L.dzc;
      L.run = take(o, T * NUN_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
      L.wy = take(o, T * NX_); L.v12 = take(o, 0);
      int f = u;  // with Ad Q~^-1 Ad^T and yc formed anew each factor
      L.p = take(f, T * NX_ * 8); L.yp = take(f, T * 144); L.q1 = take(f, 144);
      L.adqad = take(f, 144); L.yc = take(f, 144);
      L.colk = L.prow = f;  // unused
      o = o > f ? o : f;
      L.total = o;
      L.piv = o * size_of_s;
      L.bytes = (size_t)L.piv;
    } else {
      L.ka = take(o, 2 * T * 16); L.m = take(o, T * 144); L.p = take(o, T * NX_ * 8);
      L.yp = L.m;
      L.colk = take(o, nk); L.prow = take(o, nk); L.q1 = take(o, 144);
      L.r1 = take(o, L.nz); L.r2 = take(o, L.ni); L.r3 = take(o, L.ni); L.r4 = take(o, L.ne);
      L.r1h = take(o, L.nz); L.tmp = take(o, L.ni);
      L.e1 = take(o, L.nz); L.e4 = take(o, L.ne); L.ex = take(o, L.nz); L.ey = take(o, L.ne);
      L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
      L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
      L.run = take(o, T * NUN_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
      L.wy = take(o, T * NX_); L.v12 = take(o, NX_); L.red = take(o, PDIPM_THREADS);
      L.total = o;
      L.piv = o * size_of_s;
      L.bytes = (size_t)L.piv;
    }
    return L;
  }

  // q_inv, S, Ad Q~^-1 Ad^T, the [M_x, nu] pair / M_z coefficients and yc.
  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<true, true>(g, sm, L, beta, delta);
  }

  // Row o (< 14) of K_t^-1 r, r = [u(12), nu(2)].
  template <typename S>
  static __device__ __forceinline__ S kinv_row(const S* sm, const Layout& L, int t, int o,
                                               const S* r) {
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
    const S* k = sm + L.ka + krow(L.T, foot, t, a);
    S acc = S(0);
    for (int bb = 0; bb < 4; ++bb) acc += k[bb] * r[foot_col(foot, bb)];
    return acc;
  }

  // Factorization of the condensed KKT at the current W^-1.
  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags ff) {
    const int tid = g.rank(), nt = g.size(), T = L.T;
    const S* hd = sm + L.hd;
    const S* gu = sm + L.gu;
    const S* w = sm + L.w;
    S* ka = sm + L.ka;
    // Inverted in registers, one block per thread: the unpacked route, the
    // packed one in its warp group, and in the block group with "apply"; the
    // block group's pair is inverted after, together (`gj_pair`).
    const bool in_regs = LEAN || !PACK || ff.foot_pack == FOOT_PACK_APPLY;

    // Foot blocks G_f^T diag(W^-1_f) G_f + diag(r_f + beta), block foot*T + t,
    // equilibrated around the inverse when `jacobi` (`pdipm_pallas.py:712`;
    // the packed route ignores it, `:680`).
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
      if (in_regs) {
        // One inlined copy of the unrolled inverse: with a second one in an
        // else branch, nvcc spilled 48 B in f32 and the kernel ran 15% slower.
        const bool jacobi = !PACK && ff.jacobi;
        // The packed warp group's pair: each half is gj_pair's arithmetic,
        // the pivot row scaled by its reciprocal whatever gj_form says.
        const bool recip = (PACK && LEAN && ff.foot_pack == FOOT_PACK_PAIR) || ff.gj_inplace;
        S dj[4];
        if (jacobi) {
#pragma unroll
          for (int i = 0; i < 4; ++i) dj[i] = jacobi_d(a[i * 4 + i]);
          scale4(a, dj);
        }
        inverse4_nopivot(a, recip);
        if (jacobi) scale4(a, dj);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[krow(T, foot, t, i) + j] = a[i * 4 + j];
    }
    if constexpr (LEAN) {
      // Ad Q~^-1 Ad^T and yc into the union, as riccati_setup forms them.
      for (int it = tid; it < 288; it += nt) {
        const int k = it % 144, i = k / NX_, j = k % NX_;
        sm[(it < 144 ? L.adqad : L.yc) + k] =
            it < 144 ? adqad_entry(sm, L, i, j) : yc_entry(sm, L, i, j, delta);
      }
    }
    g.sync();
    if constexpr (!LEAN)
      if (!in_regs) gj_pair<4>(g, ka, T, false, sm + L.colk, sm + L.prow, piv);
    PDIPM_MARK(g, PH_FOOT);
    y_chain_packed<RicSplit>(g, sm, L, ff.gj_inplace, piv);
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    riccati_solve<RicSplit>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};

// ---------------------------------------------------------------------------
// Augmented split: K1 (PACK false) and K5e-a (PACK true). Per foot the 12x12
// block [[diag(r + beta), G_f^T], [G_f, -diag(W_f)]] on [F (3), M_y (1),
// z_f (8)], inverted with a per-block partial-pivot search unless aug_pivot
// is off (natural order then, NaN on stress problems by design).
// ---------------------------------------------------------------------------
static constexpr int NF_ = 12;  // width of a foot block [F (3), M_y (1), z_f (8)]

// The foot blocks' elimination in the warp group of K1 (PACK false) and of
// K5e-a (PACK true), one warp a stage: warp w takes stages t = w, w + 2, ...
// < T, and lane 16 h + i (i < 12) loads row i of foot h's block at stage t,
// so both blocks of a stage run in one elimination in registers
// (`gj_pair_regs`: each block its own shuffle argmax per pivot, the pivot
// row passed by shuffles, no shared memory or barrier in the chain), and
// stores its row at its position with the columns unpermuted. The layout
// fixes where a block's rows lie: K5e-a's pair [K_L | K_R] is 12 rows of 24
// values (half h at column 12 h), K1's blocks are 12 x 12 one after another,
// block h T + t. gj_inverse_inplace's arithmetic entry for entry: the pivot
// row times the pivot's reciprocal when `recip`, else divided by the pivot,
// its pivot entry 1 / pivot.
template <bool PACK, typename S, typename G>
__device__ void gj_pair_warp(const G& g, S* ka, int T, bool pivot, bool recip) {
  constexpr int N = NF_, LD = PACK ? 2 * NF_ : NF_;
  const int warp = g.rank() >> 5, lane = g.rank() & 31, h = lane >> 4, i = lane & 15;
  const int hoff = PACK ? N : T * N * N;  // from foot 0's block to foot 1's
  const bool live = i < N;
  for (int t = warp; t < T; t += G::THREADS / 32) {
    S* half = ka + t * N * LD + h * hoff;
    S a[N];
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = half[(live ? i : N - 1) * LD + j];
    int pos, q;
    gj_pair_regs<N>(a, pivot, recip, pos, q);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = __shfl_sync(0xffffffffu, q, (h << 4) | j);
      if (live) half[pos * LD + c] = a[j];
    }
    __syncwarp();
  }
  g.sync();
}

template <bool PACK, bool LEAN = false>
struct RicAugSplit {
  static constexpr bool AUG = true;
  // pdipm_common.cuh's LeanPolicy: f, b, d in device memory and the KKT
  // residuals formed where read, when lean
  static constexpr bool INPUTS_IN_GLOBAL = LEAN, RESIDUALS_FORMED = LEAN;

  // Index layout of all per-env buffers in shared memory (in values of S).
  struct Layout {
    int T, nz, ni, ne;
    // inputs
    int hd, f, ad, bd, b, gu, d;
    // iterates and residuals
    int x, s, z, y, rx, rs, re, sig, w;
    // constants of the solve: q_inv, S = Q~^-1 Ad^T, Ad Q~^-1 Ad^T, the
    // packed route's yc (`RicSplit`), 2x2 / 1x1 coefficients
    int qinv, sc, adqad, yc, cf;
    // factors: 2T foot-block inverses (packed, T pairs of 12 x 24), T y-chain
    // inverses, Y'_t (yp: m itself in the block layouts), P_t, the block
    // layouts' elimination scratch (colk, prow) and Jacobi's D (dj)
    int ka, m, yp, p, colk, prow, q1, dj;
    // reduced-solve rhs / directions
    int r1, rz, r4, r2, e1, ez, e4, ex, ezz, ey;
    int dxa, dsa, dza, dya, dxc, dsc, dzc, dyc;
    // sweep scratch
    int run, kr, g, wy, v12, red;
    int total;      // values of S
    int piv;        // byte offset of the int pivot table
    size_t bytes;   // total bytes
  };

  // Offset in `ka` of row r of foot's inverse at stage t (12 values).
  static __host__ __device__ __forceinline__ int krow(int T, int foot, int t, int r) {
    return PACK ? t * 2 * 144 + r * 2 * NF_ + foot * NF_ : (foot * T + t) * 144 + r * NF_;
  }

  // The block layout (every buffer its own), or with LEAN the warp group's:
  // f, b and d left in device memory and no KKT residual buffers (the step
  // forms rx, rs, re where it reads them), the refinement solved in place
  // (ex = e1, ezz = ez, ey = e4), r2 in dsc (ds = (r2 - dz) / Sigma reads it
  // entry by entry where it writes the solve's ds, dsa or dsc), and one union
  // region for what a Newton step needs only inside the factor (P_t, Y'_t,
  // Ad Q~^-1 Ad^T, the packed route's yc, both formed anew each factor, and
  // the chain's q1) and only after it (the rhs, refinement, directions and
  // sweep buffers); the packed route's P_t is its 8 columns a row (T x 96).
  // The foot blocks are eliminated in registers (`gj_pair_warp`): Jacobi's D
  // lies in m, which the factor rewrites after it, and the pivot table is
  // empty. The inverses stay whole: the unrefined solves of the corrector
  // forms carry the rounding of whichever triangle a half would keep
  // (PERF.md, Findings).
  static __host__ __device__ Layout make_layout(int T, int size_of_s) {
    Layout L;
    L.T = T;
    L.nz = 24 * T;
    L.ni = 16 * T;
    L.ne = 14 * T;
    const int kept = LEAN ? 0 : 1;  // f, b, d, rx, rs, re, Ad Q~^-1 Ad^T
    int o = 0;
    L.hd = take(o, L.nz); L.f = take(o, kept * L.nz); L.ad = take(o, 144); L.bd = take(o, 144);
    L.b = take(o, kept * L.ne); L.gu = take(o, NI_ * NU_); L.d = take(o, kept * L.ni);
    L.x = take(o, L.nz); L.s = take(o, L.ni); L.z = take(o, L.ni); L.y = take(o, L.ne);
    L.rx = take(o, kept * L.nz); L.rs = take(o, kept * L.ni); L.re = take(o, kept * L.ne);
    L.sig = take(o, L.ni); L.w = take(o, L.ni);
    L.qinv = take(o, NX_); L.sc = take(o, 144); L.adqad = take(o, kept * 144);
    L.yc = take(o, PACK && !LEAN ? 144 : 0); L.cf = take(o, 8);
    if constexpr (LEAN) {
      L.ka = take(o, 2 * T * 144); L.m = take(o, T * 144); L.red = take(o, 4);
      const int u = o;
      L.r1 = take(o, L.nz); L.rz = take(o, L.ni); L.r4 = take(o, L.ne);
      L.e1 = take(o, L.nz); L.ez = take(o, L.ni); L.e4 = take(o, L.ne);
      L.ex = L.e1; L.ezz = L.ez; L.ey = L.e4;
      L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
      L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
      L.r2 = L.dsc;
      L.run = take(o, T * NKA_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
      L.wy = take(o, T * NX_); L.v12 = take(o, 0);
      L.dj = L.m;  // 24 T of m's 144 T
      L.colk = L.prow = L.m;  // unused
      int fb = u;  // the y-chain's factor, with Ad Q~^-1 Ad^T (and yc) formed anew
      L.p = take(fb, PACK ? T * NX_ * 8 : T * 144); L.yp = take(fb, T * 144);
      L.q1 = take(fb, 144); L.adqad = take(fb, 144);
      if constexpr (PACK) L.yc = take(fb, 144);
      o = o > fb ? o : fb;
      L.total = o;
      L.piv = o * size_of_s;
      L.bytes = (size_t)L.piv;
    } else {
      L.ka = take(o, 2 * T * 144); L.m = take(o, T * 144); L.p = take(o, T * 144);
      L.yp = L.m;
      L.colk = take(o, 2 * T * NF_); L.prow = take(o, 2 * T * NF_); L.q1 = take(o, 144);
      L.r1 = take(o, L.nz); L.rz = take(o, L.ni); L.r4 = take(o, L.ne); L.r2 = take(o, L.ni);
      L.e1 = take(o, L.nz); L.ez = take(o, L.ni); L.e4 = take(o, L.ne);
      L.ex = take(o, L.nz); L.ezz = take(o, L.ni); L.ey = take(o, L.ne);
      L.dxa = take(o, L.nz); L.dsa = take(o, L.ni); L.dza = take(o, L.ni); L.dya = take(o, L.ne);
      L.dxc = take(o, L.nz); L.dsc = take(o, L.ni); L.dzc = take(o, L.ni); L.dyc = take(o, L.ne);
      L.run = take(o, T * NKA_); L.kr = take(o, T * NU_); L.g = take(o, T * NX_);
      L.wy = take(o, T * NX_); L.v12 = take(o, NX_); L.red = take(o, PDIPM_THREADS);
      L.dj = L.run;  // `run` holds Jacobi's D during the factor
      L.total = o;
      L.piv = o * size_of_s;
      L.bytes = (size_t)L.piv + sizeof(int) * 2 * T * NF_;
    }
    return L;
  }

  // q_inv, S, Ad Q~^-1 Ad^T, the [M_x, nu] pair / M_z coefficients (and the
  // packed block layout's yc; the lean one forms it in each factor).
  template <typename S, typename G>
  static __device__ void setup(const G& g, S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<true, PACK && !LEAN>(g, sm, L, beta, delta);
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
    const S* k = sm + L.ka + krow(L.T, foot, t, a);
    const int zoff = 12 + 8 * foot;
    S acc = S(0);
    for (int bb = 0; bb < 4; ++bb) acc += k[bb] * r[foot_col(foot, bb)];
    for (int bb = 0; bb < 8; ++bb) acc += k[4 + bb] * r[zoff + bb];
    return acc;
  }

  // -------------------------------------------------------------------------
  // Factorization of the reduced KKT at the current W.
  // -------------------------------------------------------------------------
  template <typename S, typename G>
  static __device__ void factor(const G& g, S* sm, const Layout& L, int* piv, S beta, S delta,
                                FactorFlags ff) {
    const int tid = g.rank(), nt = g.size(), T = L.T;
    const S* hd = sm + L.hd;
    const S* gu = sm + L.gu;
    const S* w = sm + L.w;
    S* ka = sm + L.ka;

    if constexpr (LEAN) {
      // Foot blocks [[diag(r + beta), G_f^T], [G_f, -diag(W_f)]], block
      // foot*T + t (packed: half foot of pair t), one row per item; then
      // their elimination, one warp a stage.
      for (int it = tid; it < 2 * T * NF_; it += nt) {
        const int blk = it / NF_, r = it % NF_;
        const int foot = blk >= T ? 1 : 0, t = blk - foot * T;
        S* row = PACK ? ka + krow(T, foot, t, r) : ka + blk * 144 + r * NF_;
        if (r < 4) {
          const int ur = foot_col(foot, r);
#pragma unroll
          for (int c = 0; c < 4; ++c) row[c] = r == c ? hd[NX_ * T + ur] + beta : S(0);
#pragma unroll
          for (int c = 4; c < NF_; ++c) row[c] = gu[(8 * foot + c - 4) * NU_ + ur];
        } else {
          const S* gr = gu + (8 * foot + r - 4) * NU_;
#pragma unroll
          for (int c = 0; c < 4; ++c) row[c] = gr[foot_col(foot, c)];
          const S wr = -w[t * NI_ + 8 * foot + r - 4];
#pragma unroll
          for (int c = 4; c < NF_; ++c) row[c] = r == c ? wr : S(0);
        }
      }
      if constexpr (PACK) {
        // Ad Q~^-1 Ad^T and yc into the union, as riccati_setup forms them.
        for (int it = tid; it < 288; it += nt) {
          const int k = it % 144, i = k / NX_, j = k % NX_;
          sm[(it < 144 ? L.adqad : L.yc) + k] =
              it < 144 ? adqad_entry(sm, L, i, j) : yc_entry(sm, L, i, j, delta);
        }
      }
      g.sync();
      // Packed: the pair's halves (True: the pivot row scaled by its
      // reciprocal, as the paired elimination does) or each half as the
      // unpacked route eliminates its block ("apply"), in place in the pair,
      // with no Jacobi scaling (`:800-812`). Unpacked: equilibrated around the
      // inverse when `jacobi`.
      const bool jacobi = !PACK && ff.jacobi;
      const bool recip =
          (PACK && ff.foot_pack == FOOT_PACK_PAIR) || (!ff.aug_pivot && ff.gj_inplace);
      if (jacobi) {
        jacobi_factor<NF_>(g, ka, 2 * T, sm + L.dj);
        jacobi_apply<NF_>(g, ka, 2 * T, sm + L.dj);
      }
      gj_pair_warp<PACK>(g, ka, T, ff.aug_pivot, recip);
      if (jacobi) jacobi_apply<NF_>(g, ka, 2 * T, sm + L.dj);
    } else {
      // Foot blocks [[diag(r + beta), G_f^T], [G_f, -diag(W_f)]], block foot*T + t.
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
        ka[krow(T, foot, t, r) + c] = v;
      }
      g.sync();
    }
    if constexpr (PACK) {
      // The pair (True) or each half as the unpacked route inverts it
      // ("apply"); no Jacobi scaling, as in the JAX kernel (`:800-812`).
      if constexpr (!LEAN) {
        if (ff.foot_pack == FOOT_PACK_PAIR)
          gj_pair<NF_>(g, ka, T, ff.aug_pivot, sm + L.colk, sm + L.prow, piv);
        else
          gj_inverse_inplace<NF_, S, 2 * NF_>(g, ka, 2 * T, ff.aug_pivot,
                                              !ff.aug_pivot && ff.gj_inplace, sm + L.colk,
                                              sm + L.prow, piv);
      }
      PDIPM_MARK(g, PH_FOOT);
      y_chain_packed<RicAugSplit>(g, sm, L, ff.gj_inplace, piv);
    } else {
      if constexpr (!LEAN)
        stage_inverse<NF_>(g, ka, 2 * T, ff.aug_pivot, ff.gj_inplace, ff.jacobi, sm + L.colk,
                           sm + L.prow, piv, sm + L.dj);
      PDIPM_MARK(g, PH_FOOT);
      // P_t = Bd (K_t^-1)_uu, using the sparsity of (K^-1)_uu; the lean
      // layout forms Ad Q~^-1 Ad^T in the union here, as riccati_setup does.
      const S* bd = sm + L.bd;
      const S* cf = sm + L.cf;
      S* p = sm + L.p;
      if constexpr (LEAN)
        for (int k = tid; k < 144; k += nt) sm[L.adqad + k] = adqad_entry(sm, L, k / NX_, k % NX_);
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
      g.sync();
      // Y'_t and the dual-Riccati chain: Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S, inverted in place.
      y_chain_from_p(g, sm, L, delta, ff.gj_inplace, piv);
    }
  }

  template <typename S, typename G>
  static __device__ void solve(const G& g, S* sm, const Layout& L, const S* r1, const S* rz,
                               const S* r4, S* dx, S* dz, S* dy) {
    riccati_solve<RicAugSplit>(g, sm, L, r1, rz, r4, dx, dz, dy);
  }
};
