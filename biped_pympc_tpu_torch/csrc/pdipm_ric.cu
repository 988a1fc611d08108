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
// that scale. kkt_scale="jacobi" equilibrates each foot block in the
// thread's registers around its inverse. Build without --use_fast_math:
// division and sqrt stay IEEE.
//
// This file supplies the route's policy for the Newton-step kernel of
// pdipm_common.cuh.

#include "pdipm_riccati.cuh"

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

// (a_ij d_i) d_j over one 4x4 block held by the calling thread.
template <typename S>
__device__ __forceinline__ void scale4(S* a, const S* dj) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i * 4 + j] = a[i * 4 + j] * dj[i] * dj[j];
}

// The route's policy for the shared Newton-step kernel (pdipm_common.cuh).
struct Ric {
  static constexpr bool AUG = false;

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
    int piv;        // byte offset of the (empty) int pivot table
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
    L.piv = o * size_of_s;
    L.bytes = (size_t)L.piv;
    return L;
  }

  // q_inv, S, Ad Q~^-1 Ad^T, the [M_x, nu] pair / M_z coefficients and yc.
  template <typename S>
  static __device__ void setup(S* sm, const Layout& L, S beta, S delta) {
    riccati_setup<true, true>(sm, L, beta, delta);
  }

  // -------------------------------------------------------------------------
  // Stage block inverse apply: row o (< 14) of K_t^-1 r, r = [u(12), nu(2)].
  // -------------------------------------------------------------------------
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
    const S* k = sm + L.k4 + (foot * L.T + t) * 16 + a * 4;
    S acc = S(0);
    for (int bb = 0; bb < 4; ++bb) acc += k[bb] * r[foot_col(foot, bb)];
    return acc;
  }

  // -------------------------------------------------------------------------
  // Factorization of the condensed KKT at the current W^-1.
  // -------------------------------------------------------------------------
  template <typename S>
  static __device__ void factor(S* sm, const Layout& L, int* piv, S beta, S delta, bool jacobi) {
    const int tid = threadIdx.x, nt = blockDim.x, T = L.T;
    const S* hd = sm + L.hd;
    const S* gu = sm + L.gu;
    const S* w = sm + L.w;
    const S* bd = sm + L.bd;
    S* k4 = sm + L.k4;
    S* m = sm + L.m;
    S* p = sm + L.p;

    // Foot blocks G_f^T diag(W^-1_f) G_f + diag(r_f + beta), block foot*T + t,
    // equilibrated around the inverse when `jacobi` (`pdipm_pallas.py:712`).
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
      // One inlined copy of the unrolled inverse: with a second one in an
      // else branch, nvcc spilled 48 B in f32 and the kernel ran 15% slower.
      S dj[4];
      if (jacobi) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dj[i] = jacobi_d(a[i * 4 + i]);
        scale4(a, dj);
      }
      inverse4_nopivot(a);
      if (jacobi) scale4(a, dj);
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
    dual_riccati_chain(m, sm + L.sc, T, sm + L.q1, sm + L.colk, sm + L.prow, piv);
  }

  template <typename S>
  static __device__ void solve(S* sm, const Layout& L, const S* r1, const S* rz, const S* r4,
                               S* dx, S* dz, S* dy) {
    riccati_solve<Ric>(sm, L, r1, rz, r4, dx, dz, dy);
  }
};

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
                  int iterations, int refine_steps, int refine_df, int kkt_jacobi, double beta,
                  double delta, void* stream) {
  return launch<Ric, float>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran,
                            batch, T, iterations, refine_steps, refine_df, kkt_jacobi, beta,
                            delta, stream);
}

int pdipm_ric_f64(const void* hd, const void* f, const void* ad, const void* bd,
                  const void* b, const void* gu, const void* d, const void* x0,
                  const void* s0, const void* z0, const void* y0, void* x, void* s, void* z,
                  void* y, void* res, const void* go, void* ran, int batch, int T,
                  int iterations, int refine_steps, int refine_df, int kkt_jacobi, double beta,
                  double delta, void* stream) {
  return launch<Ric, double>(hd, f, ad, bd, b, gu, d, x0, s0, z0, y0, x, s, z, y, res, go, ran,
                             batch, T, iterations, refine_steps, refine_df, kkt_jacobi, beta,
                             delta, stream);
}

const char* pdipm_ric_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
