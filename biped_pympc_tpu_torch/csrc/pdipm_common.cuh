// Device code shared by the PDIPM kernels (pdipm_ric_aug.cu, pdipm_ric.cu,
// and pdipm_tridiag.cuh, which pdipm_tridiag.cu and pdipm_tridiag_aug.cu
// include): the QP's structured operators, block reductions, the
// compensated arithmetic and the refinement residual of the augmented
// system, the warm / cold load and the gate, the in-place 12-wide Jordan
// inverse, the dual-Riccati y-chain and its sweeps, and the
// fraction-to-boundary rule. Each kernel owns its shared-memory `Layout`;
// the operators read only its fields T, gu, ad and bd.
//
// Every function here is called by all threads of a block; the ones that
// end in __syncthreads leave the block synchronized.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define PDIPM_THREADS 128

// Register cap of each kernel (`__maxnreg__`). In f32 shared memory admits 4
// blocks of K1 and 5 of K2 on an H100, so registers decide the blocks per SM:
// 128 registers x 128 threads lets 4 run. Without the cap nvcc gave K2 167
// registers (3 blocks) in one build and 128 (4 blocks) in another, and the
// solve time moved by a third. `__maxnreg__` ran K1 1.0% and K2 0.2% faster
// than the same cap set as `__launch_bounds__(128, 4)` (PERF.md, PR 3). In
// f64 shared memory admits 2 blocks of either, and 255 leaves nvcc free.
template <typename S>
struct MaxRegs {
  static constexpr int value = sizeof(S) == 4 ? 128 : 255;
};

static constexpr int NX_ = 12;   // states per knot
static constexpr int NU_ = 12;   // inputs per stage
static constexpr int NI_ = 16;   // inequality rows per stage
static constexpr int NMX_ = 2;   // Mx rows per stage
static constexpr int NB_ = 12;   // width of the matrices gj_inverse_inplace inverts

// Next `n` values of a shared-memory layout, starting at offset o.
static __host__ __device__ __forceinline__ int take(int& o, int n) {
  const int r = o;
  o += n;
  return r;
}

// u columns of each foot's block: foot L {F_L, M_L,y}, foot R {F_R, M_R,y}.
__device__ __forceinline__ int foot_col(int foot, int a) {
  return foot == 0 ? (a < 3 ? a : 7) : (a < 3 ? 3 + a : 10);
}

template <typename S>
__device__ __forceinline__ S nan_min(S a, S b) {
  // min that propagates NaN, as jnp.min / torch.min do
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// Block-wide reductions over one value per thread, tree-ordered in shared
// memory (deterministic). Every thread gets the result.
template <typename S>
__device__ S block_sum(S v, S* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = red[tid] + red[tid + h];
    __syncthreads();
  }
  S r = red[0];
  __syncthreads();
  return r;
}

template <typename S>
__device__ S block_min(S v, S* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = nan_min(red[tid], red[tid + h]);
    __syncthreads();
  }
  S r = red[0];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// Structured operators: one output entry each (callers spread entries over
// threads). Layouts as in ops/qp.py: z = [x_1..x_T, u_0..u_{T-1}], equality
// rows = 12 T dynamics rows then 2 T Mx rows.
// ---------------------------------------------------------------------------

// (G^T lam)[i], i < nz
template <typename S, typename Layout>
__device__ __forceinline__ S gT_entry(const S* sm, const Layout& L, int i, const S* lam) {
  if (i < NX_ * L.T) return S(0);
  const int k = i - NX_ * L.T, t = k / NU_, j = k % NU_;
  const S* gu = sm + L.gu;
  S acc = S(0);
  for (int r = 0; r < NI_; ++r) acc += lam[t * NI_ + r] * gu[r * NU_ + j];
  return acc;
}

// (A^T y)[i], i < nz
template <typename S, typename Layout>
__device__ __forceinline__ S aT_entry(const S* sm, const Layout& L, int i, const S* y) {
  const S* ad = sm + L.ad;
  const S* bd = sm + L.bd;
  const int T = L.T;
  if (i < NX_ * T) {
    const int t = i / NX_, j = i % NX_;
    S acc = S(0);
    if (t + 1 < T)
      for (int r = 0; r < NX_; ++r) acc += y[(t + 1) * NX_ + r] * ad[r * NX_ + j];
    return y[i] - acc;
  }
  const int k = i - NX_ * T, t = k / NU_, j = k % NU_;
  S acc = S(0);
  for (int r = 0; r < NX_; ++r) acc += y[t * NX_ + r] * bd[r * NU_ + j];
  S v = -acc;
  if (j == 6) v += y[NX_ * T + NMX_ * t];
  if (j == 9) v += y[NX_ * T + NMX_ * t + 1];
  return v;
}

// (G x)[k], k < ni
template <typename S, typename Layout>
__device__ __forceinline__ S g_entry(const S* sm, const Layout& L, int k, const S* x) {
  const int t = k / NI_, r = k % NI_;
  const S* gu = sm + L.gu + r * NU_;
  const S* u = x + NX_ * L.T + NU_ * t;
  S acc = S(0);
  for (int j = 0; j < NU_; ++j) acc += gu[j] * u[j];
  return acc;
}

// (A x)[e], e < ne
template <typename S, typename Layout>
__device__ __forceinline__ S a_entry(const S* sm, const Layout& L, int e, const S* x) {
  const int T = L.T;
  if (e < NX_ * T) {
    const int t = e / NX_, i = e % NX_;
    const S* ad = sm + L.ad + i * NX_;
    const S* bd = sm + L.bd + i * NU_;
    const S* u = x + NX_ * T + NU_ * t;
    S adp = S(0), bdu = S(0);
    if (t >= 1)
      for (int j = 0; j < NX_; ++j) adp += ad[j] * x[(t - 1) * NX_ + j];
    for (int j = 0; j < NU_; ++j) bdu += bd[j] * u[j];
    return x[e] - adp - bdu;
  }
  const int k = e - NX_ * T, t = k / NMX_;
  return x[NX_ * T + NU_ * t + (k % NMX_ == 0 ? 6 : 9)];
}

// ---------------------------------------------------------------------------
// Compensated (double-float) arithmetic for the refinement residual
// (`ops/df.py`, the plain version). Error-free transformations need every
// add and multiply rounded on its own: nvcc's default --fmad=true would
// contract a*b+c into an FMA and break Dekker's split and two_sum's algebra.
// The _rn intrinsics are never contracted, so the EFTs use them alone; the
// build flags stay as they are for the rest of the kernels.
// ---------------------------------------------------------------------------
template <typename S> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
};

// s = fl(a + b), e with s + e = a + b exactly (Knuth).
template <typename S>
__device__ __forceinline__ void two_sum(S a, S b, S& s, S& e) {
  using R = Rn<S>;
  s = R::add(a, b);
  const S bb = R::sub(s, a);
  e = R::add(R::sub(a, R::sub(s, bb)), R::sub(b, bb));
}

// p = fl(a * b), e with p + e = a * b (Dekker, Veltkamp split by 2^12 + 1 in
// both dtypes, as the plain version and the JAX package do).
template <typename S>
__device__ __forceinline__ void two_prod(S a, S b, S& p, S& e) {
  using R = Rn<S>;
  const S split = S(4097);
  p = R::mul(a, b);
  const S ca = R::mul(split, a), cb = R::mul(split, b);
  const S ah = R::sub(ca, R::sub(ca, a)), bh = R::sub(cb, R::sub(cb, b));
  const S al = R::sub(a, ah), bl = R::sub(b, bh);
  e = R::add(R::add(R::add(R::sub(R::mul(ah, bh), p), R::mul(ah, bl)), R::mul(al, bh)),
             R::mul(al, bl));
}

// One (sum, error) pair: `ops/df.Acc`, term for term.
template <typename S>
struct DfAcc {
  S s, c;
  __device__ __forceinline__ explicit DfAcc(S init) : s(init), c(S(0)) {}
  __device__ __forceinline__ void add(S x) {
    S e;
    two_sum(s, x, s, e);
    c = Rn<S>::add(c, e);
  }
  // accumulate a * b
  __device__ __forceinline__ void add_prod(S a, S b) {
    S p, pe, se;
    two_prod(a, b, p, pe);
    two_sum(s, p, s, se);
    c = Rn<S>::add(Rn<S>::add(c, se), pe);
  }
  __device__ __forceinline__ S value() const { return Rn<S>::add(s, c); }
};

// Compensated rows of the augmented reduced system's residual, one output
// entry each, in the term order of `ops/df.residual_aug` (a product's first
// factor is the vector entry or the scaled diagonal, as there). Terms the
// plain version adds as exact zeros are skipped: adding 0 leaves the pair as
// it is.
//   e1[i] = r - [(hd + beta) dx + G^T dz + A^T dy][i], i < nz
template <typename S, typename Layout>
__device__ S df_e1_entry(const S* sm, const Layout& L, int i, S r, S hd, S beta,
                         const S* dx, const S* dz, const S* dy) {
  const int T = L.T;
  const S* ad = sm + L.ad;
  const S* bd = sm + L.bd;
  const S* gu = sm + L.gu;
  S hb, he;
  two_sum(hd, beta, hb, he);
  DfAcc<S> a(r);
  a.add_prod(-hb, dx[i]);
  a.add_prod(-he, dx[i]);
  if (i < NX_ * T) {
    const int t = i / NX_, j = i % NX_;
    a.add(-dy[i]);
    if (t + 1 < T)
      for (int l = 0; l < NX_; ++l) a.add_prod(dy[(t + 1) * NX_ + l], ad[l * NX_ + j]);
    return a.value();
  }
  const int k = i - NX_ * T, t = k / NU_, j = k % NU_;
  for (int q = 0; q < NI_; ++q) a.add_prod(-dz[t * NI_ + q], gu[q * NU_ + j]);
  for (int l = 0; l < NX_; ++l) a.add_prod(dy[t * NX_ + l], bd[l * NU_ + j]);
  if (j == 6) a.add(-dy[NX_ * T + NMX_ * t]);
  if (j == 9) a.add(-dy[NX_ * T + NMX_ * t + 1]);
  return a.value();
}

//   ez[k] = r - [G dx - W dz][k], k < ni
template <typename S, typename Layout>
__device__ S df_ez_entry(const S* sm, const Layout& L, int k, S r, S w, const S* dx,
                         const S* dz) {
  const int t = k / NI_, q = k % NI_;
  const S* gu = sm + L.gu + q * NU_;
  const S* u = dx + NX_ * L.T + NU_ * t;
  DfAcc<S> a(r);
  for (int j = 0; j < NU_; ++j) a.add_prod(-u[j], gu[j]);
  a.add_prod(w, dz[k]);
  return a.value();
}

//   e4[e] = r - [A dx - delta dy][e], e < ne
template <typename S, typename Layout>
__device__ S df_e4_entry(const S* sm, const Layout& L, int e, S r, S delta, const S* dx,
                         const S* dy) {
  const int T = L.T;
  DfAcc<S> a(r);
  if (e < NX_ * T) {
    const int t = e / NX_, i = e % NX_;
    const S* ad = sm + L.ad + i * NX_;
    const S* bd = sm + L.bd + i * NU_;
    const S* u = dx + NX_ * T + NU_ * t;
    a.add(-dx[e]);
    if (t >= 1)
      for (int j = 0; j < NX_; ++j) a.add_prod(dx[(t - 1) * NX_ + j], ad[j]);
    for (int j = 0; j < NU_; ++j) a.add_prod(u[j], bd[j]);
    a.add_prod(delta, dy[e]);
    return a.value();
  }
  const int k = e - NX_ * T, t = k / NMX_;
  a.add(-dx[NX_ * T + NU_ * t + (k % NMX_ == 0 ? 6 : 9)]);
  a.add_prod(delta, dy[e]);
  return a.value();
}

// Refinement residual of the augmented reduced system into (e1, ez, e4):
//   e1 = r1 - [(hd + beta) dx + G^T dz + A^T dy],  ez = rz - [G dx - W dz],
//   e4 = r4 - [A dx - delta dy],
// from the layout's r1, rz, r4, hd and w, in the working precision or, with
// refine_df, as one compensated (sum, error) pair per component. Ends
// synchronized. K1's residual entry (pdipm_ric_aug_residual_*) runs it alone;
// the augmented solves of K1 and K5b call it.
template <typename S, typename Layout>
__device__ void refine_residual(S* sm, const Layout& L, bool refine_df, S beta, S delta,
                                const S* dx, const S* dz, const S* dy) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const S* r1 = sm + L.r1;
  const S* rz = sm + L.rz;
  const S* r4 = sm + L.r4;
  const S* hd = sm + L.hd;
  const S* w = sm + L.w;
  S* e1 = sm + L.e1;
  S* ez = sm + L.ez;
  S* e4 = sm + L.e4;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  for (int it = tid; it < nz + ni + ne; it += nt) {
    if (refine_df) {
      if (it < nz) e1[it] = df_e1_entry(sm, L, it, r1[it], hd[it], beta, dx, dz, dy);
      else if (it < nz + ni) ez[it - nz] = df_ez_entry(sm, L, it - nz, rz[it - nz], w[it - nz], dx, dz);
      else e4[it - nz - ni] = df_e4_entry(sm, L, it - nz - ni, r4[it - nz - ni], delta, dx, dy);
    } else if (it < nz) {
      const int i = it;
      S mv = (hd[i] + beta) * dx[i] + gT_entry(sm, L, i, dz) + aT_entry(sm, L, i, dy);
      e1[i] = r1[i] - mv;
    } else if (it < nz + ni) {
      const int k = it - nz;
      S mv = g_entry(sm, L, k, dx) - w[k] * dz[k];
      ez[k] = rz[k] - mv;
    } else {
      const int e = it - nz - ni;
      S mv = a_entry(sm, L, e, dx) - delta * dy[e];
      e4[e] = r4[e] - mv;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Load one env's QP into the layout's input fields and its start iterate
// into x, s, z, y: the warm state when x0 is non-null (s0, z0, y0 with it),
// else the cold start x = 0, s = max(d, 1), z = 1, y = 1. Every input is
// read here, before the kernel writes any output, and a block touches only
// its own env's rows: the kernels rely on this to let the outputs alias the
// warm state (in-place continuation across launches).
// ---------------------------------------------------------------------------
template <typename S, typename Layout>
__device__ void load_env(S* sm, const Layout& L, long env, const S* hd_in, const S* f_in,
                         const S* ad_in, const S* bd_in, const S* b_in, const S* gu_in,
                         const S* d_in, const S* x0, const S* s0, const S* z0, const S* y0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  const bool warm = x0 != nullptr;
  for (int i = tid; i < nz; i += nt) {
    sm[L.hd + i] = hd_in[env * nz + i];
    sm[L.f + i] = f_in[env * nz + i];
    sm[L.x + i] = warm ? x0[env * nz + i] : S(0);
  }
  for (int i = tid; i < 144; i += nt) {
    sm[L.ad + i] = ad_in[env * 144 + i];
    sm[L.bd + i] = bd_in[env * 144 + i];
  }
  for (int i = tid; i < NI_ * NU_; i += nt) sm[L.gu + i] = gu_in[env * NI_ * NU_ + i];
  for (int i = tid; i < ne; i += nt) {
    sm[L.b + i] = b_in[env * ne + i];
    sm[L.y + i] = warm ? y0[env * ne + i] : S(1);
  }
  for (int i = tid; i < ni; i += nt) {
    const S dv = d_in[env * ni + i];
    sm[L.d + i] = dv;
    sm[L.s + i] = warm ? s0[env * ni + i] : (dv > S(1) ? dv : S(1));
    sm[L.z + i] = warm ? z0[env * ni + i] : S(1);
  }
  __syncthreads();
}

// Gate of the adaptive solve: a kernel whose flag `go` (device memory) is 0
// returns at once and leaves its outputs untouched; otherwise block 0 adds
// one to the device counter `ran`. Both may be null (always run, no count).
__device__ __forceinline__ bool gate_open(const int* go, int* ran) {
  if (go != nullptr && *go == 0) return false;
  if (ran != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(ran, 1);
  return true;
}

// ---------------------------------------------------------------------------
// In-place Gauss-Jordan inverse of `count` 12x12 matrices at `mats`
// (stride 144). With pivoting, each step swaps the largest |entry| of column
// k (rows >= k, first on ties) into row k and the column swaps are undone at
// the end, in reverse order.
// ---------------------------------------------------------------------------
template <typename S>
__device__ void gj_inverse_inplace(S* mats, int count, bool pivot, S* colk, S* prow, int* piv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 0; k < NB_; ++k) {
    // Pivot choice, row swap, and the step's column / scaled pivot row.
    for (int mi = tid; mi < count; mi += nt) {
      S* a = mats + mi * 144;
      int p = k;
      if (pivot) {
        S best = a[k * NB_ + k] < S(0) ? -a[k * NB_ + k] : a[k * NB_ + k];
        for (int i = k + 1; i < NB_; ++i) {
          S v = a[i * NB_ + k];
          v = v < S(0) ? -v : v;
          if (v > best) { best = v; p = i; }
        }
        piv[mi * NB_ + k] = p;
        if (p != k)
          for (int j = 0; j < NB_; ++j) {
            S tmp = a[k * NB_ + j];
            a[k * NB_ + j] = a[p * NB_ + j];
            a[p * NB_ + j] = tmp;
          }
      }
      const S pv = a[k * NB_ + k];
      for (int i = 0; i < NB_; ++i) colk[mi * NB_ + i] = a[i * NB_ + k];
      for (int j = 0; j < NB_; ++j) prow[mi * NB_ + j] = j == k ? S(1) / pv : a[k * NB_ + j] / pv;
    }
    __syncthreads();
    // Jordan step: row k <- scaled row; column k <- -col / pivot; rest rank-1.
    for (int it = tid; it < count * 144; it += nt) {
      const int mi = it / 144, i = (it % 144) / NB_, j = it % NB_;
      S* a = mats + mi * 144;
      const S pr = prow[mi * NB_ + j];
      if (i == k) {
        a[i * NB_ + j] = pr;
      } else if (j == k) {
        a[i * NB_ + j] = -colk[mi * NB_ + i] * prow[mi * NB_ + k];
      } else {
        a[i * NB_ + j] -= colk[mi * NB_ + i] * pr;
      }
    }
    __syncthreads();
  }
  if (!pivot) return;
  // inv(A) = inv(P A) P: undo the row swaps as column swaps, last first.
  for (int it = tid; it < count * NB_; it += nt) {
    const int mi = it / NB_, i = it % NB_;
    S* row = mats + mi * 144 + i * NB_;
    for (int k = NB_ - 1; k >= 0; --k) {
      const int p = piv[mi * NB_ + k];
      if (p != k) {
        S tmp = row[k];
        row[k] = row[p];
        row[p] = tmp;
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The dual-Riccati y-chain, the same for every route once the stage blocks
// are folded in. `m` holds the T blocks Y'_t (12x12, stride 144) on entry
// and Yhat_t^-1 on exit, Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S, S = Q~^-1 Ad^T
// at `sc`. The blocks are negative definite: inverted without pivoting.
// ---------------------------------------------------------------------------
template <typename S>
__device__ void dual_riccati_chain(S* m, const S* sc, int T, S* q1, S* colk, S* prow, int* piv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int t = 0; t < T; ++t) {
    S* mt = m + t * 144;
    if (t >= 1) {
      const S* mp = m + (t - 1) * 144;
      for (int it = tid; it < 144; it += nt) {
        const int i = it / NX_, j = it % NX_;
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += mp[i * NX_ + l] * sc[l * NX_ + j];
        q1[it] = acc;
      }
      __syncthreads();
      for (int it = tid; it < 144; it += nt) {
        const int i = it / NX_, j = it % NX_;
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += sc[l * NX_ + i] * q1[l * NX_ + j];
        mt[it] -= acc;
      }
      __syncthreads();
    }
    gj_inverse_inplace(mt, 1, false, colk, prow, piv);
  }
}

// Forward and backward sweeps of the y-chain: g (T x 12) holds the folded
// y rows r'_t on entry; wy (T x 12) gets y. g is overwritten.
template <typename S>
__device__ void y_sweeps(const S* m, const S* sc, int T, S* g, S* wy, S* v12) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // Forward sweep: g_t = r'_t - S^T (Yhat_{t-1}^-1 g_{t-1}).
  for (int t = 1; t < T; ++t) {
    for (int i = tid; i < NX_; i += nt) {
      const S* mp = m + (t - 1) * 144 + i * NX_;
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += mp[l] * g[(t - 1) * NX_ + l];
      v12[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < NX_; i += nt) {
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += sc[l * NX_ + i] * v12[l];
      g[t * NX_ + i] -= acc;
    }
    __syncthreads();
  }
  // Backward sweep: y_t = Yhat_t^-1 (g_t - S y_{t+1}).
  for (int t = T - 1; t >= 0; --t) {
    for (int i = tid; i < NX_; i += nt) {
      S v = g[t * NX_ + i];
      if (t + 1 < T) {
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += sc[i * NX_ + l] * wy[(t + 1) * NX_ + l];
        v -= acc;
      }
      v12[i] = v;
    }
    __syncthreads();
    for (int i = tid; i < NX_; i += nt) {
      const S* mt = m + t * 144 + i * NX_;
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += mt[l] * v12[l];
      wy[t * NX_ + i] = acc;
    }
    __syncthreads();
  }
}

// alpha = max(min(1, 0.99 min_i(dv_i < 0 ? -v_i / dv_i : 1)), 1e-12)
template <typename S>
__device__ S frac_to_boundary(const S* v, const S* dv, int n, S* red) {
  S mn = S(INFINITY);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const S c = dv[k] < S(0) ? -v[k] / dv[k] : S(1);
    mn = nan_min(mn, c);
  }
  mn = block_min(mn, red);
  S a = S(0.99) * mn;
  a = (a != a) ? a : (a < S(1) ? a : S(1));
  return (a != a) ? a : (a > S(1e-12) ? a : S(1e-12));
}
