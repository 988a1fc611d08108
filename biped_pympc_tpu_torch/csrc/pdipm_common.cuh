// Device code shared by the PDIPM kernels (pdipm_ric_aug.cu, pdipm_ric.cu):
// the QP's structured operators, block reductions, the in-place Jordan
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
