// Device code shared by every PDIPM kernel: the QP's structured operators,
// block reductions, the compensated arithmetic and the refinement residual
// of the augmented system, the warm / cold load and the gate, the in-place
// n-wide Jordan inverse with its Jacobi equilibration, the dual-Riccati
// y-chain and its sweeps, the fraction-to-boundary rule, and the one
// Newton-step kernel `pdipm_kernel<P, S, G>` with its two reduced-solve forms,
// its four corrector forms and its host `launch`. A route is a policy P (the
// end of this file says what it supplies): through pdipm_split.cuh,
// pdipm_ric_aug.cu (K1), pdipm_ric.cu (K2) and their packed twins
// pdipm_ric_aug_pack.cu and pdipm_ric_pack.cu (K5e); through
// pdipm_riccati.cuh, pdipm_ric2.cu (K5c), pdipm_ric_dense.cu and
// pdipm_ric_aug_dense.cu (K5d); through pdipm_tridiag.cuh, pdipm_tridiag.cu
// (K5a) and pdipm_tridiag_aug.cu (K5b). Each route owns its shared-memory
// `Layout`; the operators read only its fields T, gu, ad and bd.
//
// The threads that work on one env are its group G, a compile-time parameter
// of the kernel: `BlockGroup`, the whole 128-thread block (one env per
// block; every route), or `WarpGroup<NW>`, NW warps, one env per block of
// 32 NW threads (K1 and K5e-a two warps, K2, K5a, K5b, K5c and K5d-c one,
// K5d-a four, in their lean layouts). Every function here
// is called by all threads of the group `g` and spreads its items over
// g.rank() / g.size(); the ones that end in g.sync() leave the group
// synchronized. A warp group synchronizes with __syncwarp (NW = 1) or its
// own named barrier (bar.sync), never with __syncthreads, exchanges values
// through shared memory behind those barriers or through __shfl_sync, and
// reduces with shuffle trees.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#define PDIPM_THREADS 128

// Phases of the clock64() breakdown (`PDIPM_PROFILE` builds only): a mark
// PDIPM_MARK(g, ph) books the cycles since the group's previous mark to ph.
enum {
  PH_LOAD = 0,   // load_env and the route's setup, once per launch
  PH_RESID,      // the KKT residual pass at the iterate
  PH_REDUCE,     // group reductions: mu, mu_aff, the four step-length minima
  PH_FOOT,       // the stage blocks: build and invert (the foot blocks)
  PH_PT,         // P_t = Bd K^-1 and Y'_t
  PH_YCHAIN,     // the dual-Riccati y-chain's inverses
  PH_STAGE,      // a reduced solve's stage applies (all but the sweeps)
  PH_SWEEP,      // a reduced solve's y sweeps
  PH_REFINE,     // the refinement residuals and corrections
  PH_UPDATE,     // right-hand sides, direction sums, ds and the step update
  PH_STORE,      // the residual norms and the output
  PH_COUNT
};

#ifdef PDIPM_PROFILE
#define PDIPM_PROF_MAX_ENVS 4096
// Cycles per env (< PDIPM_PROF_MAX_ENVS) and phase of the last launch,
// written by each group's rank 0 at its end; read with `prof_read`.
__device__ unsigned long long pdipm_prof[PDIPM_PROF_MAX_ENVS * PH_COUNT];
struct ProfState {
  mutable long long last = 0;
  mutable unsigned long long acc[PH_COUNT] = {};
};
#define PDIPM_MARK(g, ph) (g).mark(ph)
#else
struct ProfState {};
#define PDIPM_MARK(g, ph) ((void)0)
#endif

// bar.sync 1, N: named barrier 1 over N threads (a multiple of 32). The id
// is an immediate, so that ptxas reserves 2 of an SM's barriers per block
// and not all 16 (a register id held the 64-thread group to 4 blocks per
// SM). Built for the host (`ops/host_build.py`), the shim's barrier.
template <int N>
__device__ __forceinline__ void named_barrier_1() {
#ifdef PDIPM_HOST_SHIM
  shim_named_barrier(1, N);
#else
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
#endif
}

// One env per 128-thread block: today's configuration of every route.
// size() is unsigned, as blockDim.x is: the loops that stride by it (the
// Jacobi passes, the fraction-to-boundary minimum) keep the unsigned step
// of the code before the groups, whose trip count nvcc does not derive. As
// an int it did, unrolled each of them four times, and the block kernels
// grew 7-17%: K5d-c 13% slower in f32 (PERF.md, Findings).
struct BlockGroup : ProfState {
  static constexpr bool WARP = false;
  static constexpr int THREADS = PDIPM_THREADS;
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ unsigned size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ long env() const { return blockIdx.x; }
#ifdef PDIPM_PROFILE
  __device__ __forceinline__ void mark(int ph) const {
    if (rank() == 0) {
      const long long t = clock64();
      acc[ph] += t - last;
      last = t;
    }
  }
#endif
};

// NW warps per env, one env per block of 32 NW threads (NW > 1 syncs on
// named barrier 1; 0 is __syncthreads'). rank() is threadIdx.x % THREADS,
// which is threadIdx.x, but tells nvcc that it is below THREADS: without
// that bound K2's kernel came out larger and slower (PERF.md, Findings).
template <int NW>
struct WarpGroup : ProfState {
  static constexpr bool WARP = true;
  static constexpr int THREADS = 32 * NW;
  __device__ __forceinline__ int rank() const { return threadIdx.x % THREADS; }
  __device__ __forceinline__ int size() const { return THREADS; }
  __device__ __forceinline__ void sync() const {
    if constexpr (NW == 1) {
      __syncwarp();
    } else {
      named_barrier_1<THREADS>();
    }
  }
  __device__ __forceinline__ long env() const { return blockIdx.x; }
#ifdef PDIPM_PROFILE
  __device__ __forceinline__ void mark(int ph) const {
    if (threadIdx.x == 0) {
      const long long t = clock64();
      acc[ph] += t - last;
      last = t;
    }
  }
#endif
};

// Register cap of each kernel (`__maxnreg__`). In f32 shared memory admits 4
// blocks of K1 and 5 of K2 on an H100, so registers decide the blocks per SM:
// 128 registers x 128 threads lets 4 run. Without the cap nvcc gave K2 167
// registers (3 blocks) in one build and 128 (4 blocks) in another, and the
// solve time moved by a third. `__maxnreg__` ran K1 1.0% and K2 0.2% faster
// than the same cap set as `__launch_bounds__(128, 4)` (PERF.md, PR 3). In
// f64 shared memory admits 2 blocks of either, and 255 leaves nvcc free.
// A warp takes its registers from one of an SM's four 16,384-register
// files. A one-warp group is held to its envs per SM by shared memory (8
// warps of K2 in f32: 2 a file), so 255 registers never bind; a two-warp
// group in f32 gets 168, so that 3 of its warps share a file and the 6 envs
// K1's lean layout fits at h10 (12 warps) reside: above 170, 2 warps a file
// hold it to 4 (PERF.md, Findings).
template <typename S, typename G = BlockGroup>
struct MaxRegs {
  static constexpr int value =
      !G::WARP ? (sizeof(S) == 4 ? 128 : 255) : (G::THREADS == 32 || sizeof(S) == 8 ? 255 : 168);
};

// The kernel's configuration as one type, so that a macro argument holds no
// comma (`__maxnreg__(Config<S, G>::regs)` would be two). REGS32 > 0 caps
// the f32 kernel at that many registers instead of MaxRegs' value.
template <typename S, typename G, int REGS32 = 0>
struct KernelConfig {
  static constexpr int regs = REGS32 > 0 && sizeof(S) == 4 ? REGS32 : MaxRegs<S, G>::value;
  static constexpr int threads = G::THREADS;
};

// The configuration route P's kernel is built with: KernelConfig<S, G>, or
// with a policy's own f32 cap `REGS32` (K5a's one-warp group: 168, so that
// 3 of its warps share a register file and the 12 envs its lean layout fits
// at h10 reside; with 255 as K2's and K5b's, 2 a file hold it to 8).
template <typename P, typename S, typename G, typename = void>
struct RouteConfig {
  using type = KernelConfig<S, G>;
};
template <typename P, typename S, typename G>
struct RouteConfig<P, S, G, std::void_t<decltype(P::REGS32)>> {
  using type = KernelConfig<S, G, P::REGS32>;
};

// A lean route policy (pdipm_split.cuh) keeps f, b and d out of its layout
// and reads them from device memory; K1's lean one also keeps no KKT
// residual buffers (rx, rs, re) and forms each entry where it is read.
// Every other policy has neither member and keeps both in shared memory.
template <typename P, typename = void>
struct LeanPolicy {
  static constexpr bool inputs_in_global = false, residuals_formed = false;
};
template <typename P>
struct LeanPolicy<P, std::void_t<decltype(P::INPUTS_IN_GLOBAL)>> {
  static constexpr bool inputs_in_global = P::INPUTS_IN_GLOBAL;
  static constexpr bool residuals_formed = P::RESIDUALS_FORMED;
};

// Shared memory an H100 gives one block, in bytes.
#define PDIPM_MAX_SMEM 232448

// A policy with WORKSPACE (the warp groups of K5b, K5d-a, K5a, K5c and
// K5d-c) keeps its T stored stage inverses in shared memory or in a per-env
// workspace in device memory that the caller allocates (`uses_workspace` decides):
// `make_layout(T, size_of_s, work)` lays the env out without them when
// `work`, and gives their bytes per env in `work_bytes`; the kernel points
// the layout's `wk` at its env's slice (null: in shared memory). Every other
// policy has no such member.
template <typename P, typename = void>
struct WorkPolicy {
  static constexpr bool value = false;
};
template <typename P>
struct WorkPolicy<P, std::void_t<decltype(P::WORKSPACE)>> {
  static constexpr bool value = P::WORKSPACE;
};

// The layout of route P for horizon T and value size `size_of_s`, its
// stored inverses in the workspace when `work` (WORKSPACE policies only).
template <typename P>
static __host__ __device__ __forceinline__ typename P::Layout route_layout(int T, int size_of_s,
                                                                           bool work) {
  if constexpr (WorkPolicy<P>::value) {
    return P::make_layout(T, size_of_s, work);
  } else {
    return P::make_layout(T, size_of_s);
  }
}

static constexpr int NX_ = 12;   // states per knot
static constexpr int NU_ = 12;   // inputs per stage
static constexpr int NI_ = 16;   // inequality rows per stage
static constexpr int NMX_ = 2;   // Mx rows per stage

// The solve's options as the host passes them, by pointer, to every route's
// `pdipm_<route>_<f32|f64>` entry (`pdipm_cuda.PdipmArgs` declares the same
// fields in the same order). The ints are flags and counts; the doubles the
// regularizations and the step rule's constants.
struct PdipmArgs {
  int iterations;      // Newton steps of this launch
  int refine_steps;    // refinement passes of a refined reduced solve
  int refine_skip;     // the first this-many steps run at refine 0
  int refine_df;       // compensated refinement residual (augmented routes)
  int kkt_jacobi;      // Jacobi equilibration of the Riccati stage inverses
  int gj_inplace;      // no-pivot inverses scale the pivot row by 1 / pivot
  int aug_pivot;       // "ric_aug": pivot search in the stage inverses
  int k_pivot;         // unsplit "ric": pivot search in the stage inverses
  int corrector_form;  // CORRECTOR_* below
  int foot_pack;       // packed routes: FOOT_PACK_* below
  double beta, delta, sigma_cap, frac_to_boundary, alpha_min, sz_floor;
};

// `PdipmOptions.corrector_form`, in the order of `pdipm.CORRECTOR_FORMS`.
enum { CORRECTOR_DELTA = 0, CORRECTOR_COMBINED = 1, CORRECTOR_SUM_REFINE = 2,
       CORRECTOR_AFF_REF = 3 };
// `PdipmOptions.foot_pack` on the packed routes: one paired elimination, or
// the split's own elimination stored packed.
enum { FOOT_PACK_PAIR = 1, FOOT_PACK_APPLY = 2 };

// What a route's factor reads of the options.
struct FactorFlags {
  bool jacobi, gj_inplace, aug_pivot, k_pivot;
  int foot_pack;
};

// The options in the kernel's value type, passed by value to the kernel.
template <typename S>
struct StepArgs {
  int iterations, refine_steps, refine_skip, corrector_form;
  bool refine_df;
  FactorFlags ff;
  S beta, delta, sigma_cap, frac_to_boundary, alpha_min, sz_floor;
};

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

// Reductions over one value per thread of the group: the block tree above
// for the block group; for a warp group a butterfly of __shfl_xor_sync in
// each warp (every lane adds the same two values, so every lane holds the
// same bits), then the NW warp values in order through `red` (NW values).
template <bool MIN, typename S, typename G>
__device__ __forceinline__ S group_reduce(const G& g, S v, S* red) {
  if constexpr (!G::WARP) {
    return MIN ? block_min(v, red) : block_sum(v, red);
  } else {
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) {
      const S o = __shfl_xor_sync(0xffffffffu, v, h);
      v = MIN ? nan_min(v, o) : v + o;
    }
    if constexpr (G::THREADS > 32) {
      if ((g.rank() & 31) == 0) red[g.rank() >> 5] = v;
      g.sync();
      v = red[0];
#pragma unroll
      for (int w = 1; w < G::THREADS / 32; ++w) v = MIN ? nan_min(v, red[w]) : v + red[w];
      g.sync();
    }
    return v;
  }
}

template <typename S, typename G>
__device__ __forceinline__ S group_sum(const G& g, S v, S* red) {
  return group_reduce<false>(g, v, red);
}

template <typename S, typename G>
__device__ __forceinline__ S group_min(const G& g, S v, S* red) {
  return group_reduce<true>(g, v, red);
}

// A policy with BLOCK_ORDER_SUMS (K5e-c's one-warp group) sums mu, mu_aff
// and the residual norms in the block group's order (`block_order_sum`), so
// that its warp group gives its block group's bits; every other policy has
// no such member and sums in its own group's order.
template <typename P, typename = void>
struct BlockOrderPolicy {
  static constexpr bool value = false;
};
template <typename P>
struct BlockOrderPolicy<P, std::void_t<decltype(P::BLOCK_ORDER_SUMS)>> {
  static constexpr bool value = P::BLOCK_ORDER_SUMS;
};

// The sum over k < n of term(k) in a one-warp group, rounded as the block
// group rounds `for (it = tid; it < off + n; it += 128) part += term(it -
// off)` and then block_sum: lane l stands in for the block's threads l + 32 q
// (q < 4), each adding its terms in increasing k; the block tree's halvings
// 64 and 32 in registers, the five after them group_reduce's butterfly,
// which adds as block_sum does.
template <typename S, typename G, typename F>
__device__ __forceinline__ S block_order_sum(const G& g, int off, int n, F term, S* red) {
  static_assert(G::WARP && G::THREADS == 32, "a one-warp group stands in for the block");
  constexpr int V = PDIPM_THREADS / 32;
  S v[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    v[q] = S(0);
    for (int it = g.rank() + 32 * q; it < off + n; it += PDIPM_THREADS)
      if (it >= off) v[q] += term(it - off);
  }
#pragma unroll
  for (int h = V / 2; h > 0; h >>= 1)
#pragma unroll
    for (int q = 0; q < h; ++q) v[q] = v[q] + v[q + h];
  return group_sum(g, v[0], red);
}

// The group's sum of the per-thread partials `part`, or with BLOCK_ORDER
// (a one-warp group) the block-order sum of term(k), k < n, offset `off`
// (`part` unused).
template <bool BLOCK_ORDER, typename S, typename G, typename F>
__device__ __forceinline__ S group_total(const G& g, S part, int off, int n, F term, S* red) {
  if constexpr (BLOCK_ORDER) {
    return block_order_sum<S>(g, off, n, term, red);
  } else {
    return group_sum(g, part, red);
  }
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
template <typename S, typename Layout, typename G>
__device__ void refine_residual(const G& g, S* sm, const Layout& L, bool refine_df, S beta,
                                S delta, const S* dx, const S* dz, const S* dy) {
  const int tid = g.rank(), nt = g.size();
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
  g.sync();
}

// ---------------------------------------------------------------------------
// Load one env's QP into the layout's input fields and its start iterate
// into x, s, z, y: the warm state when x0 is non-null (s0, z0, y0 with it),
// else the cold start x = 0, s = max(d, 1), z = 1, y = 1. Every input is
// read here, before the kernel writes any output, and a block touches only
// its own env's rows: the kernels rely on this to let the outputs alias the
// warm state (in-place continuation across launches).
// ---------------------------------------------------------------------------
template <bool FBD_IN_SMEM = true, typename S, typename Layout, typename G>
__device__ void load_env(const G& g, S* sm, const Layout& L, long env, const S* hd_in,
                         const S* f_in,
                         const S* ad_in, const S* bd_in, const S* b_in, const S* gu_in,
                         const S* d_in, const S* x0, const S* s0, const S* z0, const S* y0) {
  const int tid = g.rank(), nt = g.size();
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  const bool warm = x0 != nullptr;
  for (int i = tid; i < nz; i += nt) {
    sm[L.hd + i] = hd_in[env * nz + i];
    if constexpr (FBD_IN_SMEM) sm[L.f + i] = f_in[env * nz + i];
    sm[L.x + i] = warm ? x0[env * nz + i] : S(0);
  }
  for (int i = tid; i < 144; i += nt) {
    sm[L.ad + i] = ad_in[env * 144 + i];
    sm[L.bd + i] = bd_in[env * 144 + i];
  }
  for (int i = tid; i < NI_ * NU_; i += nt) sm[L.gu + i] = gu_in[env * NI_ * NU_ + i];
  for (int i = tid; i < ne; i += nt) {
    if constexpr (FBD_IN_SMEM) sm[L.b + i] = b_in[env * ne + i];
    sm[L.y + i] = warm ? y0[env * ne + i] : S(1);
  }
  for (int i = tid; i < ni; i += nt) {
    const S dv = d_in[env * ni + i];
    if constexpr (FBD_IN_SMEM) sm[L.d + i] = dv;
    sm[L.s + i] = warm ? s0[env * ni + i] : (dv > S(1) ? dv : S(1));
    sm[L.z + i] = warm ? z0[env * ni + i] : S(1);
  }
  g.sync();
}

// Gate of the adaptive solve: a kernel whose flag `go` (device memory) is 0
// returns at once and leaves its outputs untouched; otherwise block 0 adds
// one to the device counter `ran`. Both may be null (always run, no count).
__device__ __forceinline__ bool gate_open(const int* go, int* ran) {
  if (go != nullptr && *go == 0) return false;
  if (ran != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(ran, 1);
  return true;
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
// In-place Gauss-Jordan inverse of `count` independent N x N matrices, all
// eliminated together: N barrier steps whatever the count. With LD = N the
// blocks lie at `mats` with stride N * N; with LD = 2N they are the halves
// of stage pairs [K_L | K_R] (N rows of 2N values, `gj_pair`), block mi the
// half mi % 2 of pair mi / 2. The inverse's pivot entry is written as 1/pivot
// directly. The pivot row is scaled by the pivot's reciprocal when `recip`
// (`_gj_inverse_nopivot_inplace`, gj_form="inplace", and the paired forms),
// else divided by the pivot (`_gj_inverse`, `_gj_inverse_nopivot`). With
// pivoting, each step swaps the largest |entry| of column k (rows >= k, as
// argmax picks it: NaN first, then the first maximum) into row k and the row
// swaps are undone as column swaps at the end, last first. colk and prow hold count * N values, piv count * N.
// ---------------------------------------------------------------------------
template <int N, int LD>
__device__ __forceinline__ int gj_block(int mi) {
  if constexpr (LD == N) return mi * N * N;
  else return (mi >> 1) * N * LD + (mi & 1) * N;
}

template <int N, typename S, int LD = N, typename G>
__device__ void gj_inverse_inplace(const G& g, S* mats, int count, bool pivot, bool recip,
                                   S* colk, S* prow, int* piv) {
  constexpr int NN = N * N;
  const int tid = g.rank(), nt = g.size();
  for (int k = 0; k < N; ++k) {
    // Pivot choice, row swap, and the step's column / scaled pivot row.
    for (int mi = tid; mi < count; mi += nt) {
      S* a = mats + gj_block<N, LD>(mi);
      int p = k;
      if (pivot) {
        // argmax of |column k| over rows >= k: NaN above every number, the
        // first maximum on ties.
        S best = a[k * LD + k] < S(0) ? -a[k * LD + k] : a[k * LD + k];
        for (int i = k + 1; i < N; ++i) {
          S v = a[i * LD + k];
          v = v < S(0) ? -v : v;
          if (v > best || (v != v && best == best)) { best = v; p = i; }
        }
        piv[mi * N + k] = p;
        if (p != k)
          for (int j = 0; j < N; ++j) {
            S tmp = a[k * LD + j];
            a[k * LD + j] = a[p * LD + j];
            a[p * LD + j] = tmp;
          }
      }
      const S pv = a[k * LD + k];
      const S ipv = S(1) / pv;
      for (int i = 0; i < N; ++i) colk[mi * N + i] = a[i * LD + k];
      if (recip) {
        for (int j = 0; j < N; ++j) prow[mi * N + j] = j == k ? ipv : ipv * a[k * LD + j];
      } else {
        for (int j = 0; j < N; ++j) prow[mi * N + j] = j == k ? ipv : a[k * LD + j] / pv;
      }
    }
    g.sync();
    // Jordan step: row k <- scaled row; column k <- -col / pivot; rest rank-1.
    for (int it = tid; it < count * NN; it += nt) {
      const int mi = it / NN, i = (it % NN) / N, j = it % N;
      S* a = mats + gj_block<N, LD>(mi);
      const S pr = prow[mi * N + j];
      if (i == k) {
        a[i * LD + j] = pr;
      } else if (j == k) {
        a[i * LD + j] = -colk[mi * N + i] * prow[mi * N + k];
      } else {
        a[i * LD + j] -= colk[mi * N + i] * pr;
      }
    }
    g.sync();
  }
  if (!pivot) return;
  // inv(A) = inv(P A) P: undo the row swaps as column swaps, last first.
  for (int it = tid; it < count * N; it += nt) {
    const int mi = it / N, i = it % N;
    S* row = mats + gj_block<N, LD>(mi) + i * LD;
    for (int k = N - 1; k >= 0; --k) {
      const int p = piv[mi * N + k];
      if (p != k) {
        S tmp = row[k];
        row[k] = row[p];
        row[p] = tmp;
      }
    }
  }
  g.sync();
}

// The paired elimination of the packed routes (`_gj_pair_inplace`,
// `_gj_pair_pivot`): the T stage pairs [K_L | K_R] at `pairs` (N rows of 2N
// values each), both halves of every pair eliminated in each of the N
// barrier steps, each half with its own pivot search and row swaps (a swap
// moves only its half's columns). Both JAX forms scale the pivot row by the
// reciprocal. colk and prow hold 2T * N values, piv 2T * N.
template <int N, typename S, typename G>
__device__ void gj_pair(const G& g, S* pairs, int T, bool pivot, S* colk, S* prow, int* piv) {
  gj_inverse_inplace<N, S, 2 * N>(g, pairs, 2 * T, pivot, true, colk, prow, piv);
}

// Jacobi equilibration (`kkt_scale="jacobi"`, `pdipm_pallas.py:333`):
// K^-1 = D (D K D)^-1 D with D = 1 / sqrt(max(|diag K|, 1e-30)), an IEEE
// square root and division. jacobi_factor writes D of `count` N x N blocks
// at `mats` into dsc (count * N values); jacobi_apply scales every entry as
// (a_ij d_i) d_j, before the inverse and again after it.
template <typename S>
__device__ __forceinline__ S jacobi_d(S a) {
  a = a < S(0) ? -a : a;
  return S(1) / sqrt(a > S(1e-30) || a != a ? a : S(1e-30));
}

template <int N, typename S, typename G>
__device__ void jacobi_factor(const G& g, const S* mats, int count, S* dsc) {
  for (int it = g.rank(); it < count * N; it += g.size()) {
    const int mi = it / N, i = it % N;
    dsc[it] = jacobi_d(mats[mi * N * N + i * N + i]);
  }
  g.sync();
}

template <int N, typename S, typename G>
__device__ void jacobi_apply(const G& g, S* mats, int count, const S* dsc) {
  for (int it = g.rank(); it < count * N * N; it += g.size()) {
    const int mi = it / (N * N), i = (it / N) % N, j = it % N;
    mats[it] = mats[it] * dsc[mi * N + i] * dsc[mi * N + j];
  }
  g.sync();
}

// The stage inverses of a route: `count` independent N x N blocks inverted
// in place, equilibrated first when `jacobi` (dsc: count * N scratch values).
// Pivoted, they divide by the pivot (`_gj_inverse`); without pivoting they
// take the no-pivot form of `gj_inplace` (`pdipm_pallas.py:327-331`).
template <int N, typename S, typename G>
__device__ void stage_inverse(const G& g, S* mats, int count, bool pivot, bool gj_inplace,
                              bool jacobi, S* colk, S* prow, int* piv, S* dsc) {
  if (jacobi) {
    jacobi_factor<N>(g, mats, count, dsc);
    jacobi_apply<N>(g, mats, count, dsc);
  }
  gj_inverse_inplace<N>(g, mats, count, pivot, !pivot && gj_inplace, colk, prow, piv);
  if (jacobi) jacobi_apply<N>(g, mats, count, dsc);
}

// ---------------------------------------------------------------------------
// The dual-Riccati y-chain, the same for every route once the stage blocks
// are folded in. `m` holds the T blocks Y'_t (12x12, stride 144) on entry
// and Yhat_t^-1 on exit, Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S, S = Q~^-1 Ad^T
// at `sc`. The blocks are negative definite: inverted without pivoting, in
// the no-pivot form of `gj_inplace` (`pdipm_pallas.py:562`).
// ---------------------------------------------------------------------------
template <typename S, typename G>
__device__ void dual_riccati_chain(const G& g, S* m, const S* sc, int T, bool gj_inplace, S* q1,
                                   S* colk, S* prow, int* piv) {
  const int tid = g.rank(), nt = g.size();
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
      g.sync();
      for (int it = tid; it < 144; it += nt) {
        const int i = it / NX_, j = it % NX_;
        S acc = S(0);
        for (int l = 0; l < NX_; ++l) acc += sc[l * NX_ + i] * q1[l * NX_ + j];
        mt[it] -= acc;
      }
      g.sync();
    }
    gj_inverse_inplace<NX_>(g, mt, 1, false, gj_inplace, colk, prow, piv);
  }
}

// Forward and backward sweeps of the y-chain: g (T x 12) holds the folded
// y rows r'_t on entry; wy (T x 12) gets y. g is overwritten.
template <typename S, typename G>
__device__ void y_sweeps(const G& grp, const S* m, const S* sc, int T, S* g, S* wy, S* v12) {
  const int tid = grp.rank(), nt = grp.size();
  // Forward sweep: g_t = r'_t - S^T (Yhat_{t-1}^-1 g_{t-1}).
  for (int t = 1; t < T; ++t) {
    for (int i = tid; i < NX_; i += nt) {
      const S* mp = m + (t - 1) * 144 + i * NX_;
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += mp[l] * g[(t - 1) * NX_ + l];
      v12[i] = acc;
    }
    grp.sync();
    for (int i = tid; i < NX_; i += nt) {
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += sc[l * NX_ + i] * v12[l];
      g[t * NX_ + i] -= acc;
    }
    grp.sync();
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
    grp.sync();
    for (int i = tid; i < NX_; i += nt) {
      const S* mt = m + t * 144 + i * NX_;
      S acc = S(0);
      for (int l = 0; l < NX_; ++l) acc += mt[l] * v12[l];
      wy[t * NX_ + i] = acc;
    }
    grp.sync();
  }
}

// ---------------------------------------------------------------------------
// The y-chain and its sweeps in one warp (the lean layouts of K1 and K2,
// pdipm_split.cuh): lane i < 12 holds row i of a stage's 12 x 12 block, or
// entry i of a 12-vector, in registers; a pivot row or a vector is
// broadcast by __shfl_sync, so a step of the chain or of a sweep costs no
// barrier. The other lanes mirror lane 11 and store nothing.
// ---------------------------------------------------------------------------

template <typename S>
__device__ __forceinline__ S lane_bcast(S v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

// In-place Jordan inverse of the 12 x 12 block whose row i this lane holds
// in `a`, natural pivot order, the pivot row scaled by 1 / pivot (`recip`,
// gj_form "inplace") or divided by the pivot ("tableau"), the pivot entry
// written as 1 / pivot: `gj_inverse_inplace`'s arithmetic, entry for entry.
template <typename S>
__device__ __forceinline__ void gj_regs(S (&a)[NX_], int i, bool recip) {
#pragma unroll
  for (int k = 0; k < NX_; ++k) {
    S pr[NX_];
#pragma unroll
    for (int j = 0; j < NX_; ++j) pr[j] = lane_bcast(a[j], k);
    const S pv = pr[k];
    const S ipv = S(1) / pv;
    if (recip) {
#pragma unroll
      for (int j = 0; j < NX_; ++j) pr[j] = j == k ? ipv : ipv * pr[j];
    } else {
#pragma unroll
      for (int j = 0; j < NX_; ++j) pr[j] = j == k ? ipv : pr[j] / pv;
    }
    const S ck = a[k];
#pragma unroll
    for (int j = 0; j < NX_; ++j)
      a[j] = i == k ? pr[j] : (j == k ? -ck * pr[k] : a[j] - ck * pr[j]);
  }
}

// `dual_riccati_chain` in the group's first warp: Y'_t from `yp` (T x 144),
// Yhat_t^-1 into `m` (T x 144); q1 (144 values) carries Yhat_{t-1}^-1 S
// between the lanes. Ends synchronized.
template <typename S, typename G>
__device__ void dual_riccati_chain_regs(const G& g, const S* yp, S* m, const S* sc, int T,
                                        bool gj_inplace, S* q1) {
  if (g.rank() < 32) {
    const int lane = g.rank(), i = lane < NX_ ? lane : NX_ - 1;
    S prev[NX_];
#pragma unroll
    for (int j = 0; j < NX_; ++j) prev[j] = S(0);
    for (int t = 0; t < T; ++t) {
      S a[NX_];
#pragma unroll
      for (int j = 0; j < NX_; ++j) a[j] = yp[t * 144 + i * NX_ + j];
      if (t >= 1) {
        // q1 = Yhat_{t-1}^-1 S (row i from this lane's registers), then
        // Y'_t - S^T q1.
        S q[NX_];
#pragma unroll
        for (int j = 0; j < NX_; ++j) q[j] = S(0);
#pragma unroll
        for (int l = 0; l < NX_; ++l)
#pragma unroll
          for (int j = 0; j < NX_; ++j) q[j] += prev[l] * sc[l * NX_ + j];
        if (lane < NX_)
#pragma unroll
          for (int j = 0; j < NX_; ++j) q1[i * NX_ + j] = q[j];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NX_; ++j) {
          S acc = S(0);
#pragma unroll
          for (int l = 0; l < NX_; ++l) acc += sc[l * NX_ + i] * q1[l * NX_ + j];
          a[j] -= acc;
        }
        __syncwarp();
      }
      gj_regs(a, i, gj_inplace);
      if (lane < NX_)
#pragma unroll
        for (int j = 0; j < NX_; ++j) m[t * 144 + i * NX_ + j] = a[j];
#pragma unroll
      for (int j = 0; j < NX_; ++j) prev[j] = a[j];
    }
  }
  g.sync();
}

// `y_sweeps` in the group's first warp, through Yhat_t^-1 (`m`, T x 144):
// g (T x 12) holds r'_t on entry and is overwritten; wy gets y.
// Ends synchronized.
template <typename S, typename G>
__device__ void y_sweeps_regs(const G& grp, const S* m, const S* sc, int T, S* g, S* wy) {
  if (grp.rank() < 32) {
    const int lane = grp.rank(), i = lane < NX_ ? lane : NX_ - 1;
    // Forward sweep: g_t = r'_t - S^T (Yhat_{t-1}^-1 g_{t-1}).
    S gp = g[i];
    for (int t = 1; t < T; ++t) {
      const S* mp = m + (t - 1) * 144 + i * NX_;
      S v = S(0);
#pragma unroll
      for (int l = 0; l < NX_; ++l) v += mp[l] * lane_bcast(gp, l);
      S acc = S(0);
#pragma unroll
      for (int l = 0; l < NX_; ++l) acc += sc[l * NX_ + i] * lane_bcast(v, l);
      gp = g[t * NX_ + i] - acc;
      if (lane < NX_) g[t * NX_ + i] = gp;
    }
    // Backward sweep: y_t = Yhat_t^-1 (g_t - S y_{t+1}).
    S yn = S(0);
    for (int t = T - 1; t >= 0; --t) {
      S v = g[t * NX_ + i];
      if (t + 1 < T) {
        S acc = S(0);
#pragma unroll
        for (int l = 0; l < NX_; ++l) acc += sc[i * NX_ + l] * lane_bcast(yn, l);
        v -= acc;
      }
      const S* mt = m + t * 144 + i * NX_;
      S y = S(0);
#pragma unroll
      for (int l = 0; l < NX_; ++l) y += mt[l] * lane_bcast(v, l);
      if (lane < NX_) wy[t * NX_ + i] = y;
      yn = y;
    }
  }
  grp.sync();
}

// ---------------------------------------------------------------------------
// One N x N block's Jordan inverse in one warp (the warp groups of K5b and
// K5d-a), N <= 32 R: lane l holds rows l and, with R = 2, l + 32 (slot s)
// in registers, `a[s]`; slots whose row is >= N are idle. No row moves:
// `pos[s]` is the logical row of slot s in the swapped block. Step k takes
// the column-k entry of each row (and clears it), finds the pivot among the
// rows at logical positions >= k by a shuffle argmax under `pivot_before`
// (the first row >= k of largest |entry|, NaN above every number, the lower
// row on ties), passes the pivot row through the warp's shared-memory row
// `row` (N values): its lane stores it, the lane of column j (lane j % 32,
// slot j / 32) scales entry j there (divided by the pivot, or times its
// reciprocal when `recip`; the pivot entry 1 / pivot), and every lane reads
// the scaled row back to update its rows in registers: the pivot row takes
// the scaled row, every other row r_j - c pr_j (-c / pivot in column k);
// then the rows at positions k and p trade positions. No block barrier: the
// warp's shuffles and __syncwarp carry every exchange; each lane divides at
// most two entries a step (IEEE division is the costly operation here). The
// arithmetic of `gj_inverse_pivot` and `gj_inverse_inplace`, entry for
// entry. With `pivot` lane 0 writes the pivot row of each step to piv[k]
// (shared memory, N ints).
// ---------------------------------------------------------------------------
template <int N, int R, typename S>
__device__ __forceinline__ void gj_warp(S (&a)[R][N], int (&pos)[R], bool pivot, bool recip,
                                        int* piv, S* row) {
  static_assert(N <= 32 * R && R <= 2, "one warp holds at most 64 rows");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < R; ++s) pos[s] = lane + 32 * s;
  for (int k = 0; k < N; ++k) {
    S ck[R];
#pragma unroll
    for (int s = 0; s < R; ++s) ck[s] = S(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool at = j == k;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        ck[s] = at ? a[s][j] : ck[s];
        a[s][j] = at ? S(0) : a[s][j];
      }
    }
    int p = k, src = k;  // the pivot's logical row, and lane | slot << 5 holding it
    if (pivot) {
      // The best candidate: |entry|, and its row | (lane | slot << 5) << 8
      // (row N: none yet).
      S best = S(0);
      int who = N;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const S v = ck[s] < S(0) ? -ck[s] : ck[s];
        if (pos[s] >= k && pos[s] < N && pivot_before<S, N>(v, pos[s], best, who & 255)) {
          best = v;
          who = pos[s] | ((lane | (s << 5)) << 8);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        const S ob = __shfl_xor_sync(0xffffffffu, best, m);
        const int ow = __shfl_xor_sync(0xffffffffu, who, m);
        if (pivot_before<S, N>(ob, ow & 255, best, who & 255)) {
          best = ob;
          who = ow;
        }
      }
      p = who & 255;
      src = who >> 8;
      if (lane == 0) piv[k] = p;
    }
    const int pl = src & 31, ps = src >> 5;
    const S pv = __shfl_sync(0xffffffffu, R == 2 && ps ? ck[R - 1] : ck[0], pl);
    const S ipv = S(1) / pv;
    // The pivot row through `row`: its lane stores it, the lane of each
    // column scales that entry, every lane reads the scaled row back.
    if (lane == pl) {
#pragma unroll
      for (int j = 0; j < N; ++j) row[j] = R == 2 && ps ? a[R - 1][j] : a[0][j];
    }
    __syncwarp();
    S pr[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int col = lane + 32 * s;
      const S raw = col < N ? row[col] : S(0);
      pr[s] = col == k ? ipv : (recip ? ipv * raw : raw / pv);
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < R; ++s)
      if (lane + 32 * s < N) row[lane + 32 * s] = pr[s];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const S prj = row[j];
#pragma unroll
      for (int s = 0; s < R; ++s)
        a[s][j] = lane == pl && s == ps ? prj : a[s][j] - ck[s] * prj;
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < R; ++s) pos[s] = pos[s] == k ? p : (pos[s] == p ? k : pos[s]);
  }
}

// After `gj_warp`: the inverse's column of elimination column lane + 32 s,
// into q[s]. inv(A) = inv(P A) P undoes the row swaps as column swaps, last
// first, as `gj_inverse_pivot` does in memory; without `pivot`, the identity.
// Reads piv (written by lane 0), so it begins with __syncwarp.
template <int N, int R>
__device__ __forceinline__ void gj_warp_columns(int (&q)[R], bool pivot, const int* piv) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < R; ++s) q[s] = lane + 32 * s;
  if (!pivot) return;
  for (int k = N - 1; k >= 0; --k) {
    const int p = piv[k];
#pragma unroll
    for (int s = 0; s < R; ++s) q[s] = q[s] == k ? p : (q[s] == p ? k : q[s]);
  }
}

// Two N x N blocks (N <= 16) eliminated together in one warp, in registers
// (the two foot blocks of a stage in K1's and K5e-a's warp groups,
// `gj_pair_warp`; K5c's and K5d-c's stage blocks two at a time): lane
// 16 h + i holds row i of block h in `a` (lanes i >= N idle: they hold a
// copy of row N - 1, search no pivot and store nothing), and no row moves.
// Step k finds each block's pivot by a shuffle argmax over its 16 lanes
// (`pivot_before`: the first position >= k of largest |entry|, NaN first,
// as gj_inverse_inplace scans), or takes position k; every lane of the
// block reads the pivot row by __shfl_sync, scales it (times the pivot's
// reciprocal when `recip`, else each lane divides its own column's entry
// by the pivot and passes it round; the pivot entry 1 / pivot), and updates
// its row: the pivot row takes the scaled row, every other row r_j - c pr_j
// (-c / pivot in column k). No shared memory and no barrier: the shuffles
// carry every exchange. gj_inverse_inplace's arithmetic entry for entry.
// On exit `pos` is the position of this lane's row in the swapped block (N:
// idle) and `q` the inverse's column of elimination column i: entry
// (pos, q of lane 16 h + j) of the inverse is a[j] (without `pivot`, pos =
// q = i).
template <int N, typename S>
__device__ __forceinline__ void gj_pair_regs(S (&a)[N], bool pivot, bool recip, int& pos,
                                             int& q) {
  static_assert(N <= 16, "a block's rows fit the 16 lanes of a half warp");
  const int lane = threadIdx.x & 31, h = lane >> 4, i = lane & 15;
  const bool live = i < N;
  int pk[N];  // the pivot position of each step, the same in every lane of the block
  pos = live ? i : N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const S ck = a[k];
    int p = k, src = k;  // the pivot's position, and the lane (in the half) holding it
    if (pivot) {
      S best = S(0);
      int who = N;  // position | lane << 8 of the best candidate (N: none yet)
      const S v = ck < S(0) ? -ck : ck;
      if (live && pos >= k && pivot_before<S, N>(v, pos, best, who)) {
        best = v;
        who = pos | (i << 8);
      }
#pragma unroll
      for (int m = 8; m > 0; m >>= 1) {
        const S ob = __shfl_xor_sync(0xffffffffu, best, m);
        const int ow = __shfl_xor_sync(0xffffffffu, who, m);
        if (pivot_before<S, N>(ob, ow & 255, best, who & 255)) {
          best = ob;
          who = ow;
        }
      }
      p = who & 255;
      src = who >> 8;
    }
    pk[k] = p;
    const int sl = (h << 4) | src;
    S pr[N];
#pragma unroll
    for (int j = 0; j < N; ++j) pr[j] = __shfl_sync(0xffffffffu, a[j], sl);
    const S pvt = pr[k];
    const S ipv = S(1) / pvt;
    if (recip) {
#pragma unroll
      for (int j = 0; j < N; ++j) pr[j] = j == k ? ipv : ipv * pr[j];
    } else {
      S own = S(0);
#pragma unroll
      for (int j = 0; j < N; ++j) own = j == i ? pr[j] : own;
      own = i == k ? ipv : own / pvt;
#pragma unroll
      for (int j = 0; j < N; ++j) pr[j] = __shfl_sync(0xffffffffu, own, (h << 4) | j);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = i == src ? pr[j] : (j == k ? -ck * pr[j] : a[j] - ck * pr[j]);
    pos = pos == k ? p : (pos == p ? k : pos);
  }
  // Column i of the elimination is column q of the inverse: the row swaps
  // undone as column swaps, last first.
  q = i;
  if (pivot) {
#pragma unroll
    for (int k = N - 1; k >= 0; --k) q = q == k ? pk[k] : (q == pk[k] ? k : q);
  }
}

// alpha = max(min(1, frac min_i(dv_i < 0 ? -v_i / dv_i : 1)), alpha_min);
// NaN propagates, as jnp.minimum / jnp.maximum do.
template <typename S, typename G>
__device__ S frac_to_boundary(const G& g, const S* v, const S* dv, int n, S* red, S frac,
                              S alpha_min) {
  S mn = S(INFINITY);
  for (int k = g.rank(); k < n; k += g.size()) {
    const S c = dv[k] < S(0) ? -v[k] / dv[k] : S(1);
    mn = nan_min(mn, c);
  }
  mn = group_min(g, mn, red);
  S a = frac * mn;
  a = (a != a) ? a : (a < S(1) ? a : S(1));
  return (a != a) ? a : (a > alpha_min ? a : alpha_min);
}

// ---------------------------------------------------------------------------
// The two reduced-solve forms, each with its refinement, from the layout's
// rhs buffers to the directions (dx, ds, dz, dy). They call the route's one
// solve P::solve(sm, L, r1, rz, r4, dx, dz, dy) (rz and dz only on the
// augmented routes).
// ---------------------------------------------------------------------------

// Augmented: rz = r3 - r2 / Sigma already formed; the refinement residual of
// the [x, z, y] system (`refine_residual`, working precision or df).
template <typename P, typename S, typename Layout, typename G>
__device__ void reduced_solve_aug(const G& g, S* sm, const Layout& L, int refine_steps,
                                  bool refine_df, S beta, S delta, S* dx, S* ds, S* dz, S* dy) {
  const int tid = g.rank(), nt = g.size();
  const S* r2 = sm + L.r2;
  const S* sig = sm + L.sig;
  S* ex = sm + L.ex;
  S* ezz = sm + L.ezz;
  S* ey = sm + L.ey;
  const int nz = L.nz, ni = L.ni, ne = L.ne;

  PDIPM_MARK(g, PH_UPDATE);
  P::solve(g, sm, L, sm + L.r1, sm + L.rz, sm + L.r4, dx, dz, dy);
  for (int rs = 0; rs < refine_steps; ++rs) {
    refine_residual(g, sm, L, refine_df, beta, delta, dx, dz, dy);
    PDIPM_MARK(g, PH_REFINE);
    P::solve(g, sm, L, sm + L.e1, sm + L.ez, sm + L.e4, ex, ezz, ey);
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) dx[it] += ex[it];
      else if (it < nz + ni) dz[it - nz] += ezz[it - nz];
      else dy[it - nz - ni] += ey[it - nz - ni];
    }
    g.sync();
    PDIPM_MARK(g, PH_REFINE);
  }
  for (int k = tid; k < ni; k += nt) ds[k] = (r2[k] - dz[k]) / sig[k];
  g.sync();
  PDIPM_MARK(g, PH_UPDATE);
}

// Condensed: tmp = W^-1 (r3 - r2 / Sigma) already formed, z eliminated.
template <typename P, typename S, typename Layout, typename G>
__device__ void reduced_solve_condensed(const G& g, S* sm, const Layout& L, int refine_steps,
                                        S beta, S delta, S* dx, S* ds, S* dz, S* dy) {
  const int tid = g.rank(), nt = g.size();
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
  g.sync();
  PDIPM_MARK(g, PH_UPDATE);
  P::solve(g, sm, L, r1h, (const S*)nullptr, r4, dx, (S*)nullptr, dy);
  for (int rs = 0; rs < refine_steps; ++rs) {
    for (int k = tid; k < ni; k += nt) tmp[k] = w[k] * g_entry(sm, L, k, dx);
    g.sync();
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
    g.sync();
    PDIPM_MARK(g, PH_REFINE);
    P::solve(g, sm, L, e1, (const S*)nullptr, e4, ex, (S*)nullptr, ey);
    for (int it = tid; it < nz + ne; it += nt) {
      if (it < nz) dx[it] += ex[it];
      else dy[it - nz] += ey[it - nz];
    }
    g.sync();
    PDIPM_MARK(g, PH_REFINE);
  }
  // dz = W^-1 (G dx + r2 / Sigma - r3), ds = (r2 - dz) / Sigma
  for (int k = tid; k < ni; k += nt) {
    const S v = w[k] * (g_entry(sm, L, k, dx) + r2[k] / sig[k] - r3[k]);
    dz[k] = v;
    ds[k] = (r2[k] - v) / sig[k];
  }
  g.sync();
  PDIPM_MARK(g, PH_UPDATE);
}

// The route's reduced solve: the augmented or the condensed form.
template <typename P, typename S, typename Layout, typename G>
__device__ __forceinline__ void reduced_solve(const G& g, S* sm, const Layout& L,
                                              int refine_steps, bool refine_df, S beta, S delta,
                                              S* dx, S* ds, S* dz, S* dy) {
  if constexpr (P::AUG) {
    reduced_solve_aug<P>(g, sm, L, refine_steps, refine_df, beta, delta, dx, ds, dz, dy);
  } else {
    reduced_solve_condensed<P>(g, sm, L, refine_steps, beta, delta, dx, ds, dz, dy);
  }
}

// Inequality row k of a reduced solve's rhs from its (r2, r3) entries: r2,
// and rz = r3 - r2 / Sigma (augmented) or r3 and tmp = W^-1 (r3 - r2 / Sigma)
// (condensed), as `reduced_solve` reads them.
template <typename P, typename S, typename Layout>
__device__ __forceinline__ void set_rhs_ineq(S* sm, const Layout& L, int k, S v2, S v3) {
  sm[L.r2 + k] = v2;
  if constexpr (P::AUG) {
    sm[L.rz + k] = v3 - v2 / sm[L.sig + k];
  } else {
    sm[L.r3 + k] = v3;
    sm[L.tmp + k] = sm[L.w + k] * (v3 - v2 / sm[L.sig + k]);
  }
}

// d += e over the four parts of a direction (nz, ni, ni, ne values).
template <typename S, typename Layout, typename G>
__device__ void add_direction(const G& g, const Layout& L, S* dx, S* ds, S* dz, S* dy,
                              const S* ex, const S* es, const S* ez, const S* ey) {
  const int tid = g.rank(), nt = g.size(), nz = L.nz, ni = L.ni, ne = L.ne;
  for (int it = tid; it < nz + ni + ne; it += nt) {
    if (it < nz) {
      dx[it] += ex[it];
    } else if (it < nz + ni) {
      const int k = it - nz;
      ds[k] += es[k];
      dz[k] += ez[k];
    } else {
      dy[it - nz - ni] += ey[it - nz - ni];
    }
  }
  g.sync();
}

// The kernel's layout of route P: for a WORKSPACE policy with `work`
// non-null, the stored inverses in env's slice of it.
template <typename P, typename S>
__device__ __forceinline__ typename P::Layout kernel_layout(int T, unsigned char* work,
                                                            long env) {
  if constexpr (WorkPolicy<P>::value) {
    typename P::Layout L = P::make_layout(T, (int)sizeof(S), work != nullptr);
    L.wk = work == nullptr ? nullptr : work + env * L.work_bytes;
    return L;
  } else {
    return P::make_layout(T, (int)sizeof(S));
  }
}

// ---------------------------------------------------------------------------
// The Newton-step kernel of every route: `iterations` Mehrotra steps of one
// env per group G (a block, or NW warps of a block with several envs), from
// the cold start or the warm state, in the corrector
// form of `A.corrector_form` (`iteration_base`, `pdipm_pallas.py:1237-1485`):
//   delta       refined affine solve, refined corrector solve, added;
//   combined    unrefined affine solve, then one refined solve of the summed
//               rhs (-rx, -(s z + rc) / s, -rs, -re) into the direction;
//   sum_refine  both unrefined, added, then `refine` passes of one unrefined
//               solve of the full 4-row KKT residual of the sum, added;
//   aff_ref     refined affine solve, unrefined corrector, added.
// The first A.refine_skip steps run at refine 0 (`:1499-1517`). Sigma = z / s
// + delta is capped at A.sigma_cap when that is > 0, before W is formed.
//
// A route policy P supplies:
//   Layout, make_layout(T, size_of_s)  its shared-memory layout (host and
//        device); besides the fields read above and below, `piv` (byte
//        offset of its int pivot table) and `bytes` (one env's, and so
//        one block's);
//   AUG  true: z stays in the stage blocks, W = Sigma^-1 + delta, the
//        augmented reduced solve, refine_df accepted; false: z eliminated
//        with W^-1 = Sigma / (1 + delta Sigma), the condensed reduced solve,
//        refine_df refused by `launch`;
//   setup(g, sm, L, beta, delta)  the solve's constants, after load_env;
//   factor(g, sm, L, piv, beta, delta, ff)  the factorization at the current
//        W (W^-1), with the options it reads (`FactorFlags`; routes ignore
//        those that do not apply to them);
//   solve(g, sm, L, r1, rz, r4, dx, dz, dy)  one reduced solve through it.
//
// The corrector forms reuse the corrector's buffers (dxc ... dyc) for the
// sum_refine correction and e1 (read only by a refinement pass, which the
// form's inner solves never run) for its summed r2, so no layout grows.
// The outputs may alias the warm state x0, s0, z0, y0 (load_env), so none of
// those pointers is __restrict__.
// ---------------------------------------------------------------------------
template <typename P, typename S, typename G = BlockGroup, typename C = KernelConfig<S, G>>
__global__ void __launch_bounds__(C::threads) __maxnreg__(C::regs)
pdipm_kernel(
    const S* __restrict__ hd_in, const S* __restrict__ f_in, const S* __restrict__ ad_in,
    const S* __restrict__ bd_in, const S* __restrict__ b_in, const S* __restrict__ gu_in,
    const S* __restrict__ d_in, const S* x0, const S* s0, const S* z0, const S* y0,
    S* x_out, S* s_out, S* z_out, S* y_out, S* res_out, const int* go, int* ran, int T,
    const StepArgs<S> A, unsigned char* work) {
  if (!gate_open(go, ran)) return;
  const G g{};
  const long env = g.env();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const typename P::Layout L = kernel_layout<P, S>(T, work, env);
  S* sm = reinterpret_cast<S*>(smem_raw);
  int* piv = reinterpret_cast<int*>(smem_raw + L.piv);
  const int tid = g.rank(), nt = g.size();
  const int nz = L.nz, ni = L.ni, ne = L.ne;
  S* red = sm + L.red;
  const S beta = A.beta, delta = A.delta;
#ifdef PDIPM_PROFILE
  g.last = clock64();
#endif

  // f, b and d: in the layout, or (a lean layout that leaves them out) read
  // from device memory through the read-only path once per Newton step.
  constexpr bool fbd_global = LeanPolicy<P>::inputs_in_global;
  constexpr bool formed = LeanPolicy<P>::residuals_formed;
  constexpr bool block_order = BlockOrderPolicy<P>::value;
  static_assert(!(block_order && formed), "block-order sums read the stored residuals");
  load_env<!fbd_global>(g, sm, L, env, hd_in, f_in, ad_in, bd_in, b_in, gu_in, d_in, x0, s0, z0,
                        y0);
  P::setup(g, sm, L, beta, delta);
  PDIPM_MARK(g, PH_LOAD);
  const S* fv = fbd_global ? f_in + env * nz : sm + L.f;
  const S* dv = fbd_global ? d_in + env * ni : sm + L.d;
  const S* bv = fbd_global ? b_in + env * ne : sm + L.b;

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
  S* r4 = sm + L.r4;
  S* r2s = sm + L.e1;  // sum_refine: the summed direction's r2
  S* dxa = sm + L.dxa; S* dsa = sm + L.dsa; S* dza = sm + L.dza; S* dya = sm + L.dya;
  S* dxc = sm + L.dxc; S* dsc = sm + L.dsc; S* dzc = sm + L.dzc; S* dyc = sm + L.dyc;
  const S nif = S(ni);
  const bool df = A.refine_df;
  const int form = A.corrector_form;
  // The KKT residuals at the iterate, entry by entry: rx, rs, re.
  auto rx_at = [&](int i) -> S {
    return sm[L.hd + i] * x[i] + fv[i] + gT_entry(sm, L, i, z) + aT_entry(sm, L, i, y);
  };
  auto rs_at = [&](int k) -> S { return g_entry(sm, L, k, x) + s[k] - dv[k]; };
  auto re_at = [&](int e) -> S { return a_entry(sm, L, e, x) - bv[e]; };
  // ... as the step reads them: stored by the residual pass, or (`formed`)
  // formed again, from the same iterate, where read.
  auto rx_v = [&](int i) -> S { if constexpr (formed) return rx_at(i); else return rx[i]; };
  auto rs_v = [&](int k) -> S { if constexpr (formed) return rs_at(k); else return rsb[k]; };
  auto re_v = [&](int e) -> S { if constexpr (formed) return re_at(e); else return re[e]; };
  S p0 = S(0), p1 = S(0), p2 = S(0);  // residual norms' partial sums (`formed`)

  for (int iter = 0; iter < A.iterations; ++iter) {
    const int refine = iter < A.refine_skip ? 0 : A.refine_steps;
    const bool last = iter + 1 == A.iterations;
    // KKT residuals at the current iterate, Sigma, and W = 1 / Sigma + delta
    // (augmented) or W^-1 = Sigma / (1 + delta Sigma) (condensed).
    S part = S(0);
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        const int i = it;
        if constexpr (formed) {
          if (last) { const S v = rx_at(i); p0 += v * v; }
        } else {
          rx[i] = rx_at(i);
        }
      } else if (it < nz + ni) {
        const int k = it - nz;
        if constexpr (formed) {
          if (last) { const S v = rs_at(k); p1 += v * v; }
        } else {
          rsb[k] = rs_at(k);
        }
        S sg = z[k] / s[k] + delta;
        if (A.sigma_cap > S(0) && sg > A.sigma_cap) sg = A.sigma_cap;
        sig[k] = sg;
        w[k] = P::AUG ? S(1) / sg + delta : sg / (S(1) + delta * sg);
        part += s[k] * z[k];
      } else {
        const int e = it - nz - ni;
        if constexpr (formed) {
          if (last) { const S v = re_at(e); p2 += v * v; }
        } else {
          re[e] = re_at(e);
        }
      }
    }
    PDIPM_MARK(g, PH_RESID);
    // mu: the pass's partials, or the block-order sum of s z over its ni
    // rows, which start at entry nz of the pass.
    const S mu = group_total<block_order>(g, part, nz, ni, [&](int k) { return s[k] * z[k]; },
                                          red) / nif;  // syncs
    PDIPM_MARK(g, PH_REDUCE);

    P::factor(g, sm, L, piv, beta, delta, A.ff);

    // Affine direction: rhs (-rx, -(s z)/s, -rs, -re); unrefined in the
    // combined and sum_refine forms.
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        r1[it] = -rx_v(it);
      } else if (it < nz + ni) {
        const int k = it - nz;
        set_rhs_ineq<P>(sm, L, k, -(s[k] * z[k]) / s[k], -rs_v(k));
      } else {
        r4[it - nz - ni] = -re_v(it - nz - ni);
      }
    }
    g.sync();
    const bool cheap_affine = form == CORRECTOR_COMBINED || form == CORRECTOR_SUM_REFINE;
    reduced_solve<P>(g, sm, L, cheap_affine ? 0 : refine, df, beta, delta, dxa, dsa, dza, dya);
    const S ap = frac_to_boundary(g, s, dsa, ni, red, A.frac_to_boundary, A.alpha_min);
    const S adl = frac_to_boundary(g, z, dza, ni, red, A.frac_to_boundary, A.alpha_min);
    part = S(0);
    auto aff = [&](int k) { return (s[k] + ap * dsa[k]) * (z[k] + adl * dza[k]); };
    if constexpr (!block_order)
      for (int k = tid; k < ni; k += nt) part += aff(k);
    const S mu_aff = group_total<block_order>(g, part, 0, ni, aff, red) / nif;
    const S ratio = mu_aff / mu;
    const S sigma = ratio * ratio * ratio;
    PDIPM_MARK(g, PH_REDUCE);

    // Corrector, rc = s z + ds_a dz_a - sigma mu: rhs (0, -rc/s, 0, 0), or
    // the summed rhs (-rx, -(s z + rc)/s, -rs, -re) in the combined form.
    const bool combined = form == CORRECTOR_COMBINED;
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        r1[it] = combined ? -rx_v(it) : S(0);
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S rc = s[k] * z[k] + dsa[k] * dza[k] - sigma * mu;
        if (combined) {
          set_rhs_ineq<P>(sm, L, k, -(s[k] * z[k] + rc) / s[k], -rs_v(k));
        } else {
          set_rhs_ineq<P>(sm, L, k, -rc / s[k], S(0));
          if (form == CORRECTOR_SUM_REFINE) r2s[k] = -(s[k] * z[k] + rc) / s[k];
        }
      } else {
        r4[it - nz - ni] = combined ? -re_v(it - nz - ni) : S(0);
      }
    }
    g.sync();
    if (combined) {
      reduced_solve<P>(g, sm, L, refine, df, beta, delta, dxa, dsa, dza, dya);
    } else {
      reduced_solve<P>(g, sm, L, form == CORRECTOR_DELTA ? refine : 0, df, beta, delta, dxc,
                       dsc, dzc, dyc);
      add_direction(g, L, dxa, dsa, dza, dya, dxc, dsc, dzc, dyc);
    }
    if (form == CORRECTOR_SUM_REFINE) {
      // Refine the summed direction against the full 4-row KKT residual:
      // m1 = H dx + beta dx + G^T dz + A^T dy, m2 = Sigma ds + dz,
      // m3 = G dx + ds - delta dz, m4 = A dx - delta dy.
      for (int rs = 0; rs < refine; ++rs) {
        for (int it = tid; it < nz + ni + ne; it += nt) {
          if (it < nz) {
            const int i = it;
            const S m1 = sm[L.hd + i] * dxa[i] + beta * dxa[i] + gT_entry(sm, L, i, dza)
                       + aT_entry(sm, L, i, dya);
            r1[i] = -rx_v(i) - m1;
          } else if (it < nz + ni) {
            const int k = it - nz;
            const S m2 = sig[k] * dsa[k] + dza[k];
            const S m3 = g_entry(sm, L, k, dxa) + dsa[k] - delta * dza[k];
            set_rhs_ineq<P>(sm, L, k, r2s[k] - m2, -rs_v(k) - m3);
          } else {
            const int e = it - nz - ni;
            r4[e] = -re_v(e) - (a_entry(sm, L, e, dxa) - delta * dya[e]);
          }
        }
        g.sync();
        PDIPM_MARK(g, PH_REFINE);
        reduced_solve<P>(g, sm, L, 0, df, beta, delta, dxc, dsc, dzc, dyc);
        add_direction(g, L, dxa, dsa, dza, dya, dxc, dsc, dzc, dyc);
      }
    }
    PDIPM_MARK(g, PH_UPDATE);
    const S alp = frac_to_boundary(g, s, dsa, ni, red, A.frac_to_boundary, A.alpha_min);
    const S ald = frac_to_boundary(g, z, dza, ni, red, A.frac_to_boundary, A.alpha_min);
    PDIPM_MARK(g, PH_REDUCE);
    const S floor_ = A.sz_floor;
    for (int it = tid; it < nz + ni + ne; it += nt) {
      if (it < nz) {
        x[it] += alp * dxa[it];
      } else if (it < nz + ni) {
        const int k = it - nz;
        const S sn = s[k] + alp * dsa[k];
        const S zn = z[k] + ald * dza[k];
        s[k] = sn > floor_ || sn != sn ? sn : floor_;
        z[k] = zn > floor_ || zn != zn ? zn : floor_;
      } else {
        y[it - nz - ni] += ald * dya[it - nz - ni];
      }
    }
    g.sync();
    PDIPM_MARK(g, PH_UPDATE);
  }

  // Residual norms of the last step's start (summed by its residual pass
  // when `formed`), and mu after it.
  S p3 = S(0);
  if (!block_order && A.iterations > 0) {
    if constexpr (!formed)
      for (int i = tid; i < nz; i += nt) p0 += rx[i] * rx[i];
    for (int k = tid; k < ni; k += nt) {
      if constexpr (!formed) p1 += rsb[k] * rsb[k];
      p3 += s[k] * z[k];
    }
    if constexpr (!formed)
      for (int e = tid; e < ne; e += nt) p2 += re[e] * re[e];
  }
  const int n_sum = A.iterations > 0 ? 1 : 0;  // no step: every norm 0
  p0 = group_total<block_order>(g, p0, 0, n_sum * nz, [&](int i) { return rx[i] * rx[i]; }, red);
  p1 = group_total<block_order>(g, p1, 0, n_sum * ni, [&](int k) { return rsb[k] * rsb[k]; }, red);
  p2 = group_total<block_order>(g, p2, 0, n_sum * ne, [&](int e) { return re[e] * re[e]; }, red);
  p3 = group_total<block_order>(g, p3, 0, n_sum * ni, [&](int k) { return s[k] * z[k]; }, red);
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
#ifdef PDIPM_PROFILE
  PDIPM_MARK(g, PH_STORE);
  if (tid == 0 && env < PDIPM_PROF_MAX_ENVS)
    for (int ph = 0; ph < PH_COUNT; ++ph) pdipm_prof[env * PH_COUNT + ph] = g.acc[ph];
#endif
}

template <typename S>
static StepArgs<S> step_args(const PdipmArgs* args) {
  StepArgs<S> a;
  a.iterations = args->iterations;
  a.refine_steps = args->refine_steps;
  a.refine_skip = args->refine_skip;
  a.corrector_form = args->corrector_form;
  a.refine_df = args->refine_df != 0;
  a.ff = FactorFlags{args->kkt_jacobi != 0, args->gj_inplace != 0, args->aug_pivot != 0,
                     args->k_pivot != 0, args->foot_pack};
  a.beta = (S)args->beta;
  a.delta = (S)args->delta;
  a.sigma_cap = (S)args->sigma_cap;
  a.frac_to_boundary = (S)args->frac_to_boundary;
  a.alpha_min = (S)args->alpha_min;
  a.sz_floor = (S)args->sz_floor;
  return a;
}

// Host side of every route's `pdipm_<route>_f32` / `_f64` entry (route
// policy P in the block group, one env per 128-thread block) and of the
// `pdipm_<route>_warp_f32` / `_f64` entries (a lean policy in its warp group
// G, one env per block of G::THREADS threads; K5b's and K5d-a's with the
// workspace `work`, batch x `work_bytes` bytes of device memory, or null):
// sets the kernel's shared memory (one env's layout), launches `batch`
// blocks on `stream` with the options `*args` and returns a cudaError_t (0 =
// success). The compensated
// residual refines the augmented system; a condensed route keeps the common
// argument list, and `pdipm.check_options` refuses df there before any
// launch, so the guard below fires only for a direct C caller.
template <typename P, typename S, typename G = BlockGroup>
static int launch(const void* hd, const void* f, const void* ad, const void* bd, const void* b,
                  const void* gu, const void* d, const void* x0, const void* s0, const void* z0,
                  const void* y0, void* x, void* s, void* z, void* y, void* res, const void* go,
                  void* ran, int batch, int T, const PdipmArgs* args, void* stream,
                  void* work = nullptr) {
  if (args == nullptr || (!P::AUG && args->refine_df != 0)) return (int)cudaErrorInvalidValue;
  if (work != nullptr && !WorkPolicy<P>::value) return (int)cudaErrorInvalidValue;
  using C = typename RouteConfig<P, S, G>::type;
  const StepArgs<S> a = step_args<S>(args);
  const typename P::Layout L = route_layout<P>(T, (int)sizeof(S), work != nullptr);
  cudaError_t err = cudaFuncSetAttribute(pdipm_kernel<P, S, G, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (G::WARP) {
    err = cudaFuncSetAttribute(pdipm_kernel<P, S, G, C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  if (batch == 0) return 0;
  pdipm_kernel<P, S, G, C><<<batch, G::THREADS, L.bytes, (cudaStream_t)stream>>>(
      (const S*)hd, (const S*)f, (const S*)ad, (const S*)bd, (const S*)b, (const S*)gu,
      (const S*)d, (const S*)x0, (const S*)s0, (const S*)z0, (const S*)y0, (S*)x, (S*)s, (S*)z,
      (S*)y, (S*)res, (const int*)go, (int*)ran, T, a, (unsigned char*)work);
  return (int)cudaGetLastError();
}

// Resident envs per SM of route P in group G (one env per block), its
// stored inverses in the workspace when `work`, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
template <typename P, typename S, typename G>
static int envs_per_sm(int T, bool work = false) {
  using C = typename RouteConfig<P, S, G>::type;
  const size_t bytes = route_layout<P>(T, (int)sizeof(S), work).bytes;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(pdipm_kernel<P, S, G, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && G::WARP)
    err = cudaFuncSetAttribute(pdipm_kernel<P, S, G, C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pdipm_kernel<P, S, G, C>,
                                                        G::THREADS, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Whether a WORKSPACE policy P in group G keeps its stored inverses in the
// workspace at horizon T: when its layout with them does not fit in
// PDIPM_MAX_SMEM, or when leaving them out lets more envs reside on an SM
// (the occupancy calculator: registers, threads and shared memory). Where
// shared memory holds the env, more resident envs hide the latency of its
// chain of dependent steps better than shared memory serves the inverses
// (PERF.md, Findings).
template <typename P, typename S, typename G>
static bool uses_workspace(int T) {
  if (P::make_layout(T, (int)sizeof(S), false).bytes > PDIPM_MAX_SMEM) return true;
  return envs_per_sm<P, S, G>(T, true) > envs_per_sm<P, S, G>(T, false);
}

// The C entries' bytes of a WORKSPACE policy (K5b's and K5d-a's warp
// groups): one env's shared memory as it launches (`lean_bytes`), and the
// workspace per env, 0 when the inverses stay in shared memory, or with
// `force` whenever (`work_bytes`).
template <typename P, typename G>
static size_t lean_bytes(int T, int size_of_s) {
  const bool work = size_of_s == 4 ? uses_workspace<P, float, G>(T)
                                   : uses_workspace<P, double, G>(T);
  return P::make_layout(T, size_of_s, work).bytes;
}

template <typename P, typename G>
static size_t work_bytes(int T, int size_of_s, bool force) {
  const bool work = force || (size_of_s == 4 ? uses_workspace<P, float, G>(T)
                                             : uses_workspace<P, double, G>(T));
  return work ? P::make_layout(T, size_of_s, true).work_bytes : 0;
}

#ifdef PDIPM_PROFILE
// Copies the breakdown of the last launch, n envs x PH_COUNT cycles, to the
// host buffer `out` and clears the device table; a cudaError_t.
static int prof_read(void* out, int n) {
  if (n > PDIPM_PROF_MAX_ENVS) n = PDIPM_PROF_MAX_ENVS;
  const size_t bytes = sizeof(unsigned long long) * PH_COUNT * (size_t)n;
  cudaError_t err = cudaMemcpyFromSymbol(out, pdipm_prof, bytes);
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, pdipm_prof);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, sizeof(unsigned long long) * PH_COUNT * PDIPM_PROF_MAX_ENVS);
}
#endif

// One route's extern "C" entries take these arguments: the QP inputs hd, f,
// Ad, Bd, b, G_u, d; the warm start x0, s0, z0, y0 (all null: cold start);
// the outputs x, s, z, y, res (they may be the warm buffers); the gate go and
// the counter ran (null: always run, no count); batch, T, the options and
// the stream (`pdipm_cuda.ENTRY_ARGTYPES`); K1's and K2's warp entries
// take the same.
