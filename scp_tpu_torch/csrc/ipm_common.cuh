// The Mehrotra step algebra shared by the two fused IPM kernels: the
// structured kernel (ipm_struct.cu, KKT formed from pair slabs) and the
// dense-G kernel (ipm_dense.cu, KKT formed from a dense G), each running all
// fixed iterations in one launch. Both hold one QP
// instance per CTA with the inequality system stacked as [G rows | ub rows |
// lb rows] (m = mg + 2n entries) and the factored KKT matrix in shared
// memory; they differ only in how they form that matrix and in how they
// multiply by G. The second difference is a template parameter here: a
// `Rows` type with
//
//   float row(const float* x, int r) const   // (G x)[r],   r < mg
//   template <class Epi> void cols(const float* v, Epi epi) const
//     // all threads call; (G^T v)[c] for every c < n, split across the
//     // block's threads however the type likes, and epi(c, (G^T v)[c]) run
//     // once per column by the thread that holds the sum; no barrier
//
// The factor and the two substitutions are the package's one blocked factor
// and one blocked solve (chol_blocked.cuh); what follows the factorization
// is common too: predictor, corrector, n_cor
// Gondzio correctors with per-instance acceptance, step lengths,
// sigma = (mu_aff / mu)^3, the exact (1 - alpha) primal-residual recurrence,
// and freeze on stall / convergence / a non-finite step.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "chol_blocked.cuh"

namespace scpk {

// Threads of a CTA of either fused IPM kernel (one QP instance per CTA).
constexpr int kIpmThreads = 256;
// Floats of the block reductions' scratch (one per warp).
constexpr int kRedWords = 32;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / min of one value per thread; every thread gets the result.
__device__ inline float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarp = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < nwarp; ++w) t += red[w];
  return t;
}

__device__ inline float block_min(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarp = blockDim.x >> 5;
  v = warp_min(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < nwarp; ++w) t = fminf(t, red[w]);
  return t;
}

// -v / dv where the step shrinks the variable, +inf elsewhere. A NaN step is
// not "< 0" and maps to +inf, as in the TPU kernel; the update then goes
// non-finite and the finite check freezes the instance.
__device__ inline float step_ratio(float v, float dv) {
  return dv < 0.0f ? -v / dv : CUDART_INF_F;
}

// The per-instance vectors in shared memory (m entries for the first nine,
// n for the next nine), the factored matrix, the reduction scratch
// (kRedWords) and the factor's failure flag.
struct IpmVecs {
  float *s, *z, *rp, *w, *a1, *a2, *a3, *dz, *ds;
  float *q, *pdiag, *x, *px, *dsc, *kb, *rhs, *dx, *dinv;
  float *K, *red;
  int* bad;
};

// mg G rows, n variables, m = mg + 2n rows in all; the factored system has
// nk columns with leading dimension ldk. With `schur` the last variable (a
// slack whose P row is zero) is eliminated by a rank-1 border (kb) and
// nk = n - 1; without it nk = n.
struct IpmDims {
  int mg, n, m, nk, ldk;
  bool schur;
};

// w = z / s over all m rows; returns mu = s.z / m. All threads call.
__device__ inline float weights_and_mu(const IpmVecs& v, const IpmDims& d) {
  float part = 0.0f;
  for (int r = threadIdx.x; r < d.m; r += blockDim.x) {
    v.w[r] = v.z[r] / v.s[r];
    part += v.s[r] * v.z[r];
  }
  return block_sum(part, v.red) / (float)d.m;
}

// rhs[c] = -(px + q + Ghat^T vin) with Ghat = [G; I; -I]; `vin` spans all m
// rows (without the cost terms when `with_cost` is false).
template <class Rows>
__device__ inline void build_rhs(const Rows& g, const IpmVecs& v,
                                 const IpmDims& d, const float* vin,
                                 bool with_cost) {
  g.cols(vin, [&](int c, float gt) {
    const float box = vin[d.mg + c], boxl = vin[d.mg + d.n + c];
    const float head = with_cost ? (v.px[c] + v.q[c]) + gt : gt;
    v.rhs[c] = -((head + box) - boxl);
  });
}

// Factor the formed nk x nk KKT matrix in place (lower triangle, L_jj on
// the diagonal, dinv = 1 / L_jj). A failed factor (a pivot not > 0) writes
// NaN into dinv[0], which makes every solve against it NaN throughout, so
// that the step's finite check freezes the instance. All threads call; the
// solve that follows starts with a block barrier.
//
// A kernel may call the factor out of line by defining SCP_IPM_FACTOR_CALL
// as __noinline__ before including this header: the dense-G kernel does,
// since inlined, the factor's register tiles spilled its step algebra under
// its launch bounds (PERF.md); the structured kernel spilled more with it
// out of line. kDevK: the factored matrix lies in device memory (a kernel's
// device tier); kDevV: its dinv too (a global tier). Each combination is a
// function of its own, so that an out-of-line factor whose every caller
// passes shared memory keeps shared-memory loads rather than generic ones.
#ifndef SCP_IPM_FACTOR_CALL
#define SCP_IPM_FACTOR_CALL inline
#endif

template <bool kDevK, bool kDevV = false>
static __device__ SCP_IPM_FACTOR_CALL void ipm_factor(float* K, int n, int ld,
                                                      float* dinv, int* bad) {
  chol_blocked_smem<kIpmThreads>(K, n, ld, dinv, bad);
}

template <bool kDevK, bool kDevV = false>
__device__ inline void factor_kkt(const IpmVecs& v, const IpmDims& d) {
  if (threadIdx.x == 0) *v.bad = 0;
  ipm_factor<kDevK, kDevV>(v.K, d.nk, d.ldk, v.dinv, v.bad);
  if (threadIdx.x == 0 && *v.bad) v.dinv[0] = CUDART_NAN_F;
}

// The two triangular solves against the factored KKT matrix (v.K, leading
// dimension ld) in place in y: the blocked solve of chol_blocked.cuh. A
// kernel whose factor lies elsewhere overloads this on its Rows type
// (ipm_struct.cu's cluster tier: the factor's rows on other CTAs).
template <class Rows>
__device__ inline void kkt_tri_solve(const Rows&, const IpmVecs& v, int n,
                                     int ld, float* y) {
  chol_blocked_solve_smem<kIpmThreads>(v.K, n, ld, v.dinv, y);
}

// dx = K^-1 rhs through the Jacobi scaling (and, with the Schur border, the
// bordered back-substitution for the slack); in place in v.rhs. All threads
// call.
template <class Rows>
__device__ inline void solve_kkt(const Rows& g, const IpmVecs& v,
                                 const IpmDims& d, float inv_kappa) {
  __syncthreads();
  if (!d.schur) {
    for (int c = threadIdx.x; c < d.n; c += blockDim.x)
      v.rhs[c] = v.dsc[c] * v.rhs[c];
    kkt_tri_solve(g, v, d.n, d.ldk, v.rhs);
    for (int c = threadIdx.x; c < d.n; c += blockDim.x)
      v.rhs[c] = v.dsc[c] * v.rhs[c];
    __syncthreads();
    return;
  }
  const int nu = d.nk;
  const float rw = v.dsc[nu] * v.rhs[nu];
  __syncthreads();
  for (int c = threadIdx.x; c < nu; c += blockDim.x)
    v.rhs[c] = v.dsc[c] * v.rhs[c] - v.kb[c] * (inv_kappa * rw);
  kkt_tri_solve(g, v, nu, d.ldk, v.rhs);
  float part = 0.0f;
  for (int c = threadIdx.x; c < nu; c += blockDim.x)
    part += v.kb[c] * v.rhs[c];
  const float dot = block_sum(part, v.red);
  const float xw = (rw - dot) * inv_kappa;
  __syncthreads();
  for (int c = threadIdx.x; c < d.n; c += blockDim.x)
    v.rhs[c] = v.dsc[c] * (c < nu ? v.rhs[c] : xw);
  __syncthreads();
}

// out[r] = (Ghat x)[r] over all m rows.
template <class Rows>
__device__ inline void ghat_mv(const Rows& g, const IpmDims& d,
                               const float* xv, float* out) {
  for (int r = threadIdx.x; r < d.m; r += blockDim.x) {
    float val;
    if (r < d.mg) val = g.row(xv, r);
    else if (r < d.mg + d.n) val = xv[r - d.mg];
    else val = -xv[r - d.mg - d.n];
    out[r] = val;
  }
}

// min(1, 0.99 * min ratio) over the s rows and the z rows.
__device__ inline float step_length(const IpmVecs& v, const IpmDims& d,
                                    const float* ds, const float* dz) {
  float r = CUDART_INF_F;
  for (int i = threadIdx.x; i < d.m; i += blockDim.x) {
    r = fminf(r, step_ratio(v.s[i], ds[i]));
    r = fminf(r, step_ratio(v.z[i], dz[i]));
  }
  return fminf(1.0f, 0.99f * block_min(r, v.red));
}

// Section marks of the step for the structured kernel's cycle profile
// (ipm_struct.cu); `mark(i)` is a no-op elsewhere.
enum { kSecLoad, kSecDiag, kSecForm, kSecChol, kSecRhs, kSecSolve,
       kSecVector, kSecUpdate, kSecStore, kSecCount };

// One Mehrotra predictor-corrector step on the factored KKT matrix (v.K,
// v.dinv, v.dsc and, with the Schur border, v.kb are ready; v.w holds z / s
// and `mu` the pre-step complementarity). Updates x, s, z, rp in place
// unless the instance freezes; `mu_prev` / `frozen` carry the freeze
// bookkeeping. All threads call.
template <class Rows, class Mark>
__device__ inline void mehrotra_step(const Rows& g, const IpmVecs& v,
                                     const IpmDims& d, float mu,
                                     float& mu_prev, bool& frozen,
                                     int n_cor, float tol, float tol_stall,
                                     float inv_kappa, Mark mark) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = d.m, n = d.n;

  // ---- predictor: rc = s z  =>  t = w rp - z ----
  for (int r = tid; r < m; r += nt) {
    const float t = v.w[r] * v.rp[r] - v.z[r];
    v.a3[r] = v.z[r] + t;
  }
  __syncthreads();
  build_rhs(g, v, d, v.a3, true);
  mark(kSecRhs);
  solve_kkt(g, v, d, inv_kappa);
  mark(kSecSolve);
  ghat_mv(g, d, v.rhs, v.a3);
  __syncthreads();
  for (int r = tid; r < m; r += nt) {
    const float dza = v.w[r] * (v.a3[r] + v.rp[r]) - v.z[r];
    v.a2[r] = dza;
    v.a1[r] = -v.s[r] - v.s[r] * dza / v.z[r];
  }
  __syncthreads();
  float a_p, a_d;
  {
    float rs = CUDART_INF_F, rz = CUDART_INF_F;
    for (int r = tid; r < m; r += nt) {
      rs = fminf(rs, step_ratio(v.s[r], v.a1[r]));
      rz = fminf(rz, step_ratio(v.z[r], v.a2[r]));
    }
    a_p = fminf(1.0f, 0.99f * block_min(rs, v.red));
    a_d = fminf(1.0f, 0.99f * block_min(rz, v.red));
  }
  float part = 0.0f;
  for (int r = tid; r < m; r += nt)
    part += (v.s[r] + a_p * v.a1[r]) * (v.z[r] + a_d * v.a2[r]);
  const float mu_aff = block_sum(part, v.red) / (float)m;
  float sigma = mu_aff / fmaxf(mu, 1e-30f);
  sigma = sigma * sigma * sigma;
  const float smu = sigma * mu;

  // ---- corrector: rc = s z + ds_a dz_a - sigma mu ----
  for (int r = tid; r < m; r += nt) {
    const float rc = v.s[r] * v.z[r] + v.a1[r] * v.a2[r] - smu;
    v.a1[r] = rc;
    const float t = v.w[r] * v.rp[r] - rc / v.s[r];
    v.a3[r] = v.z[r] + t;
  }
  __syncthreads();
  mark(kSecVector);
  build_rhs(g, v, d, v.a3, true);
  mark(kSecRhs);
  solve_kkt(g, v, d, inv_kappa);
  mark(kSecSolve);
  ghat_mv(g, d, v.rhs, v.a3);
  for (int c = tid; c < n; c += nt) v.dx[c] = v.rhs[c];
  __syncthreads();
  for (int r = tid; r < m; r += nt) {
    const float rc = v.a1[r];
    const float dz = v.w[r] * (v.a3[r] + v.rp[r]) - rc / v.s[r];
    v.dz[r] = dz;
    v.ds[r] = -(rc + v.s[r] * dz) / v.z[r];
  }
  __syncthreads();
  float alpha = step_length(v, d, v.ds, v.dz);

  // ---- Gondzio centrality correctors on the same factor ----
  for (int cor = 0; cor < n_cor; ++cor) {
    const float at = fminf(alpha + 0.1f, 1.0f);
    const float lo = 0.1f * smu, hi = 10.0f * smu;
    __syncthreads();
    for (int r = tid; r < m; r += nt) {
      const float val = (v.s[r] + at * v.ds[r]) * (v.z[r] + at * v.dz[r]);
      const float drc = val - fminf(fmaxf(val, lo), hi);
      v.a1[r] = drc;
      v.a2[r] = -drc / v.s[r];
    }
    __syncthreads();
    mark(kSecVector);
    build_rhs(g, v, d, v.a2, false);
    mark(kSecRhs);
    solve_kkt(g, v, d, inv_kappa);
    mark(kSecSolve);
    ghat_mv(g, d, v.rhs, v.a3);
    __syncthreads();
    for (int r = tid; r < m; r += nt) {
      const float dzc = v.w[r] * v.a3[r] + v.a2[r];
      const float dsc = -(v.a1[r] + v.s[r] * dzc) / v.z[r];
      v.a2[r] = v.dz[r] + dzc;
      v.a1[r] = v.ds[r] + dsc;
    }
    __syncthreads();
    const float alpha2 = step_length(v, d, v.a1, v.a2);
    if (alpha2 >= alpha + 0.01f) {  // uniform over the CTA
      for (int r = tid; r < m; r += nt) {
        v.dz[r] = v.a2[r];
        v.ds[r] = v.a1[r];
      }
      for (int c = tid; c < n; c += nt) v.dx[c] += v.rhs[c];
      alpha = alpha2;
    }
  }
  __syncthreads();

  mark(kSecVector);
  // ---- step, finite check, freeze bookkeeping ----
  float bad = 0.0f;
  for (int c = tid; c < n; c += nt)
    if (!isfinite(v.x[c] + alpha * v.dx[c])) bad = 1.0f;
  for (int r = tid; r < m; r += nt) {
    if (!isfinite(v.s[r] + alpha * v.ds[r])) bad = 1.0f;
    if (!isfinite(v.z[r] + alpha * v.dz[r])) bad = 1.0f;
  }
  const bool ok = block_sum(bad, v.red) == 0.0f;
  const bool stalled = (mu > 0.7f * mu_prev) && (mu < tol_stall);
  const bool converged = mu < tol;
  frozen = frozen || stalled || converged || !ok;
  if (!frozen) {
    const float shrink = 1.0f - alpha;
    for (int c = tid; c < n; c += nt) v.x[c] += alpha * v.dx[c];
    for (int r = tid; r < m; r += nt) {
      v.s[r] += alpha * v.ds[r];
      v.z[r] += alpha * v.dz[r];
      v.rp[r] *= shrink;
    }
  }
  mu_prev = mu;
  __syncthreads();
}

}  // namespace scpk
