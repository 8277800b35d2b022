// Blocked batched Cholesky for the stand-alone factor kernel K3
// (linalg.cu::chol_batched_launch): chol_blocked_smem, in which one CTA
// factors one instance of any n held in shared memory, a panel of
// kPanel = 16 columns at a time.
//
// chol_blocked_smem, per panel (columns j0 .. j0+w-1, w = min(16, n-j0)):
//   1. warp 0 factors the w x w diagonal block in registers (lane i owns
//      row i, the pivot and the column entries travel by shuffle) and
//      writes L_D and 1 / diag(L_D);
//   2. every thread solves one panel row below the block against L_D
//      (x L_D^T = k, a forward substitution in registers, column by
//      column, so that its dependent chain is 16 steps; L_D is read by
//      broadcast);
//   3. the trailing lower triangle takes the rank-16 update A -= P P^T.
//      A warp owns a 16 x 32 tile, each thread a 4 x 4 register tile of
//      it: rows r0 + g + 4u (g = lane / 8), columns c0 + t + 8v
//      (t = lane % 8), so that each of the 16 steps is 8 shared-memory
//      loads (4 panel entries of its rows, 4 of its columns; all free of
//      bank conflicts with an odd leading dimension) for 16 FMAs, and each
//      entry is loaded and stored once per panel.
// Step 1 of the next panel overlaps step 3: the trailing update's first
// warp tile IS the next diagonal block, so warp 0 updates and factors it
// while the other warps update the rest. Two block barriers per panel
// (2 ceil(n / 16) in all) against the n + 1 of chol.cuh::
// chol_lower_inplace, and ~0.6 shared-memory accesses per multiply-add
// against ~3. The panel width 16 was chosen by measurement: with 8 the
// factor was slower at every batch width on an H100 (PERF.md).
//
// Layout: row-major, odd leading dimension ld (column walks hit distinct
// banks), only the lower triangle is read; the diagonal holds L_jj itself
// (chol.cuh keeps the pivot there). A pivot that is not > 0 (or NaN) sets
// *bad; the caller writes that instance as NaN. The upper triangle of the
// 16 x 32 tiles that straddle the diagonal is computed and not stored.
#pragma once

#include <math_constants.h>

#ifndef CHOL_SECTION  // section marks of a profiling build (linalg.cu)
#define CHOL_SECTION_INIT()
#define CHOL_SECTION(i)
#endif

namespace scpk {

constexpr int kPanel = 16;  // equals the warp tile's rows (step 3)

// Rank-1 steps of a w-wide lower factor held in registers across one warp:
// lane i owns row i, a[c] = entry (i, c). On return lane i holds row i of
// L (a[i] = L_ii) for i < w; the return value is false (on every lane)
// when a pivot was not > 0. The steps form a chain of w pivots, each
// broadcast by shuffle, so each step's work is ordered for it: the next
// column's update and pivot first, the rest of the column's update after,
// off the chain. 1 / sqrt is the special-function unit's, with one Newton
// step. (A branch-free form, the block padded with the identity up to W,
// measured slower in the blocked kernel: more registers live under its
// 64-register cap.)
template <int W>
__device__ inline bool warp_factor_regs(float (&a)[W], int w) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  float piv = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c < w) {
      ok = ok && (piv > 0.0f);
      float inv = rsqrtf(piv);
      inv = inv * (1.5f - 0.5f * piv * inv * inv);
      a[c] = lane == c ? piv * inv : a[c] * inv;
      if (c + 1 < W && c + 1 < w) {
        const int c1 = min(c + 1, W - 1);
        const float l1 = __shfl_sync(0xffffffffu, a[c], c1);
        if (lane >= c1) a[c1] -= a[c] * l1;
        piv = __shfl_sync(0xffffffffu, a[c1], c1);
      }
#pragma unroll
      for (int c2 = c + 2; c2 < W; ++c2) {
        const float l2 = __shfl_sync(0xffffffffu, a[c], c2);
        if (lane >= c2) a[c2] -= a[c] * l2;
      }
    }
  }
  return ok;
}

// Step 1 on warp 0: factor the w x w diagonal block at (j0, j0) in
// registers, write L_D and 1 / diag(L_D) (dinv).
__device__ inline void diag_block_factor(float* A, int ld, int j0, int w,
                                         float* dinv, int* bad) {
  const int lane = threadIdx.x & 31;
  float a[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    a[c] = (lane < w && c <= lane) ? A[(j0 + lane) * ld + j0 + c] : 0.0f;
  const bool ok = warp_factor_regs<kPanel>(a, w);
  if (lane < w) {
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c <= lane) A[(j0 + lane) * ld + j0 + c] = a[c];
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c == lane) dinv[j0 + c] = 1.0f / a[c];
  }
  if (!ok && lane == 0) *bad = 1;
}

// Step 3 for one warp tile (ti, tj) of the trailing triangle below and right
// of the full panel at column j0 (rows and columns from j1 = j0 + kPanel).
__device__ inline void trailing_tile(float* A, int n, int ld, int j0,
                                     int ti, int tj) {
  const int lane = threadIdx.x & 31, g = lane >> 3, t = lane & 7;
  const int j1 = j0 + kPanel;
  int ri[4], cj[4], pr[4], pc[4];  // pr / pc: panel row offsets
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ri[u] = j1 + ti * 16 + g + 4 * u;
    cj[u] = j1 + tj * 32 + t + 8 * u;
    pr[u] = min(ri[u], n - 1) * ld + j0;
    pc[u] = min(cj[u], n - 1) * ld + j0;
  }
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      acc[u][v] = (ri[u] < n && cj[v] <= ri[u]) ? A[ri[u] * ld + cj[v]] : 0.0f;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    float pu[4], pv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      pu[u] = A[pr[u] + c];
      pv[u] = A[pc[u] + c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] -= pu[u] * pv[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (ri[u] < n && cj[v] <= ri[u]) A[ri[u] * ld + cj[v]] = acc[u][v];
}

// Steps 1-3 above on the matrix A (n x ld, ld odd) in shared memory; all NT
// threads of the block call (NT >= 64). dinv: n floats of scratch. Ends
// with a block barrier.
template <int NT>
__device__ inline void chol_blocked_smem(float* A, int n, int ld, float* dinv,
                                         int* bad) {
  const int tid = threadIdx.x, warp = tid >> 5;
  constexpr int kOthers = NT / 32 - 1;
  __syncthreads();
  if (warp == 0) diag_block_factor(A, ld, 0, min(kPanel, n), dinv, bad);
  __syncthreads();
  CHOL_SECTION(1);
  for (int j0 = 0; j0 + kPanel < n; j0 += kPanel) {
    const int j1 = j0 + kPanel;
    // 2. the panel rows below the block
    for (int i = j1 + tid; i < n; i += NT) {
      float* row = A + i * ld + j0;
      float x[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) x[c] = row[c];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {  // column by column: a chain of
        x[c] *= dinv[j0 + c];             // kPanel steps
#pragma unroll
        for (int c2 = c + 1; c2 < kPanel; ++c2)
          x[c2] -= x[c] * A[(j0 + c2) * ld + j0 + c];
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c) row[c] = x[c];
    }
    __syncthreads();
    CHOL_SECTION(2);
    // 3. the trailing update. Its first warp tile (rows and columns j1 ..
    // j1 + 15) is the next diagonal block: warp 0 updates it and factors it
    // (step 1 of the next panel) while the other warps update the rest.
    if (warp == 0) {
      trailing_tile(A, n, ld, j0, 0, 0);
      __syncwarp();
      diag_block_factor(A, ld, j1, min(kPanel, n - j1), dinv, bad);
    } else {
      int q = 0;
      for (int ti = 0; ti * 16 < n - j1; ++ti)
        for (int tj = 0; tj <= (ti >> 1); ++tj, ++q)
          if (q > 0 && (q - 1) % kOthers == warp - 1)
            trailing_tile(A, n, ld, j0, ti, tj);
    }
    __syncthreads();
    CHOL_SECTION(3);
  }
}

}  // namespace scpk
