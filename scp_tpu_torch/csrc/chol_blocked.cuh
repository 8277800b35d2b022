// The one blocked Cholesky factor and the one blocked triangular solve of
// the package, on a matrix held in shared memory: chol_blocked_smem (one CTA
// factors one instance of any n, a panel of kPanel = 16 columns at a time)
// and chol_blocked_solve_smem (L L^T x = y against that factor, a block of
// 16 entries at a time). The stand-alone factor and solve (linalg.cu, K3 and
// K4) and the two fused IPM kernels (ipm_struct.cu, ipm_dense.cu, through
// ipm_common.cuh) all use these two.
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
// (2 ceil(n / 16) in all) against the n + 1 of a column-by-column factor,
// and ~0.6 shared-memory accesses per multiply-add against ~3. The panel
// width 16 was chosen by measurement: with 8 the factor was slower at every
// batch width on an H100 (PERF.md).
//
// chol_blocked_solve_smem, forward (L z = y) then backward (L^T x = z), a
// block of 16 entries at a time:
//   1. warp 0 solves the block against its diagonal block in registers:
//      lane i owns entry i and row i of the block, and each solved entry is
//      broadcast by shuffle, so the dependent chain is a multiply (by
//      1 / L_cc), a shuffle and an FMA per entry;
//   2. the entries of the next block take this block's contribution on
//      warp 0 (its upper half forms it while the lower half loads the next
//      diagonal block), which then solves that block at once (step 1);
//   3. meanwhile the other warps take this block's contribution out of
//      every entry beyond the next block, a thread per entry.
// One block barrier per block: 2 ceil(n / 16) in all, against 2n dependent
// steps of a column-by-column substitution on one warp.
//
// Layout: row-major, odd leading dimension ld (column walks hit distinct
// banks), only the lower triangle is read; the diagonal holds L_jj itself
// and dinv[j] = 1 / L_jj. A pivot that is not > 0 (or NaN) sets *bad; the
// stand-alone factor writes that instance as NaN, and the IPM kernels write
// NaN into dinv[0] (ipm_common.cuh::factor_kkt), so that every solve
// against the failed factor is NaN throughout: a NaN dinv entry poisons
// the whole solution. The upper triangle of the 16 x 32 tiles that straddle
// the diagonal is computed and not stored.
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
// off the chain. L_jj is the correctly rounded square root of the pivot
// and 1 / L_jj its correctly rounded reciprocal (the intrinsics: a third of
// the cost of sqrtf and a division on this chain), and that one value
// scales the column below the pivot, in the block and, through `dinv`
// (lane i's on return), in the panel rows. (The special-function unit's
// 1 / sqrt with one Newton step was faster, and on the fused IPM kernel's
// main path put two instances of chip_smoke.py's batch beyond its step
// limit, PERF.md.) (A branch-free form, the block padded with the identity
// up to W, measured slower in the blocked kernel: more registers live
// under its 64-register cap.)
template <int W>
__device__ inline bool warp_factor_regs(float (&a)[W], int w, float& dinv) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  float piv = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c < w) {
      ok = ok && (piv > 0.0f);
      const float l = __fsqrt_rn(piv), inv = __frcp_rn(l);
      if (lane == c) dinv = inv;
      a[c] = lane == c ? l : a[c] * inv;
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
// registers, write L_D and the reciprocals of its diagonal (dinv).
__device__ inline void diag_block_factor(float* A, int ld, int j0, int w,
                                         float* dinv, int* bad) {
  const int lane = threadIdx.x & 31;
  float a[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    a[c] = (lane < w && c <= lane) ? A[(j0 + lane) * ld + j0 + c] : 0.0f;
  float inv = 0.0f;
  const bool ok = warp_factor_regs<kPanel>(a, w, inv);
  if (lane < w) {
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c <= lane) A[(j0 + lane) * ld + j0 + c] = a[c];
    dinv[j0 + lane] = inv;
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


// Steps 1 and 2 of the solve on warp 0, forward: block j1 (w = min(16,
// n - j1) entries) takes the contribution of the block just solved at jp
// (jp < 0: none) and is solved against its diagonal block. Lanes 16-31
// form the contribution (lane 16 + i: row j1 + i against the solved
// entries, read from y) while lanes 0-15 load their row of the diagonal
// block; lane i < w then owns entry i and its row in registers, and each
// solved entry (v_c / L_cc) is broadcast by shuffle, so the chain is a
// multiply, a shuffle and an FMA per entry (a row pre-scaled by 1 / L_ii,
// one multiply shorter, rounded each of its products once more). The loop
// carries no branch: lanes >= w hold zeros and shuffle zeros. Only the
// lower triangle is read.
__device__ inline void lead_forward(const float* A, int n, int ld,
                                    const float* dinv, float* y, int jp,
                                    int j1) {
  const int lane = threadIdx.x & 31, i = lane & (kPanel - 1);
  const int r = j1 + i, w = min(kPanel, n - j1);
  const bool row_ok = r < n;
  const int col0 = (lane < kPanel || jp < 0) ? j1 : jp;
  const float* src = A + r * ld + col0;
  float t[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    t[c] = (row_ok && col0 + c <= r) ? src[c] : 0.0f;
  float s = 0.0f;
  if (jp >= 0) {  // (lanes 16-31 hold the update row)
    float s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < kPanel; c += 2) {
      s += t[c] * y[jp + c];
      s2 += t[c + 1] * y[jp + c + 1];
    }
    s += s2;
  }
  s = __shfl_down_sync(0xffffffffu, s, kPanel);
  const bool own = lane < w;
  const float di = own ? dinv[r] : 0.0f;
  float v = own ? y[r] - s : 0.0f;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) t[c] = (own && c < i) ? t[c] : 0.0f;
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    v -= t[c] * __shfl_sync(0xffffffffu, v * di, c);
  if (own) y[r] = v * di;
}

// The same, backward (L^T x = z): block j0 takes the contribution of the
// block just solved at jn (jn < 0: none) and is solved against the
// transpose of its diagonal block, from its last entry to its first. Lane
// i holds column i of the diagonal block (lanes 16-31: of block jn).
__device__ inline void lead_backward(const float* A, int n, int ld,
                                     const float* dinv, float* y, int j0,
                                     int jn) {
  const int lane = threadIdx.x & 31, i = lane & (kPanel - 1);
  const int col = j0 + i, w = min(kPanel, n - j0);
  const int row0 = (lane < kPanel || jn < 0) ? j0 : jn;
  const float* src = A + row0 * ld + col;
  float t[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    t[c] = (row0 + c < n && row0 + c >= col) ? src[c * ld] : 0.0f;
  float s = 0.0f;
  if (jn >= 0) {  // (lanes 16-31 hold the update column)
    float s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < kPanel; c += 2) {
      s += jn + c < n ? t[c] * y[jn + c] : 0.0f;
      s2 += jn + c + 1 < n ? t[c + 1] * y[jn + c + 1] : 0.0f;
    }
    s += s2;
  }
  s = __shfl_down_sync(0xffffffffu, s, kPanel);
  const bool own = lane < w;
  const float di = own ? dinv[col] : 0.0f;
  float v = own ? y[col] - s : 0.0f;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) t[c] = (own && c > i) ? t[c] : 0.0f;
#pragma unroll
  for (int c = kPanel - 1; c >= 0; --c)
    v -= t[c] * __shfl_sync(0xffffffffu, v * di, c);
  if (own) y[col] = v * di;
}

// Solve (L L^T) x = y in place in shared memory (y: n floats) against the
// factor of chol_blocked_smem (A, dinv). All NT threads of the block call
// (NT >= 64); it starts and ends with a block barrier, so y may have been
// written by any thread before the call and is visible to all after it.
// Per block, warp 0 runs steps 1-2 (lead_forward / lead_backward) on the
// next block while the other warps take the block just solved out of every
// entry beyond that one (right-looking: a form in which the other warps
// formed dot products for warp 0 to add in measured 2-5% slower, PERF.md).
template <int NT>
__device__ inline void chol_blocked_solve_smem(const float* A, int n, int ld,
                                               const float* dinv, float* y) {
  const int tid = threadIdx.x, warp = tid >> 5;
  constexpr int kOthers = NT - 32;          // threads of the other warps
  const int nblk = (n + kPanel - 1) / kPanel;
  const int ot = tid - 32;                  // index among the other warps
  __syncthreads();
  // ---- forward: L z = y ----
  if (warp == 0) lead_forward(A, n, ld, dinv, y, -1, 0);
  __syncthreads();
  for (int b = 0; b + 1 < nblk; ++b) {
    const int j0 = b * kPanel, j1 = j0 + kPanel;
    if (warp == 0) {
      lead_forward(A, n, ld, dinv, y, j0, j1);
    } else {  // every entry beyond block b + 1 takes block b
      const float* xb = y + j0;
      for (int r = j1 + kPanel + ot; r < n; r += kOthers) {
        const float* row = A + r * ld + j0;
        float s = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int c = 0; c < kPanel; c += 2) {
          s += row[c] * xb[c];
          s2 += row[c + 1] * xb[c + 1];
        }
        y[r] -= s + s2;
      }
    }
    __syncthreads();
  }
  // ---- backward: L^T x = z ----
  if (warp == 0) lead_backward(A, n, ld, dinv, y, (nblk - 1) * kPanel, -1);
  __syncthreads();
  for (int b = nblk - 1; b > 0; --b) {
    const int j0 = b * kPanel, w = min(kPanel, n - j0), jp = j0 - kPanel;
    if (warp == 0) {
      lead_backward(A, n, ld, dinv, y, jp, j0);
    } else {  // every entry before block b - 1 takes block b
      const float* xb = y + j0;
      for (int r = ot; r < jp; r += kOthers) {
        const float* col = A + j0 * ld + r;
        float s = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int c = 0; c < kPanel; c += 2) {
          if (c < w) s += col[c * ld] * xb[c];
          if (c + 1 < w) s2 += col[(c + 1) * ld] * xb[c + 1];
        }
        y[r] -= s + s2;
      }
    }
    __syncthreads();
  }
}

}  // namespace scpk
