// Block-cooperative dense Cholesky and triangular solves on a matrix held in
// shared memory. Shared by the fused IPM kernel (ipm_struct.cu) and the
// stand-alone factor / solve kernels (linalg.cu).
//
// Layout: row-major, leading dimension `ld` (callers pick an ODD ld so that
// column walks hit 32 distinct banks). Only the lower triangle is read or
// written. The factor's diagonal is NOT stored in the matrix: dinv[j] holds
// 1 / L[j][j] and K[j][j] keeps the pivot L[j][j]^2; the solves use dinv.
//
// A non-positive pivot gives dinv[j] = NaN, which poisons every solve
// against the factor; callers detect that through their finite checks.
#pragma once

namespace scpk {

// In-place right-looking Cholesky, one __syncthreads() per column. All
// threads of the block must call; blockDim.x must be a multiple of 32.
//
// Column j's trailing update uses the UNSCALED column (l_ij l_cj =
// k_ij k_cj / k_jj), so the scaling of column j can run together with the
// trailing update of column j+1: they touch disjoint entries. The trailing
// update is spread over the block as 16-wide row segments (thread = row
// offset x column offset), so a thread's entries are independent of each
// other and their shared-memory loads overlap (with one warp per row the
// update is a chain of dependent loads).
__device__ inline void chol_lower_inplace(float* K, int n, int ld,
                                          float* dinv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ty = tid >> 4, tx = tid & 15, rows = nt >> 4;
  for (int j = 0; j <= n; ++j) {
    __syncthreads();
    if (j > 0) {  // scale column j-1 below its diagonal
      const int jp = j - 1;
      const float rs = 1.0f / sqrtf(K[jp * ld + jp]);
      for (int i = jp + 1 + tid; i < n; i += nt) K[i * ld + jp] *= rs;
      if (tid == 0) dinv[jp] = rs;
    }
    if (j < n) {  // trailing update with column j
      const float invd = 1.0f / K[j * ld + j];
      for (int i = j + 1 + ty; i < n; i += rows) {
        const float lij = K[i * ld + j] * invd;
#pragma unroll 4
        for (int c = j + 1 + tx; c <= i; c += 16)
          K[i * ld + c] -= lij * K[c * ld + j];
      }
    }
  }
  __syncthreads();
}

// Solve (L L^T) x = y in place in shared memory `y` (length n) against the
// factor of chol_lower_inplace. Runs on warp 0 with warp-level barriers (the
// dependency chain is sequential; a block-wide barrier per column would cost
// more than it buys); all threads must call, and the result is visible to
// the whole block on return. (A variant that kept y in registers and sent
// the pivot by shuffle measured 10% SLOWER on an H100: a lone warp pays
// ~5 cycles per dependent instruction, and the register version needs more
// of them per column. A blocked substitution is the way to shorten the
// chain.)
__device__ inline void chol_solve_inplace(const float* K, int n, int ld,
                                          const float* dinv, float* y) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int j = 0; j < n; ++j) {  // forward: L y' = y
      __syncwarp();
      const float yj = y[j] * dinv[j];
      __syncwarp();
      if (lane == 0) y[j] = yj;
      for (int i = j + 1 + lane; i < n; i += 32) y[i] -= K[i * ld + j] * yj;
    }
    for (int j = n - 1; j >= 0; --j) {  // backward: L^T x = y'
      __syncwarp();
      const float xj = y[j] * dinv[j];
      __syncwarp();
      if (lane == 0) y[j] = xj;
      for (int i = lane; i < j; i += 32) y[i] -= K[j * ld + i] * xj;
    }
  }
  __syncthreads();
}

}  // namespace scpk
