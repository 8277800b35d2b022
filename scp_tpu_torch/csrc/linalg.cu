// Stand-alone batched dense kernels of the adaptive and per-instance IPM
// paths, on instance-major float32 tensors:
//
//   chol_batched_kernel       K (B,n,n) -> L (B,n,n), lower Cholesky factor
//   cho_solve_batched_kernel  L (B,n,n), b (B,n) -> x (B,n), (L L^T) x = b
//   gmv_batched_kernel        G (B,m,n), x (B,n) -> out (B,m), out_b = G_b x_b
//   gtmv_batched_kernel       G (B,m,n), v (B,m) -> out (B,n), out_b = G_b^T v_b
//
// They replace, in scp_tpu/ops/pallas_linalg.py: cholesky_lane and
// _batched_cholesky_impl (_cholesky_panel_kernel), cho_solve_lane and
// _batched_cho_solve_impl (_cho_solve_kernel), gmv_lane (_gmv_kernel) and
// gtmv_lane (_gtmv_kernel). The TPU kernels put the batch on the lane axis
// and unroll 8-row panels; here one instance is one CTA's (or one warp's)
// work and every size is a runtime argument, so nothing is padded.
//
// What bounds them on an H100: all four move more bytes than they do
// arithmetic for (a factor reads and writes n^2 floats for n^3/3
// multiply-adds, a matvec reads m*n floats for m*n multiply-adds), so on
// paper device memory is the limit. In practice the factor and the solve
// are chains of dependent steps (n block barriers, 2n warp barriers) and
// run at the latency of one instance: the design keeps one instance's
// matrix in shared memory (odd leading dimension, so column walks hit
// distinct banks), runs many CTAs per SM to overlap the chains, and reads
// and writes device memory once, coalesced. The matvecs read G once with
// neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "chol.cuh"
#include "smem.cuh"

namespace {

constexpr int kCholThreads = 256;
constexpr int kSolveThreads = 128;
constexpr int kMvThreads = 256;

__host__ __device__ inline int odd_ld(int n) { return n | 1; }

// One CTA per instance. Shared memory: the matrix (n x ld), dinv (n), and a
// flag. The factor's upper triangle is written as zeros; an instance with a
// non-positive (or NaN) pivot is written as NaN throughout.
__global__ void __launch_bounds__(kCholThreads)
chol_batched_kernel(const float* __restrict__ K, float* __restrict__ L,
                    int n) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* Ks = smem;
  float* dinv = Ks + n * ld;
  int* bad = reinterpret_cast<int*>(dinv + n);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * n * n;
  if (tid == 0) *bad = 0;
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    Ks[r * ld + c] = K[base + e];
  }
  scpk::chol_lower_inplace(Ks, n, ld, dinv);
  // the diagonal still holds the pivots L_jj^2
  for (int j = tid; j < n; j += nt)
    if (!(Ks[j * ld + j] > 0.0f)) *bad = 1;
  __syncthreads();
  const bool poisoned = *bad != 0;
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    float v = 0.0f;
    if (c < r) v = Ks[r * ld + c];
    else if (c == r) v = sqrtf(Ks[r * ld + r]);
    L[base + e] = poisoned ? CUDART_NAN_F : v;
  }
}

// One CTA per instance: all threads stage the factor in shared memory,
// warp 0 runs the two substitutions. Only the lower triangle is read.
__global__ void __launch_bounds__(kSolveThreads)
cho_solve_batched_kernel(const float* __restrict__ L,
                         const float* __restrict__ b, float* __restrict__ x,
                         int n) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* Ls = smem;
  float* dinv = Ls + n * ld;
  float* y = dinv + n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * n * n;
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    const float v = L[base + e];
    Ls[r * ld + c] = v;
    if (r == c) dinv[r] = 1.0f / v;
  }
  for (int i = tid; i < n; i += nt) y[i] = b[(size_t)blockIdx.x * n + i];
  scpk::chol_solve_inplace(Ls, n, ld, dinv, y);
  for (int i = tid; i < n; i += nt) x[(size_t)blockIdx.x * n + i] = y[i];
}

// One warp per row of G: lanes stride the row (coalesced), shuffle reduce.
__global__ void __launch_bounds__(kMvThreads)
gmv_batched_kernel(const float* __restrict__ G, const float* __restrict__ x,
                   float* __restrict__ out, long long rows, int m, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kMvThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long inst = row / m;
  const float* g = G + row * n;
  const float* xv = x + inst * n;
  float acc = 0.0f;
  for (int c = lane; c < n; c += 32) acc += g[c] * xv[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

// One CTA per instance: thread (ty, tx) walks rows ty, ty+8, ... of column
// c0 + tx (a warp reads 32 neighbouring floats of one row), the eight row
// groups are summed through shared memory.
__global__ void __launch_bounds__(kMvThreads)
gtmv_batched_kernel(const float* __restrict__ G, const float* __restrict__ v,
                    float* __restrict__ out, int m, int n) {
  __shared__ float red[kMvThreads / 32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  constexpr int groups = kMvThreads / 32;
  const float* g = G + (size_t)blockIdx.x * m * n;
  const float* vv = v + (size_t)blockIdx.x * m;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + tx;
    float acc = 0.0f;
    if (c < n)
      for (int i = ty; i < m; i += groups) acc += g[(size_t)i * n + c] * vv[i];
    red[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && c < n) {
      float s = red[0][tx];
#pragma unroll
      for (int k = 1; k < groups; ++k) s += red[k][tx];
      out[(size_t)blockIdx.x * n + c] = s;
    }
    __syncthreads();
  }
}

int chol_smem_granted[scpk::kMaxDevices];
int solve_smem_granted[scpk::kMaxDevices];

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError()
// (0 = launched), or -1 when `smem_bytes` disagrees with the kernel's carve.

int chol_batched_launch(const float* K, float* L, int B, int n,
                        long smem_bytes, void* stream) {
  if (smem_bytes != (long)sizeof(float) * ((long)n * odd_ld(n) + n + 1))
    return -1;
  cudaError_t err =
      scpk::ensure_dyn_smem(chol_batched_kernel, chol_smem_granted,
                            smem_bytes);
  if (err != cudaSuccess) return (int)err;
  chol_batched_kernel<<<B, kCholThreads, smem_bytes, (cudaStream_t)stream>>>(
      K, L, n);
  return (int)cudaGetLastError();
}

int cho_solve_batched_launch(const float* L, const float* b, float* x, int B,
                             int n, long smem_bytes, void* stream) {
  if (smem_bytes != (long)sizeof(float) * ((long)n * odd_ld(n) + 2 * n))
    return -1;
  cudaError_t err = scpk::ensure_dyn_smem(cho_solve_batched_kernel,
                                    solve_smem_granted, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cho_solve_batched_kernel<<<B, kSolveThreads, smem_bytes,
                             (cudaStream_t)stream>>>(L, b, x, n);
  return (int)cudaGetLastError();
}

int gmv_batched_launch(const float* G, const float* x, float* out, int B,
                       int m, int n, void* stream) {
  const long long rows = (long long)B * m;
  const int per_block = kMvThreads / 32;
  const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
  gmv_batched_kernel<<<blocks, kMvThreads, 0, (cudaStream_t)stream>>>(
      G, x, out, rows, m, n);
  return (int)cudaGetLastError();
}

int gtmv_batched_launch(const float* G, const float* v, float* out, int B,
                        int m, int n, void* stream) {
  gtmv_batched_kernel<<<B, kMvThreads, 0, (cudaStream_t)stream>>>(G, v, out,
                                                                   m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
