// The dense-G fused IPM kernel's shared part (see the head of
// ipm_dense.cu): the shape, the carves, G's products, the kernel of the
// shared, device and global tiers (ipm_dense_kernel) and the launch's
// preparation. ipm_dense.cu instantiates the shared and device tiers and
// holds the cluster tier; ipm_dense_global.cu instantiates the global
// tier. Kept apart, the global tier's instantiations leave the other
// kernels' code as it was (in one translation unit they moved the cluster
// tier's instruction schedule).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

// the factor out of line (see ipm_common.cuh)
#define SCP_IPM_FACTOR_CALL __noinline__
#include "ipm_common.cuh"
#include "bulk_copy.cuh"
#include "chol_cluster.cuh"
#include "smem.cuh"

namespace {

constexpr int kThreads = scpk::kIpmThreads;

// Built with -DSCP_PROFILE_SECTIONS (scripts/torch_kernel_check.py
// --sections k2) the kernel adds up, for block 0, the clock cycles between
// section marks; without it the marks compile to nothing.
// The cluster tier's product also splits its own section into the ring's
// wait, the panel's copy into the aligned buffers, the tiles and the border
// sums (kSecProd*).
enum { kSecLoad, kSecWeights, kSecProduct, kSecBorder, kSecDiag, kSecScale,
       kSecFactor, kSecPredRhs, kSecPredSolve, kSecPredVector, kSecCorrRhs,
       kSecCorrSolve, kSecCorrVector, kSecStep, kSecStore, kSecProdWait,
       kSecProdCopy, kSecProdTiles, kSecProdBorder, kSecCount };
#ifdef SCP_PROFILE_SECTIONS
__device__ unsigned long long g_section_cycles[24];
#define SECTION_INIT() long long section_t0 = clock64()
#define SECTION(i)                                         \
  do {                                                     \
    __syncthreads();                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) {             \
      const long long section_t1 = clock64();              \
      g_section_cycles[i] += section_t1 - section_t0;      \
      section_t0 = section_t1;                             \
    }                                                      \
  } while (0)
#else
#define SECTION_INIT()
#define SECTION(i)
#endif

struct DenseShape {
  int B, mg, n, m;
  int nk, ldk;        // factored system and its leading dimension
  int k_dev;          // the factor in the device-memory workspace
  int nb, d;          // P blocks (nb = 0: a dense P in device memory)
  int schur;          // eliminate the slack border
  int g_smem, ldg;    // G held in shared memory, its leading dimension
  int sep_dz;         // dz has storage of its own (n_cor > 0)
};

// The factor's leading dimension: odd in shared memory, a multiple of 32
// floats in the device tier's workspace.
__host__ __device__ inline int dense_kkt_ld(int nk, int k_dev) {
  return k_dev ? (nk + 31) & ~31 : nk | 1;
}

__host__ __device__ inline DenseShape make_dense_shape(int B, int mg, int n,
                                                       int nb, int d,
                                                       int schur, int g_smem,
                                                       int n_cor, int k_dev) {
  DenseShape s;
  s.B = B; s.mg = mg; s.n = n; s.m = mg + 2 * n;
  s.nk = schur ? n - 1 : n;
  s.k_dev = k_dev;
  s.ldk = dense_kkt_ld(s.nk, k_dev);
  s.nb = nb; s.d = d; s.schur = schur;
  s.g_smem = g_smem;
  s.ldg = g_smem ? (n | 1) : n;
  s.sep_dz = n_cor > 0;
  return s;
}

// Words past G in shared memory (zeroed): the tile and column walks read up
// to three columns past a row's last, unclamped.
constexpr int kGPad = 4;

// Shared-memory carve (in 4-byte words); must match
// ipm_kernel.py::dense_smem_bytes.
__host__ __device__ inline long dense_smem_words(const DenseShape& s) {
  long w = s.k_dev ? 0 : (long)s.nk * s.ldk;   // factor
  w += (long)s.nb * s.d * s.d;             // P blocks
  w += (8L + s.sep_dz) * s.m;              // s z rp w a1 a2 a3 ds (+ dz)
  w += 9L * s.n;                           // q pdiag x px dsc kb rhs dx dinv
  w += scpk::kRedWords;                    // reduction scratch
  w += 1;                                  // the factor's failure flag
  if (s.g_smem) w += (long)s.mg * s.ldg + kGPad;   // G
  return w;
}

// The global tier (kGlobal) keeps only the reduction scratch and the
// failure flag in shared memory; must match
// ipm_kernel.py::dense_global_smem_bytes.
constexpr int kGlobalSmemWords = scpk::kRedWords + 1;

// The global tier's workspace of one instance (floats): the step's vectors
// (eight m-vectors s z rp w a1 a2 a3 ds, dz too with correctors, seven
// n-vectors x px dsc kb rhs dx dinv), rounded up to 32 floats, then the
// nk x ldk factor; must match ipm_kernel.py::dense_global_layout.
__host__ __device__ inline long dense_global_vec_words(const DenseShape& s) {
  return ((8L + s.sep_dz) * s.m + 7L * s.n + 31) & ~31L;
}

__host__ __device__ inline long dense_global_ws_words(const DenseShape& s) {
  return dense_global_vec_words(s) + (long)s.nk * s.ldk;
}

struct DenseSmem : scpk::IpmVecs {
  float* pb;
  float* g;  // shared-memory copy of G, or null
};

// kKDev: the factor at `kws` (device memory), else first in shared memory.
template <bool kKDev>
__device__ inline DenseSmem carve_dense(float* base, const DenseShape& s,
                                        float* kws) {
  DenseSmem sm;
  float* p = base;
  if (kKDev) {
    sm.K = kws;
  } else {
    sm.K = p; p += (long)s.nk * s.ldk;
  }
  sm.pb = p; p += (long)s.nb * s.d * s.d;
  sm.s = p; p += s.m;   sm.z = p; p += s.m;   sm.rp = p; p += s.m;
  sm.w = p; p += s.m;   sm.a1 = p; p += s.m;  sm.a2 = p; p += s.m;
  sm.a3 = p; p += s.m;  sm.ds = p; p += s.m;
  // without correctors the predictor's dz (a2) is dead when dz is written
  if (s.sep_dz) { sm.dz = p; p += s.m; } else { sm.dz = sm.a2; }
  sm.q = p; p += s.n;   sm.pdiag = p; p += s.n;  sm.x = p; p += s.n;
  sm.px = p; p += s.n;  sm.dsc = p; p += s.n;    sm.kb = p; p += s.n;
  sm.rhs = p; p += s.n; sm.dx = p; p += s.n;     sm.dinv = p; p += s.n;
  sm.red = p; p += scpk::kRedWords;
  sm.bad = reinterpret_cast<int*>(p); p += 1;
  sm.g = s.g_smem ? p : nullptr;
  return sm;
}

// One halving round of warp_reduce_scatter and the rounds after it: lanes
// with bit OFF set keep the upper HALF of v[0 .. 2 HALF) and add their
// partner's, the others the lower half; every index is a constant, so v
// stays in registers.
template <int HALF, int OFF, int N>
__device__ __forceinline__ void reduce_scatter_round(float (&v)[N],
                                                     int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float keep = up ? v[j + HALF] : v[j];
    const float send = up ? v[j] : v[j + HALF];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (HALF > 1) reduce_scatter_round<HALF / 2, OFF / 2>(v, lane);
}

// Reduce N (a power of two, 2 <= N <= 16) values of every lane across the
// warp and scatter the sums: halving rounds exchange half the values at
// each shuffle offset (N - 1 shuffles), the last offsets sum whole. Returns,
// in every lane, the sum over the 32 lanes of v[lane / (32 / N)].
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N],
                                                     int lane) {
  reduce_scatter_round<N / 2, 16>(v, lane);
  float sum = v[0];
#pragma unroll
  for (int off = 16 / N; off >= 1; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// The dense product G x / G^T v of scpk::mehrotra_step; `g` points at the
// instance's G with leading dimension `ld`: in shared memory (kGSmem, padded
// by kGPad words), or in device memory, where a walk past a row's last
// column is clamped to it.
template <bool kGSmem>
struct DenseRows {
  const float* g;
  int ld, n, mg;

  // (G^T v)[c] for every column c < n: a warp per four adjacent columns, a
  // lane per row slice; epi(c, sum) runs in one lane per column.
  template <class Epi>
  __device__ void cols(const float* v, Epi epi) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarp = blockDim.x >> 5;
    for (int c0 = 4 * warp; c0 < n; c0 += 4 * nwarp) {
      int cu[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) cu[u] = kGSmem ? u : min(c0 + u, n - 1) - c0;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int r = lane; r < mg; r += 32) {
        const float vr = v[r];
        const float* gr = g + r * ld + c0;
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += gr[cu[u]] * vr;
      }
      const float sum = warp_reduce_scatter(acc, lane);
      const int c = c0 + (lane >> 3);
      if ((lane & 7) == 0 && c < n) epi(c, sum);
    }
  }
  __device__ float row(const float* x, int r) const {
    const float* gr = g + r * ld;
    float acc = 0.0f;
    for (int c = 0; c < n; ++c) acc += gr[c] * x[c];
    return acc;
  }
};

// The lower triangle of G_k^T diag(w) G_k (columns c < nk) into K, unscaled:
// 4 x 4 tiles, a warp per tile, a lane per row slice, the tile's 16 sums
// reduced across the warp. Ragged edge tiles read past column nk - 1 (in
// device memory: a clamped column) and drop the entries outside the
// triangle.
template <bool kGSmem>
__device__ inline void form_product(const float* g, int ld, const float* w,
                                    int mg, int nk, float* K, int ldk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarp = blockDim.x >> 5;
  const int tb = (nk + 3) >> 2, tiles = tb * (tb + 1) / 2;
  for (int t = warp; t < tiles; t += nwarp) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int r0 = 4 * ti, c0 = 4 * (t - ti * (ti + 1) / 2);
    int ra[4], cb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ra[u] = kGSmem ? r0 + u : min(r0 + u, nk - 1);
      cb[u] = kGSmem ? c0 + u : min(c0 + u, nk - 1);
    }
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#pragma unroll 2
    for (int r = lane; r < mg; r += 32) {
      const float* gr = g + r * ld;
      const float wr = w[r];
      float pa[4], pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pa[u] = wr * gr[ra[u]];
        pb[u] = gr[cb[u]];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u * 4 + v] += pa[u] * pb[v];
    }
    const float sum = warp_reduce_scatter(acc, lane);
    const int i = lane >> 1, r = r0 + (i >> 2), c = c0 + (i & 3);
    if ((lane & 1) == 0 && r < nk && c <= r) K[r * ldk + c] = sum;
  }
}

__device__ inline void copy_in(float* dst, const float* src, long count) {
  for (long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// G (mg x n, device memory, rows of n) into shared memory with leading
// dimension ld and kGPad zeros after it, four loads in flight per thread.
__device__ inline void load_g(float* dst, const float* src, int mg, int n,
                              int ld) {
  constexpr int kBatch = 4;
  const int total = mg * n;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      v[i] = e < total ? src[e] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads;
      if (e < total) {
        const int r = e / n, c = e - r * n;
        dst[r * ld + c] = v[i];
      }
    }
  }
  if (threadIdx.x < kGPad) dst[mg * ld + threadIdx.x] = 0.0f;
}

struct DenseArgs {
  const float *G, *P, *pb, *q, *pdiag;
  const float *x, *sg, *su, *sl, *zg, *zu, *zl, *rpg, *rpu, *rpl, *scal;
  float *xo, *sgo, *suo, *slo, *zgo, *zuo, *zlo, *rpgo, *rpuo, *rplo, *scalo;
  // the device tier's workspace (nk x ldk floats per instance), or the
  // global tier's (dense_global_ws_words floats per instance)
  float* ws;
  int n_iters, n_cor;
  float tol, tol_stall, reg_rel;
};

// The global tier's working set of instance b (see the head of this file):
// the vectors in its slot of the workspace a.ws (dense_global_ws_words
// floats an instance), the factor after them, the P blocks, q and pdiag
// read in place; the reduction scratch and the flag in shared memory from
// `base`.
__device__ inline DenseSmem carve_dense_global(float* base,
                                               const DenseShape& s,
                                               const DenseArgs& a, long b) {
  DenseSmem sm;
  float* p = a.ws + b * dense_global_ws_words(s);
  sm.K = p + dense_global_vec_words(s);
  sm.pb = s.nb ? const_cast<float*>(a.pb + b * s.nb * s.d * s.d) : nullptr;
  sm.q = const_cast<float*>(a.q + b * s.n);
  sm.pdiag = const_cast<float*>(a.pdiag + b * s.n);
  sm.s = p; p += s.m;   sm.z = p; p += s.m;   sm.rp = p; p += s.m;
  sm.w = p; p += s.m;   sm.a1 = p; p += s.m;  sm.a2 = p; p += s.m;
  sm.a3 = p; p += s.m;  sm.ds = p; p += s.m;
  if (s.sep_dz) { sm.dz = p; p += s.m; } else { sm.dz = sm.a2; }
  sm.x = p; p += s.n;   sm.px = p; p += s.n;  sm.dsc = p; p += s.n;
  sm.kb = p; p += s.n;  sm.rhs = p; p += s.n; sm.dx = p; p += s.n;
  sm.dinv = p;
  sm.red = base;
  sm.bad = reinterpret_cast<int*>(base + scpk::kRedWords);
  sm.g = nullptr;
  return sm;
}

// kGSmem: G in shared memory (s.g_smem), read there by shared-memory loads.
// kMinCtas: the launch bound, 4 CTAs an SM (64 registers a thread: four
// share an SM at single-vehicle frog) or 2 (128 registers: fewer spills,
// for a batch that is one wave at two CTAs an SM); the launcher's caller
// picks it (ipm_kernel.py::dense_min_ctas). kKDev: the storage tier of the
// factor; kKDev and kGlobal: the global tier (see the head of this file).
template <bool kGSmem, int kMinCtas, bool kKDev, bool kGlobal = false>
__global__ void __launch_bounds__(kThreads, kMinCtas)
ipm_dense_kernel(DenseArgs a, DenseShape s) {
  extern __shared__ float smem_base[];
  const long b = blockIdx.x;
  static_assert(!kGlobal || (kKDev && !kGSmem), "the global tier's carve");
  DenseSmem sm;
  if constexpr (kGlobal)
    sm = carve_dense_global(smem_base, s, a, b);
  else
    sm = carve_dense<kKDev>(smem_base, s,
                            kKDev ? a.ws + b * s.nk * s.ldk : nullptr);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mg = s.mg, n = s.n, m = s.m, nk = s.nk;
  const int nbd = s.nb * s.d;
  // a dense P (nb = 0) stays in device memory
  const float* pd = nbd ? nullptr : a.P + b * n * n;

  SECTION_INIT();
  // ---- load the instance: G, P blocks, state ----
  const float* gdev = a.G + b * mg * n;
  if (kGSmem) load_g(sm.g, gdev, mg, n, s.ldg);
  if (!kGlobal) {  // (the global tier reads them in place)
    if (nbd)
      copy_in(sm.pb, a.pb + b * s.nb * s.d * s.d, (long)s.nb * s.d * s.d);
    copy_in(sm.q, a.q + b * n, n);
    copy_in(sm.pdiag, a.pdiag + b * n, n);
  }
  copy_in(sm.x, a.x + b * n, n);
  copy_in(sm.s, a.sg + b * mg, mg);
  copy_in(sm.s + mg, a.su + b * n, n);
  copy_in(sm.s + mg + n, a.sl + b * n, n);
  copy_in(sm.z, a.zg + b * mg, mg);
  copy_in(sm.z + mg, a.zu + b * n, n);
  copy_in(sm.z + mg + n, a.zl + b * n, n);
  copy_in(sm.rp, a.rpg + b * mg, mg);
  copy_in(sm.rp + mg, a.rpu + b * n, n);
  copy_in(sm.rp + mg + n, a.rpl + b * n, n);
  float mu_prev = a.scal[b * 2];
  bool frozen = a.scal[b * 2 + 1] > 0.5f;
  float mu = mu_prev;
  const float inv_kappa = 1.0f / (1.0f + a.reg_rel);
  const float one_reg = 1.0f + a.reg_rel;
  const scpk::IpmDims dims{mg, n, m, nk, s.ldk, s.schur != 0};
  const float* g = kGSmem ? sm.g : gdev;
  const DenseRows<kGSmem> rows{g, s.ldg, n, mg};
#ifdef SCP_PROFILE_SECTIONS
  // the step's first three marks close the predictor's right-hand side,
  // solve and vectors (G dx, step lengths, the corrector's vectors), the
  // rest the corrector's (and the Gondzio correctors')
  int mark_i = 0;
  auto mark = [&](int kind) {
    const int at = kind == scpk::kSecRhs ? 0 : kind == scpk::kSecSolve ? 1 : 2;
    SECTION((++mark_i <= 3 ? kSecPredRhs : kSecCorrRhs) + at);
  };
#else
  auto mark = [](int) {};
#endif
  __syncthreads();
  SECTION(kSecLoad);

  for (int it = 0; it < a.n_iters; ++it) {
    // ---- barrier weights and mu ----
    mu = scpk::weights_and_mu(sm, dims);
    SECTION(kSecWeights);

    // ---- G_k^T W G_k (lower, unscaled); with the slack border, the
    // product's slack column G^T W g_slack into kb (its last entry is the
    // slack's diagonal) ----
    form_product<kGSmem>(g, s.ldg, sm.w, mg, nk, sm.K, s.ldk);
    SECTION(kSecProduct);
    if (s.schur) {
      for (int r = tid; r < mg; r += nt)
        sm.a1[r] = sm.w[r] * g[r * s.ldg + nk];
      __syncthreads();
      rows.cols(sm.a1, [&](int c, float sum) { sm.kb[c] = sum; });
    }
    __syncthreads();
    SECTION(kSecBorder);

    // ---- P x, analytic KKT diagonal (the product's), Jacobi scale ----
    for (int c = tid; c < n; c += nt) {
      float px = 0.0f;
      if (!nbd) {
        const float* prow = pd + (long)c * n;
        for (int t = 0; t < n; ++t) px += prow[t] * sm.x[t];
      } else if (c < nbd) {
        const int v = c / s.d, u = c - v * s.d;
        const float* prow = sm.pb + (v * s.d + u) * s.d;
        const float* xb = sm.x + v * s.d;
#pragma unroll 4
        for (int t = 0; t < s.d; ++t) px += prow[t] * xb[t];
      } else {
        px = sm.pdiag[c] * sm.x[c];
      }
      sm.px[c] = px;
      const float gsq = c < nk ? sm.K[c * s.ldk + c] : sm.kb[nk];
      const float dbox = sm.w[mg + c] + sm.w[mg + n + c];
      const float dk = sm.pdiag[c] + gsq + dbox;
      sm.dsc[c] = 1.0f / sqrtf(fmaxf(dk, 1e-30f));
    }
    __syncthreads();
    SECTION(kSecDiag);

    // ---- scaled border of the eliminated slack ----
    if (s.schur) {
      for (int c = tid; c < nk; c += nt)
        sm.kb[c] = sm.dsc[c] * sm.kb[c] * sm.dsc[nk];
      __syncthreads();
    }
    // ---- scale the product, add P, the border and the diagonal (lower
    // triangle, a warp per row; the diagonal is analytic: dk dsc^2 = 1) ----
    for (int r = tid >> 5; r < nk; r += nt >> 5) {
      // block v = r / d holds rows / columns o .. o + d: entry
      // pb[v][r - o][c - o] at v*d*d + (r - o)*d + (c - o) = r*d + c - o
      const int o = r < nbd ? (r / s.d) * s.d : n;
      for (int c = tid & 31; c <= r; c += 32) {
        float val = sm.K[r * s.ldk + c];
        if (!nbd) val = val + pd[(long)r * n + c];
        else if (c >= o) val = val + sm.pb[r * s.d + (c - o)];
        val = val * (sm.dsc[r] * sm.dsc[c]);
        float border = 0.0f;
        if (s.schur) {
          border = (inv_kappa * sm.kb[r]) * sm.kb[c];
          val = val - border;
        }
        sm.K[r * s.ldk + c] = (r == c) ? one_reg - border : val;
      }
    }
    SECTION(kSecScale);
    scpk::factor_kkt<kKDev, kGlobal>(sm, dims);
    SECTION(kSecFactor);

#ifdef SCP_PROFILE_SECTIONS
    mark_i = 0;
#endif
    scpk::mehrotra_step(rows, sm, dims, mu, mu_prev, frozen, a.n_cor, a.tol,
                        a.tol_stall, inv_kappa, mark);
    SECTION(kSecStep);
  }

  // ---- write the state back ----
  for (int c = tid; c < n; c += nt) {
    a.xo[b * n + c] = sm.x[c];
    a.suo[b * n + c] = sm.s[mg + c];
    a.slo[b * n + c] = sm.s[mg + n + c];
    a.zuo[b * n + c] = sm.z[mg + c];
    a.zlo[b * n + c] = sm.z[mg + n + c];
    a.rpuo[b * n + c] = sm.rp[mg + c];
    a.rplo[b * n + c] = sm.rp[mg + n + c];
  }
  for (int r = tid; r < mg; r += nt) {
    a.sgo[b * mg + r] = sm.s[r];
    a.zgo[b * mg + r] = sm.z[r];
    a.rpgo[b * mg + r] = sm.rp[r];
  }
  if (tid == 0) {
    a.scalo[b * 2] = mu;
    a.scalo[b * 2 + 1] = frozen ? 1.0f : 0.0f;
  }
  SECTION(kSecStore);
}

// Raise the kernel's dynamic shared-memory limit to `smem_bytes` and set
// the preferred carve-out of the SM's unified L1 / shared memory
// (cudaFuncAttributePreferredSharedMemoryCarveout: a percentage, -1 for
// the CUDA default) where it differs from the one last set on this
// device. `granted` and `carveout_set` are the kernel's rows of its
// translation unit's tables, one entry per device (the carve-out set plus
// 2; 0: none yet). The shared, device and cluster tiers take the largest
// shared carve-out, so that four CTAs of the frog shape fit; the global
// tier (132 bytes of shared memory a CTA) takes its caller's.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int* granted, int* carveout_set,
                    long smem_bytes,
                    int carveout = (int)cudaSharedmemCarveoutMaxShared) {
  cudaError_t err = scpk::ensure_dyn_smem(kernel, granted, smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= scpk::kMaxDevices) return cudaErrorInvalidDevice;
  if (carveout_set[dev] == carveout + 2) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             carveout);
  if (err == cudaSuccess) carveout_set[dev] = carveout + 2;
  return err;
}

using DenseKernel = void (*)(DenseArgs, DenseShape);

}  // namespace
