// Fused dense-G interior-point kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scp_tpu/ops/pallas_linalg.py::ipm_iterate_lane
// (built by make_ipm_iter_kernel WITHOUT g_struct) together with the loop
// around it in scp_tpu/solvers/qp.py (fori_body: the product
// G_k^T diag(z_g / s_g) G_k formed on the MXU, then one kernel call per
// iteration): ALL fixed Mehrotra predictor-corrector iterations of every QP
// of a batch in ONE launch. Per iteration the kernel forms the product
// itself from the G it holds, adds the P blocks (or the lower triangle of a
// dense P) and computes P x, the box diagonal and the relative
// regularisation, Jacobi-scales to unit diagonal, eliminates the slack border
// when asked (`schur`: the last variable is a slack with a zero P row),
// factors, and runs the step algebra it shares with the structured kernel
// (ipm_common.cuh): predictor, corrector, n_cor Gondzio correctors, step
// lengths, sigma = (mu_aff / mu)^3, the (1 - alpha) residual recurrence and
// freeze on stall / convergence / a non-finite step; `scal` carries
// (mu_prev, frozen) in and out.
//
// Design. ONE CTA PER QP INSTANCE, the working set in dynamic shared memory
// for the whole solve: the nk x nk factor (nk = n - 1 with the Schur border,
// n without), the P blocks, the step's vectors over the m = mg + 2n rows and,
// when it fits under the block's limit, the dense equilibrated G (mg x n;
// 37 KB at single-vehicle frog, hp = 20: 440 x 21), read from device memory
// once per QP; the state goes back once. A G that does not fit, and a dense
// P, are read from device memory (through L1 / L2) where they are used. No
// thread walks all mg rows of G:
//   * the product G_k^T W G_k is formed in 4 x 4 tiles of its lower
//     triangle, a warp per tile and a lane per row slice (rows lane,
//     lane + 32, ...), the 16 partial sums of a tile reduced across the warp
//     by a reduce-scatter of shuffles (16 shuffles a tile); its diagonal is
//     the G^T W G diagonal of the Jacobi scale;
//   * G^T v (the right-hand sides, and the slack border G_k^T W g_slack) runs
//     a warp per four adjacent columns, a lane per row slice, the four sums
//     reduced the same way (the `cols` of ipm_common.cuh's Rows contract);
//   * G x runs a thread per row over the n columns.
// G's leading dimension is odd in shared memory, so that a warp's lanes,
// each on its own row, hit distinct banks. With no Gondzio corrector the
// final direction dz shares its storage with the predictor's dz (a2), which
// is dead by then: at single-vehicle frog the carve is 56,568 bytes and four
// CTAs share an SM under __launch_bounds__(256, 4) (64 registers a thread).
// The kernel is also built for two CTAs an SM (128 registers), which runs
// one instance faster; the caller takes it while the batch is one wave at
// two CTAs an SM, four beyond (ipm_kernel.py::dense_min_ctas).
// Tensors are instance-major; nothing is padded. Shapes are runtime
// arguments: one compiled kernel (per place of G and launch bound) serves
// every shape.
//
// Two storage tiers of the factor, one template (kKDev). Where the factor
// and the vectors exceed one block's shared memory (the dense QP of
// circle-4 at hp = 64: n = 257, 370,416 bytes, of which the 256 x 257
// factor takes 263,168), the device tier keeps the factor in a
// per-instance workspace in device memory (rows padded to a multiple of 32
// floats) and G in device memory too; the vectors and the P blocks stay in
// shared memory. The factor and the solves are the same chol_blocked.cuh
// code on that pointer, every sum in the same order as in shared memory.
// The workspace is written and read inside the launch, never through the
// read-only path; the block barriers order it within the CTA. The tier
// follows from the shape (ipm_kernel.py::dense_tier).
//
// What bounds it on this card: operations. Per QP at frog (n = 21, nk = 20,
// mg = 440, 7 iterations) ~1.1 M multiply-adds in float32 outside the tensor
// cores (the product 92k an iteration, the slack border 9k, four G passes
// 37k, the factor, the substitutions, P x and the vector algebra;
// chip_smoke.py::dense_work counts them) against ~50 KB of device-memory
// traffic: at B = 1024 ~0.033 ms at the card's float32 rate and ~0.015 ms at
// its memory rate. One instance's dependent steps (the factor and the
// substitutions, chol_blocked.cuh, and ~20 block barriers an iteration) hold
// it above that bound; keeping G and the state in shared memory across the
// iterations and the row reductions split across warps shorten them.
//
// No fast-math: the Jacobi scaling and barrier ratios z/s up to 1e10 are why
// float32 works at all here.
#include <cuda_runtime.h>
#include <math_constants.h>

// the factor out of line (see ipm_common.cuh)
#define SCP_IPM_FACTOR_CALL __noinline__
#include "ipm_common.cuh"
#include "smem.cuh"

namespace {

constexpr int kThreads = scpk::kIpmThreads;

// Built with -DSCP_PROFILE_SECTIONS (scripts/torch_kernel_check.py
// --sections k2) the kernel adds up, for block 0, the clock cycles between
// section marks; without it the marks compile to nothing.
enum { kSecLoad, kSecWeights, kSecProduct, kSecBorder, kSecDiag, kSecScale,
       kSecFactor, kSecPredRhs, kSecPredSolve, kSecPredVector, kSecCorrRhs,
       kSecCorrSolve, kSecCorrVector, kSecStep, kSecStore, kSecCount };
#ifdef SCP_PROFILE_SECTIONS
__device__ unsigned long long g_section_cycles[16];
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
  float* ws;  // the device tier's workspace: nk x ldk floats per instance
  int n_iters, n_cor;
  float tol, tol_stall, reg_rel;
};

// kGSmem: G in shared memory (s.g_smem), read there by shared-memory loads.
// kMinCtas: the launch bound, 4 CTAs an SM (64 registers a thread: four
// share an SM at single-vehicle frog) or 2 (128 registers: fewer spills,
// for a batch that is one wave at two CTAs an SM); the launcher's caller
// picks it (ipm_kernel.py::dense_min_ctas). kKDev: the storage tier of the
// factor (see the head of this file).
template <bool kGSmem, int kMinCtas, bool kKDev>
__global__ void __launch_bounds__(kThreads, kMinCtas)
ipm_dense_kernel(DenseArgs a, DenseShape s) {
  extern __shared__ float smem_base[];
  const long b = blockIdx.x;
  const DenseSmem sm = carve_dense<kKDev>(
      smem_base, s, kKDev ? a.ws + b * s.nk * s.ldk : nullptr);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mg = s.mg, n = s.n, m = s.m, nk = s.nk;
  const int nbd = s.nb * s.d;
  // a dense P (nb = 0) stays in device memory
  const float* pd = nbd ? nullptr : a.P + b * n * n;

  SECTION_INIT();
  // ---- load the instance: G, P blocks, state ----
  const float* gdev = a.G + b * mg * n;
  if (kGSmem) load_g(sm.g, gdev, mg, n, s.ldg);
  if (nbd) copy_in(sm.pb, a.pb + b * s.nb * s.d * s.d, (long)s.nb * s.d * s.d);
  copy_in(sm.q, a.q + b * n, n);
  copy_in(sm.pdiag, a.pdiag + b * n, n);
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
    scpk::factor_kkt<kKDev>(sm, dims);
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

using DenseKernel = void (*)(DenseArgs, DenseShape);

// The instantiation for G in shared memory or not, a launch bound of
// `min_ctas` (2 or 4) and the factor in shared or device memory (`k_dev`;
// G then in device memory), with its index in the tables below; null for
// any other combination.
DenseKernel dense_kernel(int g_smem, int min_ctas, int k_dev, int* index) {
  if (min_ctas != 2 && min_ctas != 4) return nullptr;
  if (k_dev) {
    if (g_smem) return nullptr;
    *index = 4 + (min_ctas == 4);
    return min_ctas == 4 ? ipm_dense_kernel<false, 4, true>
                         : ipm_dense_kernel<false, 2, true>;
  }
  *index = 2 * (g_smem != 0) + (min_ctas == 4);
  if (g_smem)
    return min_ctas == 4 ? ipm_dense_kernel<true, 4, false>
                         : ipm_dense_kernel<true, 2, false>;
  return min_ctas == 4 ? ipm_dense_kernel<false, 4, false>
                       : ipm_dense_kernel<false, 2, false>;
}

// Per instantiation and device.
int ipm_dense_smem_granted[6][scpk::kMaxDevices];
int ipm_dense_carveout_set[6][scpk::kMaxDevices];

// Raise the kernel's dynamic shared-memory limit to `smem_bytes` and, once
// per device, prefer the largest shared-memory carve-out of the SM's
// unified L1 / shared memory, so that four CTAs of the frog shape fit.
cudaError_t prepare(DenseKernel kernel, int index, long smem_bytes) {
  cudaError_t err = scpk::ensure_dyn_smem(
      kernel, ipm_dense_smem_granted[index], smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= scpk::kMaxDevices) return cudaErrorInvalidDevice;
  if (ipm_dense_carveout_set[index][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ipm_dense_carveout_set[index][dev] = 1;
  return err;
}

}  // namespace

extern "C" {

// Launch on `stream` at the launch bound `min_ctas` (2 or 4 CTAs an SM),
// the factor in shared memory (`k_dev` 0) or in `ws` (`k_dev` 1: B x nk x
// ldk floats, ldk = nk rounded up to a multiple of 32; G in device memory).
// Returns cudaGetLastError() (0 = launched), or -1 when `smem_bytes`
// disagrees with the kernel's own carve or `ws_floats` with its workspace
// (0 and a null `ws` in shared memory), `min_ctas` is neither 2 nor 4, G is
// asked in shared memory with the factor in device memory, or the P
// operands do not match nb: exactly one of `P` (dense, B x n x n; nb = 0)
// and `pb` (blocks, B x nb x d x d) is non-null.
int ipm_dense_launch(
    const float* G, const float* P, const float* pb,
    const float* q, const float* pdiag,
    const float* x, const float* sg, const float* su, const float* sl,
    const float* zg, const float* zu, const float* zl,
    const float* rpg, const float* rpu, const float* rpl, const float* scal,
    float* xo, float* sgo, float* suo, float* slo,
    float* zgo, float* zuo, float* zlo,
    float* rpgo, float* rpuo, float* rplo, float* scalo, float* ws,
    int B, int mg, int n, int nb, int d, int schur, int g_smem, int k_dev,
    int n_iters, int n_cor, int min_ctas, float tol, float tol_stall,
    float reg_rel, long smem_bytes, long ws_floats, void* stream) {
  const DenseShape s = make_dense_shape(B, mg, n, nb, d, schur, g_smem,
                                        n_cor, k_dev != 0);
  if (smem_bytes != 4L * dense_smem_words(s)) return -1;
  if (ws_floats != (k_dev ? (long)B * s.nk * s.ldk : 0)
      || (ws != nullptr) != (k_dev != 0))
    return -1;
  if ((nb > 0) != (pb != nullptr) || (nb > 0) == (P != nullptr)) return -1;
  int index = 0;
  const DenseKernel kernel = dense_kernel(g_smem, min_ctas, k_dev, &index);
  if (kernel == nullptr) return -1;
  DenseArgs a;
  a.G = G; a.P = P; a.pb = pb; a.q = q; a.pdiag = pdiag;
  a.x = x; a.sg = sg; a.su = su; a.sl = sl;
  a.zg = zg; a.zu = zu; a.zl = zl; a.rpg = rpg; a.rpu = rpu; a.rpl = rpl;
  a.scal = scal;
  a.xo = xo; a.sgo = sgo; a.suo = suo; a.slo = slo;
  a.zgo = zgo; a.zuo = zuo; a.zlo = zlo;
  a.rpgo = rpgo; a.rpuo = rpuo; a.rplo = rplo; a.scalo = scalo; a.ws = ws;
  a.n_iters = n_iters; a.n_cor = n_cor;
  a.tol = tol; a.tol_stall = tol_stall; a.reg_rel = reg_rel;
  cudaError_t err = prepare(kernel, index, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(a, s);
  return (int)cudaGetLastError();
}

// CTAs of the kernel at the launch bound `min_ctas` and tier `k_dev` that
// can be resident on one SM at a shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the launch's own
// shared memory and carve-out) into `ctas`. Returns a CUDA error code, or
// -1 for a combination dense_kernel has no instantiation of.
int ipm_dense_occupancy(int mg, int n, int nb, int d, int schur, int g_smem,
                        int k_dev, int n_cor, int min_ctas, int* ctas) {
  const long smem_bytes = 4L * dense_smem_words(
      make_dense_shape(1, mg, n, nb, d, schur, g_smem, n_cor, k_dev != 0));
  int index = 0;
  const DenseKernel kernel = dense_kernel(g_smem, min_ctas, k_dev, &index);
  if (kernel == nullptr) return -1;
  cudaError_t err = prepare(kernel, index, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, kThreads, (size_t)smem_bytes);
}

#ifdef SCP_PROFILE_SECTIONS
// Copy block 0's per-section cycle sums to `out` (kSecCount entries, in the
// order of the enum above) and clear them. Synchronises the device.
int ipm_dense_read_sections(unsigned long long* out) {
  unsigned long long zero[16] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(
      out, g_section_cycles, kSecCount * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_section_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
