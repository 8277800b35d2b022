// Fused dense-G interior-point iteration for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scp_tpu/ops/pallas_linalg.py::ipm_iterate_lane
// (built by make_ipm_iter_kernel WITHOUT g_struct): ONE Mehrotra
// predictor-corrector iteration of every QP of a batch per launch, on a
// pre-formed KKT product. The caller forms Kprod = G^T diag(z_g / s_g) G
// (+ the dense P when it has no block statement) between launches; the kernel
// adds the P blocks (and computes P x from them), the box diagonal and the
// relative regularisation, Jacobi-scales to unit diagonal, eliminates the
// slack border when asked (`schur`: the last variable is a slack with a zero
// P row), factors, and runs the step algebra it shares with the structured
// kernel (ipm_common.cuh): predictor, corrector, n_cor Gondzio correctors,
// step lengths, sigma = (mu_aff / mu)^3, the (1 - alpha) residual recurrence
// and freeze on stall / convergence / a non-finite step through `scal`.
//
// Design. ONE CTA PER QP INSTANCE, the working set in dynamic shared memory:
// the nk x nk factor (nk = n - 1 with the Schur border, n without), the
// P blocks, ~20 vectors over the m = mg + 2n rows and, when it fits under
// the block's limit, the dense equilibrated G (mg x n; 37 KB at single-
// vehicle frog, hp = 20: 440 x 21). A G that does not fit is read from
// device memory through L2 at every product. G x runs a thread per row,
// G^T v a thread per column; G's leading dimension is odd in shared memory so
// both walks hit distinct banks. Tensors are instance-major; nothing is
// padded. Shapes are runtime arguments: one compiled kernel serves every
// shape.
//
// What bounds it on this card: on paper the bytes (K, G and the state are
// read once and the state written once: ~38 MB per iteration at frog,
// B = 1024, ~11 us at the memory rate; the nk^3/3 factor and ~(8 + 2 n_cor)
// passes over G are ~30 MFLOP), in practice the latency of one instance's
// dependent steps: the factor and the substitutions (the package's blocked
// ones, chol_blocked.cuh, shared with the structured kernel through
// ipm_common.cuh) and the thread-per-row / thread-per-column G products.
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
// CTAs that share an SM at single-vehicle frog (58 KB of shared memory):
// caps the registers at 80 a thread (unbounded, the inlined blocked factor
// and solve took 233 and one CTA an SM).
constexpr int kMinCtasPerSm = 3;

struct DenseShape {
  int B, mg, n, m;
  int nk, ldk;        // factored system and its leading dimension (odd)
  int nb, d;          // P blocks (nb = 0: px arrives pre-computed)
  int schur;          // eliminate the slack border
  int g_smem, ldg;    // G held in shared memory, its leading dimension
};

__host__ __device__ inline DenseShape make_dense_shape(int B, int mg, int n,
                                                       int nb, int d,
                                                       int schur,
                                                       int g_smem) {
  DenseShape s;
  s.B = B; s.mg = mg; s.n = n; s.m = mg + 2 * n;
  s.nk = schur ? n - 1 : n;
  s.ldk = s.nk | 1;
  s.nb = nb; s.d = d; s.schur = schur;
  s.g_smem = g_smem;
  s.ldg = g_smem ? (n | 1) : n;
  return s;
}

// Shared-memory carve (in 4-byte words); must match
// ipm_kernel.py::dense_smem_bytes.
__host__ __device__ inline long dense_smem_words(const DenseShape& s) {
  long w = (long)s.nk * s.ldk;             // K / factor
  w += (long)s.nb * s.d * s.d;             // P blocks
  w += 9L * s.m + 9L * s.n;                // the vectors of scpk::IpmVecs
  w += scpk::kRedWords;                    // reduction scratch
  w += 1;                                  // the factor's failure flag
  if (s.g_smem) w += (long)s.mg * s.ldg;   // G
  return w;
}

struct DenseSmem : scpk::IpmVecs {
  float* pb;
  float* g;  // shared-memory copy of G, or null
};

__device__ inline DenseSmem carve_dense(float* base, const DenseShape& s) {
  DenseSmem sm;
  float* p = base;
  sm.K = p; p += (long)s.nk * s.ldk;
  sm.pb = p; p += (long)s.nb * s.d * s.d;
  sm.s = p; p += s.m;   sm.z = p; p += s.m;   sm.rp = p; p += s.m;
  sm.w = p; p += s.m;   sm.a1 = p; p += s.m;  sm.a2 = p; p += s.m;
  sm.a3 = p; p += s.m;  sm.dz = p; p += s.m;  sm.ds = p; p += s.m;
  sm.q = p; p += s.n;   sm.pdiag = p; p += s.n;  sm.x = p; p += s.n;
  sm.px = p; p += s.n;  sm.dsc = p; p += s.n;    sm.kb = p; p += s.n;
  sm.rhs = p; p += s.n; sm.dx = p; p += s.n;     sm.dinv = p; p += s.n;
  sm.red = p; p += scpk::kRedWords;
  sm.bad = reinterpret_cast<int*>(p); p += 1;
  sm.g = s.g_smem ? p : nullptr;
  return sm;
}

// The dense product G x / G^T v of scpk::mehrotra_step; `g` points at the
// instance's G (shared or device memory) with leading dimension `ld`.
struct DenseRows {
  const float* g;
  int ld, n, mg;
  __device__ float col(const float* v, int c) const {
    float acc = 0.0f;
    for (int r = 0; r < mg; ++r) acc += g[(long)r * ld + c] * v[r];
    return acc;
  }
  __device__ int col_slots() const { return n; }
  __device__ int col_at(int t) const { return t; }
  __device__ float row(const float* x, int r) const {
    const float* gr = g + (long)r * ld;
    float acc = 0.0f;
    for (int c = 0; c < n; ++c) acc += gr[c] * x[c];
    return acc;
  }
};

__device__ inline void copy_in(float* dst, const float* src, long count) {
  for (long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

struct DenseArgs {
  const float *K, *G, *px, *pb, *q, *pdiag;
  const float *x, *sg, *su, *sl, *zg, *zu, *zl, *rpg, *rpu, *rpl, *scal;
  float *xo, *sgo, *suo, *slo, *zgo, *zuo, *zlo, *rpgo, *rpuo, *rplo, *scalo;
  int n_cor;
  float tol, tol_stall, reg_rel;
};

__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
ipm_dense_kernel(DenseArgs a, DenseShape s) {
  extern __shared__ float smem_base[];
  const DenseSmem sm = carve_dense(smem_base, s);
  const long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarp = nt >> 5;
  const int mg = s.mg, n = s.n, m = s.m, nk = s.nk;
  const int nbd = s.nb * s.d;

  // ---- load the instance: K's lower triangle, G, P blocks, state ----
  const float* kin = a.K + b * nk * nk;
  for (int e = tid; e < nk * nk; e += nt) {
    const int r = e / nk, c = e - r * nk;
    if (c <= r) sm.K[r * s.ldk + c] = kin[e];
  }
  const float* gdev = a.G + b * mg * n;
  if (s.g_smem) {
    for (long e = tid; e < (long)mg * n; e += nt) {
      const int r = (int)(e / n), c = (int)(e - (long)r * n);
      sm.g[(long)r * s.ldg + c] = gdev[e];
    }
  }
  if (nbd) copy_in(sm.pb, a.pb + b * s.nb * s.d * s.d, (long)s.nb * s.d * s.d);
  else copy_in(sm.px, a.px + b * n, n);
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
  const float inv_kappa = 1.0f / (1.0f + a.reg_rel);
  const float one_reg = 1.0f + a.reg_rel;
  const scpk::IpmDims dims{mg, n, m, nk, s.ldk, s.schur != 0};
  const float* g = s.g_smem ? sm.g : gdev;
  const DenseRows rows{g, s.ldg, n, mg};
  __syncthreads();

  // ---- barrier weights and mu ----
  const float mu = scpk::weights_and_mu(sm, dims);

  // ---- P x from the blocks, analytic KKT diagonal, Jacobi scale ----
  for (int c = tid; c < n; c += nt) {
    if (nbd) {
      float px;
      if (c < nbd) {
        const int v = c / s.d, u = c - v * s.d;
        const float* prow = sm.pb + (v * s.d + u) * s.d;
        const float* xb = sm.x + v * s.d;
        px = 0.0f;
        for (int t = 0; t < s.d; ++t) px += prow[t] * xb[t];
      } else {
        px = sm.pdiag[c] * sm.x[c];
      }
      sm.px[c] = px;
    }
    float gsq = 0.0f;
    for (int r = 0; r < mg; ++r) {
      const float gv = g[(long)r * s.ldg + c];
      gsq += sm.w[r] * gv * gv;
    }
    const float dbox = sm.w[mg + c] + sm.w[mg + n + c];
    const float dk = sm.pdiag[c] + gsq + dbox;
    sm.dsc[c] = 1.0f / sqrtf(fmaxf(dk, 1e-30f));
  }
  // ---- scaled border column of the eliminated slack ----
  if (s.schur) {
    for (int r = tid; r < mg; r += nt)
      sm.a1[r] = sm.w[r] * g[(long)r * s.ldg + nk];
    __syncthreads();
    for (int c = tid; c < nk; c += nt)
      sm.kb[c] = sm.dsc[c] * rows.col(sm.a1, c) * sm.dsc[nk];
  }
  __syncthreads();

  // ---- scale the pre-formed product, add the P blocks, border, diagonal
  // (lower triangle; the diagonal is analytic: dk * dsc^2 = 1) ----
  for (int r = warp; r < nk; r += nwarp) {
    for (int c = lane; c <= r; c += 32) {
      const float sc = sm.dsc[r] * sm.dsc[c];
      float val = sm.K[r * s.ldk + c] * sc;
      float border = 0.0f;
      if (s.schur) {
        border = (inv_kappa * sm.kb[r]) * sm.kb[c];
        val = val - border;
      }
      if (r < nbd && r / s.d == c / s.d) {
        // block v = r / d holds rows / columns o .. o + d: entry
        // pb[v][r - o][c - o] at v*d*d + (r - o)*d + (c - o) = r*d + c - o
        const int o = (r / s.d) * s.d;
        val = val + sm.pb[r * s.d + (c - o)] * sc;
      }
      sm.K[r * s.ldk + c] = (r == c) ? one_reg - border : val;
    }
  }
  scpk::factor_kkt(sm, dims);

  auto no_mark = [](int) {};
  scpk::mehrotra_step(rows, sm, dims, mu, mu_prev, frozen, a.n_cor, a.tol,
                      a.tol_stall, inv_kappa, no_mark);

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
}

int ipm_dense_smem_granted[scpk::kMaxDevices];

}  // namespace

extern "C" {

// Launch on `stream`. Returns cudaGetLastError() (0 = launched), or -1 when
// `smem_bytes` disagrees with the kernel's own carve. `pb` is null when the
// P blocks are absent (nb = 0; `px` carries P x); `px` is read only then.
int ipm_dense_launch(
    const float* K, const float* G, const float* px, const float* pb,
    const float* q, const float* pdiag,
    const float* x, const float* sg, const float* su, const float* sl,
    const float* zg, const float* zu, const float* zl,
    const float* rpg, const float* rpu, const float* rpl, const float* scal,
    float* xo, float* sgo, float* suo, float* slo,
    float* zgo, float* zuo, float* zlo,
    float* rpgo, float* rpuo, float* rplo, float* scalo,
    int B, int mg, int n, int nb, int d, int schur, int g_smem, int n_cor,
    float tol, float tol_stall, float reg_rel,
    long smem_bytes, void* stream) {
  const DenseShape s = make_dense_shape(B, mg, n, nb, d, schur, g_smem);
  if (smem_bytes != 4L * dense_smem_words(s)) return -1;
  DenseArgs a;
  a.K = K; a.G = G; a.px = px; a.pb = pb; a.q = q; a.pdiag = pdiag;
  a.x = x; a.sg = sg; a.su = su; a.sl = sl;
  a.zg = zg; a.zu = zu; a.zl = zl; a.rpg = rpg; a.rpu = rpu; a.rpl = rpl;
  a.scal = scal;
  a.xo = xo; a.sgo = sgo; a.suo = suo; a.slo = slo;
  a.zgo = zgo; a.zuo = zuo; a.zlo = zlo;
  a.rpgo = rpgo; a.rpuo = rpuo; a.rplo = rplo; a.scalo = scalo;
  a.n_cor = n_cor;
  a.tol = tol; a.tol_stall = tol_stall; a.reg_rel = reg_rel;
  cudaError_t err = scpk::ensure_dyn_smem(ipm_dense_kernel,
                                          ipm_dense_smem_granted, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ipm_dense_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(a, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
