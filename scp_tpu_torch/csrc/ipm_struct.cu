// Fused structured interior-point kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scp_tpu/ops/pallas_linalg.py::
// ipm_iterate_lane_struct (built by make_ipm_iter_kernel with g_struct and
// n_iters): ALL fixed Mehrotra predictor-corrector iterations of every QP of
// a batch in one launch. Per iteration: slab matvecs, analytic KKT diagonal,
// Jacobi-scaled KKT matrix formed from the pair / obstacle row slabs + the
// block-diagonal P + the box diagonal, rank-1 Schur elimination of the slack
// variable, Cholesky on nu = n - 1 columns, predictor + corrector (+ n_cor
// Gondzio correctors with per-instance acceptance), step lengths,
// sigma = (mu_aff / mu)^3, the exact (1 - alpha) primal-residual recurrence
// and freeze-on-stall / converged / non-finite.
//
// The step algebra from the factorization on (predictor, corrector,
// correctors, step lengths, freeze) is shared with the dense-G kernel
// through ipm_common.cuh; this file forms the KKT matrix from the slabs.
//
// Design. ONE CTA PER QP INSTANCE. The whole per-instance working set —
// the nu x nu factor, the slabs, the P blocks and ~20 vectors — lives in
// dynamic shared memory for the whole solve; it is read from device memory
// once and the state is written back once. The iteration loop is a plain
// `for` inside the CTA. Tensors are instance-major, so a CTA reads
// contiguous stretches. Shapes and the pair / obstacle-vehicle tables are
// runtime arguments: one compiled kernel serves every shape.
//
// What bounds it on this card: arithmetic and barrier latency, not memory.
// Per QP at the bench shape, with the slabs lower-triangular, an iteration
// needs ~0.32 MFLOP of non-tensor f32 (Cholesky 80^3/3 ~0.17, K formation
// ~0.09, slab matvecs ~0.03, four 80^2 substitutions ~0.03, vector algebra
// ~0.01; chip_smoke.py::k1_work counts them) against ~35 KB of device-memory
// traffic per SOLVE; at B = 1024 and 7 iterations that is ~2.3 GFLOP and
// ~36 MB, i.e. ~35 us at the card's f32 rate (67 TFLOP/s) and ~10 us at its
// memory rate. The kernel sits far above that bound because one instance's
// factor and substitutions are chains of dependent steps, so the design
// shortens the chains and keeps more instances resident per SM:
//   * the factor and the solves are the package's blocked ones
//     (chol_blocked.cuh, through ipm_common.cuh): 2 ceil(nu / 16) block
//     barriers per factor and ceil(nu / 16) per substitution, where a
//     column-by-column factor took nu + 1 and a substitution nu dependent
//     warp steps;
//   * K is formed block by block: each hu x hu (vehicle-row, vehicle-
//     column) block of its lower triangle is a sum over the slabs that
//     touch both vehicles of (W g_row)^T g_col, an inner dimension of hp,
//     computed as 4 x 4 register tiles (a thread per tile, the pair and
//     obstacle lookups resolved once per tile; w folded into the row side
//     as it is loaded, so no scaled copy of the slabs takes shared memory);
//   * lower-triangular slabs are stored packed (row k holds its
//     min(k + 1, hu) non-zero entries), which takes the carve to 56,192
//     bytes at P = 6, hp = hu = 20, V = 4, so that four CTAs share an SM
//     (__launch_bounds__(256, 4): 64 registers a thread).
//
// Four storage tiers: ipm_struct_kernel<kDev> (shared, device),
// ipm_struct_cluster_kernel (cluster) and ipm_struct_kernel<true, true>
// (global, at the end of this comment). The shared
// tier (kDev false) is the design above. Past one block's shared memory
// (the side-selection QP of parallel-11 at hp = 20: 481,908 bytes; a dense
// KKT at circle-4, hp = 64: 471,904) the device tier (kDev true) keeps the
// KKT matrix and its factor in a per-instance workspace in device memory
// (rows padded to a multiple of 32 floats, so that a row starts a 128-byte
// line) and reads the slabs in place from the input tensors (whole rows of
// hu; with lower_tri the zero entries are skipped as in the shared tier,
// not stored packed); the vectors, the P blocks, the slack column and the
// index tables stay in shared memory. The factor and the solves are the
// same chol_blocked.cuh code on a pointer into device memory, as in
// linalg.cu's chol_large_kernel: its panel rows, diagonal blocks and
// trailing tiles go through L1 / L2. Every sum is taken in the same order
// in both tiers, so on the same inputs they agree bit for bit. The
// workspace is written and read inside the launch: it is never read
// through the read-only (non-coherent) path, and the block barriers order
// it within the CTA.
//
// Between the two, the cluster tier (ipm_struct_cluster_kernel): one
// instance per thread block cluster of C CTAs on neighbouring SMs. Rank 0
// holds the device tier's carve (the vectors, the P blocks, the slack
// column, the tables) and runs the step algebra as the device tier does;
// the KKT matrix lives in 16-row stripes dealt over the ranks' shared
// memory (chol_cluster.cuh). Each iteration rank 0 computes the weights,
// the Jacobi scale and the border; every other rank copies them through
// distributed shared memory (DSMEM); every rank forms the 4 x 4 tiles
// whose rows lie in its stripes (the slabs read in place from device
// memory, as in the device tier); all ranks run the cluster factor; rank
// 0's solves read the factor's rows through DSMEM (chol_rows_solve). The
// factor thus sits in shared memory instead of L1 / L2, and the tiles are
// formed on C SMs. The same sums in the same order, so the cluster tier is
// bit for bit the device tier.
//
// Past the device tier's carve (its vectors alone: parallel-11's side-
// selection QP from hp = 32, 239,380 bytes; circle-16 from hp = 28) the
// global tier keeps the step's vectors in device memory too: a per-instance
// workspace (global_vec_words: s z rp w a1 a2 a3 dz ds, x px dsc kb rhs dx
// dinv, then the nu x ldk KKT matrix as in the device tier), the P blocks,
// the slack column, q and pdiag read in place from the inputs; shared
// memory keeps the reduction scratch, the index tables and the failure
// flag. It is a compile-time flag (kGlobal) on the device tier's kernel, so
// the other instantiations compile as before. The arithmetic and its order
// are the device tier's, so the global tier is bit for bit the device and
// the cluster tier wherever they run. The tier follows from the shape alone
// (the wrapper, ipm_kernel.py::struct_tier: shared, else cluster, else
// device, else global).
//
// No fast-math: the Jacobi scaling (1/sqrt of the analytic diagonal) and
// barrier ratios z/s up to 1e10 are why f32 works at all here.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "chol_cluster.cuh"
#include "ipm_common.cuh"
#include "smem.cuh"

namespace {

constexpr int kThreads = scpk::kIpmThreads;
constexpr int kMinCtasPerSm = 4;

// Built with -DSCP_PROFILE_SECTIONS (scripts/torch_k1_sections.py) the
// kernel adds up, for block 0, the clock cycles between section marks;
// without it the marks compile to nothing.
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
using scpk::kSecLoad;
using scpk::kSecDiag;
using scpk::kSecForm;
using scpk::kSecChol;
using scpk::kSecUpdate;
using scpk::kSecStore;
using scpk::kSecCount;

struct Shape {
  int P, S, hp, hu, V;      // pairs, single-block slabs, horizon, block, vehicles
  int nu, n, mg, m, ldk;    // derived
  int lower_tri;            // slabs are zero for u > k
};

// The factor's leading dimension: odd in shared memory (column walks hit
// distinct banks), a multiple of 32 floats in the device tier's workspace.
__host__ __device__ inline int kkt_ld(int nu, bool dev) {
  return dev ? (nu + 31) & ~31 : nu | 1;
}

__host__ __device__ inline Shape make_shape(int P, int S, int hp, int hu,
                                            int V, int lower_tri, bool dev) {
  Shape d;
  d.P = P; d.S = S; d.hp = hp; d.hu = hu; d.V = V;
  d.nu = V * hu;
  d.n = d.nu + 1;
  d.mg = (P + S) * hp;
  d.m = d.mg + 2 * d.n;
  d.ldk = kkt_ld(d.nu, dev);
  d.lower_tri = lower_tri;
  return d;
}

// A slab: row k (k < hp) holds its entries u < len(k) at off(k) + u. With
// lower_tri the slabs are zero for u > k, and only the min(k + 1, hu)
// leading entries of a row are read. In shared memory (kDev false) only
// those are stored (packed rows: the next row starts len(k) further); the
// device tier reads the input tensors in place, whole rows of hu.
__host__ __device__ inline int slab_row_len(const Shape& d, int k) {
  return d.lower_tri ? min(k + 1, d.hu) : d.hu;
}

template <bool kDev>
__host__ __device__ inline int slab_row_off(const Shape& d, int k) {
  if (kDev || !d.lower_tri) return k * d.hu;
  return k < d.hu ? k * (k + 1) / 2
                  : d.hu * (d.hu + 1) / 2 + (k - d.hu) * d.hu;
}

template <bool kDev>
__host__ __device__ inline int slab_words(const Shape& d) {
  return slab_row_off<kDev>(d, d.hp);
}

// Shared-memory carve (in 4-byte words) of a tier; must match
// ipm_kernel.py::smem_bytes (kDev false) / struct_tier (kDev true).
template <bool kDev>
__host__ __device__ inline long smem_words(const Shape& d) {
  long w = 0;
  if (!kDev) {
    w += (long)d.nu * d.ldk;                        // K / factor
    w += (2L * d.P + d.S) * slab_words<false>(d);   // gi, gj, gob
  }
  w += (long)d.V * d.hu * d.hu;            // pb
  w += d.mg;                               // gsl
  w += 9L * d.m;                           // s z rp w a1 a2 a3 dz ds
  w += 9L * d.n;                           // q pdiag x px dsc kb rhs dx dinv
  w += scpk::kRedWords;                    // reduction scratch
  w += (long)d.V * d.V + 2L * d.P + d.S;   // pair_of, pair i / j, obst veh
  w += 1;                                  // the factor's failure flag
  return w;
}

// The cluster tier's carve (in 4-byte words) on every rank: the device
// tier's (smem_words<true>), then, from the next 16-byte boundary, the
// factor's buffers (scpk::stripe_buffer_words: its diagonal-block and panel
// buffers, its mbarriers and this rank's stripe area of `area_words`), the
// deal (two ints a stripe) and, at an even word, the factor's row pointers
// (nu of 8 bytes); must match ipm_kernel.py::cluster_smem_bytes.
__host__ __device__ inline long cluster_base_word(const Shape& d) {
  return (smem_words<true>(d) + 3) & ~3L;
}

__host__ __device__ inline long cluster_krow_word(const Shape& d, int C,
                                                  int area_words) {
  const long w = cluster_base_word(d)
                 + scpk::stripe_buffer_words(d.nu, C, area_words)
                 + 2L * scpk::stripe_count(d.nu);
  return (w + 1) & ~1L;
}

__host__ __device__ inline long cluster_smem_words(const Shape& d, int C,
                                                   int area_words) {
  return cluster_krow_word(d, C, area_words) + 2L * d.nu;
}

// The global tier (kGlobal) keeps only the reduction scratch, the index
// tables and the failure flag in shared memory; must match
// ipm_kernel.py::global_smem_bytes.
__host__ __device__ inline long global_smem_words(const Shape& d) {
  return scpk::kRedWords + (long)d.V * d.V + 2L * d.P + d.S + 1;
}

// The global tier's workspace of one instance (floats): the step's vectors
// (global_vec_words: nine m-vectors s z rp w a1 a2 a3 dz ds, seven
// n-vectors x px dsc kb rhs dx dinv), rounded up to 32 floats, then the
// nu x ldk KKT matrix; must match ipm_kernel.py::global_layout.
__host__ __device__ inline long global_vec_words(const Shape& d) {
  return (9L * d.m + 7L * d.n + 31) & ~31L;
}

__host__ __device__ inline long global_ws_words(const Shape& d) {
  return global_vec_words(d) + (long)d.nu * d.ldk;
}

// The shared vectors (scpk::IpmVecs) plus the slabs, P blocks and tables.
struct Smem : scpk::IpmVecs {
  const float *gi, *gj, *gob;  // the slabs: read only, once loaded
  float *pb, *gsl;
  int *pair_of, *pi, *pj, *ov;
};

struct Args {
  const float *gi, *gj, *gob, *gsl, *pb, *q, *pdiag;
  const float *x, *sg, *su, *sl, *zg, *zu, *zl, *rpg, *rpu, *rpl, *scal;
  const int *pair_idx, *obst_veh;
  float *xo, *sgo, *suo, *slo, *zgo, *zuo, *zlo, *rpgo, *rpuo, *rplo, *scalo;
  float* ws;  // the device tier's workspace: nu x ldk floats per instance
  int n_iters, n_cor;
  float tol, tol_stall, reg_rel;
};

// The cluster tier's own arguments: the stripes' owners and offsets
// (2 x ceil(nu / 16) ints in device memory), the CTAs of an instance's
// cluster, each rank's stripe area (floats).
struct ClusterArgs {
  const int* deal;
  int C, area_words;
};

// Instance b's working set: in the shared tier all of it in shared memory
// from `base`; in the device tier K in the workspace and the slabs in the
// input tensors, the rest from `base`.
template <bool kDev>
__device__ inline Smem carve(float* base, const Shape& d, const Args& a,
                             long b) {
  Smem sm;
  float* p = base;
  if (kDev) {
    const long slab = (long)d.hp * d.hu;
    sm.K = a.ws + b * d.nu * d.ldk;
    sm.gi = a.gi + b * d.P * slab;
    sm.gj = a.gj + b * d.P * slab;
    sm.gob = d.S ? a.gob + b * d.S * slab : nullptr;
  } else {
    const int sw = slab_words<false>(d);
    sm.K = p; p += (long)d.nu * d.ldk;
    sm.gi = p; p += (long)d.P * sw;
    sm.gj = p; p += (long)d.P * sw;
    sm.gob = p; p += (long)d.S * sw;
  }
  sm.pb = p; p += (long)d.V * d.hu * d.hu;
  sm.gsl = p; p += d.mg;
  sm.s = p; p += d.m;   sm.z = p; p += d.m;   sm.rp = p; p += d.m;
  sm.w = p; p += d.m;   sm.a1 = p; p += d.m;  sm.a2 = p; p += d.m;
  sm.a3 = p; p += d.m;  sm.dz = p; p += d.m;  sm.ds = p; p += d.m;
  sm.q = p; p += d.n;   sm.pdiag = p; p += d.n;  sm.x = p; p += d.n;
  sm.px = p; p += d.n;  sm.dsc = p; p += d.n;    sm.kb = p; p += d.n;
  sm.rhs = p; p += d.n; sm.dx = p; p += d.n;     sm.dinv = p; p += d.n;
  sm.red = p; p += scpk::kRedWords;
  int* ip = reinterpret_cast<int*>(p);
  sm.pair_of = ip; ip += d.V * d.V;
  sm.pi = ip; ip += d.P;  sm.pj = ip; ip += d.P;  sm.ov = ip; ip += d.S;
  sm.bad = ip;
  return sm;
}

// The global tier's working set of instance b (see the head of this file):
// the vectors in its slot of the workspace a.ws (global_ws_words floats an
// instance), the KKT matrix after them, the slabs, P blocks, slack column,
// q and pdiag read in place; the reduction scratch, the tables and the
// flag in shared memory from `base`.
__device__ inline Smem carve_global(float* base, const Shape& d,
                                    const Args& a, long b) {
  Smem sm;
  const long slab = (long)d.hp * d.hu;
  float* p = a.ws + b * global_ws_words(d);
  sm.K = p + global_vec_words(d);
  sm.gi = a.gi + b * d.P * slab;
  sm.gj = a.gj + b * d.P * slab;
  sm.gob = d.S ? a.gob + b * d.S * slab : nullptr;
  sm.pb = const_cast<float*>(a.pb + b * d.V * d.hu * d.hu);
  sm.gsl = const_cast<float*>(a.gsl + b * d.mg);
  sm.q = const_cast<float*>(a.q + b * d.n);
  sm.pdiag = const_cast<float*>(a.pdiag + b * d.n);
  sm.s = p; p += d.m;   sm.z = p; p += d.m;   sm.rp = p; p += d.m;
  sm.w = p; p += d.m;   sm.a1 = p; p += d.m;  sm.a2 = p; p += d.m;
  sm.a3 = p; p += d.m;  sm.dz = p; p += d.m;  sm.ds = p; p += d.m;
  sm.x = p; p += d.n;   sm.px = p; p += d.n;  sm.dsc = p; p += d.n;
  sm.kb = p; p += d.n;  sm.rhs = p; p += d.n; sm.dx = p; p += d.n;
  sm.dinv = p;
  sm.red = base;
  int* ip = reinterpret_cast<int*>(base + scpk::kRedWords);
  sm.pair_of = ip; ip += d.V * d.V;
  sm.pi = ip; ip += d.P;  sm.pj = ip; ip += d.P;  sm.ov = ip; ip += d.S;
  sm.bad = ip;
  return sm;
}

template <bool kDev, bool kGlobal>
__device__ inline Smem carve_tier(float* base, const Shape& d, const Args& a,
                                  long b) {
  if constexpr (kGlobal) return carve_global(base, d, a, b);
  else return carve<kDev>(base, d, a, b);
}

// sum_rows vec[row] * g[row, col]  (SQ: * g^2) over every slab row that
// touches column `c` (< nu) — the column walk of G^T v and of diag(G^T W G).
template <bool SQ, bool kDev>
__device__ inline float col_accum(const Smem& sm, const Shape& d,
                                  const float* vec, int c) {
  const int v = c / d.hu, u = c - v * d.hu;
  const int k0 = d.lower_tri ? u : 0;
  const int slab = slab_words<kDev>(d), off0 = slab_row_off<kDev>(d, k0) + u;
  float acc = 0.0f;
  for (int p = 0; p < d.P + d.S; ++p) {
    const float* g;
    if (p < d.P) {
      if (sm.pi[p] == v) g = sm.gi + p * slab;
      else if (sm.pj[p] == v) g = sm.gj + p * slab;
      else continue;
    } else {
      if (sm.ov[p - d.P] != v) continue;
      g = sm.gob + (p - d.P) * slab;
    }
    const float* vr = vec + p * d.hp;
    int off = off0;
#pragma unroll 4
    for (int k = k0; k < d.hp; ++k) {
      const float gv = g[off];
      acc += vr[k] * (SQ ? gv * gv : gv);
      off += kDev ? d.hu : slab_row_len(d, k);
    }
  }
  return acc;
}

// (G x)[r] for slab row r (< mg), slack column included.
template <bool kDev>
__device__ inline float row_dot(const Smem& sm, const Shape& d,
                                const float* xv, int r) {
  const int blk = r / d.hp, k = r - blk * d.hp;
  const int umax = slab_row_len(d, k);
  const int at = slab_row_off<kDev>(d, k), slab = slab_words<kDev>(d);
  float acc = 0.0f;
  if (blk < d.P) {
    const float* gi = sm.gi + blk * slab + at;
    const float* gj = sm.gj + blk * slab + at;
    const float* xi = xv + sm.pi[blk] * d.hu;
    const float* xj = xv + sm.pj[blk] * d.hu;
    for (int u = 0; u < umax; ++u) acc += gi[u] * xi[u];
    float acc2 = 0.0f;
    for (int u = 0; u < umax; ++u) acc2 += gj[u] * xj[u];
    acc += acc2;
  } else {
    const int o = blk - d.P;
    const float* g = sm.gob + o * slab + at;
    const float* xo = xv + sm.ov[o] * d.hu;
    for (int u = 0; u < umax; ++u) acc += g[u] * xo[u];
  }
  return acc + sm.gsl[r] * xv[d.nu];
}

// sum_r a[r] * b[r] over r < len, four partial sums (a chain of len / 4).
__device__ inline float slack_dot(const float* a, const float* b, int len) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int r = 0;
  for (; r + 4 <= len; r += 4)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += a[r + q] * b[r + q];
  for (; r < len; ++r) s[0] += a[r] * b[r];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The slab product G x / G^T v of scpk::mehrotra_step (the slack column is
// the equilibrated gsl).
template <bool kDev>
struct SlabRows {
  const Smem& sm;
  const Shape& d;
  __device__ float col(const float* v, int c) const {
    if (c < d.nu) return col_accum<false, kDev>(sm, d, v, c);
    return slack_dot(sm.gsl, v, d.mg);
  }
  // A vehicle's columns start a warp (lanes = hu rounded up to 32 slots
  // each), so that a warp's columns walk the same slabs; the slack column
  // takes the last slot.
  __device__ int col_lanes() const { return (d.hu + 31) & ~31; }
  __device__ int col_slots() const { return d.V * col_lanes() + 1; }
  __device__ int col_at(int t) const {
    const int lanes = col_lanes(), v = t / lanes, u = t - v * lanes;
    if (v == d.V) return d.nu;
    return u < d.hu ? v * d.hu + u : -1;
  }
  // a thread per column, in the slot order above
  template <class Epi>
  __device__ void cols(const float* v, Epi epi) const {
    for (int t = threadIdx.x; t < col_slots(); t += blockDim.x) {
      const int c = col_at(t);
      if (c < 0) continue;
      epi(c, col(v, c));
    }
  }
  __device__ float row(const float* x, int r) const {
    return row_dot<kDev>(sm, d, x, r);
  }
};

// The cluster tier's rows: the device tier's slab products, and the
// factor's rows on the cluster's ranks (krow[r]: row r's generic address),
// which the step's solves read through DSMEM.
struct ClusterRows : SlabRows<true> {
  const float* const* krow;
};

// The step's triangular solves in the cluster tier (found for ClusterRows
// by scpk::solve_kkt): chol_blocked_solve_smem on the row pointers.
__device__ inline void kkt_tri_solve(const ClusterRows& g,
                                     const scpk::IpmVecs& v, int n, int,
                                     float* y) {
  scpk::chol_rows_solve<kThreads>(g.krow, n, v.dinv, y);
}

__device__ inline void copy_in(float* dst, const float* src, long count) {
  for (long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// `count` slabs of hp x hu (device memory, whole rows) into their shared
// layout (packed rows with lower_tri), eight loads in flight per thread.
__device__ inline void load_slabs(float* dst, const float* src, int count,
                                  const Shape& d) {
  constexpr int kBatch = 8;
  const int full = d.hp * d.hu, sw = slab_words<false>(d);
  const int total = count * full;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    float v[kBatch];
    int at[kBatch];  // shared-memory index, -1: not stored
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kThreads, p = e / full, r = e - p * full;
      const int k = r / d.hu, u = r - k * d.hu;
      at[i] = (e < total && u < slab_row_len(d, k))
                  ? p * sw + slab_row_off<false>(d, k) + u : -1;
      v[i] = at[i] >= 0 ? src[e] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (at[i] >= 0) dst[at[i]] = v[i];
  }
}

// One row k of tile_slab_product: acc[u][v] += w_k ga[k][r0 + u]
// gb[k][c0 + v], the row's entries from off; with kGuard the entries past
// len count as zero.
template <bool kGuard>
__device__ __forceinline__ void tile_row(float (&acc)[4][4], const float* ga,
                                         const float* gb, float wk, int off,
                                         int len, int r0, int c0) {
  float pa[4], pb[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    pa[u] = (!kGuard || r0 + u < len) ? wk * ga[off + r0 + u] : 0.0f;
    pb[u] = (!kGuard || c0 + u < len) ? gb[off + c0 + u] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] += pa[u] * pb[v];
}

// acc[u][v] += sum_k w[k] ga[k][r0 + u] gb[k][c0 + v] over the rows of one
// slab (ga, gb: the two vehicles' slabs of one pair, or one slab twice);
// entries outside a packed row (u or v past len(k)) count as zero, and
// with lower_tri the rows k < max(r0, c0) are zero throughout. Rows that
// hold the whole tile (from max(r0, c0) + 3 on with lower_tri, every row
// without, for a tile inside the hu columns) go without the guards, two at
// a time, so that their loads are in flight together.
template <bool kDev>
__device__ inline void tile_slab_product(float (&acc)[4][4], const float* ga,
                                         const float* gb, const float* w,
                                         const Shape& d, int r0, int c0) {
  const int k0 = d.lower_tri ? max(r0, c0) : 0;
  const bool inside = r0 + 4 <= d.hu && c0 + 4 <= d.hu;
  const int k1 = !inside ? d.hp
                         : min(d.lower_tri ? k0 + 3 : k0, d.hp);
  int off = slab_row_off<kDev>(d, k0), k = k0;
  for (; k < k1; ++k) {
    const int len = slab_row_len(d, k);
    tile_row<true>(acc, ga, gb, w[k], off, len, r0, c0);
    off += kDev ? d.hu : len;
  }
#pragma unroll 2
  for (; k < d.hp; ++k) {
    const int len = slab_row_len(d, k);
    tile_row<false>(acc, ga, gb, w[k], off, len, r0, c0);
    off += kDev ? d.hu : len;
  }
}

// One 4 x 4 tile (rows r0 .., columns c0 .. of the hu x hu block) of the
// (vr, vc) block (vc <= vr) of the scaled, bordered KKT matrix, lower
// triangle: sum over the slabs that touch both vehicles of (W g_r)^T g_c
// (+ the P block on the diagonal), Jacobi-scaled, minus the rank-1 border
// of the eliminated slack, the regularised unit diagonal.
template <bool kDev>
__device__ inline void form_tile(const Smem& sm, const Shape& d, int vr,
                                 int vc, int r0, int c0, float inv_kappa,
                                 float one_reg) {
  const int slab = slab_words<kDev>(d);
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  if (vr == vc) {
    for (int p = 0; p < d.P; ++p) {
      const float* g;
      if (sm.pi[p] == vr) g = sm.gi + p * slab;
      else if (sm.pj[p] == vr) g = sm.gj + p * slab;
      else continue;
      tile_slab_product<kDev>(acc, g, g, sm.w + p * d.hp, d, r0, c0);
    }
    for (int o = 0; o < d.S; ++o)
      if (sm.ov[o] == vr)
        tile_slab_product<kDev>(acc, sm.gob + o * slab, sm.gob + o * slab,
                                sm.w + (d.P + o) * d.hp, d, r0, c0);
  } else {
    // pairs are (i, j) with i < j: the row vehicle vr is the pair's j
    const int p = sm.pair_of[vc * d.V + vr];
    if (p >= 0)
      tile_slab_product<kDev>(acc, sm.gj + p * slab, sm.gi + p * slab,
                              sm.w + p * d.hp, d, r0, c0);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ar = r0 + u, ac = c0 + v;
      if (ar >= d.hu || ac >= d.hu || (vr == vc && ac > ar)) continue;
      const int r = vr * d.hu + ar, c = vc * d.hu + ac;
      float val = acc[u][v];
      if (vr == vc) val += sm.pb[(vr * d.hu + ar) * d.hu + ac];
      const float border = (inv_kappa * sm.kb[r]) * sm.kb[c];
      sm.K[r * d.ldk + c] =
          (r == c) ? one_reg - border : val * (sm.dsc[r] * sm.dsc[c]) - border;
    }
  }
}

// form_tile with each entry handed to put(r, c, value) (the cluster tier's
// stripes) instead of stored at K[r * ldk + c]; the same sums in the same
// order. (A copy, so that the shared and device tiers compile as before.)
// One 4 x 4 tile (rows r0 .., columns c0 .. of the hu x hu block) of the
// (vr, vc) block (vc <= vr) of the scaled, bordered KKT matrix, lower
// triangle: sum over the slabs that touch both vehicles of (W g_r)^T g_c
// (+ the P block on the diagonal), Jacobi-scaled, minus the rank-1 border
// of the eliminated slack, the regularised unit diagonal.
template <bool kDev, class Put>
__device__ inline void form_tile_put(const Smem& sm, const Shape& d, int vr,
                                     int vc, int r0, int c0, float inv_kappa,
                                     float one_reg, Put put) {
  const int slab = slab_words<kDev>(d);
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  if (vr == vc) {
    for (int p = 0; p < d.P; ++p) {
      const float* g;
      if (sm.pi[p] == vr) g = sm.gi + p * slab;
      else if (sm.pj[p] == vr) g = sm.gj + p * slab;
      else continue;
      tile_slab_product<kDev>(acc, g, g, sm.w + p * d.hp, d, r0, c0);
    }
    for (int o = 0; o < d.S; ++o)
      if (sm.ov[o] == vr)
        tile_slab_product<kDev>(acc, sm.gob + o * slab, sm.gob + o * slab,
                                sm.w + (d.P + o) * d.hp, d, r0, c0);
  } else {
    // pairs are (i, j) with i < j: the row vehicle vr is the pair's j
    const int p = sm.pair_of[vc * d.V + vr];
    if (p >= 0)
      tile_slab_product<kDev>(acc, sm.gj + p * slab, sm.gi + p * slab,
                              sm.w + p * d.hp, d, r0, c0);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ar = r0 + u, ac = c0 + v;
      if (ar >= d.hu || ac >= d.hu || (vr == vc && ac > ar)) continue;
      const int r = vr * d.hu + ar, c = vc * d.hu + ac;
      float val = acc[u][v];
      if (vr == vc) val += sm.pb[(vr * d.hu + ar) * d.hu + ac];
      const float border = (inv_kappa * sm.kb[r]) * sm.kb[c];
      put(r, c,
          (r == c) ? one_reg - border : val * (sm.dsc[r] * sm.dsc[c]) - border);
    }
  }
}

// kDev: the storage tier (see the head of this file); kDev and kGlobal:
// the global tier.
template <bool kDev, bool kGlobal = false>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
ipm_struct_kernel(Args a, Shape d) {
  extern __shared__ float smem_base[];
  const long b = blockIdx.x;
  const Smem sm = carve_tier<kDev, kGlobal>(smem_base, d, a, b);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long slab = (long)d.hp * d.hu;   // in device memory
  const int mg = d.mg, n = d.n, nu = d.nu, m = d.m;
  // the K tiles: tb x tb tiles of 4 x 4 per hu x hu block, the V (V + 1) / 2
  // blocks of the lower triangle (the upper tiles of a diagonal block idle)
  const int tb = (d.hu + 3) >> 2, tiles = tb * tb;
  const int n_tiles = d.V * (d.V + 1) / 2 * tiles;

  SECTION_INIT();
  // ---- load the instance ----
  if (!kDev) {  // (the slab pointers of this tier are shared memory's own)
    load_slabs(const_cast<float*>(sm.gi), a.gi + b * d.P * slab, d.P, d);
    load_slabs(const_cast<float*>(sm.gj), a.gj + b * d.P * slab, d.P, d);
    if (d.S)
      load_slabs(const_cast<float*>(sm.gob), a.gob + b * d.S * slab, d.S, d);
  }
  if (!kGlobal) {  // (the global tier reads them in place)
    copy_in(sm.pb, a.pb + b * d.V * d.hu * d.hu, (long)d.V * d.hu * d.hu);
    copy_in(sm.gsl, a.gsl + b * mg, mg);
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
  for (int i = tid; i < d.V * d.V; i += nt) sm.pair_of[i] = -1;
  for (int p = tid; p < d.P; p += nt) {
    sm.pi[p] = a.pair_idx[2 * p];
    sm.pj[p] = a.pair_idx[2 * p + 1];
  }
  for (int o = tid; o < d.S; o += nt) sm.ov[o] = a.obst_veh[o];
  __syncthreads();
  for (int p = tid; p < d.P; p += nt)
    sm.pair_of[sm.pi[p] * d.V + sm.pj[p]] = p;
  float mu_prev = a.scal[b * 2];
  bool frozen = a.scal[b * 2 + 1] > 0.5f;
  const float inv_kappa = 1.0f / (1.0f + a.reg_rel);
  const float one_reg = 1.0f + a.reg_rel;
  float mu = mu_prev;
  const scpk::IpmDims dims{mg, n, m, nu, d.ldk, true};
  const SlabRows<kDev> rows{sm, d};
  auto mark = [&](int i) { SECTION(i); };
  __syncthreads();
  SECTION(kSecLoad);

  for (int it = 0; it < a.n_iters; ++it) {
    // ---- barrier weights and mu ----
    mu = scpk::weights_and_mu(sm, dims);

    // ---- the border column of the eliminated slack, unscaled ----
    for (int r = tid; r < mg; r += nt) sm.a1[r] = sm.w[r] * sm.gsl[r];
    __syncthreads();
    // ---- P x, analytic KKT diagonal, Jacobi scale ----
    for (int t = tid; t < rows.col_slots(); t += nt) {
      const int c = rows.col_at(t);
      if (c < 0) continue;
      float px, gsq;
      if (c < nu) {
        const int v = c / d.hu, u = c - v * d.hu;
        const float* prow = sm.pb + (v * d.hu + u) * d.hu;
        const float* xb = sm.x + v * d.hu;
        px = 0.0f;
        for (int j = 0; j < d.hu; ++j) px += prow[j] * xb[j];
        gsq = col_accum<true, kDev>(sm, d, sm.w, c);
      } else {
        px = sm.pdiag[c] * sm.x[c];
        gsq = slack_dot(sm.a1, sm.gsl, mg);
      }
      const float dbox = sm.w[mg + c] + sm.w[mg + n + c];
      const float dk = sm.pdiag[c] + gsq + dbox;
      sm.px[c] = px;
      sm.dsc[c] = 1.0f / sqrtf(fmaxf(dk, 1e-30f));
    }
    // ---- scaled border column of the eliminated slack ----
    __syncthreads();
    for (int t = tid; t < rows.col_slots(); t += nt) {
      const int c = rows.col_at(t);
      if (c >= 0 && c < nu)
        sm.kb[c] =
            sm.dsc[c] * col_accum<false, kDev>(sm, d, sm.a1, c) * sm.dsc[nu];
    }
    __syncthreads();
    SECTION(kSecDiag);

    // ---- form the scaled, bordered KKT matrix (lower triangle) ----
    for (int t = tid; t < n_tiles; t += nt) {
      int blk = t / tiles, vr = 0;
      const int ti = (t - blk * tiles) / tb, tj = t - blk * tiles - ti * tb;
      while (blk > vr) blk -= ++vr;   // blk = vr (vr + 1) / 2 + vc
      if (blk == vr && tj > ti) continue;
      form_tile<kDev>(sm, d, vr, blk, 4 * ti, 4 * tj, inv_kappa, one_reg);
    }
    SECTION(kSecForm);
    scpk::factor_kkt<kDev>(sm, dims);
    SECTION(kSecChol);

    scpk::mehrotra_step(rows, sm, dims, mu, mu_prev, frozen, a.n_cor, a.tol,
                        a.tol_stall, inv_kappa, mark);
    SECTION(kSecUpdate);
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

// The cluster tier (see the head of this file): one instance per cluster
// of cl.C CTAs. Rank 0 holds the device tier's carve and runs the step;
// every rank holds stripes of the KKT matrix, forms their tiles and runs
// the factor. The load, the diagonal and border, the formation loop and the
// store are ipm_struct_kernel<true>'s.
__global__ void __launch_bounds__(kThreads, 1)
ipm_struct_cluster_kernel(Args a, Shape d, ClusterArgs cl) {
  extern __shared__ __align__(16) float cl_smem[];
  float* smem_base = cl_smem;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const long b = blockIdx.x / cl.C;
  const int rank = (int)cluster.block_rank();
  const bool lead = rank == 0;
  const Smem sm = carve<true>(smem_base, d, a, b);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int mg = d.mg, n = d.n, nu = d.nu, m = d.m;
  const int tb = (d.hu + 3) >> 2, tiles = tb * tb;
  const int n_tiles = d.V * (d.V + 1) / 2 * tiles;
  // this rank's view of the stripes (after the device tier's carve)
  scpk::Stripes st;
  st.n = nu;
  st.ns = scpk::stripe_count(nu);
  st.rank = rank;
  st.C = (unsigned)cl.C;
  float* fbase = smem_base + cluster_base_word(d);
  st.carve(fbase, cl.area_words);
  int* tab = reinterpret_cast<int*>(
      fbase + scpk::stripe_buffer_words(nu, cl.C, cl.area_words));
  st.owner = tab;
  st.off = tab + st.ns;
  st.dinv = sm.dinv;
  st.bad = sm.bad;
  float** krow = reinterpret_cast<float**>(
      smem_base + cluster_krow_word(d, cl.C, cl.area_words));
  for (int e = tid; e < 2 * st.ns; e += nt) tab[e] = cl.deal[e];

  SECTION_INIT();
  // ---- load the instance: the state on rank 0, the P blocks and the
  // tables (what formation reads) on every rank ----
  copy_in(sm.pb, a.pb + b * d.V * d.hu * d.hu, (long)d.V * d.hu * d.hu);
  if (lead) {
    copy_in(sm.gsl, a.gsl + b * mg, mg);
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
  }
  for (int i = tid; i < d.V * d.V; i += nt) sm.pair_of[i] = -1;
  for (int p = tid; p < d.P; p += nt) {
    sm.pi[p] = a.pair_idx[2 * p];
    sm.pj[p] = a.pair_idx[2 * p + 1];
  }
  for (int o = tid; o < d.S; o += nt) sm.ov[o] = a.obst_veh[o];
  __syncthreads();
  for (int p = tid; p < d.P; p += nt)
    sm.pair_of[sm.pi[p] * d.V + sm.pj[p]] = p;
  if (lead)   // the factor's rows, for rank 0's solves
    for (int r = tid; r < nu; r += nt) {
      const int s = r / scpk::kPanel;
      krow[r] = cluster.map_shared_rank(st.area, st.owner[s]) + st.off[s]
                + (r - s * scpk::kPanel) * scpk::stripe_ld(s);
    }
  float mu_prev = a.scal[b * 2];
  bool frozen = a.scal[b * 2 + 1] > 0.5f;
  const float inv_kappa = 1.0f / (1.0f + a.reg_rel);
  const float one_reg = 1.0f + a.reg_rel;
  float mu = mu_prev;
  const scpk::IpmDims dims{mg, n, m, nu, d.ldk, true};
  const ClusterRows rows{{sm, d}, krow};
  auto mark = [&](int i) { SECTION(i); };
  __syncthreads();
  SECTION(kSecLoad);

  for (int it = 0; it < a.n_iters; ++it) {
    if (lead) {
      // ---- barrier weights and mu ----
      mu = scpk::weights_and_mu(sm, dims);
      // ---- the border column of the eliminated slack, unscaled ----
      for (int r = tid; r < mg; r += nt) sm.a1[r] = sm.w[r] * sm.gsl[r];
      __syncthreads();
      // ---- P x, analytic KKT diagonal, Jacobi scale ----
      for (int t = tid; t < rows.col_slots(); t += nt) {
        const int c = rows.col_at(t);
        if (c < 0) continue;
        float px, gsq;
        if (c < nu) {
          const int v = c / d.hu, u = c - v * d.hu;
          const float* prow = sm.pb + (v * d.hu + u) * d.hu;
          const float* xb = sm.x + v * d.hu;
          px = 0.0f;
          for (int j = 0; j < d.hu; ++j) px += prow[j] * xb[j];
          gsq = col_accum<true, true>(sm, d, sm.w, c);
        } else {
          px = sm.pdiag[c] * sm.x[c];
          gsq = slack_dot(sm.a1, sm.gsl, mg);
        }
        const float dbox = sm.w[mg + c] + sm.w[mg + n + c];
        const float dk = sm.pdiag[c] + gsq + dbox;
        sm.px[c] = px;
        sm.dsc[c] = 1.0f / sqrtf(fmaxf(dk, 1e-30f));
      }
      // ---- scaled border column of the eliminated slack ----
      __syncthreads();
      for (int t = tid; t < rows.col_slots(); t += nt) {
        const int c = rows.col_at(t);
        if (c >= 0 && c < nu)
          sm.kb[c] =
              sm.dsc[c] * col_accum<false, true>(sm, d, sm.a1, c) * sm.dsc[nu];
      }
    }
    // every rank forms its stripes' tiles from rank 0's weights, Jacobi
    // scale and border
    cluster.sync();
    if (!lead) {
      const float* w0 = cluster.map_shared_rank(sm.w, 0);
      const float* dsc0 = cluster.map_shared_rank(sm.dsc, 0);
      const float* kb0 = cluster.map_shared_rank(sm.kb, 0);
      for (int r = tid; r < mg; r += nt) sm.w[r] = w0[r];
      for (int c = tid; c < n; c += nt) sm.dsc[c] = dsc0[c];
      for (int c = tid; c < nu; c += nt) sm.kb[c] = kb0[c];
      __syncthreads();
    }
    SECTION(kSecDiag);

    // ---- form the tiles with a row in this rank's stripes ----
    for (int t = tid; t < n_tiles; t += nt) {
      int blk = t / tiles, vr = 0;
      const int ti = (t - blk * tiles) / tb, tj = t - blk * tiles - ti * tb;
      while (blk > vr) blk -= ++vr;   // blk = vr (vr + 1) / 2 + vc
      if (blk == vr && tj > ti) continue;
      const int r_lo = vr * d.hu + 4 * ti;
      const int r_hi = min(r_lo + 3, vr * d.hu + d.hu - 1);
      if (!st.mine(r_lo / scpk::kPanel) && !st.mine(r_hi / scpk::kPanel))
        continue;
      form_tile_put<true>(sm, d, vr, blk, 4 * ti, 4 * tj, inv_kappa, one_reg,
                          [&](int r, int c, float v) {
                            const int s = r / scpk::kPanel;
                            if (st.mine(s))
                              st.local(s)[(r - s * scpk::kPanel)
                                          * scpk::stripe_ld(s) + c] = v;
                          });
    }
    SECTION(kSecForm);
    // the factor over the cluster (a failed pivot: NaN into dinv[0], as
    // scpk::factor_kkt does)
    const bool failed = scpk::chol_cluster<kThreads>(st);
    if (lead && tid == 0 && failed) sm.dinv[0] = CUDART_NAN_F;
    SECTION(kSecChol);

    if (lead) {
      scpk::mehrotra_step(rows, sm, dims, mu, mu_prev, frozen, a.n_cor,
                          a.tol, a.tol_stall, inv_kappa, mark);
      SECTION(kSecUpdate);
    }
  }
  cluster.sync();   // no rank leaves while rank 0's solves read its stripes

  // ---- write the state back ----
  if (lead) {
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
  SECTION(kSecStore);
}

// Per tier (0: shared, 1: device, 2: cluster, 3: global) and device.
int ipm_struct_smem_granted[4][scpk::kMaxDevices];
int ipm_struct_carveout_set[4][scpk::kMaxDevices];

// Raise `kernel`'s dynamic shared-memory limit to `smem_bytes` and, once per
// device, prefer the largest shared-memory carve-out of the SM's unified L1 /
// shared memory, so that four CTAs of the bench shape fit.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int tier, long smem_bytes) {
  cudaError_t err = scpk::ensure_dyn_smem(
      kernel, ipm_struct_smem_granted[tier], smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= scpk::kMaxDevices) return cudaErrorInvalidDevice;
  if (ipm_struct_carveout_set[tier][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ipm_struct_carveout_set[tier][dev] = 1;
  return err;
}

template <bool kDev, bool kGlobal = false>
int launch_tier(const Args& a, const Shape& d, int B, long smem_bytes,
                cudaStream_t stream) {
  cudaError_t err = prepare(ipm_struct_kernel<kDev, kGlobal>,
                            kGlobal ? 3 : kDev, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ipm_struct_kernel<kDev, kGlobal><<<B, kThreads, smem_bytes, stream>>>(a, d);
  return (int)cudaGetLastError();
}

// The cluster tier's launch: B clusters of C CTAs (grid B x C, the cluster
// along x). `clusters`: how many such clusters the device holds at once
// (cudaOccupancyMaxActiveClusters); with `run` false nothing is launched.
int cluster_launch(const Args& a, const Shape& d, const ClusterArgs& cl,
                   int B, long smem_bytes, cudaStream_t stream, bool run,
                   int* clusters) {
  auto kernel = ipm_struct_cluster_kernel;
  cudaError_t err = prepare(kernel, 2, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * cl.C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (!run) return 0;
  if (*clusters < 1) return -2;
  err = cudaLaunchKernelEx(&cfg, kernel, a, d, cl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` in the storage tier `device_tier` (0: shared memory;
// 1: the KKT matrix in `ws`, B x nu x ldk floats with ldk = nu rounded up to
// a multiple of 32, and the slabs read in place). Returns cudaGetLastError()
// (0 = launched), or -1 when `smem_bytes` disagrees with the tier's own
// carve or `ws_floats` with its workspace (0 and a null `ws` in the shared
// tier).
int ipm_struct_launch(
    const float* gi, const float* gj, const float* gob, const float* gsl,
    const float* pb, const float* q, const float* pdiag,
    const float* x, const float* sg, const float* su, const float* sl,
    const float* zg, const float* zu, const float* zl,
    const float* rpg, const float* rpu, const float* rpl, const float* scal,
    const int* pair_idx, const int* obst_veh,
    float* xo, float* sgo, float* suo, float* slo,
    float* zgo, float* zuo, float* zlo,
    float* rpgo, float* rpuo, float* rplo, float* scalo, float* ws,
    int B, int P, int S, int hp, int hu, int V,
    int n_iters, int n_cor, int lower_tri, int device_tier,
    float tol, float tol_stall, float reg_rel,
    long smem_bytes, long ws_floats, void* stream) {
  const bool dev = device_tier != 0;
  const Shape d = make_shape(P, S, hp, hu, V, lower_tri, dev);
  const long words = dev ? smem_words<true>(d) : smem_words<false>(d);
  const long want_ws = dev ? (long)B * d.nu * d.ldk : 0;
  if (smem_bytes != 4L * words || ws_floats != want_ws
      || (ws != nullptr) != dev)
    return -1;
  Args a;
  a.gi = gi; a.gj = gj; a.gob = gob; a.gsl = gsl; a.pb = pb; a.q = q;
  a.pdiag = pdiag; a.x = x; a.sg = sg; a.su = su; a.sl = sl;
  a.zg = zg; a.zu = zu; a.zl = zl; a.rpg = rpg; a.rpu = rpu; a.rpl = rpl;
  a.scal = scal; a.pair_idx = pair_idx; a.obst_veh = obst_veh;
  a.xo = xo; a.sgo = sgo; a.suo = suo; a.slo = slo;
  a.zgo = zgo; a.zuo = zuo; a.zlo = zlo;
  a.rpgo = rpgo; a.rpuo = rpuo; a.rplo = rplo; a.scalo = scalo; a.ws = ws;
  a.n_iters = n_iters; a.n_cor = n_cor;
  a.tol = tol; a.tol_stall = tol_stall; a.reg_rel = reg_rel;
  const cudaStream_t st = (cudaStream_t)stream;
  return dev ? launch_tier<true>(a, d, B, smem_bytes, st)
             : launch_tier<false>(a, d, B, smem_bytes, st);
}

// Launch on `stream` in the cluster tier: one cluster of C CTAs per
// instance, the KKT matrix in the cluster's stripes dealt by `deal` (2 x
// ceil(nu / 16) ints in device memory: owner ranks, then offsets), each
// rank's stripe area `area_words` floats. The other arguments as
// ipm_struct_launch's. Returns 0 when launched, -1 when `smem_bytes`
// disagrees with the carve, -2 when no cluster of C CTAs of `smem_bytes`
// can be resident (nothing is launched), else a CUDA error.
int ipm_struct_cluster_launch(
    const float* gi, const float* gj, const float* gob, const float* gsl,
    const float* pb, const float* q, const float* pdiag,
    const float* x, const float* sg, const float* su, const float* sl,
    const float* zg, const float* zu, const float* zl,
    const float* rpg, const float* rpu, const float* rpl, const float* scal,
    const int* pair_idx, const int* obst_veh,
    float* xo, float* sgo, float* suo, float* slo,
    float* zgo, float* zuo, float* zlo,
    float* rpgo, float* rpuo, float* rplo, float* scalo, const int* deal,
    int B, int P, int S, int hp, int hu, int V,
    int n_iters, int n_cor, int lower_tri, int C, int area_words,
    float tol, float tol_stall, float reg_rel,
    long smem_bytes, void* stream) {
  const Shape d = make_shape(P, S, hp, hu, V, lower_tri, true);
  if (C < 1 || C > scpk::kClusterMaxRanks || area_words < 0
      || smem_bytes != 4L * cluster_smem_words(d, C, area_words)
      || deal == nullptr)
    return -1;
  Args a;
  a.gi = gi; a.gj = gj; a.gob = gob; a.gsl = gsl; a.pb = pb; a.q = q;
  a.pdiag = pdiag; a.x = x; a.sg = sg; a.su = su; a.sl = sl;
  a.zg = zg; a.zu = zu; a.zl = zl; a.rpg = rpg; a.rpu = rpu; a.rpl = rpl;
  a.scal = scal; a.pair_idx = pair_idx; a.obst_veh = obst_veh;
  a.xo = xo; a.sgo = sgo; a.suo = suo; a.slo = slo;
  a.zgo = zgo; a.zuo = zuo; a.zlo = zlo;
  a.rpgo = rpgo; a.rpuo = rpuo; a.rplo = rplo; a.scalo = scalo;
  a.ws = nullptr;
  a.n_iters = n_iters; a.n_cor = n_cor;
  a.tol = tol; a.tol_stall = tol_stall; a.reg_rel = reg_rel;
  const ClusterArgs cl{deal, C, area_words};
  int clusters = 0;
  return cluster_launch(a, d, cl, B, smem_bytes, (cudaStream_t)stream, true,
                        &clusters);
}

// The cluster tier at a shape: CTAs of its kernel one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into `ctas`, clusters of
// C the device holds at once (cudaOccupancyMaxActiveClusters) into
// `clusters`. Returns a CUDA error code (-1: bad arguments).
int ipm_struct_cluster_occupancy(int P, int S, int hp, int hu, int V,
                                 int lower_tri, int C, int area_words,
                                 int* ctas, int* clusters) {
  const Shape d = make_shape(P, S, hp, hu, V, lower_tri, true);
  if (C < 1 || C > scpk::kClusterMaxRanks || area_words < 0) return -1;
  const long smem_bytes = 4L * cluster_smem_words(d, C, area_words);
  const Args a = {};
  const ClusterArgs cl{nullptr, C, area_words};
  const int err = cluster_launch(a, d, cl, 1, smem_bytes, nullptr, false,
                                 clusters);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ipm_struct_cluster_kernel, kThreads, (size_t)smem_bytes);
}

// CTAs of the tier's kernel that can be resident on one SM at a shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the launch's own
// shared memory and carve-out) into `ctas`. Returns a CUDA error code.
int ipm_struct_occupancy(int P, int S, int hp, int hu, int V, int lower_tri,
                         int device_tier, int* ctas) {
  const bool dev = device_tier != 0;
  const Shape d = make_shape(P, S, hp, hu, V, lower_tri, dev);
  const long smem_bytes = 4L * (dev ? smem_words<true>(d)
                                    : smem_words<false>(d));
  cudaError_t err = dev ? prepare(ipm_struct_kernel<true>, 1, smem_bytes)
                        : prepare(ipm_struct_kernel<false>, 0, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, dev ? ipm_struct_kernel<true> : ipm_struct_kernel<false>,
      kThreads, (size_t)smem_bytes);
}

// Launch on `stream` in the global tier: one CTA an instance, the vectors
// and the KKT matrix in `ws` (B x global_ws_words floats). The other
// arguments as ipm_struct_launch's. Returns 0 when launched, -1 when
// `smem_bytes` or `ws_floats` disagrees with the tier's carve or
// workspace, else a CUDA error.
int ipm_struct_global_launch(
    const float* gi, const float* gj, const float* gob, const float* gsl,
    const float* pb, const float* q, const float* pdiag,
    const float* x, const float* sg, const float* su, const float* sl,
    const float* zg, const float* zu, const float* zl,
    const float* rpg, const float* rpu, const float* rpl, const float* scal,
    const int* pair_idx, const int* obst_veh,
    float* xo, float* sgo, float* suo, float* slo,
    float* zgo, float* zuo, float* zlo,
    float* rpgo, float* rpuo, float* rplo, float* scalo, float* ws,
    int B, int P, int S, int hp, int hu, int V,
    int n_iters, int n_cor, int lower_tri,
    float tol, float tol_stall, float reg_rel,
    long smem_bytes, long ws_floats, void* stream) {
  const Shape d = make_shape(P, S, hp, hu, V, lower_tri, true);
  if (ws == nullptr || ws_floats != (long)B * global_ws_words(d)
      || smem_bytes != 4L * global_smem_words(d))
    return -1;
  Args a;
  a.gi = gi; a.gj = gj; a.gob = gob; a.gsl = gsl; a.pb = pb; a.q = q;
  a.pdiag = pdiag; a.x = x; a.sg = sg; a.su = su; a.sl = sl;
  a.zg = zg; a.zu = zu; a.zl = zl; a.rpg = rpg; a.rpu = rpu; a.rpl = rpl;
  a.scal = scal; a.pair_idx = pair_idx; a.obst_veh = obst_veh;
  a.xo = xo; a.suo = suo; a.slo = slo; a.sgo = sgo;
  a.zgo = zgo; a.zuo = zuo; a.zlo = zlo;
  a.rpgo = rpgo; a.rpuo = rpuo; a.rplo = rplo; a.scalo = scalo; a.ws = ws;
  a.n_iters = n_iters; a.n_cor = n_cor;
  a.tol = tol; a.tol_stall = tol_stall; a.reg_rel = reg_rel;
  return launch_tier<true, true>(a, d, B, smem_bytes, (cudaStream_t)stream);
}

// CTAs of the global tier's kernel that can be resident on one SM at a
// shape, into `ctas`. Returns a CUDA error code.
int ipm_struct_global_occupancy(int P, int S, int hp, int hu, int V,
                                int lower_tri, int* ctas) {
  const Shape d = make_shape(P, S, hp, hu, V, lower_tri, true);
  const long smem_bytes = 4L * global_smem_words(d);
  const cudaError_t err =
      prepare(ipm_struct_kernel<true, true>, 3, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ipm_struct_kernel<true, true>, kThreads, (size_t)smem_bytes);
}

#ifdef SCP_PROFILE_SECTIONS
// Copy block 0's per-section cycle sums to `out` (kSecCount entries, in the
// order of the enum above) and clear them. Synchronises the device.
int ipm_struct_read_sections(unsigned long long* out) {
  unsigned long long zero[16] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(
      out, g_section_cycles, kSecCount * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_section_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
