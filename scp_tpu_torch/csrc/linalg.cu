// Stand-alone batched dense kernels of the adaptive and per-instance IPM
// paths, on instance-major float32 tensors:
//
//   chol_blocked_kernel       K (B,n,n) -> L (B,n,n), lower Cholesky factor
//   cho_solve_batched_kernel  L (B,n,n), b (B,n) -> x (B,n), (L L^T) x = b
//   gmv_staged_kernel         G (B,m,n), x (B,n) -> out (B,m), out_b = G_b x_b
//   gtmv_cluster_kernel       G (B,m,n), v (B,m) -> out (B,n),
//                             out_b = G_b^T v_b
//   chol_cluster_kernel       the factor for n >= 240 while a thread
//                             block cluster's shared memory holds the matrix
//   chol_large_kernel, cho_solve_large_kernel: the factor past that and the
//                             solve for n >= 240, the matrix in device memory
//
// They replace, in scp_tpu/ops/pallas_linalg.py: cholesky_lane and
// _batched_cholesky_impl (_cholesky_panel_kernel), cho_solve_lane and
// _batched_cho_solve_impl (_cho_solve_kernel), gmv_lane (_gmv_kernel) and
// gtmv_lane (_gtmv_kernel). The TPU kernels put the batch on the lane axis
// and unroll 8-row panels; here one instance is one CTA's work and every
// size is a runtime argument, so nothing is padded.
//
// What bounds them on an H100: all four move more bytes than they do
// arithmetic for (a factor reads and writes n^2 floats for n^3/3
// multiply-adds, a matvec reads m*n floats for m*n multiply-adds), so on
// paper device memory is the limit.
//
// K3, the factor: a column-by-column factor in shared memory is a chain of
// n block barriers with three shared-memory accesses per multiply-add; at
// B = 1024 and n = 81 that instruction rate, not device memory, bounded it,
// and at small B one instance's barrier chain did. The blocked factor of
// chol_blocked.cuh takes two barriers per panel of 16 columns and ~0.6
// shared-memory accesses per multiply-add (register tiles of the rank-16
// trailing update), and factors each diagonal block while the trailing
// update runs; what bounds it now is the chain of n pivots (a shuffle, a
// square root and its reciprocal, a shuffle each) on one warp. Only the
// lower triangle of K is read.
//
// K4, the solve: a column-by-column substitution on one warp was a chain
// of 2n dependent steps (~380 cycles each at n = 81 with its warp
// barriers), whatever the batch. The blocked solve of chol_blocked.cuh
// (16-entry blocks, each solved in registers with a shuffle per entry, one
// block barrier per block) shortens the chain to 2 ceil(n / 16) blocks of
// 16 steps of a multiply, a shuffle and an FMA. Only the lower triangle of
// L is staged, with several loads in flight per thread, and 1 / L_jj is
// taken from its diagonal.
//
// K5a, G x: the row-per-warp kernel it replaced read each unaligned
// 324-byte row in three passes of scalar loads and re-read x for every
// row, and ran 1.3x slower than torch.bmm. Here a CTA stages a tile of
// rows - the instance's contiguous m*n block, or a run of whole rows of it -
// into shared memory with ONE bulk asynchronous copy (cp.async.bulk on an
// mbarrier) over the 16-byte-aligned span and scalar loads for the at most
// three floats before and after it (an instance base is 4-byte aligned:
// alignment is decided from the address, never assumed), stages x once,
// and computes the dot products from shared memory, four rows per warp,
// writing out coalesced. A row wider than a stage is staged a run of
// columns at a time, so one kernel takes every (m, n). Tiles are sized so
// that the grid has enough CTAs to keep copies in flight on every SM
// (ops/linalg_kernel.py::gmv_geometry); a CTA that double-buffered
// several tiles measured slower than a CTA per tile. The device-memory
// traffic is G, x and out once each (x once per tile, from L2): the
// bound's count.
//
// K5b, G^T v: the CTA-per-instance kernel it replaced (a thread per column,
// 32-wide column strips, an 8-way shared-memory reduction per strip) kept
// one 4-byte load in flight per thread, idled 15 of 32 lanes in the last
// strip at n = 81 and ran 1.16x slower than torch.bmm with a cold L2 at
// B = 1024. Here it is K5a's transpose: an instance's rows are cut into
// `tiles` row ranges (at most 8), one CTA each, and each CTA stages its
// rows a chunk at a time with ONE bulk copy per chunk (whole rows: the
// chunk is one contiguous span of G; a row wider than a stage in runs of
// columns, as K5a) through a ring of two stages, the next chunk's copy in
// flight while this one is summed. The CTA's threads form `groups` =
// 256 / cols row groups, so that no lane idles at n = 81 (three groups of
// 81 columns); thread (g, c) sums rows g, g + groups, ... of column c from
// shared memory (row-major, conflict-free) into its own partial. An instance's
// CTAs are one thread block cluster: after a cluster barrier each column
// is summed over the CTAs' partials in rank order through distributed
// shared memory (a column per thread, the columns dealt over the
// cluster's CTAs), so the sum's order is fixed and the result is
// bit-identical run to run (no atomics, no second launch). The kernel is
// bound by latency, not by bytes: each chunk a CTA waits on, and a second
// wave of CTAs, costs about a copy's latency, so the geometry
// (ops/linalg_kernel.py::gtmv_geometry) keeps the grid to one wave and a
// CTA's rows in as few chunks as that allows.
//
// K3 for n >= 240 (chol_cluster_kernel): one instance's n x n matrix no
// longer fits a block's shared memory, so it is spread over the shared
// memory of a thread block cluster of C <= 8 CTAs on neighbouring SMs
// (chol_cluster.cuh): 16-row stripes of the lower triangle dealt over the
// ranks, each rank solving its stripes' panel rows and updating their
// tiles from a local copy of the panel, the panels and diagonal blocks
// passed between ranks by st.async stores that the receivers' mbarriers
// count. The wrapper (ops/linalg_kernel.py::chol_cluster_geometry) takes
// the smallest C that holds the stripes (1 at n = 257, 2 at n = 400) and
// raises it while B x C is below the card's SMs, so one instance at B = 1
// spreads over 8 SMs. One CTA of 256 threads on one SM walking a matrix in
// device memory (chol_large_kernel) left 131 SMs idle at B = 1 and took
// every panel operand through L1 / L2 (8 loads per 16 FMAs a register
// tile); here every operand is in shared memory (2 loads per 16 FMAs), and
// what bounds it at B = 1 is a panel's chain on the next diagonal block's
// owner: that block's update, its 16 pivots and the push to every rank
// (~3 us a panel on an H100, PERF.md). The factor is bit for bit
// chol_large_kernel's.
//
// K3 past a cluster's capacity and K4 for n >= 240 (chol_large_kernel,
// cho_solve_large_kernel): one CTA per instance; the factor works in
// place in its output L in device memory (the lower triangle of K copied
// in first, zeros above), through the same blocked factor of
// chol_blocked.cuh at leading dimension n: the panel rows, the diagonal
// blocks and the trailing tiles are read and written through the L1 / L2
// caches, and only 1 / diag and the flag stay in shared memory. The solve
// reads L from device memory the same way, with 1 / diag and the
// right-hand side in shared memory. None of them changes the
// shared-memory kernels above, which every n < 240 still takes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

// Built with -DSCP_PROFILE_SECTIONS (scripts/torch_kernel_check.py
// --sections) the factor kernels add up, for block 0, the clock cycles
// between section marks (CHOL_SECTION in chol_blocked.cuh); without it the
// marks compile to nothing.
#ifdef SCP_PROFILE_SECTIONS
__device__ unsigned long long g_chol_cycles[8];
__device__ long long g_chol_t0;  // block 0, thread 0 only
#define CHOL_SECTION_INIT()                                \
  do {                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0)               \
      g_chol_t0 = clock64();                               \
  } while (0)
#define CHOL_SECTION(i)                                    \
  do {                                                     \
    __syncthreads();                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) {             \
      const long long chol_t1 = clock64();                 \
      g_chol_cycles[i] += chol_t1 - g_chol_t0;             \
      g_chol_t0 = chol_t1;                                 \
    }                                                      \
  } while (0)
#endif

// Built with -DSCP_CLUSTER_TRACE (scripts/torch_kernel_check.py --sections
// k3trace) thread 0 of each rank of instance 0 of the cluster factor stores
// the global timer (ns) at six points of each panel (CHOL_TRACE in
// chol_cluster.cuh): the diagonal block taken, its panel rows solved, pushed,
// the other ranks' received, the next block factored (its owner only) and
// the trailing update done.
#ifdef SCP_CLUSTER_TRACE
constexpr int kTracePanels = 64, kTracePoints = 6;
__device__ unsigned long long g_cl_trace[8 * kTracePanels * kTracePoints];
#define CHOL_TRACE(p, i)                                                  \
  do {                                                                    \
    if (blockIdx.x < st.C && threadIdx.x == 0 && (p) < kTracePanels) {    \
      unsigned long long chol_now;                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(chol_now));        \
      g_cl_trace[(st.rank * kTracePanels + (p)) * kTracePoints + (i)] =   \
          chol_now;                                                       \
    }                                                                     \
  } while (0)
#endif

#include "chol_blocked.cuh"
#include "chol_cluster.cuh"
#include "smem.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGmvThreads = 128;
constexpr int kGtmvThreads = 256;
constexpr int kGtmvMaxCluster = 8;  // the portable cluster size
constexpr int kLargeThreads = 256;

__host__ __device__ inline int odd_ld(int n) { return n | 1; }

// Stage the lower triangle of the n x n instance matrix M (row-major, in
// device memory) into shared memory S (leading dimension ld), eight loads in
// flight per thread before any store. With `dinv`, also 1 / M_jj.
template <int NT>
__device__ inline void stage_lower(const float* __restrict__ M, float* S,
                                   int n, int ld, float* dinv) {
  constexpr int kBatch = 8;
  for (int e0 = threadIdx.x; e0 < n * n; e0 += kBatch * NT) {
    float v[kBatch];
    int at[kBatch];  // shared-memory index, -1: not loaded
    int dg[kBatch];  // the diagonal's row, -1: off the diagonal
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * NT, r = e / n, c = e - r * n;
      at[u] = (e < n * n && c <= r) ? r * ld + c : -1;
      dg[u] = (e < n * n && c == r) ? r : -1;
      v[u] = at[u] >= 0 ? M[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) S[at[u]] = v[u];
      if (dinv && dg[u] >= 0) dinv[dg[u]] = 1.0f / v[u];
    }
  }
}

// One CTA per instance. Shared memory: the matrix (n x ld), 1 / diag (n),
// and a flag. The factor's upper triangle is written as zeros; an instance
// with a non-positive (or NaN) pivot is written as NaN throughout.
template <int NT>
__global__ void __launch_bounds__(NT, 2048 / NT / 2)
chol_blocked_kernel(const float* __restrict__ K, float* __restrict__ L,
                    int n) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* A = smem;
  float* dinv = A + n * ld;
  int* bad = reinterpret_cast<int*>(dinv + n);
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n * n;
  CHOL_SECTION_INIT();
  if (tid == 0) *bad = 0;
  stage_lower<NT>(K + base, A, n, ld, nullptr);
  CHOL_SECTION(0);
  scpk::chol_blocked_smem<NT>(A, n, ld, dinv, bad);
  const bool poisoned = *bad != 0;
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e - r * n;
    L[base + e] = poisoned ? CUDART_NAN_F : (c <= r ? A[r * ld + c] : 0.0f);
  }
  CHOL_SECTION(4);
}

// One CTA per instance. Shared memory: the factor's lower triangle (n x ld),
// 1 / diag (n) and the right-hand side (n). A NaN factor (K3's output for an
// indefinite instance) gives a NaN solution for that instance only.
template <int NT>
__global__ void __launch_bounds__(NT, 2048 / NT / 2)
cho_solve_batched_kernel(const float* __restrict__ L,
                         const float* __restrict__ b, float* __restrict__ x,
                         int n) {
  extern __shared__ float smem[];
  const int ld = odd_ld(n);
  float* Ls = smem;
  float* dinv = Ls + n * ld;
  float* y = dinv + n;
  const int tid = threadIdx.x;
  stage_lower<NT>(L + (size_t)blockIdx.x * n * n, Ls, n, ld, dinv);
  for (int i = tid; i < n; i += NT) y[i] = b[(size_t)blockIdx.x * n + i];
  scpk::chol_blocked_solve_smem<NT>(Ls, n, ld, dinv, y);
  for (int i = tid; i < n; i += NT) x[(size_t)blockIdx.x * n + i] = y[i];
}

// ---- K5a: bulk copies into shared memory on an mbarrier ----
__device__ inline unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The floats src[0 .. len) go to dst[pad + e], pad = (src / 4) % 4, so that
// dst and src agree modulo 16 bytes (dst is 16-byte aligned). The aligned
// span [b0, b1) of the source is ONE bulk copy that completes on `bar`
// (thread 0 calls; it is also the barrier's one arrival, with the byte
// count it awaits); stage_edges loads the rest.
struct Span {
  uintptr_t a0, b0, b1;
  int pad;
  __device__ Span(const float* src, int len) {
    a0 = (uintptr_t)src;
    b0 = (a0 + 15) & ~(uintptr_t)15;
    b1 = (a0 + 4 * (uintptr_t)len) & ~(uintptr_t)15;
    if (b1 < b0) b1 = b0;
    pad = (int)((a0 >> 2) & 3);
  }
  __device__ int head() const { return (int)((b0 - a0) >> 2); }
  __device__ int tail() const { return (int)((b1 - a0) >> 2); }
};

__device__ inline void stage_copy(const float* src, int len, float* dst,
                                  uint64_t* bar) {
  const Span sp(src, len);
  const unsigned bytes = (unsigned)(sp.b1 - sp.b0);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst + sp.pad + sp.head())), "l"(sp.b0), "r"(bytes),
           "r"(smem_addr(bar)) : "memory");
}

__device__ inline void stage_edges(const float* src, int len, float* dst) {
  const Span sp(src, len);
  const bool span = sp.b1 > sp.b0;
  const int h = span ? sp.head() : len, t = span ? sp.tail() : len;
  for (int e = threadIdx.x; e < h; e += blockDim.x) dst[sp.pad + e] = src[e];
  for (int e = t + threadIdx.x; e < len; e += blockDim.x)
    dst[sp.pad + e] = src[e];
}

// One CTA per row tile (`rows_per_tile` rows) of one instance; `tiles`
// CTAs cover an instance. The tile is staged `cols` columns at a time:
// cols = n (whole rows, one stage) unless a row is wider than a stage, and
// then the tile is one row and the stage and its barrier are reused, phase
// by phase. Shared memory: the mbarrier (16 bytes), the stage
// (`buf_floats`, a multiple of 4, at least rows_per_tile * cols + 3), x's
// columns (cols) and the tile's results. Thread 0 starts each copy first,
// so that x's loads and the edges overlap it.
__global__ void __launch_bounds__(kGmvThreads)
gmv_staged_kernel(const float* __restrict__ G, const float* __restrict__ x,
                  float* __restrict__ out, int m, int n, int rows_per_tile,
                  int cols, int tiles, int buf_floats) {
  extern __shared__ __align__(16) unsigned char gmv_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(gmv_smem);
  float* buf = reinterpret_cast<float*>(gmv_smem + 16);
  float* xs = buf + buf_floats;
  float* ys = xs + cols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kGmvThreads / 32;
  const long long inst = blockIdx.x / tiles;
  const int t = (int)(blockIdx.x - inst * tiles);
  const int r_first = t * rows_per_tile;
  const int rows = min(m, r_first + rows_per_tile) - r_first;
  const float* tile = G + ((size_t)inst * m + r_first) * n;
  for (int r = tid; r < rows; r += kGmvThreads) ys[r] = 0.0f;
  if (tid == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c0 = 0, phase = 0; c0 < n; c0 += cols, phase ^= 1) {
    const int w = min(cols, n - c0), len = rows * w;  // rows = 1 if w < n
    const float* src = tile + c0;
    if (tid == 0) stage_copy(src, len, buf, bar);
    for (int c = tid; c < w; c += kGmvThreads)
      xs[c] = x[(size_t)inst * n + c0 + c];
    stage_edges(src, len, buf);
    __syncthreads();
    mbar_wait(bar, phase);
    const float* tb = buf + ((uintptr_t)src >> 2 & 3);
    for (int r0 = warp * 4; r0 < rows; r0 += kWarps * 4) {
      const int nr = min(4, rows - r0);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = lane; c < w; c += 32) {
        const float xv = xs[c];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nr) acc[u] += tb[(r0 + u) * w + c] * xv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      float v = acc[0];
#pragma unroll
      for (int u = 1; u < 4; ++u)
        if (lane == u) v = acc[u];
      if (lane < nr) ys[r0 + lane] += v;
    }
    // the stage's next copy (async proxy) follows this one's generic
    // reads and edge stores
    if (c0 + cols < n)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  for (int r = tid; r < rows; r += kGmvThreads)
    out[(size_t)inst * m + r_first + r] = ys[r];
}

// One CTA per row range (`rows` rows) of one instance; the `tiles` CTAs of
// an instance are one cluster (grid = B * tiles, cluster = tiles along x,
// so a CTA's rank is blockIdx.x % tiles). The range is staged `chunk` rows
// at a time (whole rows: cols = n), or, for a row wider than a stage, a
// row at a time in runs of `cols` columns, through a ring of two stages:
// the next chunk's copy is in flight while this one is summed. Shared
// memory: two mbarriers (16 bytes), two stages (`buf_floats` each, at
// least chunk * cols + 3), two chunks of v entries and the partial sums
// (groups * cols, groups = 256 / cols or 1). Thread 0 starts each copy
// first, so that v's loads and the edges overlap it.
__global__ void __launch_bounds__(kGtmvThreads)
gtmv_cluster_kernel(const float* __restrict__ G, const float* __restrict__ v,
                    float* __restrict__ out, int m, int n, int rows,
                    int chunk, int cols, int tiles, int buf_floats) {
  extern __shared__ __align__(16) unsigned char gtmv_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(gtmv_smem);
  float* buf = reinterpret_cast<float*>(gtmv_smem + 16);
  float* vs = buf + 2 * buf_floats;
  float* part = vs + 2 * chunk;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const long long inst = blockIdx.x / tiles;
  const int rank = (int)(blockIdx.x - inst * tiles);
  const int r_first = rank * rows;
  const int my_rows = min(m, r_first + rows) - r_first;
  const int n_chunks = (my_rows + chunk - 1) / chunk;
  const float* g0 = G + ((size_t)inst * m + r_first) * n;
  const float* v0 = v + (size_t)inst * m + r_first;
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  unsigned q = 0;  // stages issued before this run of columns
  for (int c0 = 0; c0 < n; c0 += cols) {
    const int w = min(cols, n - c0);
    const int groups = max(1, kGtmvThreads / w);
    const int gw = kGtmvThreads / groups;   // threads of a row group
    const int g = tid / gw, j = tid - g * gw;
    for (int e = tid; e < groups * w; e += kGtmvThreads) part[e] = 0.0f;
    // chunk k of this run goes to stage (q + k) & 1, that stage's
    // ((q + k) >> 1)-th use
    auto issue = [&](int k) {
      const int s = (q + k) & 1, r0 = k * chunk;
      const int nr = min(chunk, my_rows - r0);
      const float* src = g0 + (size_t)r0 * n + c0;
      float* dst = buf + s * buf_floats;
      if (tid == 0) stage_copy(src, nr * w, dst, bar + s);  // nr = 1 if
      for (int r = tid; r < nr; r += kGtmvThreads)                    // w < n
        vs[s * chunk + r] = v0[r0 + r];
      stage_edges(src, nr * w, dst);
    };
    issue(0);
    for (int k = 0; k < n_chunks; ++k) {
      if (k + 1 < n_chunks) issue(k + 1);  // its stage was freed below
      __syncthreads();
      const int s = (q + k) & 1, nr = min(chunk, my_rows - k * chunk);
      mbar_wait(bar + s, ((q + k) >> 1) & 1);
      const float* src = g0 + (size_t)k * chunk * n + c0;
      const float* tb = buf + s * buf_floats + ((uintptr_t)src >> 2 & 3);
      const float* vk = vs + s * chunk;
      if (g < groups)
        for (int c = j; c < w; c += gw) {
          float acc = 0.0f;
          for (int r = g; r < nr; r += groups) acc += tb[r * w + c] * vk[r];
          part[g * w + c] += acc;
        }
      // the stage's next copy (async proxy) follows this one's generic
      // reads and edge stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    q += n_chunks;
    // the row groups' partials, in group order
    for (int c = tid; c < w; c += kGtmvThreads) {
      float s = part[c];
      for (int k = 1; k < groups; ++k) s += part[k * w + c];
      part[c] = s;
    }
    cluster.sync();
    // each column over the cluster's CTAs, in rank order
    for (int c = rank * kGtmvThreads + tid; c < w; c += tiles * kGtmvThreads) {
      float s = 0.0f;
      for (int k = 0; k < tiles; ++k)
        s += cluster.map_shared_rank(part, k)[c];
      out[(size_t)inst * n + c0 + c] = s;
    }
    cluster.sync();  // no CTA reuses or leaves its partials before they
  }                  // are read
}

// K3 for n >= 240: one CTA per instance, the factor in place in L (device
// memory, leading dimension n). Shared memory: 1 / diag (n) and the flag.
template <int NT>
__global__ void __launch_bounds__(NT, 2048 / NT / 2)
chol_large_kernel(const float* __restrict__ K, float* __restrict__ L,
                  int n) {
  extern __shared__ float smem[];
  float* dinv = smem;
  int* bad = reinterpret_cast<int*>(dinv + n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;
  float* A = L + base;
  const float* Kb = K + base;
  CHOL_SECTION_INIT();
  if (tid == 0) *bad = 0;
  for (int r = warp; r < n; r += NT / 32)   // a row per warp
    for (int c = lane; c < n; c += 32)
      A[r * n + c] = c <= r ? Kb[r * n + c] : 0.0f;
  CHOL_SECTION(0);
  scpk::chol_blocked_smem<NT>(A, n, n, dinv, bad);
  if (*bad != 0)
    for (int r = warp; r < n; r += NT / 32)
      for (int c = lane; c < n; c += 32) A[r * n + c] = CUDART_NAN_F;
  CHOL_SECTION(4);
}

// K3 from n = 240 while a cluster holds the matrix: one cluster of C CTAs
// per instance (grid = B * C, cluster = C along x), the lower triangle in
// the cluster's stripes (chol_cluster.cuh). Shared memory on every rank:
// the factor's buffers (scpk::stripe_buffer_words: the diagonal-block
// buffers, the mbarriers, this rank's stripe area of `area_words`, the
// panel buffers), 1 / diag (n), the deal (owner and offset per stripe) and
// the flag. Each rank loads and stores its own stripes' rows; the factor's
// upper triangle is written as zeros, an instance with a failed pivot on
// any rank as NaN throughout. NT threads a CTA.
template <int NT>
__global__ void __launch_bounds__(NT, 1)
chol_cluster_kernel(const float* __restrict__ K, float* __restrict__ L,
                    const int* __restrict__ deal, int n, int C,
                    int area_words) {
  extern __shared__ __align__(16) float cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, ns = scpk::stripe_count(n);
  scpk::Stripes st;
  st.n = n;
  st.ns = ns;
  st.rank = (int)cluster.block_rank();
  st.C = (unsigned)C;
  st.carve(cl_smem, area_words);
  st.dinv = cl_smem + scpk::stripe_buffer_words(n, C, area_words);
  int* tab = reinterpret_cast<int*>(st.dinv + n);
  st.owner = tab;
  st.off = tab + ns;
  st.bad = tab + 2 * ns;
  const size_t base = (size_t)(blockIdx.x / C) * n * n;
  CHOL_SECTION_INIT();
  for (int e = tid; e < 2 * ns; e += NT) tab[e] = deal[e];
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    if (!st.mine(s)) continue;
    const int ld = scpk::stripe_ld(s), w = min(n, ld - 1);
    const int rows = scpk::stripe_rows(n, s);
    float* S = st.local(s);
    const float* src = K + base + (size_t)s * scpk::kPanel * n;
    for (int e = tid; e < rows * w; e += NT) {
      const int r = e / w, c = e - r * w;
      if (c <= s * scpk::kPanel + r) S[r * ld + c] = src[(size_t)r * n + c];
    }
  }
  const bool poisoned = scpk::chol_cluster<NT>(st);
  for (int s = 0; s < ns; ++s) {
    if (!st.mine(s)) continue;
    const int ld = scpk::stripe_ld(s), rows = scpk::stripe_rows(n, s);
    const float* S = st.local(s);
    float* dst = L + base + (size_t)s * scpk::kPanel * n;
    for (int e = tid; e < rows * n; e += NT) {
      const int r = e / n, c = e - r * n;
      dst[e] = poisoned ? CUDART_NAN_F
                        : (c <= s * scpk::kPanel + r ? S[r * ld + c] : 0.0f);
    }
  }
  CHOL_SECTION(4);
}

// K4 for n >= 240: one CTA per instance, L read from device memory.
// Shared memory: 1 / diag (n) and the right-hand side (n).
template <int NT>
__global__ void __launch_bounds__(NT, 2048 / NT / 2)
cho_solve_large_kernel(const float* __restrict__ L,
                       const float* __restrict__ b, float* __restrict__ x,
                       int n) {
  extern __shared__ float smem[];
  float* dinv = smem;
  float* y = dinv + n;
  const int tid = threadIdx.x;
  const float* A = L + (size_t)blockIdx.x * n * n;
  for (int i = tid; i < n; i += NT) {
    dinv[i] = 1.0f / A[(size_t)i * n + i];
    y[i] = b[(size_t)blockIdx.x * n + i];
  }
  scpk::chol_blocked_solve_smem<NT>(A, n, n, dinv, y);
  for (int i = tid; i < n; i += NT) x[(size_t)blockIdx.x * n + i] = y[i];
}

int gmv_smem_granted[scpk::kMaxDevices];

template <int NT>
cudaError_t launch_blocked(const float* K, float* L, int B, int n,
                           long smem_bytes, cudaStream_t stream) {
  static int granted[scpk::kMaxDevices];
  cudaError_t err = scpk::ensure_dyn_smem(chol_blocked_kernel<NT>, granted,
                                          smem_bytes);
  if (err != cudaSuccess) return err;
  chol_blocked_kernel<NT><<<B, NT, smem_bytes, stream>>>(K, L, n);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_solve(const float* L, const float* b, float* x, int B,
                         int n, long smem_bytes, cudaStream_t stream) {
  static int granted[scpk::kMaxDevices];
  cudaError_t err = scpk::ensure_dyn_smem(cho_solve_batched_kernel<NT>,
                                          granted, smem_bytes);
  if (err != cudaSuccess) return err;
  cho_solve_batched_kernel<NT><<<B, NT, smem_bytes, stream>>>(L, b, x, n);
  return cudaGetLastError();
}

// The cluster factor's launch: B clusters of C CTAs (grid B x C, the
// cluster along x). Returns -2 when no cluster of C CTAs with
// `smem_bytes` each can be resident on the device (nothing is launched).
int cluster_factor_launch(const float* K, float* L, const int* deal, int B,
                          int n, int C, int area_words, long smem_bytes,
                          cudaStream_t stream) {
  static int granted[scpk::kMaxDevices];
  auto kernel = chol_cluster_kernel<kLargeThreads>;
  cudaError_t err = scpk::ensure_dyn_smem(kernel, granted, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(kLargeThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -2;
  err = cudaLaunchKernelEx(&cfg, kernel, K, L, deal, n, C, area_words);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError()
// (0 = launched), or -1 when the geometry (threads, tile sizes,
// shared-memory bytes) disagrees with the kernel's carve.

// K3: chol_blocked_kernel, one instance per CTA, threads 128 or 256.
int chol_batched_launch(const float* K, float* L, int B, int n, int threads,
                        long smem_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem_bytes != (long)sizeof(float) * ((long)n * odd_ld(n) + n + 1))
    return -1;
  if (threads == 128)
    return (int)launch_blocked<128>(K, L, B, n, smem_bytes, st);
  if (threads == 256)
    return (int)launch_blocked<256>(K, L, B, n, smem_bytes, st);
  return -1;
}

// K4: cho_solve_batched_kernel, one instance per CTA, threads 128 or 256.
int cho_solve_batched_launch(const float* L, const float* b, float* x, int B,
                             int n, int threads, long smem_bytes,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem_bytes != (long)sizeof(float) * ((long)n * odd_ld(n) + 2 * n))
    return -1;
  if (threads == 128)
    return (int)launch_solve<128>(L, b, x, B, n, smem_bytes, st);
  if (threads == 256)
    return (int)launch_solve<256>(L, b, x, B, n, smem_bytes, st);
  return -1;
}

// K5a: gmv_staged_kernel, tiles of `rows_per_tile` rows staged `cols`
// columns at a time (cols = n, or one row in runs of cols < n columns).
int gmv_batched_launch(const float* G, const float* x, float* out, int B,
                       int m, int n, int rows_per_tile, int cols,
                       long smem_bytes, void* stream) {
  if (rows_per_tile < 1 || rows_per_tile > m || cols < 1 || cols > n
      || (cols < n && rows_per_tile != 1))
    return -1;
  const int tiles = (m + rows_per_tile - 1) / rows_per_tile;
  const long buf_floats = ((long)rows_per_tile * cols + 3 + 3) / 4 * 4;
  if (smem_bytes != 16 + (long)sizeof(float) * (buf_floats + cols
                                                 + rows_per_tile))
    return -1;
  const long long grid = (long long)B * tiles;
  if (grid > 0x7fffffffLL) return -1;
  cudaError_t err = scpk::ensure_dyn_smem(gmv_staged_kernel,
                                          gmv_smem_granted, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  gmv_staged_kernel<<<(unsigned)grid, kGmvThreads, smem_bytes,
                      (cudaStream_t)stream>>>(G, x, out, m, n, rows_per_tile,
                                              cols, tiles, (int)buf_floats);
  return (int)cudaGetLastError();
}

// K5b: gtmv_cluster_kernel, `tiles` CTAs (one cluster) per instance, each
// `rows` rows staged `chunk` rows (cols = n) or one row of `cols` columns
// (cols < n) at a time.
int gtmv_batched_launch(const float* G, const float* v, float* out, int B,
                        int m, int n, int tiles, int rows, int chunk,
                        int cols, long smem_bytes, void* stream) {
  if (tiles < 1 || tiles > kGtmvMaxCluster || rows < 1
      || (long)tiles * rows < m || (long)(tiles - 1) * rows >= m
      || chunk < 1 || chunk > rows || cols < 1 || cols > n
      || (cols < n && chunk != 1))
    return -1;
  const long buf_floats = ((long)chunk * cols + 3 + 3) / 4 * 4;
  const long groups = cols < kGtmvThreads ? kGtmvThreads / cols : 1;
  if (smem_bytes != 16 + (long)sizeof(float) * (2 * buf_floats + 2 * chunk
                                                 + groups * cols))
    return -1;
  const long long grid = (long long)B * tiles;
  if (grid > 0x7fffffffLL) return -1;
  static int granted[scpk::kMaxDevices];
  cudaError_t err = scpk::ensure_dyn_smem(gtmv_cluster_kernel, granted,
                                          smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kGtmvThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gtmv_cluster_kernel, G, v, out, m, n, rows,
                           chunk, cols, tiles, (int)buf_floats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3 for n >= 240: chol_large_kernel, one instance per CTA.
int chol_large_launch(const float* K, float* L, int B, int n, int threads,
                      long smem_bytes, void* stream) {
  if (threads != kLargeThreads
      || smem_bytes != (long)sizeof(float) * (n + 1)
      || (long long)n * n > 0x7fffffffLL)
    return -1;
  static int granted[scpk::kMaxDevices];
  cudaError_t err = scpk::ensure_dyn_smem(chol_large_kernel<kLargeThreads>,
                                          granted, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  chol_large_kernel<kLargeThreads><<<B, kLargeThreads, smem_bytes,
                                     (cudaStream_t)stream>>>(K, L, n);
  return (int)cudaGetLastError();
}

// K4 for n >= 240: cho_solve_large_kernel, one instance per CTA.
int cho_solve_large_launch(const float* L, const float* b, float* x, int B,
                           int n, int threads, long smem_bytes,
                           void* stream) {
  if (threads != kLargeThreads
      || smem_bytes != (long)sizeof(float) * 2 * n
      || (long long)n * n > 0x7fffffffLL)
    return -1;
  static int granted[scpk::kMaxDevices];
  cudaError_t err = scpk::ensure_dyn_smem(
      cho_solve_large_kernel<kLargeThreads>, granted, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cho_solve_large_kernel<kLargeThreads>
      <<<B, kLargeThreads, smem_bytes, (cudaStream_t)stream>>>(L, b, x,
                                                                    n);
  return (int)cudaGetLastError();
}

// K3 from n = 240 in a cluster: chol_cluster_kernel, `C` CTAs (one
// cluster) of `threads` per instance, `deal` the stripes' owners and
// offsets (2 x ceil(n / 16) ints in device memory). Returns -1 when the
// geometry disagrees with the kernel's carve, -2 when no cluster can be
// resident (nothing is launched).
int chol_cluster_launch(const float* K, float* L, const int* deal, int B,
                        int n, int C, int threads, int area_words,
                        long smem_bytes, void* stream) {
  const int ns = scpk::stripe_count(n);
  if (C < 1 || C > scpk::kClusterMaxRanks || area_words < 0
      || smem_bytes != 4L * (scpk::stripe_buffer_words(n, C, area_words)
                             + n + 2 * ns + 1)
      || (long long)n * n > 0x7fffffffLL
      || (long long)B * C > 0x7fffffffLL)
    return -1;
  if (threads != kLargeThreads) return -1;
  return cluster_factor_launch(K, L, deal, B, n, C, area_words, smem_bytes,
                               (cudaStream_t)stream);
}

#ifdef SCP_PROFILE_SECTIONS
// Copy block 0's cycle sums of the factor kernel last run (load, first
// diagonal block, panel rows, trailing update with the next diagonal
// block, store)
// to `out` and clear them. Synchronises the device.
int chol_read_sections(unsigned long long* out) {
  unsigned long long zero[8] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_chol_cycles, sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_chol_cycles, zero, sizeof(zero));
}
#endif

#ifdef SCP_CLUSTER_TRACE
// Copy the cluster factor's trace (8 ranks x 64 panels x 6 points of the
// global timer, ns; 0 where not reached) to `out` and clear it.
int chol_read_trace(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_cl_trace, sizeof(g_cl_trace));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[8 * kTracePanels * kTracePoints];
  return (int)cudaMemcpyToSymbol(g_cl_trace, zero, sizeof(zero));
}
#endif

}  // extern "C"
