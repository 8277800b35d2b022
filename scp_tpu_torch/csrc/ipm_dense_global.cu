// K2's global tier (see the head of ipm_dense.cu): the device tier's
// kernel of ipm_dense.cuh with the step's vectors in the per-instance
// device-memory workspace too (ipm_dense_kernel<false, *, true, true>),
// and its launcher. A translation unit of its own, so that its
// instantiations leave the code of ipm_dense.cu's kernels as it was.
#include "ipm_dense.cuh"

namespace {

// The global tier's instantiation at the launch bound `min_ctas` (2 or 4),
// with its index in the tables below; null for any other bound.
DenseKernel dense_global_kernel(int min_ctas, int* index) {
  if (min_ctas != 2 && min_ctas != 4) return nullptr;
  *index = min_ctas == 4;
  return min_ctas == 4 ? ipm_dense_kernel<false, 4, true, true>
                       : ipm_dense_kernel<false, 2, true, true>;
}

// Per instantiation and device (see prepare).
int dense_global_smem_granted[2][scpk::kMaxDevices];
int dense_global_carveout_set[2][scpk::kMaxDevices];

bool carveout_ok(int carveout) { return carveout >= -1 && carveout <= 100; }

}  // namespace

extern "C" {

// Launch on `stream` in the global tier: one CTA an instance at the launch
// bound `min_ctas` (2 or 4), the step's vectors and the factor in `ws` (B x
// dense_global_ws_words floats), G, P (or its blocks), q and pdiag read in
// place, the preferred shared-memory carve-out `carveout` (a percentage of
// the unified L1 / shared memory, -1 for the CUDA default). The other
// arguments as ipm_dense_launch's; ipm_kernel.py::DENSE_GLOBAL_LAUNCH_ARGS
// names them in this order. Returns 0 when launched, -1 when `smem_bytes`
// or `ws_floats` disagrees with the tier's carve or workspace, `ws` is
// null, `min_ctas` is neither 2 nor 4, `carveout` is outside -1 .. 100 or
// the P operands do not match nb, else a CUDA error.
int ipm_dense_global_launch(
    const float* G, const float* P, const float* pb,
    const float* q, const float* pdiag,
    const float* x, const float* sg, const float* su, const float* sl,
    const float* zg, const float* zu, const float* zl,
    const float* rpg, const float* rpu, const float* rpl, const float* scal,
    float* xo, float* sgo, float* suo, float* slo,
    float* zgo, float* zuo, float* zlo,
    float* rpgo, float* rpuo, float* rplo, float* scalo, float* ws,
    int B, int mg, int n, int nb, int d, int schur, int n_iters, int n_cor,
    int min_ctas, int carveout, float tol, float tol_stall, float reg_rel,
    long smem_bytes, long ws_floats, void* stream) {
  const DenseShape s = make_dense_shape(B, mg, n, nb, d, schur, 0, n_cor, 1);
  if (ws == nullptr || ws_floats != (long)B * dense_global_ws_words(s)
      || smem_bytes != 4L * kGlobalSmemWords || !carveout_ok(carveout))
    return -1;
  if ((nb > 0) != (pb != nullptr) || (nb > 0) == (P != nullptr)) return -1;
  int index = 0;
  const DenseKernel kernel = dense_global_kernel(min_ctas, &index);
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
  cudaError_t err = prepare(kernel, dense_global_smem_granted[index],
                            dense_global_carveout_set[index], smem_bytes,
                            carveout);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(a, s);
  return (int)cudaGetLastError();
}

// CTAs of the global tier's kernel at the launch bound `min_ctas` that can
// be resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// with the launch's shared memory and the carve-out `carveout`) into
// `ctas`. Returns a CUDA error code, or -1 for a bound or carve-out
// ipm_dense_global_launch refuses.
int ipm_dense_global_occupancy(int min_ctas, int carveout, int* ctas) {
  int index = 0;
  const DenseKernel kernel = dense_global_kernel(min_ctas, &index);
  if (kernel == nullptr || !carveout_ok(carveout)) return -1;
  const long smem_bytes = 4L * kGlobalSmemWords;
  cudaError_t err = prepare(kernel, dense_global_smem_granted[index],
                            dense_global_carveout_set[index], smem_bytes,
                            carveout);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, kThreads, (size_t)smem_bytes);
}

#ifdef SCP_PROFILE_SECTIONS
// The global tier's section cycles (its translation unit's own counters),
// as ipm_dense_read_sections gives the other tiers'.
int ipm_dense_global_read_sections(unsigned long long* out) {
  unsigned long long zero[24] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(
      out, g_section_cycles, kSecCount * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_section_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
