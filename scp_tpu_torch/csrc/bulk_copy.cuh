// Bulk asynchronous copies (cp.async.bulk) from device memory into shared
// memory, completing on an mbarrier, for spans whose ends need not be
// 16-byte aligned: the aligned middle of a span is one bulk copy, the at
// most three floats before and after it are loaded by the threads. The G
// products (linalg.cu, K5a / K5b), the staged large-n solve (linalg.cu) and
// K2's cluster tier (ipm_dense.cu) stage their operands this way.
#pragma once

#include <cstdint>

namespace scpk {

// The shared::cta address of `p` (this CTA's shared memory).
__device__ inline unsigned cta_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// An mbarrier awaiting `count` arrivals (thread 0 calls; the caller fences
// and synchronises before any other thread uses it).
__device__ inline void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(cta_addr(bar)), "r"(count) : "memory");
}

// Wait for phase `parity` of this CTA's mbarrier to complete.
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" :: "r"(cta_addr(bar)), "r"(parity) : "memory");
}

// Whether phase `parity` of this CTA's mbarrier has completed (acquiring
// what it counted when it has); never blocks.
__device__ inline bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(cta_addr(bar)), "r"(parity) : "memory");
  return done != 0;
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
  __device__ unsigned bytes() const { return (unsigned)(b1 - b0); }
};

// The bulk copy of the span's aligned middle into dst (as Span places it),
// counted on `bar`; no arrival.
__device__ inline void span_bulk_copy(const Span& sp, float* dst,
                                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(cta_addr(dst + sp.pad + sp.head())), "l"(sp.b0),
         "r"(sp.bytes()), "r"(cta_addr(bar)) : "memory");
}

__device__ inline void stage_copy(const float* src, int len, float* dst,
                                  uint64_t* bar) {
  const Span sp(src, len);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(cta_addr(bar)), "r"(sp.bytes()) : "memory");
  if (sp.bytes() > 0) span_bulk_copy(sp, dst, bar);
}

// The span's floats outside its bulk copy, loaded by threads first, first +
// step, ... (the caller picks which threads wait for device memory).
__device__ inline void stage_edges_by(const float* src, int len, float* dst,
                                      int first, int step) {
  const Span sp(src, len);
  const bool span = sp.b1 > sp.b0;
  const int h = span ? sp.head() : len, t = span ? sp.tail() : len;
  for (int e = first; e < h; e += step) dst[sp.pad + e] = src[e];
  for (int e = t + first; e < len; e += step) dst[sp.pad + e] = src[e];
}

// ... by all of the block's threads.
__device__ inline void stage_edges(const float* src, int len, float* dst) {
  stage_edges_by(src, len, dst, threadIdx.x, blockDim.x);
}

}  // namespace scpk
