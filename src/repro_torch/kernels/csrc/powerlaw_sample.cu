// MalGen's inverse-CDF site sampler, for Hopper (sm_90a).
//
// K6 powerlaw_sample_kernel
//   Replaces src/repro/kernels/powerlaw_sample/powerlaw_sample.py:_kernel
//   (wrapper ops.py:powerlaw_sample). For n uniform draws u and the
//   S-entry inclusive CDF (non-decreasing, f32):
//     out[i] = min(#{s : cdf[s] <= u[i]}, S - 1)   (int32)
//   which is searchsorted(cdf, u, side="right") clipped to [0, S-1], the
//   JAX package's powerlaw_sample_ref. Ties go right and runs of equal
//   entries are skipped; u >= cdf[S-1] and +inf give S-1, u < cdf[0] and
//   -inf give 0. A NaN draw gives S-1, as the reference's search sorts NaN
//   last (the Pallas body counts cdf <= NaN, never true, and gives 0).
//   The TPU kernel counts with broadcast compares over streamed CDF tiles
//   (no per-lane gather there); a GPU thread can gather, so here each
//   thread runs an upper-bound binary search over the CDF.
//
// Design: one thread per draw, 256 threads a block, the index in 64 bits
// (n may reach 2^31 - 1). NaN is settled before the search: the loop's
// predicate cdf[mid] <= u is false for NaN and would end at 0. The search
// keeps [lo, hi) with lo + (hi - lo) / 2, so S up to 2^31 - 1 does not
// overflow. The CDF (400 KB at S = 100,000) is read through the read-only
// cache and stays in L2.
//
// What bounds it: the bytes are u read once, out written once and the CDF
// once (8 bytes a draw); at n = 2^23, S = 100,000 that is 67.5 MB, 0.0202
// ms at 3.35 TB/s. Each thread's ceil(log2(S + 1)) = 17 loads depend on
// one another, so this first version is bound by L2 latency, not by
// bandwidth: a shared-memory copy of the top levels of the search tree is
// the next step.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void powerlaw_sample_kernel(const float* __restrict__ u,
                                       const float* __restrict__ cdf,
                                       int* __restrict__ out, long long n,
                                       int num_sites) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = u[i];
  if (x != x) {  // NaN
    out[i] = num_sites - 1;
    return;
  }
  int lo = 0, hi = num_sites;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cdf + mid) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[i] = lo < num_sites ? lo : num_sites - 1;
}

}  // namespace

extern "C" int powerlaw_sample(const float* u, const float* cdf, int* out,
                               long long n, int num_sites, void* stream) {
  if (n <= 0 || num_sites <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  powerlaw_sample_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(u, cdf, out, n, num_sites);
  return (int)cudaGetLastError();
}
