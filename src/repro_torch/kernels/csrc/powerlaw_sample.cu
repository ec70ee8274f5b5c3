// MalGen's inverse-CDF site sampler, for Hopper (sm_90a).
//
// K6 powerlaw_sample
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
//   draw is found by a search.
//
// What bound the first design: one thread per draw ran an upper-bound
// binary search of ceil(log2(S + 1)) = 17 steps over the 400 KB CDF, each
// load depending on the one before: 0.0895 ms at n = 2^23 on an H100
// 80GB HBM3 at 700 W, 4.4x its byte bound.
//
// Design: a guide table takes the top of the search out of the L2.
//   1. guide_kernel writes guide[b] = #{s : cdf[s] <= b / G} for
//      b = 0..G (G = kGuide = 8,192) into scratch the wrapper allocates,
//      in one coalesced pass over the CDF. It is rebuilt on every call:
//      nothing is cached across calls.
//   2. sample_kernel runs a persistent grid (kBlocksPerSm blocks an SM).
//      Each block copies the table into shared memory once, then takes
//      groups of 4 draws grid-stride: one 16-byte load of u (the next
//      group's load is issued before the current group is searched) and
//      one 16-byte store of the sites. A draw x in [0, 1) lies in bucket
//      b = (int)(x * G): x * G and b / G are exact in f32 because G is a
//      power of two, so b / G <= x < (b + 1) / G and the answer lies in
//      [guide[b], guide[b + 1]]. x < 0 (and -inf) lies in [0, guide[0]],
//      x >= 1 (and +inf) in [guide[G], S]; -0.0 compares equal to 0 and
//      takes bucket 0. NaN gives S - 1 directly. The four brackets are
//      finished by upper-bound searches interleaved step by step, four
//      independent loads in flight a thread. Most brackets are one index
//      wide and need no load at all; the rest lie in the tail of light
//      sites and take a few steps.
//   Below kDirect = 2^18 draws the table costs more than it saves (its
//   build is some 2 us), and each draw is searched directly instead.
//   All of this holds for any non-decreasing CDF: leading zero entries (a
//   masked CDF), a last entry below 1, entries outside [0, 1], S = 1 and
//   S < G.
//
// What bounds it: the bytes are u read once, out written once and the CDF
// once (8 bytes a draw); at n = 2^23, S = 100,000 that is 67.5 MB, 0.0202
// ms at 3.35 TB/s. What holds it above that is the long searches: their
// steps run in lock step with the warp's other draws, each a random load
// from the L2 (tools/k6_mechanisms.py times the kernel with the searches
// cut out or capped; PERF.md has the numbers).
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLogGuide = 13;
constexpr int kGuide = 1 << kLogGuide;  // buckets of the guide table
constexpr int kThreads = 512;           // sample_kernel's block
constexpr int kBlocksPerSm = 3;
constexpr int kGuideThreads = 256;
constexpr int kGuideInts = kGuide + 4;  // G + 1 entries, int4-padded
constexpr int kSharedBytes = kGuideInts * (int)sizeof(int);
constexpr long long kDirect = 1LL << 18;  // fewer draws: no table
constexpr int kDirectThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGuide % (4 * kThreads) == 0, "whole int4 copies a thread");

// lo + #{s in [lo, hi) : cdf[s] <= x}, for a non-decreasing cdf.
__device__ __forceinline__ int upper_bound(const float* __restrict__ cdf,
                                           int lo, int hi, float x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cdf + mid) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Below kDirect draws: one thread a draw, one search over the whole CDF
// (the first design; the table's build would cost more than it saves).
__global__ void direct_kernel(const float* __restrict__ u,
                              const float* __restrict__ cdf,
                              int* __restrict__ out, int n, int num_sites) {
  const int i = blockIdx.x * kDirectThreads + threadIdx.x;
  if (i >= n) return;
  const float x = __ldg(u + i);
  const int r = x != x ? num_sites - 1 : upper_bound(cdf, 0, num_sites, x);
  out[i] = min(r, num_sites - 1);
}

// ceil(y) as a guide index in [0, G + 1], for y = a CDF entry times G
// (exact, G being a power of two).
__device__ __forceinline__ int edge_index(float y) {
  return (int)ceilf(fminf(fmaxf(y, 0.f), (float)(kGuide + 1)));
}

// guide[b] = #{s : cdf[s] <= b / G} for b = 0..G. Entry s (0 <= s <= S)
// owns the edges b with cdf[s - 1] <= b / G < cdf[s], i.e. b in
// [ceil(G cdf[s - 1]), ceil(G cdf[s])) (the first bound 0 for s = 0, the
// last G + 1 for s = S); for a non-decreasing CDF these ranges tile
// [0, G]. A warp takes 32 consecutive entries and writes each entry's
// edges with all 32 lanes, 16 bytes a lane, so that a heavy site (0.196
// of the mass: some 1,600 edges) does not serialise one thread.
__global__ void guide_kernel(const float* __restrict__ cdf, int num_sites,
                             int* __restrict__ guide) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kGuideThreads + threadIdx.x;
  int lo = 0, hi = 0;  // entries past S own nothing
  if (s <= num_sites) {
    lo = s == 0 ? 0 : edge_index(__ldg(cdf + s - 1) * kGuide);
    hi = s == num_sites ? kGuide + 1 : edge_index(__ldg(cdf + s) * kGuide);
  }
  for (unsigned todo = __ballot_sync(kFull, lo < hi); todo;
       todo &= todo - 1) {
    const int k = __ffs(todo) - 1;
    const int a = __shfl_sync(kFull, lo, k), e = __shfl_sync(kFull, hi, k);
    const int v = (int)(s - lane + k);
    // a scalar head to a multiple of 4, int4 stores, a scalar tail
    const int a4 = min((a + 3) & ~3, e), e4 = max(e & ~3, a4);
    if (a + lane < a4) guide[a + lane] = v;
    for (int b = a4 + 4 * lane; b < e4; b += 128)
      *reinterpret_cast<int4*>(guide + b) = make_int4(v, v, v, v);
    if (e4 + lane < e) guide[e4 + lane] = v;
  }
}

// [lo, hi], the indices the answer for draw x can take.
__device__ __forceinline__ void bracket(float x, const int* guide,
                                        int num_sites, int& lo, int& hi) {
  if (x >= 0.f && x < 1.f) {  // -0.0 too: bucket 0
    const int b = (int)(x * (float)kGuide);
    lo = guide[b];
    hi = guide[b + 1];
  } else if (x < 0.f) {
    lo = 0;
    hi = guide[0];
  } else if (x >= 1.f) {
    lo = guide[kGuide];
    hi = num_sites;
  } else {  // NaN
    lo = hi = num_sites - 1;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sample_kernel(const float* __restrict__ u, const float* __restrict__ cdf,
                  const int* __restrict__ guide_g, int* __restrict__ out,
                  int n, int num_sites, bool vec) {
  extern __shared__ int4 smem[];
  {
    // every int4 load of the copy in flight at once, then the last entry
    constexpr int kPer = kGuide / 4 / kThreads;
    const int4* src = reinterpret_cast<const int4*>(guide_g);
    int4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      v[k] = __ldg(src + k * kThreads + threadIdx.x);
#pragma unroll
    for (int k = 0; k < kPer; ++k) smem[k * kThreads + threadIdx.x] = v[k];
    if (threadIdx.x == 0)
      reinterpret_cast<int*>(smem)[kGuide] = __ldg(guide_g + kGuide);
  }
  __syncthreads();
  const int* guide = reinterpret_cast<const int*>(smem);

  // draws i .. i + 3 (those below n)
  auto load4 = [&](int i) {
    if (vec && i + 4 <= n)
      return __ldg(reinterpret_cast<const float4*>(u + i));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) x.x = __ldg(u + i);
    if (i + 1 < n) x.y = __ldg(u + i + 1);
    if (i + 2 < n) x.z = __ldg(u + i + 2);
    if (i + 3 < n) x.w = __ldg(u + i + 3);
    return x;
  };

  // groups of 4 draws, grid-stride
  const int groups = (int)(((long long)n + 3) >> 2);
  const int stride = gridDim.x * kThreads;
  int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  float4 next = load4(g << 2);
  for (; g < groups; g += stride) {
    const float x[4] = {next.x, next.y, next.z, next.w};
    // the next group's load is in flight while this one is searched
    if (g < groups - stride) next = load4((g + stride) << 2);
    int lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bracket(x[j], guide, num_sites, lo[j], hi[j]);
    // four upper-bound searches, one step of each per pass, so that up
    // to four independent loads are in flight a thread
    for (;;) {
      float c[4];
      int mid[4];
      bool live = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mid[j] = lo[j] + ((hi[j] - lo[j]) >> 1);
        c[j] = 0.f;
        if (lo[j] < hi[j]) {
          c[j] = __ldg(cdf + mid[j]);
          live = true;
        }
      }
      if (!live) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (lo[j] < hi[j]) {
          if (c[j] <= x[j])
            lo[j] = mid[j] + 1;
          else
            hi[j] = mid[j];
        }
      }
    }
    const int i = g << 2;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) =
          make_int4(min(lo[0], num_sites - 1), min(lo[1], num_sites - 1),
                    min(lo[2], num_sites - 1), min(lo[3], num_sites - 1));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) out[i + j] = min(lo[j], num_sites - 1);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// Bytes of scratch a call needs for its guide table.
extern "C" int powerlaw_sample_scratch() {
  return kGuideInts * (int)sizeof(int);
}

extern "C" int powerlaw_sample(const float* u, const float* cdf, int* out,
                               int* guide, long long n, int num_sites,
                               void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || num_sites <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < kDirect) {
    direct_kernel<<<(unsigned)((n + kDirectThreads - 1) / kDirectThreads),
                    kDirectThreads, 0, st>>>(u, cdf, out, (int)n,
                                             num_sites);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)guide % 16) return (int)cudaErrorMisalignedAddress;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (kSharedBytes > 48 * 1024) {  // a larger table than 2^13 buckets
    const cudaError_t err = cudaFuncSetAttribute(
        sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (err != cudaSuccess) return (int)err;
  }
  guide_kernel<<<(unsigned)(num_sites / kGuideThreads + 1), kGuideThreads,
                 0, st>>>(cdf, num_sites, guide);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  const bool vec = (uintptr_t)u % 16 == 0 && (uintptr_t)out % 16 == 0;
  sample_kernel<<<(unsigned)(need < most ? need : most), kThreads,
                  kSharedBytes, st>>>(u, cdf, guide, out, (int)n, num_sites,
                                      vec);
  return (int)cudaGetLastError();
}

// What the card reports for kernel k of this source, in the order of its
// ops.py KERNELS: out = {static shared bytes, registers a thread, largest
// block, largest dynamic shared bytes} (cudaFuncGetAttributes). For the
// static analysis, which holds its launch plans against the card.
extern "C" int kernel_attributes(int k, int* out) {
  const void* const fns[] = {
      (const void*)direct_kernel,
      (const void*)guide_kernel,
      (const void*)sample_kernel};
  if (k < 0 || k >= (int)(sizeof(fns) / sizeof(fns[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.numRegs;
  out[2] = a.maxThreadsPerBlock;
  out[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}
