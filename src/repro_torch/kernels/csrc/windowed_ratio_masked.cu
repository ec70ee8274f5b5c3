// Batched masked-window ratio of the query service, for Hopper (sm_90a).
//
// K5 masked_window_ratio_kernel
//   Replaces src/repro/kernels/windowed_ratio/windowed_ratio.py:_masked_kernel
//   (wrapper ops.py:masked_window_ratio), the reducer of the serving
//   engine's batched_query. For N queries, each a numerator and a
//   denominator week mask, and S sites of the [S, W, 2] (total, marked)
//   histogram:
//     num[n, s] = sum_w nmask[n, w] * hist[s, w, 1]   (int32, wrapping)
//     den[n, s] = sum_w dmask[n, w] * hist[s, w, 0]
//     rho[n, s] = den > 0 ? num / max(den, 1) : 0     (one IEEE divide)
//   The TPU kernel contracts f32 masks against f32 counts on the MXU, exact
//   only while a count stays under 2^24; here the sums are int32 adds, exact
//   at any size, as the JAX package's masked_window_ratio_ref.
//
// Design: one thread per site, kSites sites per block. The block copies its
// sites' rows of up to kWeekChunk weeks into shared memory: the rows are one
// contiguous run of the histogram, read with kUnroll independent loads in
// flight per thread (the row stride in shared memory, 2*weeks+1, is odd, so
// the threads' reads of their own rows hit distinct banks). The masks are
// packed into bits in shared memory, one (query, week) byte per thread at a
// time: for a group of kGroup queries, one 32-bit word per week holds the
// numerator bits (low half) and the denominator bits (high half). A thread
// walks the weeks once per group, reading its (total, marked) pair and the
// group's word, and adds into 2*kGroup register accumulators; the writes
// of query n go along s, so a warp's stores are coalesced. Any N (query
// blocks of kQueryBlock), any W (week chunks of kWeekChunk; later chunks add
// onto the sums already written) and any S >= 1 are taken.
//
// What bounds it: the histogram is read once (8 bytes a site-week) and the
// outputs written once (12 bytes a query-site); at the service's shapes
// (S = 100,000, W = 52, N = 9 or 52) that is 15.6 to 31 us at 3.35 TB/s.
// The integer work, two conditional adds per query, site and week, is of
// the same order at N = 52; this first version does nothing cleverer about
// it (int8 tensor-core products of byte planes would be the next step).
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kSites = 128;       // threads per block, one site each
constexpr int kWeekChunk = 64;    // weeks staged per pass
constexpr int kGroup = 16;        // queries a thread accumulates at once
constexpr int kQueryBlock = 128;  // queries whose bits are staged per pass
constexpr int kGroups = kQueryBlock / kGroup;
constexpr int kUnroll = 8;        // staging loads in flight per thread

__global__ void masked_window_ratio_kernel(
    const int* __restrict__ hist, const unsigned char* __restrict__ nmask,
    const unsigned char* __restrict__ dmask, float* __restrict__ rho,
    int* __restrict__ num, int* __restrict__ den, int num_sites,
    int num_weeks, int num_queries) {
  extern __shared__ int smem[];
  const int wc_max = num_weeks < kWeekChunk ? num_weeks : kWeekChunk;
  const int stride = 2 * wc_max + 1;
  int* tile = smem;  // [kSites][stride]
  unsigned* bits = reinterpret_cast<unsigned*>(tile + kSites * stride);
  const int s0 = blockIdx.x * kSites;
  const int ts = min(kSites, num_sites - s0);
  const int s = s0 + threadIdx.x;
  const int* row = tile + threadIdx.x * stride;

  for (int w0 = 0; w0 < num_weeks; w0 += kWeekChunk) {
    const int wc = min(kWeekChunk, num_weeks - w0);
    const bool last = w0 + wc == num_weeks;
    __syncthreads();  // the previous chunk's readers are done with the tile
    // element i of the staged block is row r = i / row_len, column k: the
    // division is a multiply-high by ceil(2^32 / row_len), exact for
    // i < kSites * 2 * kWeekChunk
    const int row_len = 2 * wc;
    const unsigned magic =
        (unsigned)((0x100000000ull + row_len - 1) / row_len);
    const int total = ts * row_len;
    const int* base = hist + ((long long)s0 * num_weeks + w0) * 2;
    for (int i0 = 0; i0 < total; i0 += kSites * kUnroll) {
      int v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSites + threadIdx.x;
        if (i < total) {
          const int r = (int)__umulhi((unsigned)i, magic);
          v[u] = base[(long long)r * num_weeks * 2 + (i - r * row_len)];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSites + threadIdx.x;
        if (i < total) {
          const int r = (int)__umulhi((unsigned)i, magic);
          tile[r * stride + (i - r * row_len)] = v[u];
        }
      }
    }
    for (int q0 = 0; q0 < num_queries; q0 += kQueryBlock) {
      const int nq = min(kQueryBlock, num_queries - q0);
      const int groups = (nq + kGroup - 1) / kGroup;
      __syncthreads();  // tile staged; the previous block's bits are read
      for (int i = threadIdx.x; i < groups * wc; i += kSites) bits[i] = 0u;
      __syncthreads();
      // bit q of word bits[g * wc + w]: week w0 + w is in query
      // q0 + g * kGroup + q's numerator mask; bit kGroup + q: denominator
#pragma unroll 4
      for (int i = threadIdx.x; i < nq * wc; i += kSites) {
        const int ql = i / wc;
        const int w = i - ql * wc;
        const long long m = (long long)(q0 + ql) * num_weeks + w0 + w;
        const int q = ql % kGroup;
        const unsigned b = ((unsigned)(nmask[m] != 0) << q)
                           | ((unsigned)(dmask[m] != 0) << (kGroup + q));
        if (b) atomicOr(bits + (ql / kGroup) * wc + w, b);
      }
      __syncthreads();
      if (s >= num_sites) continue;
      for (int g = 0; g < groups; ++g) {
        const int nb = q0 + g * kGroup;
        unsigned an[kGroup], ad[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          an[q] = 0u;
          ad[q] = 0u;
          if (w0 > 0 && nb + q < num_queries) {
            const long long o = (long long)(nb + q) * num_sites + s;
            an[q] = (unsigned)num[o];
            ad[q] = (unsigned)den[o];
          }
        }
        const unsigned* gb = bits + g * wc;
        for (int w = 0; w < wc; ++w) {
          const unsigned b = gb[w];
          const unsigned t = (unsigned)row[2 * w];
          const unsigned mk = (unsigned)row[2 * w + 1];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            if (b & (1u << q)) an[q] += mk;
            if (b & (1u << (kGroup + q))) ad[q] += t;
          }
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (nb + q < num_queries) {
            const long long o = (long long)(nb + q) * num_sites + s;
            const int nv = (int)an[q];
            const int dv = (int)ad[q];
            num[o] = nv;
            den[o] = dv;
            if (last)
              rho[o] = dv > 0 ? __fdiv_rn((float)nv, fmaxf((float)dv, 1.f))
                              : 0.f;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int masked_window_ratio(const int* hist, const unsigned char* nmask,
                                   const unsigned char* dmask, float* rho,
                                   int* num, int* den, int num_sites,
                                   int num_weeks, int num_queries,
                                   void* stream) {
  if (num_sites <= 0 || num_weeks <= 0 || num_queries <= 0)
    return (int)cudaErrorInvalidValue;
  const int wc = num_weeks < kWeekChunk ? num_weeks : kWeekChunk;
  const size_t smem = (size_t)kSites * (2 * wc + 1) * sizeof(int)
                      + (size_t)kGroups * wc * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      masked_window_ratio_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((num_sites + kSites - 1) / kSites);
  masked_window_ratio_kernel<<<blocks, kSites, smem, (cudaStream_t)stream>>>(
      hist, nmask, dmask, rho, num, den, num_sites, num_weeks, num_queries);
  return (int)cudaGetLastError();
}
