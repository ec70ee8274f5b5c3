// MalStone B finalizer, for Hopper (sm_90a).
//
// K7 windowed_ratio_kernel
//   Replaces src/repro/kernels/windowed_ratio/windowed_ratio.py:_kernel
//   (wrapper ops.py:windowed_ratio). For S sites of the [S, W, 2] (total,
//   marked) histogram:
//     cum_total[s, t]  = sum_{w <= t} hist[s, w, 0]   (int32, wrapping)
//     cum_marked[s, t] = sum_{w <= t} hist[s, w, 1]
//     rho[s, t] = cum_total > 0 ? cum_marked / max(cum_total, 1) : 0
//   (one IEEE f32 divide, bit-equal to common/types.py:safe_ratio). The
//   TPU kernel scans with a triangular f32 matmul and casts to int32, exact
//   only while a running count stays under 2^24 and saturating past 2^31;
//   here the scans are int32 adds (in uint32, since signed overflow is
//   undefined in C++), wrapping past 2^31 as the JAX package's
//   windowed_ratio_ref (jnp.cumsum) does.
//
// Design: one thread per site, kSites sites per block. A site's row is
// 2 * W interleaved ints (416 bytes at W = 52), so a thread reading its own
// row from device memory would not coalesce. The block's rows of up to
// kWeekChunk weeks are one contiguous run of the histogram: the block
// copies it into shared memory with kUnroll independent loads in flight
// per thread (row stride 2 * weeks + 1 words, odd, so the threads' reads
// of their own rows hit distinct banks). Each thread scans its row in
// place, keeping the running sums in registers across week chunks. The
// block then writes the three [sites, weeks] outputs back along the
// contiguous output rows, computing rho from the scanned pair as it goes,
// so the warps' stores are coalesced and no third tile is staged. Any
// W >= 1 and S >= 1 are taken.
//
// What bounds it: the histogram is read once (8 bytes a site-week) and the
// outputs written once (12 bytes a site-week); at S = 100,000, W = 52 that
// is 104.0 MB, 0.0310 ms at 3.35 TB/s. The adds and the divide are far
// below the card's rates.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kSites = 128;     // threads per block, one site each
constexpr int kWeekChunk = 64;  // weeks staged per pass
constexpr int kUnroll = 8;      // staging loads in flight per thread

__global__ void windowed_ratio_kernel(const int* __restrict__ hist,
                                      float* __restrict__ rho,
                                      int* __restrict__ cum_total,
                                      int* __restrict__ cum_marked,
                                      int num_sites, int num_weeks) {
  extern __shared__ int tile[];  // [kSites][stride]
  const int wc_max = num_weeks < kWeekChunk ? num_weeks : kWeekChunk;
  const int stride = 2 * wc_max + 1;
  const int s0 = blockIdx.x * kSites;
  const int ts = min(kSites, num_sites - s0);
  int* row = tile + threadIdx.x * stride;
  unsigned ct = 0u, cm = 0u;  // running sums of this thread's site

  for (int w0 = 0; w0 < num_weeks; w0 += kWeekChunk) {
    const int wc = min(kWeekChunk, num_weeks - w0);
    const int row_len = 2 * wc;
    const int total = ts * row_len;
    const int* base = hist + ((long long)s0 * num_weeks + w0) * 2;
    __syncthreads();  // the previous chunk's write-out is done with the tile
    for (int i0 = 0; i0 < total; i0 += kSites * kUnroll) {
      int v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSites + threadIdx.x;
        if (i < total) {
          const int r = i / row_len;
          v[u] = base[(long long)r * num_weeks * 2 + (i - r * row_len)];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSites + threadIdx.x;
        if (i < total) {
          const int r = i / row_len;
          tile[r * stride + (i - r * row_len)] = v[u];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < ts) {
      for (int w = 0; w < wc; ++w) {
        ct += (unsigned)row[2 * w];
        cm += (unsigned)row[2 * w + 1];
        row[2 * w] = (int)ct;
        row[2 * w + 1] = (int)cm;
      }
    }
    __syncthreads();
    const int outs = ts * wc;
#pragma unroll 4
    for (int j = threadIdx.x; j < outs; j += kSites) {
      const int r = j / wc;
      const int w = j - r * wc;
      const int t = tile[r * stride + 2 * w];
      const int m = tile[r * stride + 2 * w + 1];
      const long long o = (long long)(s0 + r) * num_weeks + w0 + w;
      cum_total[o] = t;
      cum_marked[o] = m;
      rho[o] = t > 0 ? __fdiv_rn((float)m, fmaxf((float)t, 1.f)) : 0.f;
    }
  }
}

}  // namespace

extern "C" int windowed_ratio(const int* hist, float* rho, int* cum_total,
                              int* cum_marked, int num_sites, int num_weeks,
                              void* stream) {
  if (num_sites <= 0 || num_weeks <= 0) return (int)cudaErrorInvalidValue;
  const int wc = num_weeks < kWeekChunk ? num_weeks : kWeekChunk;
  const size_t smem = (size_t)kSites * (2 * wc + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      windowed_ratio_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((num_sites + kSites - 1) / kSites);
  windowed_ratio_kernel<<<blocks, kSites, smem, (cudaStream_t)stream>>>(
      hist, rho, cum_total, cum_marked, num_sites, num_weeks);
  return (int)cudaGetLastError();
}
