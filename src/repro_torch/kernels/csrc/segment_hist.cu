// (site, week, mark, valid) columns -> (total, marked) histogram, for Hopper
// (sm_90a).
//
// K4 segment_hist_kernel
//   Replaces src/repro/kernels/segment_hist/segment_hist.py:_kernel, the
//   local combine of the streams, sphere and combiner backends and the
//   reducer of the 4-column exchange. One thread per record, batched over
//   the P nodes in one launch (blockIdx.y = node; row `node` of each [P, n]
//   column). The thread drops the record unless it is valid and its
//   rebased site (site - site_offset, int32 wrap) and its week are in range,
//   then atomicAdds 1 into hist[node][site][week][0] and, when mark > 0,
//   1 into [...][1]. Integer atomics make the result exact in any order.
//   The caller zeroes hist.
//
// Mark semantics: `mark > 0` counts one, as segment_hist_ref and the
// packed word do. The TPU kernel adds the raw mark value instead; the two
// agree on MalGen's marks, which are 0 or 1.
//
// What bounds it: the columns are read once (13 bytes a record), but the
// updates are scattered atomics whose addresses follow MalGen's power law,
// so the few hot sites serialise their atomics. This first version does
// nothing about that (as K3 in segment_hist_packed.cu); warp aggregation of
// equal keys or privatised tiles are later work. The TPU's one-hot MXU
// matmul over site tiles and its W_pad / 2*W_pad column layout are gone:
// the output is the [P, S, W, 2] histogram itself.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError() after
// the launch. Nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_hist_kernel(const int* __restrict__ site,
                                    const int* __restrict__ week,
                                    const int* __restrict__ mark,
                                    const unsigned char* __restrict__ valid,
                                    int* __restrict__ hist, long long n,
                                    int num_sites, int num_weeks,
                                    int site_offset) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long node = blockIdx.y;
  const long long r = node * n + i;
  if (!valid[r]) return;
  const int s = (int)((unsigned)site[r] - (unsigned)site_offset);
  const int w = week[r];
  if (s < 0 || s >= num_sites || w < 0 || w >= num_weeks) return;
  int* cell = hist + ((node * num_sites + s) * num_weeks + w) * 2;
  atomicAdd(cell, 1);
  if (mark[r] > 0) atomicAdd(cell + 1, 1);
}

}  // namespace

extern "C" int segment_hist(const int* site, const int* week, const int* mark,
                            const unsigned char* valid, int* hist,
                            long long n, int num_nodes, int num_sites,
                            int num_weeks, int site_offset, void* stream) {
  if (n == 0 || num_nodes == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), num_nodes);
  segment_hist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      site, week, mark, valid, hist, n, num_sites, num_weeks, site_offset);
  return (int)cudaGetLastError();
}
