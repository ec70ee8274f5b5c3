// Fused unpack + ownership filter + histogram over shuffled packed words,
// for Hopper (sm_90a).
//
// K3 packed_hist_kernel
//   Replaces src/repro/kernels/segment_hist/segment_hist.py:_packed_kernel.
//   One thread per shipped word, batched over the P receiving nodes in one
//   launch (blockIdx.y = node). A word (site<<8 | week<<2 | mark<<1 | valid,
//   an int32 bit pattern) is read as unsigned, so the shifts are logical
//   and a site >= 2^23 (bit 31 set) unpacks correctly. The thread drops the
//   word unless it is valid, owned by this node (site % P == node), inside
//   the node's block (site / P < S_local) and inside the week range, then
//   atomicAdds 1 into hist[node][site / P][week][0] and the mark bit into
//   [...][1]. Integer atomics make the result exact in any order. The
//   caller zeroes hist.
//
// What bounds it: the words are read once (a memory pass), but the updates
// are scattered atomics whose addresses follow MalGen's power law: with
// alpha = 1.2 over 100,000 sites the most popular site draws about a fifth
// of the unmarked records, so a few addresses are hot and their atomics
// serialise. This first version does nothing about that; warp aggregation
// or privatised per-block histograms are later work. The TPU's one-hot MXU
// matmul and its W_pad / 2*W_pad column layout are gone: the output is the
// [P, S_local, W, 2] histogram itself.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError() after
// the launch. Nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void packed_hist_kernel(const int* __restrict__ words,
                                   int* __restrict__ hist, long long len,
                                   int num_parts, int s_local,
                                   int num_weeks) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  const unsigned node = blockIdx.y;
  const unsigned w = (unsigned)words[(long long)node * len + i];
  if (!(w & 1u)) return;
  const unsigned site = w >> 8;
  const unsigned week = (w >> 2) & 0x3Fu;
  const unsigned p = (unsigned)num_parts;
  if (site % p != node) return;
  const unsigned local = site / p;
  if (local >= (unsigned)s_local || week >= (unsigned)num_weeks) return;
  int* cell = hist + (((long long)node * s_local + local) * num_weeks + week) * 2;
  atomicAdd(cell, 1);
  if ((w >> 1) & 1u) atomicAdd(cell + 1, 1);
}

}  // namespace

extern "C" int packed_hist(const int* words, int* hist, long long len,
                           int num_nodes, int num_parts, int s_local,
                           int num_weeks, void* stream) {
  if (len == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((len + kThreads - 1) / kThreads), num_nodes);
  packed_hist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      words, hist, len, num_parts, s_local, num_weeks);
  return (int)cudaGetLastError();
}
