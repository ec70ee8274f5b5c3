// MapReduce-with-a-combiner block exchange, for Hopper (sm_90a).
//
// K8 combine_blocks_kernel
//   Replaces no TPU kernel: the JAX package's combiner
//   (src/repro/core/backends/mapreduce.py:mapreduce_combiner_histogram)
//   leaves the exchange to XLA's all_to_all and a sum. On one card the
//   port's torch path was a transposed copy of the [P, S, W, 2] local
//   histograms (common/nodes.py:all_to_all), an int64 sum over the senders
//   with three elementwise passes to wrap it back to int32 (nodes.psum),
//   and the add into the carry: about 2.2 GB of memory traffic and seven
//   launches a step for a dataflow whose own bytes are a fifth of that.
//   For P nodes' local histograms local[src] of S = P * S_local sites, in
//   place into the owned [P, S_local, W, 2] carry:
//     carry[d, i, w, c] += sum_src local[src, i * P + d, w, c]
//   (node d owns the strided sites i * P + d). The adds are uint32 adds,
//   so the sum wraps modulo 2^32 exactly as `carry += psum(all_to_all(
//   blocks), dim=1)` does, whatever the order of the senders.
//
// What bounds it: every sender's blocks are read once (4 bytes a site-week
// channel a node) and the carry read and written once: 8 S W (P + 2)
// bytes, 499.2 MB at P = 8, S = 120,000, W = 52, or 0.149 ms at
// 3.35 TB/s. No operation rate comes near.
//
// Design: one pass, no shared memory and no transposed copy. The kernel
// walks the output in the local histograms' site order (v = site * R + k,
// R vectors a site row), so each sender's array is read front to back,
// and node d's carry rows are written as P interleaved streams of whole
// rows (8 W bytes each). A thread takes a vector of V ints (V = 4: 16
// bytes, where a row of 2W ints splits into whole vectors and both
// pointers are 16-byte aligned; else 8 bytes, else 4), loads the P
// senders' vectors with the streaming hint (read once: they need not stay
// in the L2) and the carry's vector, adds and stores. P + 1 independent
// loads a thread are in flight; a persistent grid of kBlocksPerSm blocks
// an SM walks the vectors grid-stride. Offsets within one node's histogram
// are 32-bit (the host refuses one over 2^31 - 1 ints), the sender's
// offset 64-bit.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // 8 warps a block
constexpr int kBlocksPerSm = 4;   // 32 warps an SM, up to 64 registers

__device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint2 add(uint2 a, uint2 b) {
  return make_uint2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
  return a + b;
}

// The grid's share of the n vectors, each of V ints (Vec).
template <typename Vec>
__device__ __forceinline__ void combine(const int* local_ints,
                                        int* carry_ints, int parts,
                                        unsigned s_local, unsigned row_vecs,
                                        unsigned n) {
  const Vec* __restrict__ local = reinterpret_cast<const Vec*>(local_ints);
  Vec* __restrict__ carry = reinterpret_cast<Vec*>(carry_ints);
  const unsigned p = (unsigned)parts;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < n;
       v += stride) {
    const unsigned site = v / row_vecs;
    const unsigned k = v - site * row_vecs;
    const unsigned i = site / p, d = site - i * p;
    const unsigned o = (d * s_local + i) * row_vecs + k;
    Vec acc = carry[o];
    const Vec* from = local + v;
#pragma unroll 8
    for (int src = 0; src < parts; ++src)
      acc = add(acc, __ldcs(from + (long long)src * n));
    carry[o] = acc;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    combine_blocks_kernel(const int* __restrict__ local,
                          int* __restrict__ carry, int parts, int s_local,
                          int row_vecs, int n, int vec) {
  if (vec == 4)
    combine<uint4>(local, carry, parts, s_local, row_vecs, n);
  else if (vec == 2)
    combine<uint2>(local, carry, parts, s_local, row_vecs, n);
  else
    combine<unsigned>(local, carry, parts, s_local, row_vecs, n);
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

// local: [parts, parts * s_local, num_weeks, 2] int32; carry: [parts,
// s_local, num_weeks, 2] int32, added into in place. One node's histogram
// (parts * s_local * 2 * num_weeks ints) must be at most 2^31 - 1 ints.
extern "C" int combine_blocks(const int* local, int* carry, int parts,
                              int s_local, int num_weeks, void* stream) {
  if (parts <= 0 || s_local <= 0 || num_weeks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long row_ints = 2LL * num_weeks;
  const long long node_ints = (long long)parts * s_local * row_ints;
  if (node_ints > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uintptr_t both = (uintptr_t)local | (uintptr_t)carry;
  // a row of 2W ints is always a whole number of 2-int vectors
  const int vec = row_ints % 4 == 0 && both % 16 == 0 ? 4
                  : both % 8 == 0                     ? 2
                                                      : 1;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long n = node_ints / vec;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  combine_blocks_kernel<<<(unsigned)(need < most ? need : most), kThreads, 0,
                          (cudaStream_t)stream>>>(
      local, carry, parts, s_local, (int)(row_ints / vec), (int)n, vec);
  return (int)cudaGetLastError();
}

// What the card reports for kernel k of this source, in the order of its
// ops.py KERNELS: out = {static shared bytes, registers a thread, largest
// block, largest dynamic shared bytes} (cudaFuncGetAttributes). For the
// static analysis, which holds its launch plans against the card.
extern "C" int kernel_attributes(int k, int* out) {
  const void* const fns[] = {(const void*)combine_blocks_kernel};
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
