// The record shuffle's round of shipped words, for Hopper (sm_90a).
//
// K9 ship_buckets_kernel
//   Replaces no TPU kernel: the JAX package's word exchange
//   (src/repro/core/backends/mapreduce.py:_word_shuffle_histogram) fills
//   its buckets with XLA's gather and `where` and ships them with
//   `all_to_all`. On one card the port's torch path did the same in seven
//   passes: an int32 index of every slot, a liveness mask, its int64 copy,
//   the gather, the `where`, then the all_to_all's transposed copy. At the
//   benchmark's step (P = 8 nodes of 2^23 words, C = 2^22 slots a bucket)
//   that is about 16 GB of memory traffic a round to move 0.27 GB of words
//   into a 1.07 GB zero-padded buffer. This kernel writes that buffer, as
//   the receivers hold it, in one pass. For receiver d, sender s and lane
//   c < C of round r:
//     shipped[d, s, c] = words[s, starts[s, d] + r*C + c]
//                        if that index is below starts[s, d + 1], else 0
//   (words are each sender's words ordered by destination; starts[s, d]
//   is where destination d's segment begins, starts[s, P] the end of the
//   valid words). In a gang of processes a process holds only its own
//   senders' rows, and its buckets go to the other processes over the
//   host: there the kernel writes the senders' layout, row s * P + d in
//   place of d * P + s, which `nodes.all_to_all` ships as it is.
//
// What bounds it: every slot of the [P, P, C] buffer written once and
// every word shipped this round read once: 4 P P C + 4 (live words)
// bytes, 1.342 GB at the benchmark's step (0.401 ms at 3.35 TB/s). No
// operation rate comes near.
//
// Design: a row (d, s) is a contiguous source run of `live` words
// followed by C - live zeros, into a destination row that starts on a
// 16-byte boundary when C is a multiple of 4. A persistent grid of
// kBlocksPerSm blocks an SM walks tiles of kTile 16-byte output vectors
// (16 KB) over the rows, grid-stride, so every block has the same
// stores to make whatever the skew; a thread loads its kUnroll vectors of
// a tile before it stores them, and stores each evict-first (each slot is
// written once). The run's start is arbitrary, so its offset from a
// 16-byte boundary, k ints, is one of four, the same for the whole row:
// a vector of data is cut from the two aligned source vectors it
// straddles (one where k = 0), both loaded evict-first; the second is the
// next thread's first, so the pair costs one read of the run from device
// memory (the L1 serves the other). The vector that holds the run's end
// is gathered by element; the rest of the row is zeros. Where C or the
// row length is not a multiple of 4, or a pointer is off a 16-byte
// boundary, every row is copied by element in the same tiles. Offsets
// within a row are 32-bit, a row's base 64-bit.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // 8 warps a block
constexpr int kBlocksPerSm = 4;  // 32 warps an SM, up to 64 registers
constexpr int kUnroll = 4;       // vectors (or ints) a thread takes a tile
constexpr int kTile = kThreads * kUnroll;

// The vector of data at ints k..k+3 of the aligned pair (lo, hi), k > 0.
__device__ __forceinline__ int4 cut(int4 lo, int4 hi, int k) {
  switch (k) {
    case 1: return make_int4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_int4(lo.z, lo.w, hi.x, hi.y);
    default: return make_int4(lo.w, hi.x, hi.y, hi.z);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ship_buckets_kernel(const int* __restrict__ words,
                        const int* __restrict__ starts,
                        int* __restrict__ out, int senders, int parts,
                        int n, int capacity, long long first,
                        int row_tiles, int vec, int by_sender) {
  // items a row: 16-byte vectors, or ints where vec is 1
  const unsigned items = vec == 4 ? (unsigned)capacity / 4 : capacity;
  const long long tiles = (long long)senders * parts * row_tiles;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    // d * P + s for the receivers, s * P + d for the senders
    const unsigned row = (unsigned)(t / row_tiles);
    const unsigned tile = (unsigned)(t - (long long)row * row_tiles);
    const unsigned major = row / (unsigned)parts;
    const unsigned minor = row - major * (unsigned)parts;
    const unsigned d = by_sender ? minor : major;
    const unsigned s = by_sender ? major : minor;
    const int* st = starts + (long long)s * (parts + 1);
    const long long begin = (long long)__ldg(st + d) + first;
    const long long left = (long long)__ldg(st + d + 1) - begin;
    const unsigned live =
        left <= 0 ? 0u : (unsigned)(left < capacity ? left : capacity);
    // read only below `live`, where it lies inside sender s's row
    const int* src = words + (long long)s * n + begin;
    int* dst = out + (long long)row * capacity;
    const unsigned j0 = tile * kTile + threadIdx.x;

    if (vec != 4) {
      int v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned c = j0 + u * kThreads;
        v[u] = c < live ? __ldcs(src + c) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned c = j0 + u * kThreads;
        if (c < items) __stcs(dst + c, v[u]);
      }
      continue;
    }
    const unsigned whole = live / 4;
    const int k = (int)(((uintptr_t)src >> 2) & 3);
    const int4* aligned = reinterpret_cast<const int4*>(src - k);
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned j = j0 + u * kThreads;
      v[u] = make_int4(0, 0, 0, 0);
      if (j < whole) {
        const int4 lo = __ldcs(aligned + j);
        v[u] = k == 0 ? lo : cut(lo, __ldcs(aligned + j + 1), k);
      } else if (j == whole && 4 * j < live) {  // the run's last vector
        int e[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * j + i < live) e[i] = __ldcs(src + 4 * j + i);
        v[u] = make_int4(e[0], e[1], e[2], e[3]);
      }
    }
    int4* to = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned j = j0 + u * kThreads;
      if (j < items) __stcs(to + j, v[u]);
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

// words: [senders, n] int32, each sender's words ordered by destination
// among `parts`; starts: [senders, parts + 1] int32; out: [parts,
// senders, capacity] int32 (the receivers' layout, senders == parts) or
// [senders, parts, capacity] where by_sender is 1, every slot written.
// first = r * capacity, round r's window start.
extern "C" int ship_buckets(const int* words, const int* starts, int* out,
                            int senders, int parts, int n, int capacity,
                            long long first, int by_sender, void* stream) {
  if (senders <= 0 || parts <= 0 || n < 0 || capacity <= 0 || first < 0
      || (by_sender != 0 && by_sender != 1)
      || (!by_sender && senders != parts))
    return (int)cudaErrorInvalidValue;
  const bool vec = capacity % 4 == 0 && n % 4 == 0
                   && (uintptr_t)words % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long items = vec ? capacity / 4 : capacity;
  const long long row_tiles = (items + kTile - 1) / kTile;
  const long long tiles = (long long)senders * parts * row_tiles;
  const long long most = (long long)sms * kBlocksPerSm;
  ship_buckets_kernel<<<(unsigned)(tiles < most ? tiles : most), kThreads,
                        0, (cudaStream_t)stream>>>(
      words, starts, out, senders, parts, n, capacity, first,
      (int)row_tiles, vec ? 4 : 1, by_sender);
  return (int)cudaGetLastError();
}

// What the card reports for kernel k of this source, in the order of its
// ops.py KERNELS: out = {static shared bytes, registers a thread, largest
// block, largest dynamic shared bytes} (cudaFuncGetAttributes). For the
// static analysis, which holds its launch plans against the card.
extern "C" int kernel_attributes(int k, int* out) {
  const void* const fns[] = {(const void*)ship_buckets_kernel};
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
