// Stable counting sort of packed shuffle words by destination, for Hopper
// (sm_90a). Two kernels, batched over the P nodes (blockIdx.y = node):
//
// K1 count_tiles_kernel
//   Replaces src/repro/kernels/count_scatter/count_scatter.py:_count_kernel.
//   One block per (record tile, node). The P+1 destination counters live in
//   shared memory and are bumped with shared int32 atomicAdd; integer
//   addition does not depend on order, so the per-tile histogram is exact.
//   Output: int32 counts[P][T][P+1]. The exclusive prefix sums over
//   destinations and over tiles are torch glue in ops.py, as they are jnp
//   glue in the JAX package.
//
// K2 scatter_tiles_kernel
//   Replaces src/repro/kernels/count_scatter/count_scatter.py:_scatter_kernel.
//   One block per (record tile, node). Each word goes to
//   out[base[t][d] + rank], rank = number of earlier records of the tile
//   with the same destination. The rank must be STABLE (the result has to
//   equal a stable argsort bit for bit), so it is not taken from an atomic:
//   inside a warp __match_any_sync groups the lanes by destination and
//   __popc(peers & lanemask_lt) ranks a lane among its peers; the per-warp
//   group sizes go to shared memory and are scanned across the warps in
//   warp order; a per-destination running offset carries the rank from one
//   256-record chunk of the tile to the next. Every one of the n output
//   slots is written exactly once.
//
// What bounds them: both are memory passes (K1 reads the destinations once;
// K2 reads words and destinations and writes the words once), so the card's
// 3.35 TB/s is the limit. The TPU workarounds of the Pallas kernels (one-hot
// MXU matmuls, triangular-matmul ranks, 16-bit word halves, the VMEM-resident
// OR-accumulated output and its slack tile) are gone: the card scatters
// directly. Loads are coalesced (consecutive lanes, consecutive records);
// K2's stores land in at most P+1 contiguous runs per chunk.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() after its launch. Nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;    // records per tile (K1 and K2 must agree)
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void count_tiles_kernel(const int* __restrict__ dest,
                                   int* __restrict__ counts, long long n,
                                   int num_dests, int tiles) {
  extern __shared__ int cnt[];  // [num_dests]
  const int tile = blockIdx.x;
  const int node = blockIdx.y;
  for (int d = threadIdx.x; d < num_dests; d += kThreads) cnt[d] = 0;
  __syncthreads();
  const int* row = dest + (long long)node * n;
  const long long begin = (long long)tile * kTile;
  const long long end = min(begin + kTile, n);
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const int d = row[i];
    if (d >= 0 && d < num_dests) atomicAdd(&cnt[d], 1);
  }
  __syncthreads();
  int* out = counts + ((long long)node * tiles + tile) * num_dests;
  for (int d = threadIdx.x; d < num_dests; d += kThreads) out[d] = cnt[d];
}

__global__ void scatter_tiles_kernel(const int* __restrict__ words,
                                     const int* __restrict__ dest,
                                     const int* __restrict__ base,
                                     int* __restrict__ out, long long n,
                                     int num_dests, int tiles) {
  extern __shared__ int smem[];
  int* running = smem;                    // [num_dests] next free slot
  int* warp_off = smem + num_dests;       // [kWarps][num_dests]
  const int tile = blockIdx.x;
  const int node = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = (long long)node * n;
  const int* tile_base = base + ((long long)node * tiles + tile) * num_dests;
  for (int d = threadIdx.x; d < num_dests; d += kThreads)
    running[d] = tile_base[d];

  const long long begin = (long long)tile * kTile;
  for (int chunk = 0; chunk < kTile; chunk += kThreads) {
    for (int k = threadIdx.x; k < kWarps * num_dests; k += kThreads)
      warp_off[k] = 0;
    __syncthreads();  // running initialised / previous chunk done; zeroed

    const long long i = begin + chunk + threadIdx.x;
    const bool in = i < n;
    const int d = in ? dest[row0 + i] : -1;
    const bool ok = in && d >= 0 && d < num_dests;
    const unsigned peers = __match_any_sync(kFull, ok ? d : -1);
    const int rank = __popc(peers & lanemask_lt());
    if (ok && lane == __ffs(peers) - 1) warp_off[warp * num_dests + d] =
        __popc(peers);
    __syncthreads();

    // exclusive scan of the per-warp group sizes, in warp order
    for (int dd = threadIdx.x; dd < num_dests; dd += kThreads) {
      int s = running[dd];
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_off[w * num_dests + dd];
        warp_off[w * num_dests + dd] = s;
        s += c;
      }
      running[dd] = s;
    }
    __syncthreads();

    if (ok) out[row0 + warp_off[warp * num_dests + d] + rank] =
        words[row0 + i];
    __syncthreads();  // warp_off is reused by the next chunk
  }
}

}  // namespace

extern "C" int count_tiles(const int* dest, int* counts, long long n,
                           int num_nodes, int num_dests, int tiles,
                           void* stream) {
  dim3 grid(tiles, num_nodes);
  const size_t shmem = sizeof(int) * num_dests;
  count_tiles_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      dest, counts, n, num_dests, tiles);
  return (int)cudaGetLastError();
}

extern "C" int scatter_tiles(const int* words, const int* dest,
                             const int* base, int* out, long long n,
                             int num_nodes, int num_dests, int tiles,
                             void* stream) {
  dim3 grid(tiles, num_nodes);
  const size_t shmem = sizeof(int) * num_dests * (1 + kWarps);
  scatter_tiles_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      words, dest, base, out, n, num_dests, tiles);
  return (int)cudaGetLastError();
}

extern "C" int count_scatter_tile() { return kTile; }
