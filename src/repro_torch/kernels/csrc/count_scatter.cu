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
//   One block per (record tile of kTile, node). Each word goes to
//   out[base[t][d] + rank], rank = number of earlier records of the tile
//   with the same destination. The rank must be STABLE (the result has to
//   equal a stable argsort bit for bit), so it is not taken from an atomic.
//   The block works in four steps, with one barrier between each:
//   1. Stage: every thread issues all its loads of the tile's destinations
//      and words at once (16-byte loads when the row is aligned) and
//      stores them into shared memory in record order.
//   2. Rank: warp w takes the tile's w-th run of kWarpRecords records, 32
//      at a time in record order. __match_any_sync groups a slot's lanes by
//      destination, __popc(peers & lanemask_lt) ranks a lane among them,
//      and a per-warp counter per destination in shared memory carries the
//      rank from one slot to the next; each thread keeps (destination,
//      rank, word) of its kSlots records in registers.
//   3. Scan: for every destination at once, an 8-lane shuffle scan over the
//      warps' counters turns them into each warp's offset, and a block scan
//      over the destinations gives each destination's run in the tile.
//   4. Reorder and write: each record goes to its place in the tile's
//      destination order in shared memory, beside its output index; then
//      consecutive threads write consecutive places, so each destination's
//      run (about kTile / (P + 1) words) leaves as whole lines.
//   Every one of the n output slots is written exactly once: destinations
//   outside [0, num_dests) land nowhere, and the row's slots they leave
//   over at its end are zeroed, as the plain version leaves them.
//
// What bounds them: both are memory passes (K1 reads the destinations once;
// K2 reads words and destinations and writes the words once), so the card's
// 3.35 TB/s is the limit. The TPU workarounds of the Pallas kernels (one-hot
// MXU matmuls, triangular-matmul ranks, 16-bit word halves, the VMEM-resident
// OR-accumulated output and its slack tile) are gone: the card scatters
// directly. K2's design keeps its loads in flight together, spends a few
// barriers per kTile records, and writes long runs.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() after its launch. Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;    // records per tile (K1 and K2 must agree)
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRecords = kTile / kWarps;  // 512 records a warp ranks
constexpr int kSlots = kWarpRecords / 32;     // 16 records a lane holds
constexpr int kVec = kTile / 4 / kThreads;    // 4 16-byte loads an input
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile % (4 * kThreads) == 0, "tile of whole 16-byte loads");
static_assert(kWarps == 8, "the scan over warps runs in groups of 8 lanes");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__host__ __device__ inline size_t scatter_smem_bytes(int num_dests) {
  // staged dests / output indices, staged words / ordered words, per-warp
  // counters, the tile's bases and runs, the block scan's warp sums
  return sizeof(int) * (2 * (size_t)kTile + (size_t)kWarps * num_dests
                        + 2 * (size_t)num_dests + kWarps);
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

__global__ void __launch_bounds__(kThreads) scatter_tiles_kernel(
    const int* __restrict__ words, const int* __restrict__ dest,
    const int* __restrict__ base, int* __restrict__ out, long long n,
    int num_dests, int tiles) {
  extern __shared__ __align__(16) int smem[];
  int* sd = smem;                     // [kTile] dests, then output indices
  int* sw = sd + kTile;               // [kTile] words, then in dest order
  int* cnt = sw + kTile;              // [kWarps][num_dests] counts, offsets
  int* run = cnt + kWarps * num_dests;  // [num_dests] run start in the tile
  int* tbase = run + num_dests;       // [num_dests] base[t][d]
  int* part = tbase + num_dests;      // [kWarps] block scan's warp sums
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x;
  const int node = blockIdx.y;
  const long long row0 = (long long)node * n;
  const long long begin = (long long)tile * kTile;
  const int len = (int)min((long long)kTile, n - begin);
  const int* tile_base = base + ((long long)node * tiles + tile) * num_dests;

  // 1. stage the tile in record order (-1: no record)
  const int* gd = dest + row0 + begin;
  const int* gw = words + row0 + begin;
  if (len == kTile && ((uintptr_t)gd % 16) == 0 && ((uintptr_t)gw % 16) == 0) {
    int4 xd[kVec], xw[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      xd[u] = reinterpret_cast<const int4*>(gd)[u * kThreads + tid];
      xw[u] = reinterpret_cast<const int4*>(gw)[u * kThreads + tid];
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      reinterpret_cast<int4*>(sd)[u * kThreads + tid] = xd[u];
      reinterpret_cast<int4*>(sw)[u * kThreads + tid] = xw[u];
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kTile; i += kThreads) {
      sd[i] = i < len ? gd[i] : -1;
      sw[i] = i < len ? gw[i] : 0;
    }
  }
  for (int k = tid; k < kWarps * num_dests; k += kThreads) cnt[k] = 0;
  for (int d = tid; d < num_dests; d += kThreads) tbase[d] = tile_base[d];
  __syncthreads();

  // 2. stable ranks within the warp's records, slot by slot in record order
  int* wcnt = cnt + warp * num_dests;
  int held[kSlots];  // destination << 16 | rank in the warp, or -1
  int word[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = warp * kWarpRecords + k * 32 + lane;
    int d = sd[i];
    word[k] = sw[i];
    if (d < 0 || d >= num_dests) d = -1;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = d >= 0 ? wcnt[d] : 0;
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) wcnt[d] = before + __popc(peers);
    __syncwarp();
    held[k] = d >= 0 ? (d << 16) | (before + __popc(peers & lanemask_lt()))
                     : -1;
  }
  __syncthreads();

  // 3a. every destination's counts over the warps -> each warp's offset
  // (groups of kWarps lanes, one destination a group)
  for (int i0 = 0; i0 < kWarps * num_dests; i0 += kThreads) {
    const int i = i0 + tid;
    const bool in = i < kWarps * num_dests;
    const int d = i / kWarps, w = i % kWarps;
    const int c = in ? cnt[w * num_dests + d] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off, kWarps);
      if (w >= off) incl += y;
    }
    if (in) {
      cnt[w * num_dests + d] = incl - c;
      if (w == kWarps - 1) run[d] = incl;  // the tile's count of d
    }
  }
  __syncthreads();
  // 3b. exclusive scan of the tile's counts over destinations: each thread
  // a block of consecutive destinations, a shuffle scan in the warp, the
  // warps' sums in part[]
  const int per = (num_dests + kThreads - 1) / kThreads;
  const int lo = min(num_dests, tid * per);
  const int hi = min(num_dests, lo + per);
  int mine = 0;
  for (int d = lo; d < hi; ++d) mine += run[d];
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int start = incl - mine, valid = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) start += part[w];
    valid += part[w];
  }
  for (int d = lo; d < hi; ++d) {
    const int c = run[d];
    run[d] = start;
    start += c;
  }
  __syncthreads();

  // 4. each record to its place in destination order, beside its output
  // index; then the places in order, consecutive threads on consecutive
  // output slots of a run
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (held[k] >= 0) {
      const int d = held[k] >> 16;
      const int off = cnt[warp * num_dests + d] + (held[k] & 0xffff);
      const int place = run[d] + off;
      sw[place] = word[k];
      sd[place] = tbase[d] + off;
    }
  }
  __syncthreads();
  int* row_out = out + row0;
#pragma unroll 4
  for (int p = tid; p < valid; p += kThreads) row_out[sd[p]] = sw[p];
  // records whose destination is out of range leave the row's last slots
  // unwritten; the last tile's block zeroes them, as the plain version
  // leaves them (the row's count of valid records is where the last
  // destination's run ends: base[T-1][D-1] plus this tile's count of D-1)
  if (tile == tiles - 1) {
    const int last = num_dests - 1;
    const long long counted = (long long)tbase[last] + (valid - run[last]);
    for (long long i = counted + tid; i < n; i += kThreads) row_out[i] = 0;
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
  const size_t shmem = scatter_smem_bytes(num_dests);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(tiles, num_nodes);
  scatter_tiles_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      words, dest, base, out, n, num_dests, tiles);
  return (int)cudaGetLastError();
}

extern "C" int count_scatter_tile() { return kTile; }
