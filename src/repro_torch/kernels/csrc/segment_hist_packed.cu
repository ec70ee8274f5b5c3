// Fused unpack + ownership filter + histogram over shuffled packed words,
// for Hopper (sm_90a).
//
// K3 replaces src/repro/kernels/segment_hist/segment_hist.py:_packed_kernel.
// Row r of the [rows, L] words holds the words node `first_node + r` of P
// received, and adds into hist[r] of the [rows, S_local, W, 2] output (the
// Pallas kernel is told its node as `my_index`; one process holds all P
// rows, first_node 0, a process of a gang the rows of its own nodes). A
// word (site<<8 | week<<2 | mark<<1 | valid, an int32 bit pattern) is read
// as unsigned, so the shifts are logical and a site >= 2^23 (bit 31 set)
// unpacks correctly. A word counts when it is valid, owned by the row's
// node (site % P == node), inside the node's block (site / P < S_local) and
// inside the week range: 1 into [site / P][week][0] and the mark bit into
// [...][1]. The caller zeroes hist.
//
// What bounds it: the words are read once (a memory pass), but every word
// is a scattered integer atomic, and MalGen's power law makes a few
// addresses hot: with alpha = 1.2 over 100,000 sites the top site draws
// about a fifth of all records, and every one of them lands in the row of
// the one node that owns it. Atomics on one address serialise in L2. The
// design (as K4's in segment_hist.cu) takes the hot sites off the global
// atomics:
//
// 1. hot_sites_kernel (one block a row) counts the local sites of `sample`
//    evenly spaced words of its row in a shared-memory hash table and
//    writes hot[row] = {h, site_0, ..., site_63}: the local sites seen at
//    least `threshold` times, most frequent first (ties by site), -1 after
//    the h-th. Hot sites differ per row, since each node owns other sites.
//    The host sets the threshold (segment_hist/ops.py: hist_geometry).
// 2. packed_hist_kernel runs `blocks` blocks (two an SM) that take
//    chunks of 4,096 words from a counter in node-major order, so the rows
//    in flight at any time are one, or two at a row's end, and their slices
//    of the histogram stay in L2. While its chunks stay in one row, a
//    block keeps that row's first hot_capacity hot sites in an
//    open-addressed site -> slot table in shared memory. A word on a hot
//    site adds to the block's private [hot_capacity, W, 2] tile with a
//    shared-memory atomic; every other word keeps its global atomic. When
//    the block's next chunk lies in another row, it adds each nonzero tile
//    entry to the histogram with one global atomic and clears the tile.
//
// The hot list is only a hint: a site missing from it is counted by the
// global path, so the result is exact for any input and any list. The
// words are read with the streaming cache hint, so they do not evict the
// histogram from L2.
//
// Warp aggregation of equal cells (__match_any_sync, one atomic a group)
// is left out: MalGen's records are in no site or week order, so a warp
// rarely holds two records of one cell, and aggregation alone saved little
// of the first version's time (PERF.md, section 6).
//
// Plain C interface, loaded with ctypes. Each entry point returns
// cudaGetLastError() after its launches; nothing is allocated here (the
// caller passes hist, the [P, 65] int32 hot list and the chunk counter).

#include <cuda_runtime.h>

namespace {

constexpr int kHot = 64;            // hot sites a row can list
constexpr int kCandidates = 256;    // sites the threshold lets pass, at most
constexpr int kSample = 8192;       // words sampled a row, at most
constexpr int kSelectThreads = 1024;
constexpr int kSelectSlots = 16384; // sample table: load <= 1/2
constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kChunk = 2 * kUnroll * kThreads;  // words a block takes
constexpr int kTableSlots = 1024;   // site -> tile slot: load <= 1/16
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ unsigned mix(int key) {
  return (unsigned)key * 2654435761u;
}

// The word's local site if node `node` counts it, else -1; its week.
__device__ __forceinline__ int word_site(unsigned w, unsigned node,
                                         unsigned num_parts, int s_local,
                                         int num_weeks, int* week) {
  const unsigned site = w >> 8;
  *week = (int)((w >> 2) & 0x3Fu);
  const unsigned local = site / num_parts;
  if (!(w & 1u) || site - local * num_parts != node ||
      local >= (unsigned)s_local || *week >= num_weeks)
    return -1;
  return (int)local;
}

__global__ void __launch_bounds__(kSelectThreads)
hot_sites_kernel(const int* __restrict__ words, int* __restrict__ hot,
                 long long len, int num_parts, int first_node, int s_local,
                 int num_weeks, int sample, int threshold) {
  extern __shared__ int2 table[];           // {site or -1, count}
  __shared__ int cand_site[kCandidates];
  __shared__ int cand_count[kCandidates];
  __shared__ int num_cand;
  const int tid = threadIdx.x;
  const unsigned row = blockIdx.x;
  const unsigned node = (unsigned)first_node + row;
  for (int i = tid; i < kSelectSlots; i += kSelectThreads)
    table[i] = make_int2(-1, 0);
  if (tid == 0) num_cand = 0;
  __syncthreads();
  for (int k = tid; k < sample; k += kSelectThreads) {
    const long long r = (long long)row * len + (long long)k * len / sample;
    int week;
    const int s = word_site((unsigned)words[r], node, (unsigned)num_parts,
                            s_local, num_weeks, &week);
    if (s < 0) continue;
    unsigned h = mix(s) >> 18;
    while (true) {
      const int prev = atomicCAS(&table[h].x, -1, s);
      if (prev == -1 || prev == s) {
        atomicAdd(&table[h].y, 1);
        break;
      }
      h = (h + 1) & (kSelectSlots - 1);
    }
  }
  __syncthreads();
  for (int i = tid; i < kSelectSlots; i += kSelectThreads) {
    const int2 e = table[i];
    if (e.x >= 0 && e.y >= threshold) {
      const int c = atomicAdd(&num_cand, 1);
      if (c < kCandidates) {
        cand_site[c] = e.x;
        cand_count[c] = e.y;
      }
    }
  }
  __syncthreads();
  const int nc = min(num_cand, kCandidates);
  int* out = hot + (long long)row * (kHot + 1);
  if (tid < nc) {
    const int s = cand_site[tid], c = cand_count[tid];
    int rank = 0;
    for (int j = 0; j < nc; ++j)
      rank += cand_count[j] > c || (cand_count[j] == c && cand_site[j] < s);
    if (rank < kHot) out[1 + rank] = s;
  }
  const int nh = min(nc, kHot);
  if (tid >= nh && tid < kHot) out[1 + tid] = -1;
  if (tid == 0) out[0] = nh;
}

__global__ void __launch_bounds__(kThreads)
packed_hist_kernel(const int* __restrict__ words,
                   const int* __restrict__ hot, int* __restrict__ hist,
                   unsigned* __restrict__ work, long long len, int num_nodes,
                   int num_parts, int first_node, int s_local, int num_weeks,
                   int hot_capacity) {
  extern __shared__ int smem[];
  int2* table = reinterpret_cast<int2*>(smem);          // {site, slot}
  int* tile = smem + 2 * kTableSlots;                   // [slot][week][2]
  __shared__ unsigned next[2];        // the chunk this block takes next
  const int tid = threadIdx.x;
  const long long per_row = (len + kChunk - 1) / kChunk;
  const long long chunks = per_row * num_nodes;
  for (int i = tid; i < kTableSlots; i += kThreads)
    table[i] = make_int2(-1, 0);
  for (int i = tid; i < hot_capacity * num_weeks * 2; i += kThreads)
    tile[i] = 0;
  if (tid == 0) next[0] = atomicAdd(work, 1u);
  int node = -1, nh = 0;
  unsigned mine = 0;                  // this thread's table entry
  const int* row_hot = hot;
  int* row_hist = hist;
  for (int k = 0;; k ^= 1) {
    __syncthreads();                  // next[k] is set, the last chunk done
    const long long c = next[k];
    unsigned after = 0;
    if (tid == 0 && c < chunks) after = atomicAdd(work, 1u);
    const int row = c < chunks ? (int)(c / per_row) : num_nodes;
    if (row != node) {
      if (node >= 0) {                // add the tile to the histogram
        for (int i = tid; i < nh * num_weeks * 2; i += kThreads) {
          const int v = tile[i];
          if (v == 0) continue;
          tile[i] = 0;
          const int slot = i / (num_weeks * 2);
          atomicAdd(row_hist + (long long)row_hot[1 + slot] * num_weeks * 2
                        + (i - slot * num_weeks * 2), v);
        }
        if (tid < nh) table[mine] = make_int2(-1, 0);
      }
      if (row == num_nodes) break;
      __syncthreads();                // the table and the tile are clear
      node = row;
      row_hot = hot + (long long)node * (kHot + 1);
      row_hist = hist + (long long)node * s_local * num_weeks * 2;
      nh = min(row_hot[0], hot_capacity);
      if (tid < nh) {
        const int s = row_hot[1 + tid];
        mine = mix(s) >> 22;
        while (atomicCAS(&table[mine].x, -1, s) != -1)
          mine = (mine + 1) & (kTableSlots - 1);
        table[mine].y = tid;
      }
      __syncthreads();
    }
    const long long lo = (c - (long long)row * per_row) * kChunk;
    const long long hi = min(len, lo + kChunk);
    const int* row_words = words + (long long)row * len;
    for (long long i0 = lo + tid; i0 < hi; i0 += kUnroll * kThreads) {
      unsigned wd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        wd[u] = i < hi ? (unsigned)__ldcs(row_words + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int w;
        const int s = word_site(wd[u], (unsigned)(first_node + row),
                                (unsigned)num_parts, s_local, num_weeks, &w);
        if (s < 0) continue;
        const bool m = (wd[u] >> 1) & 1u;
        int slot = -1;
        if (nh > 0) {
          unsigned h = mix(s) >> 22;
          int2 e = table[h];
          while (e.x != s && e.x != -1) {
            h = (h + 1) & (kTableSlots - 1);
            e = table[h];
          }
          if (e.x == s) slot = e.y;
        }
        if (slot >= 0) {              // shared memory: the block's tile
          int* cell = tile + (slot * num_weeks + w) * 2;
          atomicAdd(cell, 1);
          if (m) atomicAdd(cell + 1, 1);
        } else {                      // global memory: the histogram
          int* cell = row_hist + ((long long)s * num_weeks + w) * 2;
          atomicAdd(cell, 1);
          if (m) atomicAdd(cell + 1, 1);
        }
      }
    }
    if (tid == 0) next[k ^ 1] = after;
  }
}

bool bad_geometry(long long len, int num_nodes, int num_parts,
                  int first_node, int blocks, int hot_capacity, int sample,
                  int num_weeks) {
  const long long chunks = (len + kChunk - 1) / kChunk * num_nodes;
  return num_parts < 1 || first_node < 0 ||
         (long long)first_node + num_nodes > num_parts || blocks < 1 ||
         chunks + blocks >= (1ll << 32) ||
         hot_capacity < 0 || hot_capacity > kHot || sample < 0 ||
         sample > kSample || num_weeks < 1 || num_weeks > 64 ||
         (long long)2 * kTableSlots * 4 +
                 (long long)hot_capacity * num_weeks * 8 > kStaticSmem;
}

int launch_hot_sites(const int* words, int* hot, long long len,
                     int num_nodes, int num_parts, int first_node,
                     int s_local, int num_weeks, int sample, int threshold,
                     cudaStream_t stream) {
  const int smem = kSelectSlots * (int)sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      hot_sites_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  hot_sites_kernel<<<num_nodes, kSelectThreads, smem, stream>>>(
      words, hot, len, num_parts, first_node, s_local, num_weeks, sample,
      threshold);
  return (int)cudaGetLastError();
}

int launch_tiled(const int* words, const int* hot, int* hist, unsigned* work,
                 long long len, int num_nodes, int num_parts, int first_node,
                 int s_local, int num_weeks, int blocks, int hot_capacity,
                 cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(work, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * kTableSlots * 4 + hot_capacity * num_weeks * 8;
  packed_hist_kernel<<<blocks, kThreads, smem, stream>>>(
      words, hot, hist, work, len, num_nodes, num_parts, first_node, s_local,
      num_weeks, hot_capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// The hot list alone: hot[rows][65] from `sample` words a row; row r is
// node first_node + r of num_parts.
extern "C" int packed_hist_hot_sites(const int* words, int* hot, long long len,
                                     int num_nodes, int num_parts,
                                     int first_node, int s_local,
                                     int num_weeks, int sample, int threshold,
                                     void* stream) {
  if (num_nodes == 0) return (int)cudaGetLastError();
  if (bad_geometry(len, num_nodes, num_parts, first_node, 1, 0, sample,
                   num_weeks) ||
      (len > 0 && sample == 0))
    return (int)cudaErrorInvalidValue;
  return launch_hot_sites(words, hot, len, num_nodes, num_parts, first_node,
                          s_local, num_weeks, sample, threshold,
                          (cudaStream_t)stream);
}

// The histogram given a hot list (any list: exact for all of them). work
// is scratch of one unsigned int.
extern "C" int packed_hist_tiled(const int* words, const int* hot, int* hist,
                                 unsigned* work, long long len, int num_nodes,
                                 int num_parts, int first_node, int s_local,
                                 int num_weeks, int blocks, int hot_capacity,
                                 void* stream) {
  if (len == 0 || num_nodes == 0) return (int)cudaGetLastError();
  if (bad_geometry(len, num_nodes, num_parts, first_node, blocks,
                   hot_capacity, 0, num_weeks))
    return (int)cudaErrorInvalidValue;
  return launch_tiled(words, hot, hist, work, len, num_nodes, num_parts,
                      first_node, s_local, num_weeks, blocks, hot_capacity,
                      (cudaStream_t)stream);
}

// The histogram: the hot list from a sample of each row, then the tiled
// pass. hot is scratch of [P][65] ints, work of one unsigned int.
extern "C" int packed_hist(const int* words, int* hist, int* hot,
                           unsigned* work, long long len, int num_nodes,
                           int num_parts, int first_node, int s_local,
                           int num_weeks, int blocks, int hot_capacity,
                           int sample, int threshold, void* stream) {
  if (len == 0 || num_nodes == 0) return (int)cudaGetLastError();
  if (sample < 1 || bad_geometry(len, num_nodes, num_parts, first_node,
                                 blocks, hot_capacity, sample, num_weeks))
    return (int)cudaErrorInvalidValue;
  const int err = launch_hot_sites(words, hot, len, num_nodes, num_parts,
                                   first_node, s_local, num_weeks, sample,
                                   threshold, (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_tiled(words, hot, hist, work, len, num_nodes, num_parts,
                      first_node, s_local, num_weeks, blocks, hot_capacity,
                      (cudaStream_t)stream);
}
