// (site, week, mark, valid) columns -> (total, marked) histogram, for Hopper
// (sm_90a).
//
// K4 replaces src/repro/kernels/segment_hist/segment_hist.py:_kernel, the
// local combine of the streams, sphere and combiner backends and the
// reducer of the 4-column exchange. Row `node` of each [P, n] column adds
// into hist[node] of the [P, S, W, 2] output. A record counts when it is
// valid and its rebased site (site - site_offset, int32 wrap) and its week
// are in range: 1 into [site][week][0] and, when mark > 0, 1 into [...][1].
// The caller zeroes hist.
//
// Mark semantics: `mark > 0` counts one, as segment_hist_ref and the
// packed word do. The TPU kernel adds the raw mark value instead; the two
// agree on MalGen's marks, which are 0 or 1.
//
// What bounds it: the columns are read once (13 bytes a record), but every
// record is a scattered integer atomic. MalGen draws sites from a power law
// (the top site gets about a fifth of the records), and atomics on one
// address serialise in L2, so the few hot sites, not the bytes, set the
// time. The design takes those sites off the global atomics:
//
// 1. hot_sites_kernel (one block a row) counts the sites of `sample`
//    evenly spaced records of its row in a shared-memory hash table and
//    writes hot[row] = {h, site_0, ..., site_63}: the sites seen at least
//    `threshold` times, most frequent first (ties by site), -1 after the
//    h-th. The host sets the threshold so that at most 256 sites can pass
//    and a passing site puts about two records into each of its cells per
//    block and row (segment_hist/ops.py: hist_geometry).
// 2. segment_hist_kernel runs `blocks` blocks (two an SM) that take
//    chunks of 4,096 records from a counter in node-major order (all of
//    row 0's chunks, then row 1's, ...), so the rows in flight at any time
//    are one, or two at a row's end: their slices of the histogram (41.6
//    MB a row at 100,000 sites) stay in the 50 MB L2. With a fixed share
//    of every row per block instead, fast blocks run a row ahead of slow
//    ones, two or three slices compete for L2, and uniform sites ran
//    slower than the first version's one-thread-a-record launch. While its
//    chunks stay in one row, a block keeps that row's first hot_capacity
//    hot sites in an open-addressed site -> slot table in shared memory. A
//    record on a hot site adds to the block's private [hot_capacity, W, 2]
//    tile with a shared-memory atomic; every other record keeps its global
//    atomic. When the block's next chunk lies in another row, it adds each
//    nonzero tile entry to the histogram with one global atomic and clears
//    the tile.
//
// The hot list is only a hint: a site missing from it is counted by the
// global path, so the result is exact for any input and any list. Integer
// addition does not depend on order. The input columns are read with the
// streaming cache hint, so they do not evict the histogram from L2.
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
constexpr int kSample = 8192;       // records sampled a row, at most
constexpr int kSelectThreads = 1024;
constexpr int kSelectSlots = 16384; // sample table: load <= 1/2
constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kChunk = 2 * kUnroll * kThreads;  // records a block takes
constexpr int kTableSlots = 1024;   // site -> tile slot: load <= 1/16
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ unsigned mix(int key) {
  return (unsigned)key * 2654435761u;
}

// The record's rebased site, or -1 when it counts nowhere.
__device__ __forceinline__ int record_site(int site, int week,
                                           unsigned char valid,
                                           int num_sites, int num_weeks,
                                           int site_offset) {
  const int s = (int)((unsigned)site - (unsigned)site_offset);
  if (!valid || s < 0 || s >= num_sites || week < 0 || week >= num_weeks)
    return -1;
  return s;
}

__global__ void __launch_bounds__(kSelectThreads)
hot_sites_kernel(const int* __restrict__ site, const int* __restrict__ week,
                 const unsigned char* __restrict__ valid,
                 int* __restrict__ hot, long long n, int num_sites,
                 int num_weeks, int site_offset, int sample, int threshold) {
  extern __shared__ int2 table[];           // {site or -1, count}
  __shared__ int cand_site[kCandidates];
  __shared__ int cand_count[kCandidates];
  __shared__ int num_cand;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  for (int i = tid; i < kSelectSlots; i += kSelectThreads)
    table[i] = make_int2(-1, 0);
  if (tid == 0) num_cand = 0;
  __syncthreads();
  for (int k = tid; k < sample; k += kSelectThreads) {
    const long long r = row * n + (long long)k * n / sample;
    const int s = record_site(site[r], week[r], valid[r], num_sites,
                              num_weeks, site_offset);
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
  int* out = hot + row * (kHot + 1);
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
segment_hist_kernel(const int* __restrict__ site,
                    const int* __restrict__ week,
                    const int* __restrict__ mark,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ hot, int* __restrict__ hist,
                    unsigned* __restrict__ work, long long n, int num_nodes,
                    int num_sites, int num_weeks, int site_offset,
                    int hot_capacity) {
  extern __shared__ int smem[];
  int2* table = reinterpret_cast<int2*>(smem);          // {site, slot}
  int* tile = smem + 2 * kTableSlots;                   // [slot][week][2]
  __shared__ unsigned next[2];        // the chunk this block takes next
  const int tid = threadIdx.x;
  const long long per_row = (n + kChunk - 1) / kChunk;
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
      row_hist = hist + (long long)node * num_sites * num_weeks * 2;
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
    const long long hi = min(n, lo + kChunk);
    const long long base = (long long)row * n;
    for (long long i0 = lo + tid; i0 < hi; i0 += kUnroll * kThreads) {
      int s[kUnroll], w[kUnroll];
      bool m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        s[u] = -1;
        w[u] = 0;
        m[u] = false;
        if (i < hi) {
          const long long r = base + i;
          w[u] = __ldcs(week + r);
          m[u] = __ldcs(mark + r) > 0;
          s[u] = record_site(__ldcs(site + r), w[u], __ldcs(valid + r),
                             num_sites, num_weeks, site_offset);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s[u] < 0) continue;
        int slot = -1;
        if (nh > 0) {
          unsigned h = mix(s[u]) >> 22;
          int2 e = table[h];
          while (e.x != s[u] && e.x != -1) {
            h = (h + 1) & (kTableSlots - 1);
            e = table[h];
          }
          if (e.x == s[u]) slot = e.y;
        }
        if (slot >= 0) {              // shared memory: the block's tile
          int* cell = tile + (slot * num_weeks + w[u]) * 2;
          atomicAdd(cell, 1);
          if (m[u]) atomicAdd(cell + 1, 1);
        } else {                      // global memory: the histogram
          int* cell = row_hist + ((long long)s[u] * num_weeks + w[u]) * 2;
          atomicAdd(cell, 1);
          if (m[u]) atomicAdd(cell + 1, 1);
        }
      }
    }
    if (tid == 0) next[k ^ 1] = after;
  }
}

bool bad_geometry(long long n, int num_nodes, int blocks, int hot_capacity,
                  int sample, int num_weeks) {
  const long long chunks = (n + kChunk - 1) / kChunk * num_nodes;
  return blocks < 1 || chunks + blocks >= (1ll << 32) || hot_capacity < 0 ||
         hot_capacity > kHot || sample < 0 || sample > kSample ||
         (long long)2 * kTableSlots * 4 +
                 (long long)hot_capacity * num_weeks * 8 > kStaticSmem;
}

int launch_hot_sites(const int* site, const int* week,
                     const unsigned char* valid, int* hot, long long n,
                     int num_nodes, int num_sites, int num_weeks,
                     int site_offset, int sample, int threshold,
                     cudaStream_t stream) {
  const int smem = kSelectSlots * (int)sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      hot_sites_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  hot_sites_kernel<<<num_nodes, kSelectThreads, smem, stream>>>(
      site, week, valid, hot, n, num_sites, num_weeks, site_offset, sample,
      threshold);
  return (int)cudaGetLastError();
}

int launch_tiled(const int* site, const int* week, const int* mark,
                 const unsigned char* valid, const int* hot, int* hist,
                 unsigned* work, long long n, int num_nodes, int num_sites,
                 int num_weeks, int site_offset, int blocks, int hot_capacity,
                 cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(work, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * kTableSlots * 4 + hot_capacity * num_weeks * 8;
  segment_hist_kernel<<<blocks, kThreads, smem, stream>>>(
      site, week, mark, valid, hot, hist, work, n, num_nodes, num_sites,
      num_weeks, site_offset, hot_capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// The hot list alone: hot[P][65] from `sample` records a row.
extern "C" int segment_hist_hot_sites(const int* site, const int* week,
                                      const unsigned char* valid, int* hot,
                                      long long n, int num_nodes,
                                      int num_sites, int num_weeks,
                                      int site_offset, int sample,
                                      int threshold, void* stream) {
  if (num_nodes == 0) return (int)cudaGetLastError();
  if (bad_geometry(n, num_nodes, 1, 0, sample, num_weeks) ||
      (n > 0 && sample == 0))
    return (int)cudaErrorInvalidValue;
  return launch_hot_sites(site, week, valid, hot, n, num_nodes, num_sites,
                          num_weeks, site_offset, sample, threshold,
                          (cudaStream_t)stream);
}

// The histogram given a hot list (any list: exact for all of them). work
// is scratch of one unsigned int.
extern "C" int segment_hist_tiled(const int* site, const int* week,
                                  const int* mark, const unsigned char* valid,
                                  const int* hot, int* hist, unsigned* work,
                                  long long n, int num_nodes, int num_sites,
                                  int num_weeks, int site_offset, int blocks,
                                  int hot_capacity, void* stream) {
  if (n == 0 || num_nodes == 0) return (int)cudaGetLastError();
  if (bad_geometry(n, num_nodes, blocks, hot_capacity, 0, num_weeks))
    return (int)cudaErrorInvalidValue;
  return launch_tiled(site, week, mark, valid, hot, hist, work, n, num_nodes,
                      num_sites, num_weeks, site_offset, blocks, hot_capacity,
                      (cudaStream_t)stream);
}

// The histogram: the hot list from a sample of each row, then the tiled
// pass. hot is scratch of [P][65] ints, work of one unsigned int.
extern "C" int segment_hist(const int* site, const int* week, const int* mark,
                            const unsigned char* valid, int* hist, int* hot,
                            unsigned* work, long long n, int num_nodes,
                            int num_sites, int num_weeks, int site_offset,
                            int blocks, int hot_capacity, int sample,
                            int threshold, void* stream) {
  if (n == 0 || num_nodes == 0) return (int)cudaGetLastError();
  if (sample < 1 ||
      bad_geometry(n, num_nodes, blocks, hot_capacity, sample, num_weeks))
    return (int)cudaErrorInvalidValue;
  const int err = launch_hot_sites(site, week, valid, hot, n, num_nodes,
                                   num_sites, num_weeks, site_offset, sample,
                                   threshold, (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_tiled(site, week, mark, valid, hot, hist, work, n, num_nodes,
                      num_sites, num_weeks, site_offset, blocks, hot_capacity,
                      (cudaStream_t)stream);
}

// What the card reports for kernel k of this source, in the order of its
// ops.py KERNELS: out = {static shared bytes, registers a thread, largest
// block, largest dynamic shared bytes} (cudaFuncGetAttributes). For the
// static analysis, which holds its launch plans against the card.
extern "C" int kernel_attributes(int k, int* out) {
  const void* const fns[] = {
      (const void*)hot_sites_kernel,
      (const void*)segment_hist_kernel};
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
