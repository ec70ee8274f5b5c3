// The first designs of K2 (the stable scatter, with K1 at its tile of 1,024
// records), K5 (the masked window ratio), K6 (the power-law sampler) and
// K7 (the MalStone B finalizer), kept as yardsticks: each is timed beside
// the design in src/repro_torch/kernels/csrc/ on the same inputs in the
// same process (chip_smoke.py, tools/kernel_turns.py). They are never
// called by the port. See count_scatter.cu, windowed_ratio_masked.cu,
// powerlaw_sample.cu and windowed_ratio.cu there for what each design
// does.
//
// K2, first design: one block per 1,024-record tile, 256 threads, four
// chunks of 256 records, each chunk with four barriers and a cross-warp
// scan of the per-warp group sizes by one thread per destination.
// K5, first design: one thread per site, 128 sites a block; for each group
// of 16 queries a thread walks every week with 32 predicated adds.
// K6, first design: one thread per draw, 256 threads a block, a binary
// search of ceil(log2(S + 1)) dependent loads over the whole CDF.
// K7, first design: one thread per site, 128 sites a block; the block
// stages its rows in shared memory, each thread scans its row in place,
// and the block writes the three outputs, with barriers between phases.

#include <cuda_runtime.h>

namespace k2_first {

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

}  // namespace k2_first

namespace k5_first {

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

}  // namespace k5_first

namespace k6_first {

constexpr int kThreads = 256;

__global__ void powerlaw_sample_kernel(const float* __restrict__ u,
                                       const float* __restrict__ cdf,
                                       int* __restrict__ out, long long n,
                                       int num_sites) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = u[i];
  if (x != x) {  // NaN
    out[i] = num_sites - 1;
    return;
  }
  int lo = 0, hi = num_sites;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cdf + mid) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[i] = lo < num_sites ? lo : num_sites - 1;
}

}  // namespace k6_first

namespace k7_first {

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

}  // namespace k7_first

using namespace k2_first;

extern "C" int count_tiles_first(const int* dest, int* counts, long long n,
                                 int num_nodes, int num_dests, int tiles,
                                 void* stream) {
  dim3 grid(tiles, num_nodes);
  const size_t shmem = sizeof(int) * num_dests;
  count_tiles_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      dest, counts, n, num_dests, tiles);
  return (int)cudaGetLastError();
}

extern "C" int scatter_tiles_first(const int* words, const int* dest,
                                   const int* base, int* out, long long n,
                                   int num_nodes, int num_dests, int tiles,
                                   void* stream) {
  dim3 grid(tiles, num_nodes);
  const size_t shmem = sizeof(int) * num_dests * (1 + kWarps);
  scatter_tiles_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      words, dest, base, out, n, num_dests, tiles);
  return (int)cudaGetLastError();
}

extern "C" int count_scatter_tile_first() { return kTile; }

extern "C" int masked_window_ratio_first(
    const int* hist, const unsigned char* nmask, const unsigned char* dmask,
    float* rho, int* num, int* den, int num_sites, int num_weeks,
    int num_queries, void* stream) {
  namespace k5 = k5_first;
  if (num_sites <= 0 || num_weeks <= 0 || num_queries <= 0)
    return (int)cudaErrorInvalidValue;
  const int wc = num_weeks < k5::kWeekChunk ? num_weeks : k5::kWeekChunk;
  const size_t smem = (size_t)k5::kSites * (2 * wc + 1) * sizeof(int)
                      + (size_t)k5::kGroups * wc * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      k5::masked_window_ratio_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((num_sites + k5::kSites - 1) / k5::kSites);
  k5::masked_window_ratio_kernel<<<blocks, k5::kSites, smem,
                                   (cudaStream_t)stream>>>(
      hist, nmask, dmask, rho, num, den, num_sites, num_weeks, num_queries);
  return (int)cudaGetLastError();
}

extern "C" int powerlaw_sample_first(const float* u, const float* cdf,
                                     int* out, long long n, int num_sites,
                                     void* stream) {
  namespace k6 = k6_first;
  if (n <= 0 || num_sites <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + k6::kThreads - 1) / k6::kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k6::powerlaw_sample_kernel<<<(unsigned)blocks, k6::kThreads, 0,
                               (cudaStream_t)stream>>>(u, cdf, out, n,
                                                       num_sites);
  return (int)cudaGetLastError();
}

extern "C" int windowed_ratio_first(const int* hist, float* rho,
                                    int* cum_total, int* cum_marked,
                                    int num_sites, int num_weeks,
                                    void* stream) {
  namespace k7 = k7_first;
  if (num_sites <= 0 || num_weeks <= 0) return (int)cudaErrorInvalidValue;
  const int wc = num_weeks < k7::kWeekChunk ? num_weeks : k7::kWeekChunk;
  const size_t smem = (size_t)k7::kSites * (2 * wc + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      k7::windowed_ratio_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((num_sites + k7::kSites - 1) / k7::kSites);
  k7::windowed_ratio_kernel<<<blocks, k7::kSites, smem,
                              (cudaStream_t)stream>>>(
      hist, rho, cum_total, cum_marked, num_sites, num_weeks);
  return (int)cudaGetLastError();
}
