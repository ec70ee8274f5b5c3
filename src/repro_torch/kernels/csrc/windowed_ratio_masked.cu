// Batched masked-window ratio of the query service, for Hopper (sm_90a).
//
// K5 masked_window_ratio_kernel (with mask_runs_kernel before it)
//   Replaces src/repro/kernels/windowed_ratio/windowed_ratio.py:_masked_kernel
//   (wrapper ops.py:masked_window_ratio), the reducer of the serving
//   engine's batched_query. For N queries, each a numerator and a
//   denominator week mask, and S sites of the [S, W, 2] (total, marked)
//   histogram:
//     num[n, s] = sum_w nmask[n, w] * hist[s, w, 1]   (int32, wrapping)
//     den[n, s] = sum_w dmask[n, w] * hist[s, w, 0]
//     rho[n, s] = den > 0 ? num / max(den, 1) : 0     (one IEEE divide)
//   The TPU kernel contracts f32 masks against f32 counts on the MXU, exact
//   only while a count stays under 2^24; here the sums are uint32 adds,
//   exact at any size, as the JAX package's masked_window_ratio_ref.
//
// Design: prefix differences over mask runs. A mask is a list of runs
// [a, b) of set weeks, and with each site's exclusive prefix sums P_c[0..W]
// of both channels a run's sum is P_c[b] - P_c[a]. So a query costs two
// shared-memory reads and two adds per run instead of one predicated add
// per week, and the sum, taken mod 2^32, is exactly the wrapping int32 sum
// of the weeks for any mask and any counts. The service's masks are one
// run each (a window, a year prefix, an exposure). The worst mask,
// alternating weeks, has W / 2 runs.
//
// mask_runs_kernel encodes the masks once, on the card, with no host round
// trip: one warp per (week chunk, channel, query) row; a ballot over the
// weeks marks where the mask (unset outside the chunk) changes, and a
// popcount places each change in order, so positions 2i and 2i + 1 of the
// row's list are run i's start and end (one byte each). Rows of the list
// are kRowAlign-byte multiples, so a block copies them with 16-byte loads.
//
// masked_window_ratio_kernel: one block per tile of kSites sites.
//   1. Staging: the run lists and lengths of up to kQueryBlock queries
//      (16-byte loads that hit the L2), then the tile's [ts, W, 2] rows,
//      one contiguous run of the histogram read with 16-byte loads (kVec in
//      flight per thread) and written transposed into P[c][w + 1][t] (row
//      stride kSites + 1, so the transposing writes spread over the banks).
//   2. Threads (c, t) turn each site's column into its running sum, eight
//      loads in flight.
//   3. Warp w answers queries w, w + kWarps, ...; lane l takes sites l and
//      l + 32, so one decoded run serves two sites, the warp's reads of
//      P_c[e][t] are conflict-free (e is the same for the warp) and its
//      stores of rho, num and den go along s, 128 bytes at a time.
// Blocks are small (34.6 KB of shared memory at N = W = 52, at most 80
// registers a thread) so that three are resident on each SM: one block's
// loads overlap another's stores. Any N (query blocks of kQueryBlock), any W (week chunks of
// kWeekChunk; later chunks add onto the sums already written) and any
// S >= 1 are taken.
//
// What bounds it: the histogram is read once (8 bytes a site-week) and the
// outputs written once (12 bytes a query-site): at the service's shapes
// (S = 100,000, W = 52, N = 9 or 52) that is 15.6 to 31 us at 3.35 TB/s.
// The integer work is a few operations per query, site and run.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here: the wrapper passes the run lists'
// scratch, masked_window_ratio_scratch() bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSites = 64;                  // sites per block (one tile)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;       // query lanes of a block
constexpr int kStride = kSites + 1;         // prefix row stride in words
constexpr int kWeekChunk = 64;              // weeks staged per pass
constexpr int kQueryBlock = 64;             // queries staged per pass
constexpr int kVec = 4;                     // histogram loads in flight
constexpr int kRunVec = 2;                  // run-list loads in flight
constexpr int kRowAlign = 16;               // run-list row, in bytes
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSites == 64, "lane l takes sites l and l + 32");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__host__ __device__ inline int num_chunks(int num_weeks) {
  return (num_weeks + kWeekChunk - 1) / kWeekChunk;
}

// Bytes of one row of run lists: room for the wc + 1 changes of a chunk.
__host__ __device__ inline int run_row(int num_weeks) {
  const int wc = num_weeks < kWeekChunk ? num_weeks : kWeekChunk;
  return (wc + 1 + kRowAlign - 1) / kRowAlign * kRowAlign;
}

// Scratch: run lists [chunks][2][N][run_row] bytes, then their lengths
// [chunks][2][N] int32 (c = 0 the denominator, c = 1 the numerator).
__host__ __device__ inline long long runs_bytes(int num_weeks,
                                                int num_queries) {
  return (long long)num_chunks(num_weeks) * 2 * num_queries
         * run_row(num_weeks);
}

// Shared memory of the main kernel: run lists [2][nq][row] bytes, P
// [2][wc + 1][kStride] uint32, list lengths [2][nq] int32, sized by the
// largest chunk wc and query block nq.
__host__ __device__ inline size_t smem_bytes(int num_weeks,
                                             int num_queries) {
  const int wc = num_weeks < kWeekChunk ? num_weeks : kWeekChunk;
  const int nq = num_queries < kQueryBlock ? num_queries : kQueryBlock;
  return (size_t)2 * nq * run_row(num_weeks)
         + (size_t)2 * (wc + 1) * kStride * 4 + (size_t)2 * nq * 4;
}

__global__ void __launch_bounds__(kThreads) mask_runs_kernel(
    const unsigned char* __restrict__ nmask,
    const unsigned char* __restrict__ dmask, unsigned char* __restrict__ runs,
    int* __restrict__ lengths, int num_weeks, int num_queries, int rows) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;  // a warp's row
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int q = r % num_queries;
  const int chunk_c = r / num_queries;  // chunk * 2 + c
  const int w0 = (chunk_c >> 1) * kWeekChunk;
  const int wc = min(kWeekChunk, num_weeks - w0);
  const unsigned char* m = ((chunk_c & 1) ? nmask : dmask)
                           + (long long)q * num_weeks + w0;
  unsigned char* out = runs + (long long)r * run_row(num_weeks);
  int count = 0;
  unsigned carry = 0u;  // the week before this round's first
  for (int j0 = 0; j0 <= wc; j0 += 32) {
    const int j = j0 + lane;
    const unsigned cur = j < wc ? (unsigned)(m[j] != 0) : 0u;
    unsigned prev = __shfl_up_sync(kFull, cur, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, cur, 31);
    const bool change = j <= wc && cur != prev;
    const unsigned ballot = __ballot_sync(kFull, change);
    if (change) out[count + __popc(ballot & lanemask_lt())] = (unsigned char)j;
    count += __popc(ballot);
  }
  if (lane == 0) lengths[r] = count;
}

// Element e of the staged block is row r = e / row_len, column k; the
// division is a multiply-high by ceil(2^32 / row_len), exact for e <
// kSites * 2 * kWeekChunk. Column k = 2w + c goes to P[c][w + 1][r].
__device__ __forceinline__ void put(unsigned* pre, int wc, unsigned magic,
                                    int row_len, int e, int v) {
  const int r = (int)__umulhi((unsigned)e, magic);
  const int k = e - r * row_len;
  pre[((k & 1) * (wc + 1) + (k >> 1) + 1) * kStride + r] = (unsigned)v;
}

// The sums of one channel over one mask's runs for sites l and l + 32: the
// list's k bytes are (start, end) pairs of week indices into the column
// P_c + l.
__device__ __forceinline__ void run_sums(const unsigned char* list,
                                         const unsigned* col, int k,
                                         unsigned& s0, unsigned& s1) {
  s0 = 0u;
  s1 = 0u;
  for (int i = 0; i < k; i += 2) {
    const unsigned ab = *reinterpret_cast<const unsigned short*>(list + i);
    const unsigned* pa = col + (ab & 0xffu) * kStride;
    const unsigned* pb = col + (ab >> 8) * kStride;
    s0 += pb[0] - pa[0];
    s1 += pb[32] - pa[32];
  }
}

// One answer: add the earlier chunks' sums, store num and den (int32
// bits) and, after the last chunk, the ratio with one IEEE divide.
__device__ __forceinline__ void answer(float* rho, int* num, int* den,
                                       long long o, unsigned dsum,
                                       unsigned nsum, bool first, bool last) {
  if (!first) {
    dsum += (unsigned)den[o];
    nsum += (unsigned)num[o];
  }
  const int nv = (int)nsum;
  const int dv = (int)dsum;
  num[o] = nv;
  den[o] = dv;
  if (last)
    rho[o] = dv > 0 ? __fdiv_rn((float)nv, fmaxf((float)dv, 1.f)) : 0.f;
}

__global__ void __launch_bounds__(kThreads, 3) masked_window_ratio_kernel(
    const int* __restrict__ hist, const unsigned char* __restrict__ runs,
    const int* __restrict__ lengths, float* __restrict__ rho,
    int* __restrict__ num, int* __restrict__ den, int num_sites,
    int num_weeks, int num_queries, int hist_aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wc_max = min(num_weeks, kWeekChunk);
  const int nq_max = min(num_queries, kQueryBlock);
  const int row = run_row(num_weeks);
  unsigned char* list = smem;  // [2][nq][row]
  unsigned* pre = reinterpret_cast<unsigned*>(list + 2 * nq_max * row);
  int* len = reinterpret_cast<int*>(pre + 2 * (wc_max + 1) * kStride);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int s0 = blockIdx.x * kSites;
  const int ts = min(kSites, num_sites - s0);

  for (int w0 = 0, chunk = 0; w0 < num_weeks; w0 += kWeekChunk, ++chunk) {
    const int wc = min(kWeekChunk, num_weeks - w0);
    const bool first = w0 == 0;
    const bool last = w0 + wc == num_weeks;
    const int row_len = 2 * wc;
    const unsigned magic =
        (unsigned)((0x100000000ull + row_len - 1) / row_len);
    const int total = ts * row_len;
    const int* base = hist + ((long long)s0 * num_weeks + w0) * 2;
    // the tile is one contiguous run starting on a 16-byte boundary (s0 * W
    // * 8 is a multiple of 16) when the chunk is the whole row
    const bool vec = wc == num_weeks && hist_aligned;
    const int nvec = vec ? total / 4 : 0;

    for (int q0 = 0; q0 < num_queries; q0 += kQueryBlock) {
      const int nq = min(kQueryBlock, num_queries - q0);
      __syncthreads();  // the last pass's readers are done
      // 1. stage the run lists and their lengths (L2 hits: every block
      // reads the same), then the histogram rows, kVec 16-byte loads in
      // flight per thread before their stores
      const int4* lists0 = reinterpret_cast<const int4*>(
          runs + ((long long)chunk * 2 * num_queries + q0) * row);
      const int4* lists1 = reinterpret_cast<const int4*>(
          runs + ((long long)(chunk * 2 + 1) * num_queries + q0) * row);
      const int lvec = nq * row / 16;  // int4 of one channel's lists
      int4 x[kVec], y[kRunVec];
#pragma unroll
      for (int u = 0; u < kRunVec; ++u) {
        const int v = u * kThreads + tid;
        if (v < 2 * lvec) y[u] = v < lvec ? lists0[v] : lists1[v - lvec];
      }
#pragma unroll
      for (int u = 0; u < kRunVec; ++u) {
        const int v = u * kThreads + tid;
        if (v < 2 * lvec) reinterpret_cast<int4*>(list)[v] = y[u];
      }
      for (int i = tid; i < 2 * nq; i += kThreads) {
        const int c = i >= nq;
        len[i] = lengths[(long long)(chunk * 2 + c) * num_queries + q0 + i
                         - c * nq];
      }
      for (int v = kRunVec * kThreads + tid; v < 2 * lvec; v += kThreads)
        reinterpret_cast<int4*>(list)[v] = v < lvec ? lists0[v]
                                                    : lists1[v - lvec];
      if (q0 == 0) {
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int v = u * kThreads + tid;
          if (v < nvec) x[u] = reinterpret_cast<const int4*>(base)[v];
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int v = u * kThreads + tid;
          if (v < nvec) {
            put(pre, wc, magic, row_len, 4 * v, x[u].x);
            put(pre, wc, magic, row_len, 4 * v + 1, x[u].y);
            put(pre, wc, magic, row_len, 4 * v + 2, x[u].z);
            put(pre, wc, magic, row_len, 4 * v + 3, x[u].w);
          }
        }
        // the rest: further rounds of 16-byte loads and the ragged end, or
        // the whole chunk one word at a time
        for (int v = kVec * kThreads + tid; v < nvec; v += kThreads) {
          const int4 z = reinterpret_cast<const int4*>(base)[v];
          put(pre, wc, magic, row_len, 4 * v, z.x);
          put(pre, wc, magic, row_len, 4 * v + 1, z.y);
          put(pre, wc, magic, row_len, 4 * v + 2, z.z);
          put(pre, wc, magic, row_len, 4 * v + 3, z.w);
        }
#pragma unroll 4
        for (int e = 4 * nvec + tid; e < total; e += kThreads) {
          const int r = (int)__umulhi((unsigned)e, magic);
          put(pre, wc, magic, row_len, e,
              base[(long long)r * num_weeks * 2 + (e - r * row_len)]);
        }
        if (tid < 2 * kSites)
          pre[(tid / kSites) * (wc + 1) * kStride + tid % kSites] = 0u;
      }
      __syncthreads();

      // 2. running sums of each site's two columns (once per chunk)
      if (q0 == 0) {
        if (tid < 2 * kSites && tid % kSites < ts) {
          unsigned* col = pre + (tid / kSites) * (wc + 1) * kStride
                          + tid % kSites;
          unsigned acc = 0u;
          for (int j0 = 1; j0 <= wc; j0 += 8) {
            unsigned v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (j0 + u <= wc) v[u] = col[(j0 + u) * kStride];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (j0 + u <= wc) {
                acc += v[u];
                col[(j0 + u) * kStride] = acc;
              }
          }
        }
        __syncthreads();
      }

      // 3. the answers: warp w takes queries w, w + kWarps, ...; lane l
      // sites s0 + l and s0 + l + 32
      for (int q = warp; q < nq; q += kWarps) {
        unsigned d0, d1, n0, n1;  // den and num of sites l and l + 32
        run_sums(list + q * row, pre + lane, len[q], d0, d1);
        run_sums(list + (nq + q) * row, pre + (wc + 1) * kStride + lane,
                 len[nq + q], n0, n1);
        const long long o = (long long)(q0 + q) * num_sites + s0 + lane;
        if (lane < ts) answer(rho, num, den, o, d0, n0, first, last);
        if (lane + 32 < ts)
          answer(rho, num, den, o + 32, d1, n1, first, last);
      }
    }
  }
}

}  // namespace

extern "C" long long masked_window_ratio_scratch(int num_weeks,
                                                 int num_queries) {
  return runs_bytes(num_weeks, num_queries)
         + (long long)num_chunks(num_weeks) * 2 * num_queries * 4;
}

extern "C" int masked_window_ratio(const int* hist, const unsigned char* nmask,
                                   const unsigned char* dmask,
                                   unsigned char* scratch, float* rho,
                                   int* num, int* den, int num_sites,
                                   int num_weeks, int num_queries,
                                   void* stream) {
  if (num_sites <= 0 || num_weeks <= 0 || num_queries <= 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)scratch % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int* lengths = reinterpret_cast<int*>(
      scratch + runs_bytes(num_weeks, num_queries));
  const int rows = num_chunks(num_weeks) * 2 * num_queries;
  mask_runs_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                     (cudaStream_t)stream>>>(nmask, dmask, scratch, lengths,
                                             num_weeks, num_queries, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(num_weeks, num_queries);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(masked_window_ratio_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((num_sites + kSites - 1) / kSites);
  const int aligned = ((uintptr_t)hist % 16) == 0;
  masked_window_ratio_kernel<<<blocks, kThreads, smem,
                               (cudaStream_t)stream>>>(
      hist, scratch, lengths, rho, num, den, num_sites, num_weeks,
      num_queries, aligned);
  return (int)cudaGetLastError();
}

// What the card reports for kernel k of this source, in the order of its
// ops.py KERNELS: out = {static shared bytes, registers a thread, largest
// block, largest dynamic shared bytes} (cudaFuncGetAttributes). For the
// static analysis, which holds its launch plans against the card.
extern "C" int kernel_attributes(int k, int* out) {
  const void* const fns[] = {
      (const void*)mask_runs_kernel,
      (const void*)masked_window_ratio_kernel};
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
