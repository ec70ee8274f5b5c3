// MalStone B finalizer, for Hopper (sm_90a).
//
// K7 windowed_ratio_kernel
//   Replaces src/repro/kernels/windowed_ratio/windowed_ratio.py:_kernel
//   (wrapper ops.py:windowed_ratio). For S sites of the [S, W, 2] (total,
//   marked) histogram:
//     cum_total[s, t]  = sum_{w <= t} hist[s, w, 0]   (int32, wrapping)
//     cum_marked[s, t] = sum_{w <= t} hist[s, w, 1]
//     rho[s, t] = cum_total > 0 ? cum_marked / max(cum_total, 1) : 0
//   (one IEEE f32 divide, bit-equal to common/types.py:safe_ratio). The
//   TPU kernel scans with a triangular f32 matmul and casts to int32, exact
//   only while a running count stays under 2^24 and saturating past 2^31;
//   here the scans are int32 adds (in uint32, since signed overflow is
//   undefined in C++), wrapping past 2^31 as the JAX package's
//   windowed_ratio_ref (jnp.cumsum) does.
//
// What bound the first design: one thread per site and 128 sites a block,
// staged in shared memory as [128][2W + 1] ints (53.8 KB at W = 52), so 4
// blocks fit an SM (16 warps of 64) and the 782 blocks ran in 1.48 waves;
// each block loaded, scanned (104 dependent shared-memory read-modify-
// writes a thread) and wrote in three phases between barriers, so no load
// was in flight during the scan; and every element paid an integer
// division by a run-time divisor. 0.0864 ms at S = 100,000, W = 52 on an
// H100 80GB HBM3 at 700 W, 2.8x its byte bound.
//
// Design: a warp per site, no shared memory and no block barrier. A
// persistent grid (kBlocksPerSm blocks an SM, 64 warps) walks the sites
// grid-stride by warp; a site's weeks go in chunks of 64, lane l holding
// weeks 2l and 2l + 1 of the chunk: one 16-byte load of (total, marked)
// x 2 weeks, since a row of W even weeks is 8W bytes and so 16-byte
// aligned. The warp scans the lanes' pair sums with shuffles (5 steps a
// channel), adds the carry of the site's earlier chunks, and each lane
// writes its two weeks of each output with one 8-byte store (an output
// row is 4W bytes). The next (site, chunk)'s load is issued before the
// current one is scanned, so two rows a warp are in flight. At W = 52, 26
// lanes of 32 carry weeks. An odd W, or a pointer not so aligned, takes
// 4-byte loads and stores instead. Any W >= 1 and S >= 1 are taken.
//
// What bounds it: the histogram is read once (8 bytes a site-week) and the
// outputs written once (12 bytes a site-week); at S = 100,000, W = 52 that
// is 104.0 MB, 0.0310 ms at 3.35 TB/s. The adds and the divide are far
// below the card's rates.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // 8 warps a block
constexpr int kBlocksPerSm = 8;   // 64 warps an SM
constexpr int kChunk = 64;        // weeks a warp scans per pass
constexpr unsigned kFull = 0xffffffffu;

// Weeks w and w + 1 of a site's row (zeros past the last week).
__device__ __forceinline__ uint4 load_weeks(const int* __restrict__ row,
                                            int w, int num_weeks,
                                            bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (w >= num_weeks) return v;
  if (vec)  // w is even and W is even, so w + 1 < W
    return __ldg(reinterpret_cast<const uint4*>(row + 2 * w));
  v.x = (unsigned)__ldg(row + 2 * w);
  v.y = (unsigned)__ldg(row + 2 * w + 1);
  if (w + 1 < num_weeks) {
    v.z = (unsigned)__ldg(row + 2 * w + 2);
    v.w = (unsigned)__ldg(row + 2 * w + 3);
  }
  return v;
}

__device__ __forceinline__ float ratio(unsigned m, unsigned t) {
  const int ti = (int)t;
  return ti > 0 ? __fdiv_rn((float)(int)m, fmaxf((float)ti, 1.f)) : 0.f;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    windowed_ratio_kernel(const int* __restrict__ hist,
                          float* __restrict__ rho,
                          int* __restrict__ cum_total,
                          int* __restrict__ cum_marked, int num_sites,
                          int num_weeks, bool vec) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const int chunks = (num_weeks + kChunk - 1) / kChunk;
  int site = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (site >= num_sites) return;
  int chunk = 0;
  uint4 cur = load_weeks(hist + (long long)site * num_weeks * 2, 2 * lane,
                         num_weeks, vec);
  unsigned carry_t = 0u, carry_m = 0u;  // the site's earlier chunks
  for (;;) {
    // the warp's next (site, chunk), loaded before this one is scanned
    int next_site = site, next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next_chunk = 0;
      next_site = site < num_sites - warps ? site + warps : num_sites;
    }
    uint4 nxt = make_uint4(0u, 0u, 0u, 0u);
    if (next_site < num_sites)
      nxt = load_weeks(hist + (long long)next_site * num_weeks * 2,
                       next_chunk * kChunk + 2 * lane, num_weeks, vec);

    // inclusive scan of the lanes' two-week sums, both channels
    const unsigned st = cur.x + cur.z, sm = cur.y + cur.w;
    unsigned it = st, im = sm;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned ut = __shfl_up_sync(kFull, it, d);
      const unsigned um = __shfl_up_sync(kFull, im, d);
      if (lane >= d) {
        it += ut;
        im += um;
      }
    }
    const unsigned t0 = carry_t + (it - st) + cur.x, t1 = t0 + cur.z;
    const unsigned m0 = carry_m + (im - sm) + cur.y, m1 = m0 + cur.w;
    carry_t += __shfl_sync(kFull, it, 31);
    carry_m += __shfl_sync(kFull, im, 31);

    const int w = chunk * kChunk + 2 * lane;
    const long long o = (long long)site * num_weeks + w;
    if (w < num_weeks) {
      if (vec) {
        *reinterpret_cast<int2*>(cum_total + o) = make_int2((int)t0, (int)t1);
        *reinterpret_cast<int2*>(cum_marked + o) =
            make_int2((int)m0, (int)m1);
        *reinterpret_cast<float2*>(rho + o) =
            make_float2(ratio(m0, t0), ratio(m1, t1));
      } else {
        cum_total[o] = (int)t0;
        cum_marked[o] = (int)m0;
        rho[o] = ratio(m0, t0);
        if (w + 1 < num_weeks) {
          cum_total[o + 1] = (int)t1;
          cum_marked[o + 1] = (int)m1;
          rho[o + 1] = ratio(m1, t1);
        }
      }
    }
    if (next_chunk == 0) carry_t = carry_m = 0u;
    if (next_site >= num_sites) break;
    site = next_site;
    chunk = next_chunk;
    cur = nxt;
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

extern "C" int windowed_ratio(const int* hist, float* rho, int* cum_total,
                              int* cum_marked, int num_sites, int num_weeks,
                              void* stream) {
  if (num_sites <= 0 || num_weeks <= 0) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const bool vec = num_weeks % 2 == 0 && (uintptr_t)hist % 16 == 0
                   && (uintptr_t)rho % 8 == 0 && (uintptr_t)cum_total % 8 == 0
                   && (uintptr_t)cum_marked % 8 == 0;
  const long long need = ((long long)num_sites + kThreads / 32 - 1)
                         / (kThreads / 32);
  const long long most = (long long)sms * kBlocksPerSm;
  windowed_ratio_kernel<<<(unsigned)(need < most ? need : most), kThreads, 0,
                          (cudaStream_t)stream>>>(
      hist, rho, cum_total, cum_marked, num_sites, num_weeks, vec);
  return (int)cudaGetLastError();
}
