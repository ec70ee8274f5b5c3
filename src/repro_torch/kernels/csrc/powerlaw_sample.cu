// MalGen's inverse-CDF site sampler, for Hopper (sm_90a).
//
// K6 powerlaw_sample
//   Replaces src/repro/kernels/powerlaw_sample/powerlaw_sample.py:_kernel
//   (wrapper ops.py:powerlaw_sample). For n uniform draws u and the
//   S-entry inclusive CDF (non-decreasing, f32):
//     out[i] = min(#{s : cdf[s] <= u[i]}, S - 1)   (int32)
//   which is searchsorted(cdf, u, side="right") clipped to [0, S-1], the
//   JAX package's powerlaw_sample_ref. Ties go right and runs of equal
//   entries are skipped; u >= cdf[S-1] and +inf give S-1, u < cdf[0] and
//   -inf give 0. A NaN draw gives S-1, as the reference's search sorts NaN
//   last (the Pallas body counts cdf <= NaN, never true, and gives 0).
//   The TPU kernel counts with broadcast compares over streamed CDF tiles
//   (no per-lane gather there); a GPU thread can gather, so here each
//   draw is found by a search.
//
// What bound the first design: one thread per draw ran an upper-bound
// binary search of ceil(log2(S + 1)) = 17 steps over the 400 KB CDF, each
// load depending on the one before: 0.0895 ms at n = 2^23 on an H100
// 80GB HBM3 at 700 W, 4.4x its byte bound.
//
// Design: a guide table takes the top of the search out of the L2.
//   1. guide_kernel writes guide[b] = #{s : cdf[s] <= b / G} for
//      b = 0..G (G = kGuide = 8,192) into scratch the wrapper allocates,
//      in one coalesced pass over the CDF. It is rebuilt on every call:
//      nothing is cached across calls.
//   2. sample_kernel runs a persistent grid (kBlocksPerSm blocks an SM).
//      Each block copies the table into shared memory once, then takes
//      groups of 4 draws grid-stride: one 16-byte load of u (the next
//      group's load is issued before the current group is searched) and
//      one 16-byte store of the sites. A draw x in [0, 1) lies in bucket
//      b = (int)(x * G): x * G and b / G are exact in f32 because G is a
//      power of two, so b / G <= x < (b + 1) / G and the answer lies in
//      [guide[b], guide[b + 1]]. x < 0 (and -inf) lies in [0, guide[0]],
//      x >= 1 (and +inf) in [guide[G], S]; -0.0 compares equal to 0 and
//      takes bucket 0. NaN gives S - 1 directly. The four brackets are
//      finished by upper-bound searches interleaved step by step, four
//      independent loads in flight a thread. Most brackets are one index
//      wide and need no load at all; the rest lie in the tail of light
//      sites and take a few steps.
//   Below kDirect = 2^18 draws the table costs more than it saves (its
//   build is some 2 us), and each draw is searched directly instead.
//   All of this holds for any non-decreasing CDF: leading zero entries (a
//   masked CDF), a last entry below 1, entries outside [0, 1], S = 1 and
//   S < G.
//
// What bounds it: the bytes are u read once, out written once and the CDF
// once (8 bytes a draw); at n = 2^23, S = 100,000 that is 67.5 MB, 0.0202
// ms at 3.35 TB/s. What holds it above that is the long searches: their
// steps run in lock step with the warp's other draws, each a random load
// from the L2 (tools/k6_mechanisms.py times the kernel with the searches
// cut out or capped; PERF.md has the numbers).
//
// The join pass (powerlaw_sample_join; wrapper ops.py:powerlaw_sample_join)
//   Replaces no TPU kernel: the JAX package's generate_chunk joins the
//   columns with XLA's fused ops. It does K6's work for one half of a
//   MalGen chunk (the marked or the unmarked rows) and writes that half's
//   records in place, in the [P, C] columns the streaming step folds:
//     site[i]  = K6's answer for u[i]
//     mark[i]  = entity_mark_time[entity[i]] <= ts[i]
//     seq[i]   = seq0 + i      (the row's event_seq)
//     hash[i]  = hash_value    (the chunk's shard_hash)
//   entity and ts were drawn into their rows before the call; u is the
//   half's draws. The search is K6's (the same guide table, bracket and
//   interleaved steps, as __device__ functions that both passes inline),
//   and join::sample_kernel / join::direct_kernel keep K6's kernel names
//   inside a nested namespace. What it adds to K6's 8 bytes a draw: entity
//   and ts read, mark, seq and hash written, 20 bytes a record; the 4 MB
//   mark table stays in the L2. It has its own __launch_bounds__ (2 blocks
//   an SM: the join's streams need registers the plain search does not),
//   so the plain sample_kernel keeps its registers and occupancy.
//   The unmarked half starts at the row's marked count, which need not be a
//   multiple of 4 (838,861 at 2^23 records a chunk), so its slices are not
//   16-byte aligned: group g holds the draws 4g - skew .. 4g - skew + 3,
//   where skew is the slices' shared offset from a 16-byte boundary, so a
//   scalar head group brings every later group onto the boundary and only
//   the first and the last group are written by element.
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the call. Nothing is allocated here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLogGuide = 13;
constexpr int kGuide = 1 << kLogGuide;  // buckets of the guide table
constexpr int kThreads = 512;           // sample_kernel's block
constexpr int kBlocksPerSm = 3;
constexpr int kJoinBlocksPerSm = 2;     // join::sample_kernel
constexpr int kGuideThreads = 256;
constexpr int kGuideInts = kGuide + 4;  // G + 1 entries, int4-padded
constexpr int kSharedBytes = kGuideInts * (int)sizeof(int);
constexpr long long kDirect = 1LL << 18;  // fewer draws: no table
constexpr int kDirectThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGuide % (4 * kThreads) == 0, "whole int4 copies a thread");

// lo + #{s in [lo, hi) : cdf[s] <= x}, for a non-decreasing cdf.
__device__ __forceinline__ int upper_bound(const float* __restrict__ cdf,
                                           int lo, int hi, float x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cdf + mid) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Below kDirect draws: one thread a draw, one search over the whole CDF
// (the first design; the table's build would cost more than it saves).
__global__ void direct_kernel(const float* __restrict__ u,
                              const float* __restrict__ cdf,
                              int* __restrict__ out, int n, int num_sites) {
  const int i = blockIdx.x * kDirectThreads + threadIdx.x;
  if (i >= n) return;
  const float x = __ldg(u + i);
  const int r = x != x ? num_sites - 1 : upper_bound(cdf, 0, num_sites, x);
  out[i] = min(r, num_sites - 1);
}

// ceil(y) as a guide index in [0, G + 1], for y = a CDF entry times G
// (exact, G being a power of two).
__device__ __forceinline__ int edge_index(float y) {
  return (int)ceilf(fminf(fmaxf(y, 0.f), (float)(kGuide + 1)));
}

// guide[b] = #{s : cdf[s] <= b / G} for b = 0..G. Entry s (0 <= s <= S)
// owns the edges b with cdf[s - 1] <= b / G < cdf[s], i.e. b in
// [ceil(G cdf[s - 1]), ceil(G cdf[s])) (the first bound 0 for s = 0, the
// last G + 1 for s = S); for a non-decreasing CDF these ranges tile
// [0, G]. A warp takes 32 consecutive entries and writes each entry's
// edges with all 32 lanes, 16 bytes a lane, so that a heavy site (0.196
// of the mass: some 1,600 edges) does not serialise one thread.
__global__ void guide_kernel(const float* __restrict__ cdf, int num_sites,
                             int* __restrict__ guide) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kGuideThreads + threadIdx.x;
  int lo = 0, hi = 0;  // entries past S own nothing
  if (s <= num_sites) {
    lo = s == 0 ? 0 : edge_index(__ldg(cdf + s - 1) * kGuide);
    hi = s == num_sites ? kGuide + 1 : edge_index(__ldg(cdf + s) * kGuide);
  }
  for (unsigned todo = __ballot_sync(kFull, lo < hi); todo;
       todo &= todo - 1) {
    const int k = __ffs(todo) - 1;
    const int a = __shfl_sync(kFull, lo, k), e = __shfl_sync(kFull, hi, k);
    const int v = (int)(s - lane + k);
    // a scalar head to a multiple of 4, int4 stores, a scalar tail
    const int a4 = min((a + 3) & ~3, e), e4 = max(e & ~3, a4);
    if (a + lane < a4) guide[a + lane] = v;
    for (int b = a4 + 4 * lane; b < e4; b += 128)
      *reinterpret_cast<int4*>(guide + b) = make_int4(v, v, v, v);
    if (e4 + lane < e) guide[e4 + lane] = v;
  }
}

// [lo, hi], the indices the answer for draw x can take.
__device__ __forceinline__ void bracket(float x, const int* guide,
                                        int num_sites, int& lo, int& hi) {
  if (x >= 0.f && x < 1.f) {  // -0.0 too: bucket 0
    const int b = (int)(x * (float)kGuide);
    lo = guide[b];
    hi = guide[b + 1];
  } else if (x < 0.f) {
    lo = 0;
    hi = guide[0];
  } else if (x >= 1.f) {
    lo = guide[kGuide];
    hi = num_sites;
  } else {  // NaN
    lo = hi = num_sites - 1;
  }
}

// The guide table from global into shared memory, by a block of kThreads:
// every int4 load of the copy in flight at once, then the last entry.
__device__ __forceinline__ const int* copy_guide(int4* smem,
                                                 const int* guide_g) {
  constexpr int kPer = kGuide / 4 / kThreads;
  const int4* src = reinterpret_cast<const int4*>(guide_g);
  int4 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = __ldg(src + k * kThreads + threadIdx.x);
#pragma unroll
  for (int k = 0; k < kPer; ++k) smem[k * kThreads + threadIdx.x] = v[k];
  if (threadIdx.x == 0)
    reinterpret_cast<int*>(smem)[kGuide] = __ldg(guide_g + kGuide);
  __syncthreads();
  return reinterpret_cast<const int*>(smem);
}

// The sites of four draws x, each found inside its bracket by an
// upper-bound search, one step of each per pass, so that up to four
// independent loads are in flight a thread; out[j] = min(answer, S - 1).
__device__ __forceinline__ void search4(const float (&x)[4],
                                        const int* guide,
                                        const float* __restrict__ cdf,
                                        int num_sites, int (&out)[4]) {
  int lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bracket(x[j], guide, num_sites, lo[j], hi[j]);
  for (;;) {
    float c[4];
    int mid[4];
    bool live = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mid[j] = lo[j] + ((hi[j] - lo[j]) >> 1);
      c[j] = 0.f;
      if (lo[j] < hi[j]) {
        c[j] = __ldg(cdf + mid[j]);
        live = true;
      }
    }
    if (!live) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lo[j] < hi[j]) {
        if (c[j] <= x[j])
          lo[j] = mid[j] + 1;
        else
          hi[j] = mid[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = min(lo[j], num_sites - 1);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sample_kernel(const float* __restrict__ u, const float* __restrict__ cdf,
                  const int* __restrict__ guide_g, int* __restrict__ out,
                  int n, int num_sites, bool vec) {
  extern __shared__ int4 smem[];
  const int* guide = copy_guide(smem, guide_g);

  // draws i .. i + 3 (those below n)
  auto load4 = [&](int i) {
    if (vec && i + 4 <= n)
      return __ldg(reinterpret_cast<const float4*>(u + i));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) x.x = __ldg(u + i);
    if (i + 1 < n) x.y = __ldg(u + i + 1);
    if (i + 2 < n) x.z = __ldg(u + i + 2);
    if (i + 3 < n) x.w = __ldg(u + i + 3);
    return x;
  };

  // groups of 4 draws, grid-stride
  const int groups = (int)(((long long)n + 3) >> 2);
  const int stride = gridDim.x * kThreads;
  int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  float4 next = load4(g << 2);
  for (; g < groups; g += stride) {
    const float x[4] = {next.x, next.y, next.z, next.w};
    // the next group's load is in flight while this one is searched
    if (g < groups - stride) next = load4((g + stride) << 2);
    int site[4];
    search4(x, guide, cdf, num_sites, site);
    const int i = g << 2;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) =
          make_int4(site[0], site[1], site[2], site[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) out[i + j] = site[j];
    }
  }
}

namespace join {

// One half-chunk's columns: the draws and drawn columns read, the
// records' columns written (each [n], at one offset from a 16-byte
// boundary when the pass runs vectorised).
struct Rows {
  const float* u;
  const int* entity;
  const int* ts;
  const int* mark_time;  // [num_entities]
  int* site;
  int* mark;
  int* seq;
  int* hash;
  int seq0;        // seq of record 0
  int hash_value;  // every record's hash
};

// Below kDirect draws: one thread a record, one search over the whole CDF.
__global__ void direct_kernel(Rows r, const float* __restrict__ cdf, int n,
                              int num_sites) {
  const int i = blockIdx.x * kDirectThreads + threadIdx.x;
  if (i >= n) return;
  const float x = __ldg(r.u + i);
  const int t = __ldg(r.ts + i);
  const int m = __ldg(r.mark_time + __ldg(r.entity + i));
  const int s = x != x ? num_sites - 1 : upper_bound(cdf, 0, num_sites, x);
  r.site[i] = min(s, num_sites - 1);
  r.mark[i] = m <= t;
  r.seq[i] = r.seq0 + i;
  r.hash[i] = r.hash_value;
}

// The 16-byte loads and stores of the join's streams, each touched once:
// evict-first (.cs), so that they pass through the L2 without pushing out
// the mark table and the CDF, which every record reads at random.
__device__ __forceinline__ int4 load4(const int* p) {
  return __ldcs(reinterpret_cast<const int4*>(p));
}
__device__ __forceinline__ void store4(int* p, int4 v) {
  __stcs(reinterpret_cast<int4*>(p), v);
}

// A group's inputs: four draws, entities and timestamps.
struct Group {
  float4 x;
  int4 e;
  int4 t;
};

__global__ void __launch_bounds__(kThreads, kJoinBlocksPerSm)
    sample_kernel(Rows r, const float* __restrict__ cdf,
                  const int* __restrict__ guide_g, int n, int num_sites,
                  int skew, bool vec) {
  extern __shared__ int4 smem[];
  const int* guide = copy_guide(smem, guide_g);

  // records i .. i + 3 (those in [0, n)), i = 4g - skew
  auto full = [&](int i) { return vec && i >= 0 && i + 4 <= n; };
  auto load = [&](int i) {
    Group v;
    if (full(i)) {
      v.x = __ldcs(reinterpret_cast<const float4*>(r.u + i));
      v.e = load4(r.entity + i);
      v.t = load4(r.ts + i);
      return v;
    }
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    int e[4] = {0, 0, 0, 0}, t[4] = {0, 0, 0, 0};  // entity 0: a safe gather
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j >= 0 && i + j < n) {
        x[j] = __ldg(r.u + i + j);
        e[j] = __ldg(r.entity + i + j);
        t[j] = __ldg(r.ts + i + j);
      }
    }
    v.x = make_float4(x[0], x[1], x[2], x[3]);
    v.e = make_int4(e[0], e[1], e[2], e[3]);
    v.t = make_int4(t[0], t[1], t[2], t[3]);
    return v;
  };

  // groups of 4 records, grid-stride; group 0 is the scalar head. No
  // group is loaded ahead (unlike sample_kernel): the gathers and the
  // search keep enough loads in flight, and it saves the registers.
  const int groups = (int)(((long long)n + skew + 3) >> 2);
  const int stride = gridDim.x * kThreads;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const Group cur = load((g << 2) - skew);
    // the mark times: four gathers from the L2, in flight with the search
    const int m[4] = {__ldg(r.mark_time + cur.e.x),
                      __ldg(r.mark_time + cur.e.y),
                      __ldg(r.mark_time + cur.e.z),
                      __ldg(r.mark_time + cur.e.w)};
    const float x[4] = {cur.x.x, cur.x.y, cur.x.z, cur.x.w};
    int site[4];
    search4(x, guide, cdf, num_sites, site);
    const int t[4] = {cur.t.x, cur.t.y, cur.t.z, cur.t.w};
    const int i = (g << 2) - skew;
    if (full(i)) {
      store4(r.site + i, make_int4(site[0], site[1], site[2], site[3]));
      store4(r.mark + i, make_int4(m[0] <= t[0], m[1] <= t[1], m[2] <= t[2],
                                   m[3] <= t[3]));
      store4(r.seq + i, make_int4(r.seq0 + i, r.seq0 + i + 1,
                                  r.seq0 + i + 2, r.seq0 + i + 3));
      store4(r.hash + i, make_int4(r.hash_value, r.hash_value, r.hash_value,
                                   r.hash_value));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j >= 0 && i + j < n) {
          r.site[i + j] = site[j];
          r.mark[i + j] = m[j] <= t[j];
          r.seq[i + j] = r.seq0 + i + j;
          r.hash[i + j] = r.hash_value;
        }
      }
    }
  }
}

}  // namespace join

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// Bytes of scratch a call needs for its guide table.
extern "C" int powerlaw_sample_scratch() {
  return kGuideInts * (int)sizeof(int);
}

extern "C" int powerlaw_sample(const float* u, const float* cdf, int* out,
                               int* guide, long long n, int num_sites,
                               void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || num_sites <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < kDirect) {
    direct_kernel<<<(unsigned)((n + kDirectThreads - 1) / kDirectThreads),
                    kDirectThreads, 0, st>>>(u, cdf, out, (int)n,
                                             num_sites);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)guide % 16) return (int)cudaErrorMisalignedAddress;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (kSharedBytes > 48 * 1024) {  // a larger table than 2^13 buckets
    const cudaError_t err = cudaFuncSetAttribute(
        sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (err != cudaSuccess) return (int)err;
  }
  guide_kernel<<<(unsigned)(num_sites / kGuideThreads + 1), kGuideThreads,
                 0, st>>>(cdf, num_sites, guide);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  const bool vec = (uintptr_t)u % 16 == 0 && (uintptr_t)out % 16 == 0;
  sample_kernel<<<(unsigned)(need < most ? need : most), kThreads,
                  kSharedBytes, st>>>(u, cdf, guide, out, (int)n, num_sites,
                                      vec);
  return (int)cudaGetLastError();
}

// K6's search and the mark join over one half-chunk of n records, written
// in place (see the note at the top). One guide_kernel launch and one
// join::sample_kernel launch, or one join::direct_kernel launch below
// kDirect records, as powerlaw_sample makes.
extern "C" int powerlaw_sample_join(const float* u, const float* cdf,
                                    const int* entity, const int* ts,
                                    const int* mark_time, int* site,
                                    int* mark, int* seq, int* hash,
                                    int* guide, long long n, int num_sites,
                                    int seq0, int hash_value, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || num_sites <= 0 || seq0 < 0
      || seq0 > 0x7fffffffLL - n)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const join::Rows r{u, entity, ts, mark_time, site, mark, seq, hash, seq0,
                     hash_value};
  if (n < kDirect) {
    join::direct_kernel<<<(unsigned)((n + kDirectThreads - 1)
                                     / kDirectThreads),
                          kDirectThreads, 0, st>>>(r, cdf, (int)n,
                                                   num_sites);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)guide % 16) return (int)cudaErrorMisalignedAddress;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (kSharedBytes > 48 * 1024) {  // a larger table than 2^13 buckets
    const cudaError_t err = cudaFuncSetAttribute(
        join::sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (err != cudaSuccess) return (int)err;
  }
  guide_kernel<<<(unsigned)(num_sites / kGuideThreads + 1), kGuideThreads,
                 0, st>>>(cdf, num_sites, guide);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // every slice at one offset from a 16-byte boundary: vectorised groups
  // after a head of 4 - skew records; else every group by element
  const uintptr_t off = (uintptr_t)site % 16;
  const bool vec = off % 4 == 0 && (uintptr_t)u % 16 == off
                   && (uintptr_t)entity % 16 == off
                   && (uintptr_t)ts % 16 == off && (uintptr_t)mark % 16 == off
                   && (uintptr_t)seq % 16 == off
                   && (uintptr_t)hash % 16 == off;
  const int skew = vec ? (int)(off / 4) : 0;
  const long long need = ((n + skew + 3) / 4 + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kJoinBlocksPerSm;
  join::sample_kernel<<<(unsigned)(need < most ? need : most), kThreads,
                        kSharedBytes, st>>>(r, cdf, guide, (int)n, num_sites,
                                            skew, vec);
  return (int)cudaGetLastError();
}

// What the card reports for kernel k of this source, in the order of its
// ops.py KERNELS: out = {static shared bytes, registers a thread, largest
// block, largest dynamic shared bytes} (cudaFuncGetAttributes). For the
// static analysis, which holds its launch plans against the card.
extern "C" int kernel_attributes(int k, int* out) {
  const void* const fns[] = {
      (const void*)direct_kernel,
      (const void*)guide_kernel,
      (const void*)sample_kernel,
      (const void*)join::direct_kernel,
      (const void*)join::sample_kernel};
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
