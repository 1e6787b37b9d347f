// Exact replay for Hopper (sm_90a): the MXU engine's step 4, each query's
// hits summed in f64 in the reference's scan order, frozen at its early exit
// (isslScoreOfftargets.cpp:308-511).
//
// Replaces no Pallas kernel: the JAX package replays on the host
// (crackling_tpu/ops/issl_mxu.py::_replay_page, numpy and a C loop), as the
// port did before this kernel. Its plain version,
// ops/mxu_replay.py::mxu_replay_plain, runs the same algorithm on the CPU.
//
// Input: one page's hit table as the decode leaves it on the device, rows
// (query, slice, site id, flat entry position in the aligned lists), in no
// order, and per query its own site (id, -1 where the index lacks it, and
// its occurrences). Output: per query the (MIT, CFD) f64 sums.
//
// Four launches on the caller's stream:
//  1. count: per query its rows, plus one for its own site (atomicAdd);
//  2. scan: one block, the counts' exclusive scan into offsets;
//  3. scatter: each row's key (slice << 32 | site id) and entry position
//     into its query's segment, in no order; the own site as key (0, id)
//     and position -1: it is found in every slice, and kept in slice 0;
//  4. replay: a block per query sorts its keys (a bitonic network that
//     puts the smaller key first in every step, so that positions past the
//     count act as +inf and are never touched) in shared memory, or in its
//     global segment where they do not fit (counted in `spilled`), forms
//     each hit's terms in parallel, and one thread adds them in key order.
//
// Within a slice all of a query's hits lie in one bucket, whose list is in
// site-id order, so the key order is the reference's scan order. Dedup:
// the finder reports a site in exactly the slices where it equals the query
// (discovery parity), so a hit in slice s repeats an earlier one iff the two
// signatures agree in a slice s' < s: one test a hit, no sort. Terms, as
// the host replay forms them: MIT the f64 local score of the 20-bit
// mismatch mask in the reference's map (0 at distance 0; the map is
// searched, so its tables stay a few KB) times the occurrences; CFD pam times
// pen[p][q_p << 2 | (o_p ^ 3)] over the mismatched positions in ascending
// order (exactly 1.0 at distance 0) times the occurrences. Every add and
// multiply is an __dadd_rn / __dmul_rn, so nvcc contracts none into an FMA,
// and the sums equal numpy's and native/replay.cpp's bit for bit.
//
// What bounds it on the H100: the bytes of its gathers. A mouse page (~7,750
// queries, ~300 rows each, ~2.3 M rows) reads each row's four words twice
// over (count, scatter: 40 B), writes and reads its key and position (32 B),
// and gathers its entry, occurrences and MIT score (20 B, the first two at
// random over ~30 GB of lists): ~0.2 GB, ~0.07 ms at 3.35 TB/s. The sort (~45 steps of
// a 512-key network a query) and the sequential walk (~300 dependent f64
// adds) are a few microseconds a block, hidden across ~7,750 blocks.
//
// Contract: launched on the caller's stream, allocates nothing (the wrapper
// hands it its scratch), and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // a replay block
constexpr int kShared = 1024;         // keys a block sorts in shared memory
constexpr int kScanThreads = 1024;
constexpr int kWalk = 16;             // terms the walk loads at once

enum Method { kMit = 0, kCfd = 1, kAnd = 2, kOr = 3, kAvg = 4 };

struct Rows {
  const long long* q;                 // page-local query
  const long long* slice;
  const long long* id;
  const long long* pos;               // flat entry position
  long long count;
};

struct Page {
  const unsigned long long* qsig;
  const long long* self_id;           // -1: the site is not in the index
  const long long* self_occ;
  int n;
};

struct Terms {
  const unsigned long long* entries;
  const int* occ;
  const int* mit_masks;               // the MIT map's 20-bit masks, sorted
  const double* mit;                  // and their local scores
  const double* pen;                  // (20, 16) CFD position penalties
  double pam;
  double maximum_sum;
  unsigned long long slice_mask;
  int mit_count, width, method;
};

__device__ __forceinline__ long long thread_index() {
  return blockIdx.x * (long long)blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * blockDim.x;
}

__global__ void count_kernel(Rows r, Page p, int* cnt) {
  for (long long i = thread_index(); i < r.count + p.n; i += grid_stride()) {
    if (i < r.count) {
      const long long q = r.q[i];
      if (q >= 0 && q < p.n) atomicAdd(cnt + q, 1);
    } else if (p.self_id[i - r.count] >= 0) {
      atomicAdd(cnt + (i - r.count), 1);
    }
  }
}

// One block: offsets[q] = sum of cnt[0..q), offsets[n] the total; cnt is
// zeroed for the scatter's cursors.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* cnt, long long* offsets, int n) {
  __shared__ long long part[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = min((long long)n, t * per);
  const long long hi = min((long long)n, lo + per);
  long long own = 0;
  for (long long i = lo; i < hi; ++i) own += cnt[i];
  part[t] = own;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const long long v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - own;
  for (long long i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += cnt[i];
    cnt[i] = 0;
  }
  if (t == kScanThreads - 1) offsets[n] = part[t];
}

__global__ void scatter_kernel(Rows r, Page p, const long long* offsets,
                               int* cursor, unsigned long long* key,
                               long long* pos) {
  for (long long i = thread_index(); i < r.count + p.n; i += grid_stride()) {
    long long q, e;
    unsigned long long k;
    if (i < r.count) {
      q = r.q[i];
      if (q < 0 || q >= p.n) continue;
      k = ((unsigned long long)r.slice[i] << 32) |
          (unsigned long long)r.id[i];
      e = r.pos[i];
    } else {
      q = i - r.count;
      const long long sid = p.self_id[q];
      if (sid < 0) continue;
      k = (unsigned long long)sid;
      e = -1;
    }
    const long long at = offsets[q] + atomicAdd(cursor + q, 1);
    key[at] = k;
    pos[at] = e;
  }
}

__device__ __forceinline__ void compare_swap(unsigned long long* key,
                                             long long* pos, int i, int l) {
  const unsigned long long a = key[i], b = key[l];
  if (a > b) {
    key[i] = b;
    key[l] = a;
    const long long t = pos[i];
    pos[i] = pos[l];
    pos[l] = t;
  }
}

// Ascending sort of k keys (and their positions) by the block: a bitonic
// network over the next power of two whose every comparator puts the
// smaller key at the lower index, so the slots past k act as +inf and each
// comparator that reaches one is skipped.
__device__ void sort_keys(unsigned long long* key, long long* pos, int k) {
  int P = 1;
  while (P < k) P <<= 1;
  for (int size = 2; size <= P; size <<= 1) {
    const int half = size >> 1;
    for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
      const int base = (t / half) * size, j = t % half;
      const int l = base + size - 1 - j;
      if (l < k) compare_swap(key, pos, base + j, l);
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int i = (t / stride) * 2 * stride + t % stride;
        if (i + stride < k) compare_swap(key, pos, i, i + stride);
      }
      __syncthreads();
    }
  }
}

// The local MIT score of a 20-bit mismatch mask: a binary search of the
// map's sorted masks (6,195 at max-distance 4, 74 KB with their scores,
// read through the cache), 0 for a mask the map lacks.
__device__ __forceinline__ double mit_score(int m20, const Terms& T) {
  int lo = 0, hi = T.mit_count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(T.mit_masks + mid) < m20) lo = mid + 1;
    else hi = mid;
  }
  return lo < T.mit_count && __ldg(T.mit_masks + lo) == m20
             ? __ldg(T.mit + lo) : 0.0;
}

__device__ __forceinline__ uint32_t compress_even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// Each hit's (MIT, CFD) terms, in place of its (key, position): a repeat of
// an earlier slice's hit takes CFD -1, which the walk skips (a real term
// is never negative).
__device__ void hit_terms(unsigned long long* key, long long* pos, int k,
                          unsigned long long q, long long self_occ,
                          const Terms& T) {
  const bool calc_mit = T.method != kCfd, calc_cfd = T.method != kMit;
  double* mit_v = reinterpret_cast<double*>(key);
  double* cfd_v = reinterpret_cast<double*>(pos);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int s = (int)(key[i] >> 32);
    const long long e = pos[i];
    double m = 0.0, c = 0.0;
    if (e < 0) {                        // the own site: distance 0
      if (calc_cfd) c = __dmul_rn(1.0, (double)self_occ);
    } else {
      const unsigned long long x = __ldg(T.entries + e) ^ q;
      bool seen = false;
      for (int sp = 0; sp < s; ++sp)
        seen |= ((x >> (sp * T.width)) & T.slice_mask) == 0ull;
      if (seen) {
        c = -1.0;
      } else {
        const double o = (double)__ldg(T.occ + e);
        const unsigned long long cl = (x | (x >> 1)) & 0x5555555555ull;
        const uint32_t m20 = compress_even_bits((uint32_t)cl) |
                             (compress_even_bits((uint32_t)(cl >> 32)) << 16);
        if (calc_mit) m = __dmul_rn(m20 ? mit_score((int)m20, T) : 0.0, o);
        if (calc_cfd) {
          double prod = 1.0;
          if (m20) {
            prod = T.pam;
            for (uint32_t b = m20; b != 0u; b &= b - 1u) {
              const int p = __ffs(b) - 1;
              const int qc = (int)((q >> (2 * p)) & 3ull);
              const int oc = (int)((x >> (2 * p)) & 3ull) ^ qc;
              prod = __dmul_rn(prod, __ldg(T.pen + p * 16 + ((qc << 2) | (oc ^ 3))));
            }
          }
          c = __dmul_rn(prod, o);
        }
      }
    }
    mit_v[i] = m;
    cfd_v[i] = c;
  }
}

__device__ __forceinline__ bool exits(double m, double cc, const Terms& T) {
  switch (T.method) {
    case kAnd: return m > T.maximum_sum && cc > T.maximum_sum;
    case kOr: return m > T.maximum_sum || cc > T.maximum_sum;
    case kAvg: return __dmul_rn(__dadd_rn(m, cc), 0.5) > T.maximum_sum;
    case kMit: return m > T.maximum_sum;
    default: return cc > T.maximum_sum;
  }
}

__global__ void __launch_bounds__(kThreads)
    replay_kernel(const long long* offsets, unsigned long long* key,
                  long long* pos, Page p, Terms T, double* sums,
                  unsigned long long* spilled) {
  __shared__ unsigned long long s_key[kShared];
  __shared__ long long s_pos[kShared];
  const int q = blockIdx.x;
  const long long lo = offsets[q];
  const int k = (int)(offsets[q + 1] - lo);
  unsigned long long* kq = s_key;
  long long* pq = s_pos;
  if (k <= kShared) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      s_key[i] = key[lo + i];
      s_pos[i] = pos[lo + i];
    }
  } else {
    kq = key + lo;
    pq = pos + lo;
    if (threadIdx.x == 0) atomicAdd(spilled, 1ull);
  }
  __syncthreads();
  sort_keys(kq, pq, k);
  hit_terms(kq, pq, k, p.qsig[q], p.self_occ[q], T);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double* mit_v = reinterpret_cast<const double*>(kq);
  const double* cfd_v = reinterpret_cast<const double*>(pq);
  // the terms are loaded kWalk at a time, so that their loads overlap
  // (the global segment's are L2 reads), then added one by one
  double m = 0.0, cc = 0.0;
  bool stop = false;
  for (int i0 = 0; i0 < k && !stop; i0 += kWalk) {
    double mv[kWalk], cv[kWalk];
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      mv[j] = i0 + j < k ? mit_v[i0 + j] : 0.0;
      cv[j] = i0 + j < k ? cfd_v[i0 + j] : -1.0;
    }
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      if (stop || cv[j] < 0.0) continue;
      m = __dadd_rn(m, mv[j]);
      cc = __dadd_rn(cc, cv[j]);
      stop = exits(m, cc, T);
    }
  }
  sums[2 * (long long)q] = m;
  sums[2 * (long long)q + 1] = cc;
}

int blocks_for(long long items) {
  const long long b = (items + 255) / 256;
  return (int)(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

}  // namespace

extern "C" int crackling_mxu_replay(
    const void* hq, const void* hs, const void* hid, const void* hpos,
    long long rows, const void* qsig, const void* self_id,
    const void* self_occ, int n, const void* entries, const void* occ,
    const void* mit_masks, const void* mit, int mit_count, const void* pen,
    double pam, int method,
    double maximum_sum, int width, void* cnt, void* offsets, void* key,
    void* pos, void* sums, void* spilled, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || rows < 0 || width < 1 || width > 32 || method < 0 ||
      method > 4 || mit_count < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Rows r{static_cast<const long long*>(hq), static_cast<const long long*>(hs),
         static_cast<const long long*>(hid),
         static_cast<const long long*>(hpos), rows};
  Page p{static_cast<const unsigned long long*>(qsig),
         static_cast<const long long*>(self_id),
         static_cast<const long long*>(self_occ), n};
  Terms T{static_cast<const unsigned long long*>(entries),
          static_cast<const int*>(occ), static_cast<const int*>(mit_masks),
          static_cast<const double*>(mit), static_cast<const double*>(pen),
          pam, maximum_sum, (1ull << width) - 1ull, mit_count, width,
          method};
  int* c = static_cast<int*>(cnt);
  long long* off = static_cast<long long*>(offsets);
  if ((err = cudaMemsetAsync(c, 0, sizeof(int) * (size_t)n, st)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(spilled, 0, sizeof(unsigned long long), st)) !=
          cudaSuccess)
    return (int)err;
  const int grid = blocks_for(rows + n);
  count_kernel<<<grid, 256, 0, st>>>(r, p, c);
  scan_kernel<<<1, kScanThreads, 0, st>>>(c, off, n);
  scatter_kernel<<<grid, 256, 0, st>>>(
      r, p, off, c, static_cast<unsigned long long*>(key),
      static_cast<long long*>(pos));
  replay_kernel<<<(unsigned)n, kThreads, 0, st>>>(
      off, static_cast<unsigned long long*>(key), static_cast<long long*>(pos),
      p, T, static_cast<double*>(sums),
      static_cast<unsigned long long*>(spilled));
  return (int)cudaGetLastError();
}
