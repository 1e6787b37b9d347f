// Compact rescan for Hopper (sm_90a): the compact engine's step 3, per-row
// screened and occurrence-weighted MIT/CFD sums over the entries of every
// chunk whose finder cell holds 3 or more hits.
//
// Replaces: step 3 of crackling_tpu/ops/issl_compact.py::decode_score
// (scan_block, issl_compact.py:1016). It is no Pallas kernel: XLA fuses each
// block of rows into one pass. The port's first form of it was eager torch
// ops, about 600 launches over (rows, 4,096) temporaries per page; they stay
// as the plain version (ops/compact_rescan.py::compact_rescan_plain).
//
// The input is the page's compacted rescan list: per row (one chunk of one
// query slot) the query signature, its sum slot hq, the flat position of the
// chunk's first entry, the bucket's live length from there and the bucket's
// slice; ridx < 0 marks a padding row and hq = n a slot that holds no query.
// For each entry of a live row at a column below both the scan width and the
// live length, the pair is tested as the finder tested it (exact_hit, from
// csrc/mma_screen.cuh: at most max_dist mismatches, no earlier slice clean)
// and a hit is scored by pair_hit_terms (csrc/pair_terms.cuh, shared with
// csrc/fullscan.cu and csrc/compact_decode.cu): the plain version's f32
// terms, then occ x term as the f32 product the plain version forms,
// widened to f64 and added into mit_sums[hq] and cfd_sums[hq], so kernel
// and plain version differ only in the order of their f64 sums.
//
// What bounds it on the H100: bytes. The 27 Mbp operating point's
// 65,536-query page rescans 5,595 rows of up to 4,096 entries, 21.9 M pairs
// (8 B of packed entry each, 0.18 GB); the slots of one bucket share its
// chunks, so the bytes that must move are the distinct chunks' entries (8.23
// M, 66 MB: more than the 50 MB L2), each once. The screen is ~20 32-bit
// operations per pair (~0.007 ms at the 67e12 ALU peak); the ~19 K hits
// read 4 B of occurrence and 4 B of MIT table each. Tensor cores are not
// used: ~2.8 queries per chunk cannot fill an mma tile's 16 rows.
//
// What the design does about it: each entry of a chunk is loaded once for
// the rows that share it, and every block does the same work. The decode
// lists the rows of one chunk consecutively. The kernel cuts the list into
// segments: rows 8m .. 8m + 7, cut again before every row that does not
// continue its predecessor's run (same start, live length and slice, both
// live). The grid has one block of 128 threads per row, sized by the list
// with no host sync; a padding row's block leaves after one round of loads
// (warp 0 loads the segment's eight rows at once, a lane a row). The k
// blocks of a segment split its chunk into k parts, and block j streams
// part j, each thread kUnroll entries a round (neighbouring threads on
// neighbouring 8-B words), and screens each entry against all k queries of
// the segment: the chunk is read once, and each block does one chunk's
// worth of tests, as a row of one query does. The tests run in one small
// loop for any query count: a body unrolled for each count outgrows the
// instruction cache. Only the
// hits are scored (rare: ~19 K in 21.9 M pairs), in a rolled loop; their
// products go into each query's f64 sums in shared memory, which the block
// adds to mit_sums[hq], cfd_sums[hq] with one atomicAdd each. A list in any
// other order stays correct: its segments are single rows.
//
// Contract: launched on the caller's stream, allocates nothing, adds into the
// sums (never at slot n), and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_screen.cuh"
#include "pair_terms.cuh"

namespace {

using mma_screen::exact_hit;
using mma_screen::kFull;
using pair_terms::pair_hit_terms;
using pair_terms::kPenalties;

constexpr int kThreads = 128;
constexpr int kUnroll = 8;            // entries a thread loads per round
constexpr int kRun = 8;               // rows of a segment, at most

struct Rows {
  const long long* ridx;
  const unsigned long long* qsig;
  const long long* hq;
  const long long* start;
  const long long* live;
  const long long* slice;
  long long count;
  int n;
};

// One row's descriptor, its five fields loaded at once (no load waits on
// another's test).
struct Row {
  long long ridx, hq, start, live, slice;

  __device__ __forceinline__ Row(const Rows& rows, long long r)
      : ridx(__ldg(rows.ridx + r)), hq(__ldg(rows.hq + r)),
        start(__ldg(rows.start + r)), live(__ldg(rows.live + r)),
        slice(__ldg(rows.slice + r)) {}
  // a row that adds to a query's sums
  __device__ __forceinline__ bool scored(int n) const {
    return (ridx >= 0) & (hq >= 0) & (hq < n);
  }
  // both scored and on the same chunk: the second continues the first's run
  __device__ __forceinline__ bool joins(const Row& prev, int n) const {
    return scored(n) & prev.scored(n) & (start == prev.start) &
           (live == prev.live) & (slice == prev.slice);
  }
};

// A block's segment in shared memory: its queries and their sums, its
// chunk, and the block's part of it.
struct Segment {
  unsigned long long q[kRun];
  long long hq[kRun];
  double acc[2][kRun];                  // the block's sums of each query
  long long start, live;                // the chunk
  int nq, part, slice;                  // 0 queries: the block has no work
};

// Entries [lo, hi) of the chunk at row screened against the segment's
// queries: each thread loads kUnroll entries a round (neighbouring threads
// on neighbouring 8-B words) and tests each against every query in a loop
// (one small body for any query count: a body unrolled for each count
// outgrows the instruction cache), then scores only the hits, in a rolled
// loop that re-reads a hit's entry and occurrence, so the rare scoring path
// stays small; their products go into each query's f64 sums in shared
// memory.
__device__ __forceinline__ void screen_part(
    const unsigned long long* __restrict__ row, const int* __restrict__ occ,
    int lo, int hi, Segment& seg, int max_dist,
    const float* __restrict__ mit_tab, const float* pen, float pam) {
  const int s = seg.slice, nq = seg.nq;
  // bytes 0..s-1 of the collapsed low word are the earlier slices; the
  // others are forced nonzero so only those can test clean
  const uint32_t force = s < 4 ? ~((1u << (8 * s)) - 1u) : 0u;
  for (int c0 = lo + threadIdx.x; c0 < hi; c0 += kUnroll * kThreads) {
    unsigned long long e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = c0 + u * kThreads;
      e[u] = col < hi ? __ldg(row + col) : 0ull;
    }
    unsigned long long hits = 0ull;         // bit kRun * u + i
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * kThreads >= hi) break;
      for (int i = 0; i < nq; ++i)
        if (exact_hit(e[u], seg.q[i], force, max_dist))
          hits |= 1ull << (kRun * u + i);
    }
#pragma unroll 1
    while (hits != 0ull) {
      const int b = __ffsll((long long)hits) - 1;
      hits &= hits - 1ull;
      const int col = c0 + (b / kRun) * kThreads, i = b % kRun;
      float mit, cfd;
      pair_hit_terms(__ldg(row + col), seg.q[i], mit_tab, pen, pam, mit, cfd);
      const float w = (float)__ldg(occ + col);
      atomicAdd(&seg.acc[0][i], (double)__fmul_rn(mit, w));
      atomicAdd(&seg.acc[1][i], (double)__fmul_rn(cfd, w));
    }
  }
}

// One block per row of the list. Rows 8m .. 8m + 7 are cut into segments
// at every row that does not continue its predecessor's run; the k blocks
// of a segment split its chunk into k parts, and block j screens part j
// against all k queries, so each entry is loaded once for the segment and
// every block does the same work as a row of one query would (len tests).
__global__ void __launch_bounds__(kThreads)
compact_rescan_kernel(Rows rows, int scan_width, int max_dist,
                      const unsigned long long* __restrict__ entries,
                      const int* __restrict__ occ,
                      const float* __restrict__ mit_tab,
                      const float* __restrict__ pen_g, float pam,
                      double* __restrict__ mit_sums,
                      double* __restrict__ cfd_sums) {
  __shared__ float pen[kPenalties];
  __shared__ Segment seg;

  const long long r = blockIdx.x, base = r & ~(long long)(kRun - 1);
  const int at = (int)(r - base);
  if (threadIdx.x < 32) {
    // lane i holds row base + i, every field loaded at once; lane i - 1
    // hands it its predecessor
    const int i = threadIdx.x;
    const bool in = i < kRun && base + i < rows.count;
    const Row mine(rows, in ? base + i : base);
    const unsigned long long q = __ldg(rows.qsig + (in ? base + i : base));
    Row before = mine;
    before.ridx = __shfl_up_sync(kFull, mine.ridx, 1);
    before.hq = __shfl_up_sync(kFull, mine.hq, 1);
    before.start = __shfl_up_sync(kFull, mine.start, 1);
    before.live = __shfl_up_sync(kFull, mine.live, 1);
    before.slice = __shfl_up_sync(kFull, mine.slice, 1);
    const unsigned joined =
        __ballot_sync(kFull, in && i > 0 && mine.joins(before, rows.n));
    const unsigned scored = __ballot_sync(kFull, in && mine.scored(rows.n));
    // this row's segment: back to the first row that does not join, on to
    // the last that does
    int first = at, last = at;
    while (first > 0 && (joined >> first & 1u)) --first;
    while (last + 1 < kRun && (joined >> (last + 1) & 1u)) ++last;
    const int k = (scored >> at & 1u) ? last - first + 1 : 0;
    if (k > 0 && i >= first && i <= last) {
      seg.q[i - first] = q;
      seg.hq[i - first] = mine.hq;
      seg.acc[0][i - first] = 0.0;
      seg.acc[1][i - first] = 0.0;
    }
    if (i == at) {
      seg.nq = k;
      seg.part = at - first;
      seg.slice = (int)mine.slice;
      seg.start = mine.start;
      seg.live = mine.live;
    }
  }
  __syncthreads();
  const int nq = seg.nq;
  if (nq == 0) return;                      // uniform over the block
  pair_terms::load_penalties<kThreads>(pen, pen_g);
  __syncthreads();

  const int len = seg.live <= 0            ? 0
                  : seg.live < scan_width ? (int)seg.live
                                          : scan_width;
  const int lo = (int)((long long)len * seg.part / nq);
  const int hi = (int)((long long)len * (seg.part + 1) / nq);
  screen_part(entries + seg.start, occ + seg.start, lo, hi, seg, max_dist,
              mit_tab, pen, pam);
  __syncthreads();
  if (threadIdx.x < nq) {
    atomicAdd(mit_sums + seg.hq[threadIdx.x], seg.acc[0][threadIdx.x]);
    atomicAdd(cfd_sums + seg.hq[threadIdx.x], seg.acc[1][threadIdx.x]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors: the row descriptors ridx, qsig, hq, start, live, slice,
// each (rows,) int64; entries (E,) int64 packed signatures and occ (E,) int32
// occurrences (the bucket-aligned lists, flat), which must hold every entry
// start + col for col < min(scan_width, live) of each live row; mit_tab
// (2^20,) f32, pen (20, 16) f32; mit_sums and cfd_sums (n + 1,) f64, added
// to in place.
extern "C" int crackling_compact_rescan(
    const void* ridx, const void* qsig, const void* hq, const void* start,
    const void* live, const void* slice, long long rows, int n,
    int scan_width, int max_dist, const void* entries, const void* occ,
    const void* mit_tab, const void* pen, float pam, void* mit_sums,
    void* cfd_sums, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_dist < 0 || max_dist > 20 || scan_width < 0 || rows < 1 ||
      rows > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  Rows r;
  r.ridx = static_cast<const long long*>(ridx);
  r.qsig = static_cast<const unsigned long long*>(qsig);
  r.hq = static_cast<const long long*>(hq);
  r.start = static_cast<const long long*>(start);
  r.live = static_cast<const long long*>(live);
  r.slice = static_cast<const long long*>(slice);
  r.count = rows;
  r.n = n;
  compact_rescan_kernel<<<(unsigned)rows, kThreads, 0,
                          (cudaStream_t)stream>>>(
      r, scan_width, max_dist,
      static_cast<const unsigned long long*>(entries),
      static_cast<const int*>(occ), static_cast<const float*>(mit_tab),
      static_cast<const float*>(pen), pam, static_cast<double*>(mit_sums),
      static_cast<double*>(cfd_sums));
  return (int)cudaGetLastError();
}
