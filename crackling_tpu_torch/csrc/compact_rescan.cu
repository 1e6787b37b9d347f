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
// csrc/fullscan.cu and csrc/compact_decode.cu): the plain version's f32 terms, then occ x term as the
// f32 product the plain version forms, widened to f64. Each row's two sums
// go to mit_sums[hq] and cfd_sums[hq] by one f64 atomicAdd each, so kernel
// and plain version differ only in the order of their f64 sums.
//
// What bounds it on the H100: bytes. The 27 Mbp operating point's
// 65,536-query page rescans 5,595 rows of up to 4,096 entries, 21.9 M pairs
// (8 B of packed entry each, 0.18 GB); the slots of one bucket share its
// chunks, so the bytes that must move are the distinct chunks' entries, and
// a chunk's other rows read it again from L2. The screen is ~20 32-bit
// operations per pair (~0.007 ms at the 67e12 ALU peak); the ~19 K hits
// read 4 B of occurrence and 4 B of MIT table each.
//
// What the design does about it: one block of 128 threads per row, and a
// padding row's block leaves at once, so the work follows the rows the page
// has and not the list's capacity. Each thread loads kUnroll entries a round
// (neighbouring threads on neighbouring 8-B words, kUnroll loads in flight),
// screens them in registers and scores only the hits, re-reading a hit's
// entry and its occurrence from memory in a rolled loop so the rare scoring
// path stays small. A warp shuffle and one exchange in shared memory reduce
// the row's sums.
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
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // entries a thread loads per round

__global__ void __launch_bounds__(kThreads)
compact_rescan_kernel(const long long* __restrict__ ridx,
                      const unsigned long long* __restrict__ qsig,
                      const long long* __restrict__ hq,
                      const long long* __restrict__ start,
                      const long long* __restrict__ live,
                      const long long* __restrict__ slice, int n,
                      int scan_width, int max_dist,
                      const unsigned long long* __restrict__ entries,
                      const int* __restrict__ occ,
                      const float* __restrict__ mit_tab,
                      const float* __restrict__ pen_g, float pam,
                      double* __restrict__ mit_sums,
                      double* __restrict__ cfd_sums) {
  __shared__ float pen[kPenalties];
  __shared__ double part[2][kWarps];

  const long long r = blockIdx.x;
  const long long h = hq[r];
  if (ridx[r] < 0 || h < 0 || h >= n) return;   // uniform over the block
  pair_terms::load_penalties<kThreads>(pen, pen_g);
  __syncthreads();

  const unsigned long long q = qsig[r];
  // bytes 0..s-1 of the collapsed low word are the earlier slices; the
  // others are forced nonzero so only those can test clean
  const int s = (int)slice[r];
  const uint32_t force =
      s < 4 ? ~(uint32_t)((1ull << (8 * s)) - 1ull) : 0u;
  const unsigned long long* row = entries + start[r];
  const int* row_occ = occ + start[r];
  const long long left = live[r];
  const int len = left <= 0 ? 0 : left < scan_width ? (int)left : scan_width;

  double m = 0.0, c = 0.0;
  for (int c0 = threadIdx.x; c0 < len; c0 += kUnroll * kThreads) {
    unsigned long long e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = c0 + u * kThreads;
      e[u] = col < len ? __ldg(row + col) : 0ull;
    }
    uint32_t hits = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * kThreads < len && exact_hit(e[u], q, force, max_dist))
        hits |= 1u << u;
    }
#pragma unroll 1
    while (hits != 0u) {
      const int col = c0 + (__ffs(hits) - 1) * kThreads;
      hits &= hits - 1u;
      float mit, cfd;
      pair_hit_terms(__ldg(row + col), q, mit_tab, pen, pam, mit, cfd);
      const float w = (float)__ldg(row_occ + col);
      m += (double)__fmul_rn(mit, w);
      c += (double)__fmul_rn(cfd, w);
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m += __shfl_down_sync(kFull, m, o);
    c += __shfl_down_sync(kFull, c, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = m;
    part[1][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tm = 0.0, tc = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      tm += part[0][w];
      tc += part[1][w];
    }
    atomicAdd(mit_sums + h, tm);
    atomicAdd(cfd_sums + h, tc);
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
  compact_rescan_kernel<<<(unsigned)rows, kThreads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const long long*>(ridx),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const long long*>(hq), static_cast<const long long*>(start),
      static_cast<const long long*>(live),
      static_cast<const long long*>(slice), n, scan_width, max_dist,
      static_cast<const unsigned long long*>(entries),
      static_cast<const int*>(occ), static_cast<const float*>(mit_tab),
      static_cast<const float*>(pen), pam, static_cast<double*>(mit_sums),
      static_cast<double*>(cfd_sums));
  return (int)cudaGetLastError();
}
