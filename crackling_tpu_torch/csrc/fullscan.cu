// Full-scan scorers for Hopper (sm_90a): per (slice, query) occurrence-weighted
// MIT and CFD sums over every entry of the query's bucket.
//
// Replaces two TPU kernels that compute the same function:
// * crackling_dense_scan  <- crackling_tpu/ops/issl_dense.py::_kernel (the
//   dense engine). The TPU kernel gets the 20-bit mismatch mask and the MIT
//   and CFD log-sums from five bf16 matmuls of one-hot site tiles against
//   per-slot weight columns, because the MXU has no popcount, and completes
//   the products with exp2. Its queries sit in a padded slot plan (S, B, qb).
// * crackling_bucket_scan <- crackling_tpu/ops/issl_pallas.py::_kernel (the
//   scan-style engine). The TPU kernel loops over the bucket's queries one at
//   a time from SMEM, with XOR / collapse / popcount, a raw-XOR dedup at any
//   slice width and a CFD select tree. Its queries sit in a CSR of sorted
//   queries, qoff (S, B+1) and qsorted (S, n).
//
// The hit test is a distance screen on the tensor cores, as in
// csrc/compact_finder.cu (the helpers and the bucket loop, stream_bucket,
// are csrc/mma_screen.cuh, shared with csrc/mxu_finder.cu; the per-hit
// terms, pair_hit_terms, are csrc/pair_terms.cuh, shared with
// csrc/compact_rescan.cu and csrc/compact_decode.cu): every
// (entry, query) pair's distance is an int8 product (mma.sync m16n8k32) of
// the entry's one-hot row, built in registers from its packed word, by the
// query's weight column (1 at the lanes of the bases the query does not
// have). The product's K:
// * 64 where a bucket's own slice is one byte (w = 8: the dense scan, and
//   the bucket scan at w = 8): the 16 positions outside slice s, two k32
//   steps. Entries and queries of the bucket share slice s.
// * 96 at the bucket scan's other widths (2, 4, 16), where a slice is not
//   four whole positions: all 20 positions, three k32 steps. The first two
//   are positions 0-15 of the low word, laid out as at K = 64; in the third,
//   byte m of the first register is 1 iff position 16 + t has base m, and
//   its upper half (lanes 80-95) is zero.
// Position 0's weights are lowered by max_dist + 1 (every row has exactly
// one base there), so a pair is a candidate iff its sum is negative; an OR
// tree and one warp vote skip the (16-entry, NT x 8-query) tiles that hold
// none (nearly all: hits are rare). A query column of a padding slot holds
// 2 at every lane (distance 32 or 40: never a candidate); rows past the
// bucket load 0, distance 0 to a poly-A query, so the candidate path tests
// the rank. A candidate is re-tested from its packed words (the distance
// and the first-clean-slice dedup: the dense scan on the bytes of the
// collapsed low word, exact_hit; the bucket scan on each earlier slice's raw
// XOR bits at the index's width), and a hit then reads its MIT local score
// from the 2^20-entry f32 table by its 20-bit mask (4 MB, read only on hits,
// so it stays in L2), forms its CFD as pam times the penalty of every
// mismatched position in ascending order (1.0 at distance 0) from the
// 1.3 KB penalty table held in shared memory, reads its occurrence, and
// adds occ x term to its query's f64 sums in shared memory (atomics: the
// warps of a block hit the same queries). The f32 terms are formed in the
// order of the port's plain version (issl_compact.pair_scores), and occ x
// term is the plain version's product, so kernel and plain version differ
// only in the order of their f64 sums.
//
// What bounds it on the H100: the tensor cores. Per (query, entry) pair
// 2 x K int8 operations: at the dense engine's 65,536-query page of the
// 27 Mbp operating point (6.48e9 pairs, K = 64) 6.48e9 x 128 / 1,979e12 =
// 0.42 ms; per 8,192-query page of the scan-style engine (8.10e8 pairs)
// 0.05 ms, against ~0.06 ms for its packed lists (5 slices x 5.06 M entries
// x 8 B at 3.35 TB/s). The 32-bit ALU work is the operand build (per entry
// and 64-query group 2 x 6 ops per quad thread) and the OR fold (half an
// op per pair); the scoring runs only on the rare hits.
//
// What the design does about it: one block of eight warps per 64-query
// group of one (slice, bucket) (the dense scan: grid (64-slot groups of qb,
// B, S); the bucket scan: grid (B, S, Z), block z taking the bucket's
// groups of 64 consecutive CSR positions z, z + Z, ..., and a block whose
// bucket has fewer groups leaving at once). A block compacts its live
// queries into NT <= 8 n-tiles and builds their B fragments in registers
// once; its warps take the bucket's 64-entry batches in turn, a lane loading
// two entries (coalesced, one batch ahead), and the quads exchange words by
// shuffles, so no operand passes through shared memory and a group reads the
// bucket once. Occurrences are read only for hits: 8 B per streamed entry.
//
// Contract: launched on the caller's stream, allocates nothing, writes every
// output cell (0 where a slot holds no query), and each C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_screen.cuh"
#include "pair_terms.cuh"

namespace {

using mma_screen::exact_hit;
using mma_screen::kFull;
using mma_screen::stream_bucket_nt;
using pair_terms::pair_hit_terms;
using pair_terms::kPenalties;

constexpr int kThreads = mma_screen::kStreamWarps * 32;
constexpr int kSlots = 64;            // queries per block (one group)
constexpr int kMaxZ = 64;             // the bucket scan's grid depth
// The bucket scan's exact hit test of one pair from its packed words: at
// most max_dist of the 20 positions mismatch, and no earlier slice has all
// its raw XOR bits 0 (the width divides 32, so no slice straddles the two
// words).
__device__ __forceinline__ bool exact_hit_raw(unsigned long long e,
                                              unsigned long long q, int s,
                                              int width, int max_dist) {
  const uint32_t xl = (uint32_t)e ^ (uint32_t)q;
  const uint32_t xh = ((uint32_t)(e >> 32) ^ (uint32_t)(q >> 32)) & 0xFFu;
  const uint32_t cl = (xl | (xl >> 1)) & 0x55555555u;
  const uint32_t ch = (xh | (xh >> 1)) & 0x55u;
  if (__popc(cl) + __popc(ch) > max_dist) return false;
  const uint32_t wmask = (1u << width) - 1u;
  for (int sp = 0; sp < s; ++sp) {
    const int sh = sp * width;
    if ((((sh < 32 ? xl : xh) >> (sh & 31)) & wmask) == 0u) return false;
  }
  return true;
}

// What every warp of a block reads while it streams its bucket.
struct Scan {
  const unsigned long long* bucket;   // the bucket's packed entries
  const int* occ;                     // their occurrences
  int len;                            // the bucket's length
  int s;                              // its slice
  uint32_t low;                       // outside_slice's mask for slice s
  uint32_t force;                     // exact_hit's mask (dense scan)
  int width;                          // the raw dedup's width; 0: exact_hit
  int max_dist;
  int nlive;                          // live queries = columns 0..nlive-1
  const int* slot_of;                 // column -> the block's slot
  const unsigned long long* qcol;     // column -> query signature
  double* mit;                        // slot -> f64 MIT sum (shared)
  double* cfd;                        // slot -> f64 CFD sum (shared)
  const float* mit_tab;
  const float* pen;                   // shared
  float pam;

  // stream_bucket's view: entries as stored; candidates to add_candidates
  __device__ __forceinline__ unsigned long long entry(
      unsigned long long e) const {
    return e;
  }
  __device__ __forceinline__ void candidates(uint32_t cand, int r0,
                                             int t) const;
};

// A warp's candidates of one m-tile (bit 4i + e of ``cand``: element e of
// n-tile i; rows r0 and r0 + 8) through the exact test; each hit adds occ x
// its terms to its slot's sums. A rolled loop: the candidate path stays
// small and stays in the instruction cache.
__device__ __forceinline__ void add_candidates(const Scan& k, uint32_t cand,
                                               int r0, int t) {
#pragma unroll 1
  while (cand != 0u) {
    const int bit = __ffs(cand) - 1;
    cand &= cand - 1u;
    const int r = r0 + 8 * ((bit >> 1) & 1);
    const int col = 8 * (bit >> 2) + 2 * t + (bit & 1);
    if (r >= k.len || col >= k.nlive) continue;
    const unsigned long long e = k.bucket[r];
    const unsigned long long q = k.qcol[col];
    if (k.width ? !exact_hit_raw(e, q, k.s, k.width, k.max_dist)
                : !exact_hit(e, q, k.force, k.max_dist))
      continue;
    float mit, cfd;
    pair_hit_terms(e, q, k.mit_tab, k.pen, k.pam, mit, cfd);
    const double w = (double)__ldg(k.occ + r);
    const int slot = k.slot_of[col];
    atomicAdd(k.mit + slot, (double)mit * w);
    atomicAdd(k.cfd + slot, (double)cfd * w);
  }
}

__device__ __forceinline__ void Scan::candidates(uint32_t cand, int r0,
                                                 int t) const {
  add_candidates(*this, cand, r0, t);
}

// The block's bucket of slice s and what every block reads of it.
__device__ __forceinline__ Scan scan_of(
    const unsigned long long* entries, const int* occ, long long epad,
    const long long* boff, const int* blen, long long sb, int s,
    int max_dist, const float* mit_tab, const float* pen, float pam,
    const int* slot_of, const unsigned long long* qcol,
    double (&sums)[2][kSlots]) {
  Scan k;
  const long long base = (long long)s * epad + boff[sb];
  k.bucket = entries + base;
  k.occ = occ + base;
  k.len = blen[sb];
  k.s = s;
  k.low = s < 5 ? (uint32_t)((1ull << (8 * s)) - 1ull) : 0xFFFFFFFFu;
  // bytes 0..s-1 of the collapsed low word are the earlier slices; the
  // others are forced nonzero so only those can test clean
  k.force = ~k.low;
  k.width = 0;
  k.max_dist = max_dist;
  k.nlive = 0;
  k.slot_of = slot_of;
  k.qcol = qcol;
  k.mit = sums[0];
  k.cfd = sums[1];
  k.mit_tab = mit_tab;
  k.pen = pen;
  k.pam = pam;
  return k;
}

__global__ void __launch_bounds__(kThreads, 2)
dense_scan_kernel(const unsigned long long* __restrict__ entries,
                  const int* __restrict__ occ, long long epad,
                  const long long* __restrict__ boff,
                  const int* __restrict__ blen,
                  const unsigned long long* __restrict__ qsig,
                  const int* __restrict__ qsp, int B, int qb, int n,
                  int max_dist, const float* __restrict__ mit_tab,
                  const float* __restrict__ pen_g, float pam,
                  double* __restrict__ out_mit, double* __restrict__ out_cfd) {
  __shared__ int slot_of[kSlots];
  __shared__ unsigned long long qcol[kSlots];
  __shared__ double sums[2][kSlots];
  __shared__ float pen[kPenalties];
  __shared__ int warp_live[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = blockIdx.z;
  const long long sb = (long long)s * B + blockIdx.y;
  const int j0 = blockIdx.x * kSlots;
  const int slots = min(kSlots, qb - j0);
  pair_terms::load_penalties<kThreads>(pen, pen_g);
  Scan k = scan_of(entries, occ, epad, boff, blen, sb, s, max_dist, mit_tab,
                   pen, pam, slot_of, qcol, sums);

  // the block's live slots (query id in [0, n)) become columns 0..nlive-1
  // in plan order; padding slots (id n) read no signature
  int id = n;
  if (tid < kSlots) {
    if (tid < slots) id = qsp[sb * qb + j0 + tid];
    sums[0][tid] = 0.0;
    sums[1][tid] = 0.0;
  }
  const bool live = id >= 0 && id < n;
  const unsigned ballot = __ballot_sync(kFull, live);
  if (warp < 2 && lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  k.nlive = warp_live[0] + warp_live[1];
  if (live) {
    const int col = (warp ? warp_live[0] : 0) +
                    __popc(ballot & ((1u << lane) - 1u));
    slot_of[col] = tid;
    qcol[col] = qsig[id];
  }
  __syncthreads();

  stream_bucket_nt<2>(k, k.len > 0 ? (k.nlive + 7) / 8 : 0);
  __syncthreads();                           // every hit is in sums
  if (tid < slots) {
    out_mit[sb * qb + j0 + tid] = sums[0][tid];
    out_cfd[sb * qb + j0 + tid] = sums[1][tid];
  }
}

// KS k32 steps: 2 at w = 8 (K = 64), 3 at the other widths (K = 96); one
// instance each, so each keeps its own register allocation. At K = 64 three
// blocks share an SM (80 registers, no spill; a page's buckets hold few
// queries, so more warps in flight hide the loads); at K = 96 two (128
// registers; three would spill).
template <int KS>
__global__ void __launch_bounds__(kThreads, KS == 2 ? 3 : 2)
bucket_scan_kernel(const unsigned long long* __restrict__ entries,
                   const int* __restrict__ occ, long long epad,
                   const long long* __restrict__ boff,
                   const int* __restrict__ blen,
                   const unsigned long long* __restrict__ qsig,
                   const int* __restrict__ qoff,
                   const int* __restrict__ qsorted, int B, int n, int width,
                   int max_dist, const float* __restrict__ mit_tab,
                   const float* __restrict__ pen_g, float pam,
                   double* __restrict__ out_mit,
                   double* __restrict__ out_cfd) {
  __shared__ int slot_of[kSlots];
  __shared__ unsigned long long qcol[kSlots];
  __shared__ double sums[2][kSlots];
  __shared__ float pen[kPenalties];

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const long long sb = (long long)s * B + blockIdx.x;
  const int q0 = qoff[(long long)s * (B + 1) + blockIdx.x];
  const int nq = qoff[(long long)s * (B + 1) + blockIdx.x + 1] - q0;
  const int ngroups = (nq + kSlots - 1) / kSlots;
  if ((int)blockIdx.z >= ngroups) return;    // uniform over the block
  pair_terms::load_penalties<kThreads>(pen, pen_g);
  Scan k = scan_of(entries, occ, epad, boff, blen, sb, s, max_dist, mit_tab,
                   pen, pam, slot_of, qcol, sums);
  k.width = width;
  if (tid < kSlots) slot_of[tid] = tid;

  // group grp: CSR positions q0 + 64 grp .. of the bucket, columns in order
  for (int grp = blockIdx.z; grp < ngroups; grp += gridDim.z) {
    const long long at0 = (long long)s * n + q0 + (long long)grp * kSlots;
    k.nlive = min(kSlots, nq - grp * kSlots);
    __syncthreads();                         // the last group is written
    if (tid < kSlots) {
      sums[0][tid] = 0.0;
      sums[1][tid] = 0.0;
      if (tid < k.nlive) qcol[tid] = qsig[qsorted[at0 + tid]];
    }
    __syncthreads();
    stream_bucket_nt<KS>(k, k.len > 0 ? (k.nlive + 7) / 8 : 0);
    __syncthreads();                         // every hit is in sums
    if (tid < k.nlive) {
      out_mit[at0 + tid] = sums[0][tid];
      out_cfd[at0 + tid] = sums[1][tid];
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors: entries (S, epad) int64 packed signatures and occ
// (S, epad) int32 occurrences (bucket-aligned lists), boff (S, B) int64
// bucket starts, blen (S, B) int32 bucket lengths, qsig (n,) int64 query
// signatures, mit_tab (2^20,) f32, pen (20, 16) f32.
//
// Dense scan: qsp (S, B, qb) int32 slot plan (id n = padding); out_mit and
// out_cfd (S, B, qb) f64 per slot.
extern "C" int crackling_dense_scan(
    const void* entries, const void* occ, long long epad, const void* boff,
    const void* blen, const void* qsig, const void* qsp, int S, int B,
    int qb, int n, int max_dist, const void* mit_tab, const void* pen,
    float pam, void* out_mit, void* out_cfd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_dist < 0 || max_dist > 20) return (int)cudaErrorInvalidValue;
  const dim3 grid((qb + kSlots - 1) / kSlots, B, S);
  dense_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(entries),
      static_cast<const int*>(occ), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, max_dist,
      static_cast<const float*>(mit_tab), static_cast<const float*>(pen), pam,
      static_cast<double*>(out_mit), static_cast<double*>(out_cfd));
  return (int)cudaGetLastError();
}

// Bucket scan: qoff (S, B+1) int32 CSR offsets and qsorted (S, n) int32 query
// ids sorted by bucket, per slice; width the slice width in bits (even,
// dividing 32); out_mit and out_cfd (S, n) f64 per (slice, CSR position).
extern "C" int crackling_bucket_scan(
    const void* entries, const void* occ, long long epad, const void* boff,
    const void* blen, const void* qsig, const void* qoff,
    const void* qsorted, int S, int B, int n, int width, int max_dist,
    const void* mit_tab, const void* pen, float pam, void* out_mit,
    void* out_cfd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_dist < 0 || max_dist > 20 || width < 2 || width > 16 || width % 2 ||
      32 % width)
    return (int)cudaErrorInvalidValue;
  // as many blocks per bucket as an even spread of the page needs; a
  // bucket with more groups loops over them
  const long long per_bucket =
      ((long long)n + (long long)kSlots * B - 1) / ((long long)kSlots * B);
  const int z = (int)(per_bucket < 1 ? 1 : per_bucket > kMaxZ ? kMaxZ
                                                              : per_bucket);
  const dim3 grid(B, S, z);
  auto kernel = width == 8 ? bucket_scan_kernel<2> : bucket_scan_kernel<3>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(entries),
      static_cast<const int*>(occ), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qoff), static_cast<const int*>(qsorted), B, n,
      width, max_dist, static_cast<const float*>(mit_tab),
      static_cast<const float*>(pen), pam, static_cast<double*>(out_mit),
      static_cast<double*>(out_cfd));
  return (int)cudaGetLastError();
}
