// Neighbour finder for Hopper (sm_90a): per-(segment, query slot) neighbour
// count and rank sum, the exact (MXU) engine's device scan.
//
// Replaces: crackling_tpu/ops/issl_mxu.py::_kernel. The TPU kernel gets each
// pair's match count from a bf16 matmul of int8 one-hot site planes
// (S, Epad, 128) against one-hot query columns and writes f32 count /
// position-sum rows interleaved in blocks of 8. This kernel reads the same
// bucket-aligned packed lists as the other finders (8 B per entry, no
// planes) and takes every pair's distance from the int8 tensor-core screen
// of csrc/mma_screen.cuh: each entry's one-hot row is built in registers
// from its packed word (A), each live query slot's weight column once per
// block (B: 1 at the lanes of the bases its query does not have, 2 at every
// lane of a padding column), and position 0's weights are lowered by
// max_dist + 1, so a pair is a candidate iff its sum is negative. The
// product's K follows the index's slice width, which the bucket count
// gives (B = 2^width):
// * 64 at width 8 (B = 256): the 16 positions outside slice s; every entry
//   and query of a bucket of slice s share slice s's byte;
// * 96 at every other width: all 20 positions (fullscan.cu's K = 96).
// Signatures are cut to their 2L bits (mask_lo, mask_hi) before the
// product, so positions at or past seq_length add no mismatch.
//
// A neighbour is an entry at distance 1..max_dist: each candidate is
// re-tested from its packed words (XOR, pair collapse, popcount of the 2L
// bits) and kept iff 1 <= d <= max_dist. Distance 0 (the query's own site,
// a candidate in each of its buckets) is dropped there and found by the
// host's binary search, and there is no dedup across slices (the host
// replay keeps each site's first occurrence).
//
// What bounds it on the H100: the tensor cores and the output planes. A
// page does S x sum_b(blen_b x live slots_b) pair tests, 3.24e9 for a
// 32,768-query page at the 27 Mbp operating point: 2 x 64 int8 operations
// each, 0.21 ms at the int8 peak. Its output, two planes of
// S x B x nseg x qb cells (4 + 8 B), is ~0.52 GB there, and the lists it
// reads ~0.2 GB: together ~0.22 ms at 3.35 TB/s.
//
// What the design does about it: one block of eight warps per (bucket,
// 64-slot group, slice) writes 0 to all its cells (coalesced, once), then
// streams the bucket with mma_screen::stream_bucket (fullscan.cu's loop);
// its handler adds each neighbour to its cell with global atomics
// (neighbours are rare, so the atomics are off the critical path). A block
// with no live slot streams nothing. Counts are int32 and rank sums int64,
// so both are exact at any depth.
//
// Output: cnt (S, B, nseg, qb) int32 and rsum (S, B, nseg, qb) int64, cell
// (s, b, g, j) = segment g (entries [g*segw, (g+1)*segw) of the bucket) of
// slot j; entries past nseg segments are not counted. Contract: launched on
// the caller's stream, allocates nothing, writes every output cell
// (segments past the bucket's end read 0), and the C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_screen.cuh"

namespace {

using mma_screen::kFull;
using mma_screen::stream_bucket_nt;

constexpr int kThreads = mma_screen::kStreamWarps * 32;
constexpr int kSlots = 64;            // query slots per block (one group)

// What every warp of a block reads while it streams its bucket, and the
// candidate handler of stream_bucket.
struct Block {
  const unsigned long long* bucket;   // the bucket's packed entries
  int len;                            // its length, at most nseg * segw
  uint32_t low;                       // outside_slice's mask for slice s
  int max_dist;
  int nlive;                          // live slots = columns 0..nlive-1
  const int* slot_of;                 // column -> the block's slot
  const unsigned long long* qcol;     // column -> masked query signature
  unsigned long long mask;            // the 2L signature bits
  int* cnt;                           // cell of the block's slot 0, seg 0
  unsigned long long* rsum;
  long long qb;                       // a segment's cell stride
  int segw;

  __device__ __forceinline__ unsigned long long entry(
      unsigned long long e) const {
    return e & mask;
  }

  // A warp's candidates of one m-tile through the 1..max_dist test into
  // their cells. A rolled loop: the candidate path stays small.
  __device__ __forceinline__ void candidates(uint32_t cand, int r0,
                                             int t) const {
#pragma unroll 1
    while (cand != 0u) {
      const int bit = __ffs(cand) - 1;
      cand &= cand - 1u;
      const int r = r0 + 8 * ((bit >> 1) & 1);
      const int col = 8 * (bit >> 2) + 2 * t + (bit & 1);
      if (r >= len || col >= nlive) continue;
      const unsigned long long x = entry(bucket[r]) ^ qcol[col];
      const uint32_t xl = (uint32_t)x, xh = (uint32_t)(x >> 32);
      const int d = __popc((xl | (xl >> 1)) & 0x55555555u) +
                    __popc((xh | (xh >> 1)) & 0x55555555u);
      // 1 <= d <= max_dist: d - 1 < max_dist as unsigned (0 wraps)
      if ((unsigned)(d - 1) >= (unsigned)max_dist) continue;
      const long long at = (long long)(r / segw) * qb + slot_of[col];
      atomicAdd(cnt + at, 1);
      atomicAdd(rsum + at, (unsigned long long)r);
    }
  }
};

// KS k32 steps: 2 at width 8 (K = 64), 3 at the other widths (K = 96); one
// instance each, so each keeps its own register allocation.
template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
mxu_finder_kernel(const unsigned long long* __restrict__ entries,
                  long long epad, const long long* __restrict__ boff,
                  const int* __restrict__ blen,
                  const unsigned long long* __restrict__ qsig,
                  const int* __restrict__ qsp, int B, int qb, int n,
                  int segw, int nseg, int max_dist, unsigned long long mask,
                  int* __restrict__ cnt, long long* __restrict__ rsum) {
  __shared__ int slot_of[kSlots];
  __shared__ unsigned long long qcol[kSlots];
  __shared__ int warp_live[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = blockIdx.z;
  const long long sb = (long long)s * B + blockIdx.x;
  const int j0 = blockIdx.y * kSlots;
  const int slots = min(kSlots, qb - j0);

  Block k;
  k.bucket = entries + (long long)s * epad + boff[sb];
  k.len = (int)min((long long)blen[sb], (long long)nseg * segw);
  k.low = s < 5 ? (uint32_t)((1ull << (8 * s)) - 1ull) : 0xFFFFFFFFu;
  k.max_dist = max_dist;
  k.slot_of = slot_of;
  k.qcol = qcol;
  k.mask = mask;
  k.cnt = cnt + sb * nseg * qb + j0;
  k.rsum = reinterpret_cast<unsigned long long*>(rsum) + sb * nseg * qb + j0;
  k.qb = qb;
  k.segw = segw;

  // every cell of the block's slots reads 0 before any neighbour is added
  for (int idx = tid; idx < nseg * kSlots; idx += kThreads) {
    const int jl = idx % kSlots;
    if (jl < slots) {
      const long long at = (long long)(idx / kSlots) * qb + jl;
      k.cnt[at] = 0;
      k.rsum[at] = 0ull;
    }
  }

  // the block's live slots (query id in [0, n)) become columns 0..nlive-1
  // in plan order; padding slots read no signature
  int id = n;
  if (tid < slots) id = qsp[sb * qb + j0 + tid];
  const bool live = id >= 0 && id < n;
  const unsigned ballot = __ballot_sync(kFull, live);
  if (warp < 2 && lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  k.nlive = warp_live[0] + warp_live[1];
  if (live) {
    const int col = (warp ? warp_live[0] : 0) +
                    __popc(ballot & ((1u << lane) - 1u));
    slot_of[col] = tid;
    qcol[col] = qsig[id] & mask;
  }
  __syncthreads();                 // columns and the zeroed cells are seen

  stream_bucket_nt<KS>(k, k.len > 0 ? (k.nlive + 7) / 8 : 0);
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors: entries (S, epad) int64, boff (S, B) int64, blen
// (S, B) int32, qsig (n,) int64, qsp (S, B, qb) int32; outputs cnt
// (S, B, nseg, qb) int32 and rsum (S, B, nseg, qb) int64. mask_lo / mask_hi
// keep the 2L signature bits of each 32-bit half. B = 2^width: the K = 64
// instance at B = 256 (width 8), K = 96 at the others.
extern "C" int crackling_mxu_finder(
    const void* entries, long long epad, const void* boff, const void* blen,
    const void* qsig, const void* qsp, int S, int B, int qb, int n,
    int segw, int nseg, int max_dist, unsigned int mask_lo,
    unsigned int mask_hi, void* cnt, void* rsum, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_dist < 0 || max_dist > 20 || segw < 1 || nseg < 1)
    return (int)cudaErrorInvalidValue;
  // buckets on x (up to 2^16 at w = 16), slot groups on y, slices on z
  const dim3 grid(B, (qb + kSlots - 1) / kSlots, S);
  const unsigned long long mask =
      (unsigned long long)mask_lo | ((unsigned long long)mask_hi << 32);
  auto kernel = B == 256 ? mxu_finder_kernel<2> : mxu_finder_kernel<3>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(entries), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, segw, nseg, max_dist, mask,
      static_cast<int*>(cnt), static_cast<long long*>(rsum));
  return (int)cudaGetLastError();
}
