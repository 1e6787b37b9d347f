// Neighbour finder for Hopper (sm_90a): per-(segment, query slot) neighbour
// count and rank sum, the exact (MXU) engine's device scan.
//
// Replaces: crackling_tpu/ops/issl_mxu.py::_kernel. The TPU kernel gets each
// pair's match count from a bf16 matmul of int8 one-hot site planes
// (S, Epad, 128) against one-hot query columns, because the MXU has no
// popcount, and writes f32 count / position-sum rows interleaved in blocks
// of 8. Hopper has __popc, so this kernel computes the distance directly
// from the packed 40-bit signatures (XOR -> pair collapse -> popcount, masked
// to 2L bits when L < 20) and needs no one-hot planes (640 B per site on the
// TPU); it reads the same bucket-aligned packed lists as the compact finder.
// A neighbour is an entry at distance 1..max_dist; distance 0 (the query's
// own site) is found by the host's binary search, and there is no dedup
// across slices (the host replay keeps each site's first occurrence).
//
// What bounds it on the H100: integer ALU work, not bytes. A page does
// S x sum_b(blen_b x occupied slots_b) (slot, entry) pair tests, about 3.2e9
// for a 32,768-query page at the 27 Mbp operating point, each some thirteen
// 32-bit integer instructions; the packed index it reads is ~200 MB and the
// integer planes it writes ~0.7 GB, ~0.3 ms of HBM traffic together.
// Neighbours are rare, so the moment updates are off the critical path.
//
// What the design does about it: one thread per query slot keeps its
// query's signature and its running (count, rank sum) in registers, so each
// pair costs only the distance test. A block of kThreads slots of one
// (slice, bucket) stages the bucket's entries in shared memory by coalesced
// cooperative loads, kTile entries at a time, and every thread reads each
// entry as a broadcast. Counts are int32 and rank sums int64, so both are
// exact at any depth.
//
// Output: cnt (S, B, nseg, qb) int32 and rsum (S, B, nseg, qb) int64, cell
// (s, b, g, j) = segment g (entries [g*segw, (g+1)*segw) of the bucket) of
// slot j. Contract: launched on the caller's stream, allocates nothing,
// writes every output cell (segments past the bucket's end read 0), and the
// C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;          // query slots per block
constexpr int kTile = 512;            // entries per shared-memory tile

__global__ void __launch_bounds__(kThreads)
mxu_finder_kernel(const unsigned long long* __restrict__ entries,
                  long long epad, const long long* __restrict__ boff,
                  const int* __restrict__ blen,
                  const unsigned long long* __restrict__ qsig,
                  const int* __restrict__ qsp, int B, int qb, int n,
                  int segw, int nseg, int max_dist, uint32_t mask_lo,
                  uint32_t mask_hi, int* __restrict__ cnt,
                  long long* __restrict__ rsum) {
  __shared__ uint2 tile[kTile];

  const int b = blockIdx.x;
  const int s = blockIdx.z;
  const long long sb = (long long)s * B + b;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const bool in_range = j < qb;
  const int qid = in_range ? qsp[sb * qb + j] : -1;
  // padding slots (any id outside [0, n)) read no signature, count nothing
  const bool active = qid >= 0 && qid < n;
  uint32_t q_lo = 0u, q_hi = 0u;
  if (active) {
    const unsigned long long q = qsig[qid];
    q_lo = (uint32_t)q & mask_lo;
    q_hi = (uint32_t)(q >> 32) & mask_hi;
  }
  // distance d is a neighbour iff 1 <= d <= max_dist, i.e. d - 1 < max_dist
  // as unsigned (d == 0 wraps to the largest value)
  const unsigned dmax = (unsigned)max_dist;

  const int len = blen[sb];
  const unsigned long long* bucket = entries + (long long)s * epad + boff[sb];
  const int used = min(nseg, (len + segw - 1) / segw);
  const long long cell0 = sb * nseg * qb + j;     // segment g at cell0 + g*qb

  for (int g = 0; g < used; ++g) {
    int c = 0;
    long long sum = 0;
    const int gend = min(len, (g + 1) * segw);
    for (int t0 = g * segw; t0 < gend; t0 += kTile) {
      const int tn = min(kTile, gend - t0);
      __syncthreads();                       // last tile fully consumed
      for (int k = threadIdx.x; k < tn; k += kThreads) {
        const unsigned long long e = bucket[t0 + k];
        tile[k] = make_uint2((uint32_t)e & mask_lo,
                             (uint32_t)(e >> 32) & mask_hi);
      }
      __syncthreads();
      if (!active) continue;
#pragma unroll 8
      for (int k = 0; k < tn; ++k) {
        const uint2 e = tile[k];
        const uint32_t xl = e.x ^ q_lo;
        const uint32_t xh = e.y ^ q_hi;
        const int d = __popc((xl | (xl >> 1)) & 0x55555555u) +
                      __popc((xh | (xh >> 1)) & 0x55555555u);
        if ((unsigned)(d - 1) < dmax) {
          c += 1;
          sum += t0 + k;
        }
      }
    }
    if (in_range) {
      cnt[cell0 + (long long)g * qb] = c;
      rsum[cell0 + (long long)g * qb] = sum;
    }
  }
  if (!in_range) return;
  for (int g = used; g < nseg; ++g) {
    cnt[cell0 + (long long)g * qb] = 0;
    rsum[cell0 + (long long)g * qb] = 0;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors: entries (S, epad) int64, boff (S, B) int64, blen
// (S, B) int32, qsig (n,) int64, qsp (S, B, qb) int32; outputs cnt
// (S, B, nseg, qb) int32 and rsum (S, B, nseg, qb) int64. mask_lo / mask_hi
// keep the 2L signature bits of each 32-bit half.
extern "C" int crackling_mxu_finder(
    const void* entries, long long epad, const void* boff, const void* blen,
    const void* qsig, const void* qsp, int S, int B, int qb, int n,
    int segw, int nseg, int max_dist, unsigned int mask_lo,
    unsigned int mask_hi, void* cnt, void* rsum, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // buckets on x (up to 2^16 at w = 16), slot groups on y, slices on z
  const dim3 grid(B, (qb + kThreads - 1) / kThreads, S);
  mxu_finder_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(entries), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, segw, nseg, max_dist,
      (uint32_t)mask_lo, (uint32_t)mask_hi, static_cast<int*>(cnt),
      static_cast<long long*>(rsum));
  return (int)cudaGetLastError();
}
