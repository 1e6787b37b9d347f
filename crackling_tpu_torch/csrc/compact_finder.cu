// Compact finder for Hopper (sm_90a): per-(chunk, query slot) hit moments.
//
// Replaces: crackling_tpu/ops/issl_compact.py::_finder_kernel (with its
// _moment_tail and _moment_init). The TPU kernel builds the 20-bit mismatch
// mask with a one-hot bf16 matmul, because the MXU has no popcount. Hopper
// has __popc, so this kernel computes it directly: XOR -> pair collapse ->
// popcount, and tests the first-clean-slice dedup on the bytes of the
// collapsed low word (as the TPU engine's rescan does).
//
// What bounds it on the H100: integer ALU work, not bytes. A page does
// S x sum_b(blen_b x qb) (slot, entry) pair tests, about 1e10 at the
// 27 Mbp / 64K-query operating point, each some fifteen 32-bit integer
// instructions; the packed index it streams is ~320 MB, ~0.1 ms of HBM
// traffic. Hits are rare (distance <= 4 of 20 positions), so the moment
// updates are off the critical path.
//
// What the design does about it: one thread per query slot keeps its
// query's signature and its running quads (chunk, superchunk, bucket) in
// registers, so each pair costs only the predicate. A block of kThreads
// slots of one (slice, bucket) stages the bucket's packed entries in shared
// memory by coalesced cooperative loads, kTile entries at a time, and every
// thread reads each entry as a broadcast; the grid is
// (slot groups, buckets, slices), several blocks per SM, so the ragged
// bucket lengths even out. Ranks are exact integers (int32 counts and
// min/max, int64 rank sums).
//
// Contract: launched on the caller's stream, allocates nothing, writes
// every output cell (empty cells read 0, 0, kRankEmpty, -1), and the
// C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;          // query slots per block
constexpr int kTile = 512;            // entries per shared-memory tile
constexpr int kRankEmpty = 1 << 23;   // min rank of an empty cell

struct Quad {
  int cnt;
  long long sum;
  int rmin;
  int rmax;
};

__device__ __forceinline__ Quad quad_empty() {
  Quad q;
  q.cnt = 0;
  q.sum = 0;
  q.rmin = kRankEmpty;
  q.rmax = -1;
  return q;
}

__device__ __forceinline__ void quad_fold(Quad& into, const Quad& q) {
  into.cnt += q.cnt;
  into.sum += q.sum;
  into.rmin = min(into.rmin, q.rmin);
  into.rmax = max(into.rmax, q.rmax);
}

struct Planes {
  int* cnt;
  long long* rsum;
  int* rmin;
  int* rmax;

  __device__ __forceinline__ void store(long long at, const Quad& q) const {
    cnt[at] = q.cnt;
    rsum[at] = q.sum;
    rmin[at] = q.rmin;
    rmax[at] = q.rmax;
  }
};

__global__ void __launch_bounds__(kThreads)
compact_finder_kernel(const unsigned long long* __restrict__ entries,
                      long long epad, const long long* __restrict__ boff,
                      const int* __restrict__ blen,
                      const unsigned long long* __restrict__ qsig,
                      const int* __restrict__ qsp, int B, int qb, int n,
                      int chunk, int nchmax, int superchunk, int nsc,
                      int max_dist, Planes out) {
  __shared__ uint32_t tile_lo[kTile];
  __shared__ uint32_t tile_hi[kTile];

  const int s = blockIdx.z;
  const long long sb = (long long)s * B + blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = j < qb;
  const int qid = in_range ? qsp[sb * qb + j] : n;
  // padding slots (id n) read no signature and produce no hits
  const bool active = qid >= 0 && qid < n;
  uint32_t q_lo = 0u, q_hi = 0u;
  if (active) {
    const unsigned long long q = qsig[qid];
    q_lo = (uint32_t)q;
    q_hi = (uint32_t)(q >> 32) & 0xFFu;
  }
  // bytes 0..s-1 of the collapsed low word are the earlier slices; the
  // others are forced nonzero so only those can test clean
  const uint32_t force = ~(uint32_t)((1ull << (8 * s)) - 1ull);

  const int len = blen[sb];
  const unsigned long long* bucket = entries + (long long)s * epad + boff[sb];
  const int nch = (len + chunk - 1) / chunk;
  const long long ncells = nchmax + nsc + 1;
  const long long cell0 = sb * ncells * qb + j;   // cell c at cell0 + c*qb

  Quad tot = quad_empty();
  Quad sc = quad_empty();
  for (int c = 0; c < nch; ++c) {
    Quad ck = quad_empty();
    const int cend = min(len, (c + 1) * chunk);
    for (int t0 = c * chunk; t0 < cend; t0 += kTile) {
      const int tn = min(kTile, cend - t0);
      __syncthreads();                       // last tile fully consumed
      for (int k = threadIdx.x; k < tn; k += kThreads) {
        const unsigned long long e = bucket[t0 + k];
        tile_lo[k] = (uint32_t)e;
        tile_hi[k] = (uint32_t)(e >> 32);
      }
      __syncthreads();
      if (!active) continue;
#pragma unroll 8
      for (int k = 0; k < tn; ++k) {
        const uint32_t xl = tile_lo[k] ^ q_lo;
        const uint32_t xh = (tile_hi[k] ^ q_hi) & 0xFFu;
        const uint32_t cl = (xl | (xl >> 1)) & 0x55555555u;
        const uint32_t ch = (xh | (xh >> 1)) & 0x55u;
        if (__popc(cl) + __popc(ch) <= max_dist) {
          const uint32_t xb = cl | force;
          if (((xb - 0x01010101u) & ~xb & 0x80808080u) == 0u) {
            const int r = t0 + k;
            ck.cnt += 1;
            ck.sum += r;
            ck.rmin = min(ck.rmin, r);
            ck.rmax = r;                     // ranks ascend
          }
        }
      }
    }
    if (in_range) out.store(cell0 + (long long)c * qb, ck);
    quad_fold(tot, ck);
    if (superchunk > 0) {
      quad_fold(sc, ck);
      if ((c + 1) % superchunk == 0 || c == nch - 1) {
        if (in_range)
          out.store(cell0 + (long long)(nchmax + c / superchunk) * qb, sc);
        sc = quad_empty();
      }
    }
  }
  if (!in_range) return;
  const Quad empty = quad_empty();
  for (int c = nch; c < nchmax; ++c) out.store(cell0 + (long long)c * qb, empty);
  if (superchunk > 0) {
    for (int u = (nch + superchunk - 1) / superchunk; u < nsc; ++u)
      out.store(cell0 + (long long)(nchmax + u) * qb, empty);
  }
  out.store(cell0 + (long long)(nchmax + nsc) * qb, tot);
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// of contiguous tensors: entries (S, epad) int64, boff (S, B) int64,
// blen (S, B) int32, qsig (n,) int64, qsp (S, B, qb) int32; outputs
// (S, B, nchmax + nsc + 1, qb): cnt/rmin/rmax int32, rsum int64.
extern "C" int crackling_compact_finder(
    const void* entries, long long epad, const void* boff, const void* blen,
    const void* qsig, const void* qsp, int S, int B, int qb, int n,
    int chunk, int nchmax, int superchunk, int nsc, int max_dist,
    void* cnt, void* rsum, void* rmin, void* rmax, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Planes out{static_cast<int*>(cnt), static_cast<long long*>(rsum),
                   static_cast<int*>(rmin), static_cast<int*>(rmax)};
  const dim3 grid((qb + kThreads - 1) / kThreads, B, S);
  compact_finder_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(entries), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, chunk, nchmax, superchunk, nsc,
      max_dist, out);
  return (int)cudaGetLastError();
}
