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
// Hopper has __popc, so both entry points compute each pair directly: XOR,
// pair collapse and popcount give the distance; only a pair within max_dist
// tests the first-clean-slice dedup (dense: the bytes of the collapsed low
// word, w = 8, as the compact finder; bucket scan: each earlier slice's raw
// XOR bits, at the index's width); a hit then reads its MIT local score from
// the 2^20-entry f32 table by its 20-bit mask (4 MB, read only on hits, so it
// stays in L2) and forms its CFD as pam times the penalty of every mismatched
// position in ascending order (1.0 at distance 0), from the 1.3 KB penalty
// table held in shared memory. The f32 terms are formed in the order of the
// port's plain version (issl_compact.pair_scores), and each hit adds
// occ x term to an f64 accumulator (an exact product), so kernel and plain
// version differ only in the order of their f64 sums.
//
// What bounds it on the H100: integer ALU work, not bytes. A page does one
// distance test per (query, bucket entry) pair: S x sum_b(blen_b x queries_b),
// 6.48e9 pairs for the dense engine's 65,536-query page at the 27 Mbp
// operating point (the compact finder's pairs and predicate), ~12 32-bit
// operations each, ~1.16 ms at the card's 67e12 op/s; the scan-style engine's
// pairs are what its CSR ranges give. The packed index streamed per page is
// ~12 B per entry per slice (~0.4 GB at 27 Mbp, ~0.1 ms of HBM). Hits are
// rare (distance <= 4 of 20 positions), so the scoring branch is off the
// critical path.
//
// What the design does about it: one thread per query (a slot of the plan,
// or a position of the bucket's CSR range) keeps its signature and two f64
// accumulators in registers, so each pair costs only the distance test. A
// block of kThreads queries of one (slice, bucket) stages the bucket's packed
// entries and occurrences in shared memory by coalesced cooperative loads,
// kTile entries at a time, and every thread reads each entry as a broadcast.
// Padding slots (id >= n) and entries past the bucket's length are skipped by
// index. The bucket scan walks its bucket's CSR range in groups of kThreads
// inside one block per (slice, bucket), so a bucket with fewer queries leaves
// lanes idle (at 8,192 queries a bucket holds ~32 per slice).
//
// Contract: launched on the caller's stream, allocates nothing, writes every
// output cell (0 where a slot holds no query), and each C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;          // queries per block
constexpr int kTile = 512;            // entries per shared-memory tile
constexpr int kPenalties = 20 * 16;   // CFD position penalties

__device__ __forceinline__ uint32_t compress_even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// The f32 terms of one hit, given the collapsed mismatch words (cl: positions
// 0-15 in the even bits, ch: positions 16-19): MIT from the dense table by the
// 20-bit mask, CFD = pam x pen[p][q_p << 2 | (o_p ^ 3)] over the mismatched
// positions p in ascending order, exactly 1.0 at distance 0.
__device__ __forceinline__ void hit_terms(uint32_t cl, uint32_t ch,
                                          uint32_t q_lo, uint32_t q_hi,
                                          uint32_t e_lo, uint32_t e_hi,
                                          const float* __restrict__ mit_tab,
                                          const float* pen, float pam,
                                          float& mit, float& cfd) {
  const uint32_t m20 = compress_even_bits(cl) | (compress_even_bits(ch) << 16);
  mit = __ldg(mit_tab + m20);
  if (m20 == 0u) {
    cfd = 1.0f;
    return;
  }
  float c = pam;
  for (uint32_t m = m20; m != 0u; m &= m - 1u) {
    const int p = __ffs(m) - 1;
    const int sh = 2 * (p & 15);
    const uint32_t qc = ((p < 16 ? q_lo : q_hi) >> sh) & 3u;
    const uint32_t oc = ((p < 16 ? e_lo : e_hi) >> sh) & 3u;
    c = __fmul_rn(c, pen[p * 16 + ((qc << 2) | (oc ^ 3u))]);
  }
  cfd = c;
}

// One tile of the bucket's entries in shared memory.
struct Tile {
  uint32_t lo[kTile];
  uint32_t hi[kTile];
  int occ[kTile];
};

__device__ __forceinline__ void load_tile(Tile& t, const unsigned long long* e,
                                          const int* occ, int t0, int tn) {
  for (int k = threadIdx.x; k < tn; k += kThreads) {
    const unsigned long long v = e[t0 + k];
    t.lo[k] = (uint32_t)v;
    t.hi[k] = (uint32_t)(v >> 32);
    t.occ[k] = occ[t0 + k];
  }
}

__device__ __forceinline__ void load_penalties(float* pen,
                                               const float* __restrict__ g) {
  for (int k = threadIdx.x; k < kPenalties; k += kThreads) pen[k] = g[k];
}

__global__ void __launch_bounds__(kThreads)
dense_scan_kernel(const unsigned long long* __restrict__ entries,
                  const int* __restrict__ occ, long long epad,
                  const long long* __restrict__ boff,
                  const int* __restrict__ blen,
                  const unsigned long long* __restrict__ qsig,
                  const int* __restrict__ qsp, int B, int qb, int n,
                  int max_dist, const float* __restrict__ mit_tab,
                  const float* __restrict__ pen_g, float pam,
                  double* __restrict__ out_mit, double* __restrict__ out_cfd) {
  __shared__ Tile tile;
  __shared__ float pen[kPenalties];
  load_penalties(pen, pen_g);

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
  const long long base = (long long)s * epad + boff[sb];
  double acc_mit = 0.0, acc_cfd = 0.0;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int tn = min(kTile, len - t0);
    __syncthreads();                         // last tile fully consumed
    load_tile(tile, entries + base, occ + base, t0, tn);
    __syncthreads();
    if (!active) continue;
#pragma unroll 8
    for (int k = 0; k < tn; ++k) {
      const uint32_t e_lo = tile.lo[k], e_hi = tile.hi[k];
      const uint32_t xl = e_lo ^ q_lo;
      const uint32_t xh = (e_hi ^ q_hi) & 0xFFu;
      const uint32_t cl = (xl | (xl >> 1)) & 0x55555555u;
      const uint32_t ch = (xh | (xh >> 1)) & 0x55u;
      if (__popc(cl) + __popc(ch) > max_dist) continue;
      const uint32_t xb = cl | force;
      if (((xb - 0x01010101u) & ~xb & 0x80808080u) != 0u) continue;
      float mit, cfd;
      hit_terms(cl, ch, q_lo, q_hi, e_lo, e_hi & 0xFFu, mit_tab, pen, pam,
                mit, cfd);
      const double w = (double)tile.occ[k];
      acc_mit += (double)mit * w;
      acc_cfd += (double)cfd * w;
    }
  }
  if (in_range) {
    out_mit[sb * qb + j] = acc_mit;
    out_cfd[sb * qb + j] = acc_cfd;
  }
}

__global__ void __launch_bounds__(kThreads)
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
  __shared__ Tile tile;
  __shared__ float pen[kPenalties];

  const int s = blockIdx.y;
  const long long sb = (long long)s * B + blockIdx.x;
  const int q0 = qoff[(long long)s * (B + 1) + blockIdx.x];
  const int nq = qoff[(long long)s * (B + 1) + blockIdx.x + 1] - q0;
  if (nq <= 0) return;                       // uniform over the block
  load_penalties(pen, pen_g);
  const int len = blen[sb];
  const long long base = (long long)s * epad + boff[sb];
  const uint32_t wmask = (1u << width) - 1u;

  for (int g0 = 0; g0 < nq; g0 += kThreads) {
    const int i = g0 + threadIdx.x;
    const bool active = i < nq;
    const long long at = (long long)s * n + q0 + i;
    uint32_t q_lo = 0u, q_hi = 0u;
    if (active) {
      const unsigned long long q = qsig[qsorted[at]];
      q_lo = (uint32_t)q;
      q_hi = (uint32_t)(q >> 32) & 0xFFu;
    }
    double acc_mit = 0.0, acc_cfd = 0.0;
    for (int t0 = 0; t0 < len; t0 += kTile) {
      const int tn = min(kTile, len - t0);
      __syncthreads();                       // last tile fully consumed
      load_tile(tile, entries + base, occ + base, t0, tn);
      __syncthreads();
      if (!active) continue;
#pragma unroll 8
      for (int k = 0; k < tn; ++k) {
        const uint32_t e_lo = tile.lo[k], e_hi = tile.hi[k];
        const uint32_t xl = e_lo ^ q_lo;
        const uint32_t xh = (e_hi ^ q_hi) & 0xFFu;
        const uint32_t cl = (xl | (xl >> 1)) & 0x55555555u;
        const uint32_t ch = (xh | (xh >> 1)) & 0x55u;
        if (__popc(cl) + __popc(ch) > max_dist) continue;
        // an earlier slice whose raw XOR bits are all 0 matched exactly;
        // the width divides 32, so no slice straddles the two words
        bool seen = false;
        for (int sp = 0; sp < s && !seen; ++sp) {
          const int sh = sp * width;
          seen = (((sh < 32 ? xl : xh) >> (sh & 31)) & wmask) == 0u;
        }
        if (seen) continue;
        float mit, cfd;
        hit_terms(cl, ch, q_lo, q_hi, e_lo, e_hi & 0xFFu, mit_tab, pen, pam,
                  mit, cfd);
        const double w = (double)tile.occ[k];
        acc_mit += (double)mit * w;
        acc_cfd += (double)cfd * w;
      }
    }
    if (active) {
      out_mit[at] = acc_mit;
      out_cfd[at] = acc_cfd;
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
  const dim3 grid((qb + kThreads - 1) / kThreads, B, S);
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
  const dim3 grid(B, S);
  bucket_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
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
