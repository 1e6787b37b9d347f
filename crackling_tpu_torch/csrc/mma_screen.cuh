// The int8 tensor-core distance screen of the kernels that read the packed
// lists: csrc/compact_finder.cu (the packed compact finder),
// csrc/fullscan.cu (the full-scan scorers) and csrc/mxu_finder.cu (the
// exact engine's neighbour finder); csrc/compact_rescan.cu takes only its
// exact hit test (exact_hit).
//
// A pair's distance is the number of positions at which entry and query
// differ. Each position's base, one-hot over four int8 lanes, makes an
// entry a row and a query a column (1 at the lanes of the bases the query
// does not have), so (row . column) counts the mismatched positions,
// exactly, on the tensor cores (mma.sync m16n8k32, s8 in, s32 out). Lane
// 32 ks + 16 h + 4 t + m of a 32-lane k-step is base 2 ks + h at position
// 4 m + t of a 32-bit word of 16 positions, so the thread of a quad that
// holds lanes 4t..4t+3 of each half builds its registers from the word with
// two shifts and one 3-input logic op each (onehot4). Within a bucket of
// slice s every entry and query share slice s's positions; the word is then
// the other 16 (outside_slice), K = 64. A candidate (a sum within the
// bound) is re-tested from its packed words (exact_hit).
//
// stream_bucket is the loop of fullscan.cu and mxu_finder.cu: one block of
// kStreamWarps warps streams a bucket against up to 64 query columns and
// hands each m-tile's candidates to the kernel's own handler.

#pragma once

#include <stdint.h>

namespace mma_screen {

constexpr uint32_t kOnes = 0x01010101u;
constexpr unsigned kFull = 0xffffffffu;

// The 16 positions outside slice s as one word: position i at bits
// 2i..2i+1 in ascending order, slice s's byte (bits 8s..8s+7) cut out;
// ``low`` keeps bits 0..8s-1.
__device__ __forceinline__ uint32_t outside_slice(unsigned long long sig,
                                                  uint32_t low) {
  const uint32_t lo = (uint32_t)sig;
  const uint32_t up = __funnelshift_r(lo, (uint32_t)(sig >> 32), 8);
  return (lo & low) | (up & ~low);
}

// Thread t's four registers of a word's one-hot row: r[b] byte m is 1 iff
// position 4m + t has base b.
__device__ __forceinline__ void onehot4(uint32_t w, int t, uint32_t (&r)[4]) {
  const uint32_t c0 = w >> (2 * t);      // byte m bit 0: the code's bit 0
  const uint32_t c1 = c0 >> 1;           // ... its bit 1
  r[0] = ~c0 & ~c1 & kOnes;
  r[1] = c0 & ~c1 & kOnes;
  r[2] = ~c0 & c1 & kOnes;
  r[3] = c0 & c1 & kOnes;
}

// d = a . b
__device__ __forceinline__ void mma_first(int (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// d += a . b
__device__ __forceinline__ void mma_acc(int (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The exact hit test of one pair from its packed words: at most max_dist
// of the 20 positions mismatch, and no earlier slice (bytes 0..s-1 of the
// collapsed low word; ``force`` sets the others) matches exactly.
__device__ __forceinline__ bool exact_hit(unsigned long long e,
                                          unsigned long long q,
                                          uint32_t force, int max_dist) {
  const uint32_t xl = (uint32_t)e ^ (uint32_t)q;
  const uint32_t xh = ((uint32_t)(e >> 32) ^ (uint32_t)(q >> 32)) & 0xFFu;
  const uint32_t cl = (xl | (xl >> 1)) & 0x55555555u;
  const uint32_t ch = (xh | (xh >> 1)) & 0x55u;
  if (__popc(cl) + __popc(ch) > max_dist) return false;
  const uint32_t xb = cl | force;
  return ((xb - 0x01010101u) & ~xb & 0x80808080u) == 0u;
}

// The A fragments of the m-tile whose rows g and g + 8 lie at lanes src
// and src + 8 of w: per k-step ks the bases 2ks (a0, a1) and 2ks + 1 (a2,
// a3) of rows g (a0, a2) and g + 8 (a1, a3).
__device__ __forceinline__ void a_fragments(uint32_t w, int src, int t,
                                            uint32_t (&a)[2][4]) {
  uint32_t ra[4], rb[4];
  onehot4(__shfl_sync(kFull, w, src), t, ra);
  onehot4(__shfl_sync(kFull, w, src + 8), t, rb);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    a[ks][0] = ra[2 * ks];
    a[ks][1] = rb[2 * ks];
    a[ks][2] = ra[2 * ks + 1];
    a[ks][3] = rb[2 * ks + 1];
  }
}

// The OR of a thread's sums, as a tree: negative iff one of them is.
template <int NT>
__device__ __forceinline__ int or_tree(const int (&d)[NT][4]) {
  int v[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    v[i] = (d[i][0] | d[i][1]) | (d[i][2] | d[i][3]);
#pragma unroll
  for (int w = 1; w < NT; w *= 2)
#pragma unroll
    for (int i = 0; i + w < NT; i += 2 * w) v[i] |= v[i + w];
  return v[0];
}

// -- the bucket loop --------------------------------------------------------

constexpr int kStreamWarps = 8;      // warps of a block that streams a bucket
constexpr int kStreamBatch = 64;     // entries per warp step: 4 m-tiles

// The bucket of ``k`` against NT n-tiles of live columns (8 each), KS k32
// steps (2: K = 64, the positions outside slice s; 3: K = 96, all 20). The
// block's kStreamWarps warps take the bucket's 64-entry batches in turn, a
// lane loading two entries (coalesced, one batch ahead), and the quads
// exchange words by shuffles, so no operand passes through shared memory.
// ``K`` is the kernel's view of the block:
//   bucket, len      the bucket's packed entries and its length
//   low              outside_slice's mask for the bucket's slice
//   max_dist         the screen's bound
//   nlive, qcol      live columns 0..nlive-1 and their query signatures
//   entry(e)         an entry as the screen sees it (the kernel's mask)
//   candidates(cand, r0, t)  a warp's candidates of one m-tile: bit 4i + e
//                    is element e of n-tile i (rows r0, r0 + 8; column
//                    8i + 2t + (e & 1)); the handler re-tests them
template <int KS, int NT, class K>
__device__ __forceinline__ void stream_bucket(const K& k) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // rows g, g + 8; column g
  const int t = lane & 3;

  // B fragments: column g of n-tile i is live column 8i + g; per k-step
  // ks the bases 2ks (b0) and 2ks + 1 (b1); with KS = 3, bf[i][4] the
  // bases of position 16 + t (byte m: base m) and bf[i][5] the zero half.
  // Every row has one base at position 0 (byte 0 of thread 0's
  // registers), so max_dist + 1 taken from position 0's four weights
  // starts every sum at -(max_dist + 1).
  const uint32_t bias = (uint32_t)(k.max_dist + 1);
  uint32_t bf[NT][2 * KS];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = 8 * i + g;
    const bool live = col < k.nlive;
    const unsigned long long q = live ? k.qcol[col] : 0ull;
    uint32_t r[4];
    onehot4(KS == 2 ? outside_slice(q, k.low) : (uint32_t)q, t, r);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t w = live ? r[b] ^ kOnes : 2u * kOnes;
      bf[i][b] = t == 0 ? (w & ~0xFFu) | ((w - bias) & 0xFFu) : w;
    }
    if constexpr (KS == 3) {
      const uint32_t code = (uint32_t)(q >> (32 + 2 * t)) & 3u;
      bf[i][4] = live ? (1u << (8 * code)) ^ kOnes : 2u * kOnes;
      bf[i][5] = 0u;
    }
  }
  const int nb = (k.len + kStreamBatch - 1) / kStreamBatch;

  // lane l holds entries l and l + 32 of batch bt; past the bucket, 0
  unsigned long long nxt[2];
  auto load = [&](int bt) {
    const int r = bt * kStreamBatch + lane;
    nxt[0] = r < k.len ? k.entry(__ldg(k.bucket + r)) : 0ull;
    nxt[1] = r + 32 < k.len ? k.entry(__ldg(k.bucket + r + 32)) : 0ull;
  };
  // the A fragments of the m-tile whose rows g and g + 8 lie at lanes src
  // and src + 8 of (w, hi): two k-steps from the words w, and with KS = 3
  // a third from the high bytes (its upper half a3[2], a3[3] stays 0)
  uint32_t a[2][4];
  uint32_t a3[4] = {0u, 0u, 0u, 0u};
  auto fragments = [&](uint32_t w, uint32_t hi, int src) {
    a_fragments(w, src, t, a);
    if constexpr (KS == 3) {
      a3[0] = 1u << (8 * ((__shfl_sync(kFull, hi, src) >> (2 * t)) & 3u));
      a3[1] = 1u << (8 * ((__shfl_sync(kFull, hi, src + 8) >> (2 * t))
                          & 3u));
    }
  };
  int bt = warp;
  if (bt < nb) load(bt);
  for (; bt < nb; bt += kStreamWarps) {
    const uint32_t w0 = KS == 2 ? outside_slice(nxt[0], k.low)
                                : (uint32_t)nxt[0];
    const uint32_t w1 = KS == 2 ? outside_slice(nxt[1], k.low)
                                : (uint32_t)nxt[1];
    const uint32_t h0 = (uint32_t)(nxt[0] >> 32);
    const uint32_t h1 = (uint32_t)(nxt[1] >> 32);
    if (bt + kStreamWarps < nb) load(bt + kStreamWarps);
    // m-tile m: entries 16m..16m+15 of the batch; its row g is at lane
    // 16 (m & 1) + g of w0 (m < 2) or w1. The next m-tile's A fragments
    // are built while this one's products are in flight.
    fragments(w0, h0, g);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int d[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        mma_first(d[i], a[0], bf[i][0], bf[i][1]);
        mma_acc(d[i], a[1], bf[i][2], bf[i][3]);
        if constexpr (KS == 3) mma_acc(d[i], a3, bf[i][4], bf[i][5]);
      }
      if (m < 3)
        fragments(m < 1 ? w0 : w1, m < 1 ? h0 : h1, 16 * ((m + 1) & 1) + g);
      if (__any_sync(kFull, or_tree<NT>(d) < 0)) {
        uint32_t cand = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cand |= ((uint32_t)d[i][e] >> 31) << (4 * i + e);
        k.candidates(cand, bt * kStreamBatch + 16 * m + g, t);
        __syncwarp();     // reconverge before the next mma.sync
      }
    }
  }
}

// stream_bucket with NT, the block's live n-tiles (1..8), known at run time;
// 0 streams nothing.
template <int KS, class K>
__device__ __forceinline__ void stream_bucket_nt(const K& k, int nt) {
  switch (nt) {
    case 1: stream_bucket<KS, 1>(k); break;
    case 2: stream_bucket<KS, 2>(k); break;
    case 3: stream_bucket<KS, 3>(k); break;
    case 4: stream_bucket<KS, 4>(k); break;
    case 5: stream_bucket<KS, 5>(k); break;
    case 6: stream_bucket<KS, 6>(k); break;
    case 7: stream_bucket<KS, 7>(k); break;
    case 8: stream_bucket<KS, 8>(k); break;
    default: break;
  }
}

}  // namespace mma_screen
