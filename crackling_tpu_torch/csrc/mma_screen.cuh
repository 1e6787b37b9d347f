// The int8 tensor-core distance screen of the kernels that read the packed
// lists: csrc/compact_finder.cu (the packed compact finder) and
// csrc/fullscan.cu (the full-scan scorers).
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

}  // namespace mma_screen
