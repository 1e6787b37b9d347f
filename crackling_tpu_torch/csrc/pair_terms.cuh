// The per-hit arithmetic of the kernels that score pairs: csrc/fullscan.cu
// (the full-scan scorers), csrc/compact_rescan.cu (the compact engine's
// rescan) and csrc/compact_decode.cu (its direct and tree steps). Each f32 term is formed as the port's plain version
// (issl_compact.pair_scores) forms it: MIT from the dense table by the
// 20-bit mismatch mask, CFD as pam times the penalty of every mismatched
// position in ascending order, exactly 1.0 at distance 0.

#pragma once

#include <stdint.h>

namespace pair_terms {

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

// The f32 terms of the pair (e, q) of packed signatures (40 bits of 2-bit
// codes): hit_terms over their collapsed mismatch words.
__device__ __forceinline__ void pair_hit_terms(unsigned long long e,
                                               unsigned long long q,
                                               const float* __restrict__ mit_tab,
                                               const float* pen, float pam,
                                               float& mit, float& cfd) {
  const uint32_t q_lo = (uint32_t)q, q_hi = (uint32_t)(q >> 32) & 0xFFu;
  const uint32_t e_lo = (uint32_t)e, e_hi = (uint32_t)(e >> 32) & 0xFFu;
  const uint32_t xl = e_lo ^ q_lo, xh = e_hi ^ q_hi;
  hit_terms((xl | (xl >> 1)) & 0x55555555u, (xh | (xh >> 1)) & 0x55u, q_lo,
            q_hi, e_lo, e_hi, mit_tab, pen, pam, mit, cfd);
}

// The (20, 16) penalty table into shared memory, by a block of Threads.
template <int Threads>
__device__ __forceinline__ void load_penalties(float* pen,
                                               const float* __restrict__ g) {
  for (int k = threadIdx.x; k < kPenalties; k += Threads) pen[k] = g[k];
}

}  // namespace pair_terms
