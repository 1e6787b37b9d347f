// Compact finder for Hopper (sm_90a): per-(chunk, query slot) hit moments,
// with every (slot, entry) pair's distance from an int8 tensor-core
// product over one-hot rows built in registers from the packed lists.
//
// Replaces: crackling_tpu/ops/issl_compact.py::_finder_kernel (with its
// _moment_tail and _moment_init). Like the TPU kernel, it turns each tile
// of packed entries into one-hot rows on chip and multiplies them by the
// query slots' weight columns; it reads the index as the packed int64
// lists (8 B per entry), never as one-hot planes.
//
// The product. Within bucket b of slice s every entry and every query slot
// share slice s's four positions, so the distance is the number of the
// other 16 positions that mismatch. Those 16 positions, 2 bits each, form
// one 32-bit word (the signature with slice s's byte cut out). Their
// one-hot rows have 64 lanes, K = 64: two k32 steps of mma.sync
// m16n8k32 (s8 in, s32 out, exact). Lane 32 ks + 16 h + 4 t + m is base
// 2 ks + h at position 4 m + t, so the thread of a quad that holds lanes
// 4t..4t+3 of each half builds its four A registers (one per base, byte m
// for position 4 m + t) from an entry's word with two shifts and four
// 3-input logic ops. A slot's column holds 1 at the lanes of the bases its
// query does not have (the same registers XOR 0x01010101), so
// (row . column) counts the mismatched positions; a padding slot's column
// holds 2 at every lane (distance 32: its sum 32 - max_dist - 1 > 0).
//
// The hit test in the epilogue. Position 0's weights are lowered by
// max_dist + 1 (every row has exactly one base there, so every sum is),
// and a pair is a candidate iff its sum is negative; the sums of a warp's
// (16-entry, NT x 8-slot) tile are ORed and one warp vote skips the tiles
// that hold no candidate (nearly all: hits are rare). For a candidate the
// lane re-tests the pair from its packed words: the rank below the bucket
// length, a live slot, the 20-position collapse and popcount, and the
// first-clean-slice dedup on the bytes of the collapsed low word. Hits fold
// into per-slot chunk quads in shared memory with atomics; chunk,
// superchunk and bucket cells are written as csrc/finder_cells.cuh says
// (shared with compact_onehot.cu).
//
// What bounds it on the H100: the tensor cores. Per live pair 2 x 64 int8
// operations: at the 27 Mbp / 65,536-query page (6.48e9 pairs) 6.48e9 x
// 128 / 1,979e12 = 0.42 ms (0.63 ms at the K = 96 of all 20 positions),
// against ~0.1 ms of packed lists and ~0.06 ms of output cells at 3.35
// TB/s. The 32-bit ALU work is the operand build (per entry and 64-slot
// group 2 x 6 ops per quad thread) and the epilogue's OR fold (half an op
// per pair).
//
// What the design does about it: the grid is (64-slot groups, buckets,
// slices), so the ragged buckets spread over many blocks and a long bucket
// is shared by its slot groups; a block compacts its live slots into
// NT <= 8 n-tiles and builds their B fragments in registers once. Its
// eight warps take the bucket's 64-entry batches in turn: a lane loads two
// entries (coalesced, one batch ahead), cuts slice s out, and the quads
// exchange words by shuffles, so no operand passes through shared memory
// and no bytes are read twice by a block. Each m-tile runs NT independent
// pairs of mma.sync from a zero accumulator (the bias sits in the weights,
// so no accumulator is initialised), and the next m-tile's A fragments are
// built while they are in flight. The candidate path is a rolled loop over
// a bit mask of the tile's negative sums: unrolled over every sum it
// was larger than the product loop and cost more than the products. The
// chunk quads are double-buffered: one barrier per chunk.
//
// Contract: launched on the caller's stream, allocates nothing, writes
// every output cell (empty cells read 0, 0, kRankEmpty, -1), and the
// C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "finder_cells.cuh"
#include "mma_screen.cuh"

namespace {

using finder_cells::Planes;
using finder_cells::Quads;
using finder_cells::SlotCells;
using mma_screen::a_fragments;
using mma_screen::exact_hit;
using mma_screen::kFull;
using mma_screen::kOnes;
using mma_screen::mma_acc;
using mma_screen::mma_first;
using mma_screen::onehot4;
using mma_screen::or_tree;
using mma_screen::outside_slice;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 64;              // query slots per block
constexpr int kBatch = 64;              // entries per warp step: 4 m-tiles
constexpr int kTile = kWarps * kBatch;  // entries per block round

// What every warp of a block reads while it streams its bucket.
struct Block {
  const unsigned long long* bucket;   // the bucket's packed entries
  int len;                            // its length
  int chunk;
  int nch;                            // its chunks
  uint32_t low;                       // outside_slice's mask for slice s
  uint32_t force;                     // exact_hit's mask for slice s
  int max_dist;
  int nlive;                          // live slots = columns 0..nlive-1
  const int* slot_of;                 // column -> the block's slot
  const unsigned long long* qcol;     // column -> query signature
  Quads ck[2];                        // chunk quads, by chunk parity
  Quads sc;
  Quads tot;
  Planes out;
  long long at0;                      // cell 0 of the block's slot 0
  long long qb;
  int nchmax;
  int nsc;
  int superchunk;
  int slots;                          // the block's slots within qb

  __device__ __forceinline__ SlotCells cells(int jl) const {
    return SlotCells{at0 + jl, qb, nchmax, nsc, superchunk};
  }
};

// A warp's candidates of one m-tile (bit 4i + e of ``cand``: element e of
// n-tile i; rows r0 and r0 + 8) through the exact test into the chunk
// quads. A rolled loop: the candidate path stays small and stays in the
// instruction cache.
__device__ __forceinline__ void add_candidates(const Block& k, const Quads& ck,
                                               uint32_t cand, int r0, int t) {
#pragma unroll 1
  while (cand != 0u) {
    const int bit = __ffs(cand) - 1;
    cand &= cand - 1u;
    const int r = r0 + 8 * ((bit >> 1) & 1);
    const int col = 8 * (bit >> 2) + 2 * t + (bit & 1);
    if (r < k.len && col < k.nlive &&
        exact_hit(k.bucket[r], k.qcol[col], k.force, k.max_dist))
      ck.add(k.slot_of[col], r);
  }
}

// The bucket against NT n-tiles of live columns (8 each): every chunk's
// batches, then its cells.
template <int NT>
__device__ __forceinline__ void stream_bucket(const Block& k) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // rows g, g + 8; column g
  const int t = lane & 3;

  // B fragments: column g of n-tile i is live column 8i + g; per k-step
  // ks the bases 2ks (b0) and 2ks + 1 (b1). Every row has one base at
  // position 0 (byte 0 of thread 0's registers), so max_dist + 1 taken
  // from position 0's four weights starts every sum at -(max_dist + 1).
  const uint32_t bias = (uint32_t)(k.max_dist + 1);
  uint32_t bf[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = 8 * i + g;
    uint32_t r[4];
    onehot4(outside_slice(col < k.nlive ? k.qcol[col] : 0ull, k.low), t, r);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t w = col < k.nlive ? r[b] ^ kOnes : 2u * kOnes;
      bf[i][b] = t == 0 ? (w & ~0xFFu) | ((w - bias) & 0xFFu) : w;
    }
  }
  const int nb = (k.len + kBatch - 1) / kBatch;
  const int per_chunk = k.chunk / kBatch;

  // lane l holds entries l and l + 32 of batch bt; past the bucket, 0
  unsigned long long nxt[2];
  auto load = [&](int bt) {
    const int r = bt * kBatch + lane;
    nxt[0] = r < k.len ? __ldg(k.bucket + r) : 0ull;
    nxt[1] = r + 32 < k.len ? __ldg(k.bucket + r + 32) : 0ull;
  };
  int bt = warp;
  if (bt < nb) load(bt);
  for (int c = 0; c < k.nch; ++c) {
    const Quads ck = (c & 1) ? k.ck[1] : k.ck[0];
    const int cend = min(nb, (c + 1) * per_chunk);
    for (; bt < cend; bt += kWarps) {
      const uint32_t w0 = outside_slice(nxt[0], k.low);
      const uint32_t w1 = outside_slice(nxt[1], k.low);
      if (bt + kWarps < nb) load(bt + kWarps);
      // m-tile m: entries 16m..16m+15 of the batch; its row g is at lane
      // 16 (m & 1) + g of w0 (m < 2) or w1. The next m-tile's A fragments
      // are built while this one's products are in flight.
      uint32_t a[2][4];
      a_fragments(w0, g, t, a);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        int d[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          mma_first(d[i], a[0], bf[i][0], bf[i][1]);
          mma_acc(d[i], a[1], bf[i][2], bf[i][3]);
        }
        if (m < 3)
          a_fragments(m < 1 ? w0 : w1, 16 * ((m + 1) & 1) + g, t, a);
        if (__any_sync(kFull, or_tree<NT>(d) < 0)) {
          uint32_t cand = 0;
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cand |= ((uint32_t)d[i][e] >> 31) << (4 * i + e);
          add_candidates(k, ck, cand, bt * kBatch + 16 * m + g, t);
          __syncwarp();     // reconverge before the next mma.sync
        }
      }
    }
    __syncthreads();        // every hit of chunk c is in ck
    if (tid < k.slots)
      finder_cells::end_chunk(k.out, k.cells(tid), ck, k.sc, k.tot, tid, c,
                              k.nch);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
compact_finder_kernel(const unsigned long long* __restrict__ entries,
                      long long epad, const long long* __restrict__ boff,
                      const int* __restrict__ blen,
                      const unsigned long long* __restrict__ qsig,
                      const int* __restrict__ qsp, int B, int qb, int n,
                      int chunk, int nchmax, int superchunk, int nsc,
                      int max_dist, Planes out) {
  __shared__ int slot_of[kSlots];
  __shared__ unsigned long long qcol[kSlots];
  __shared__ unsigned long long sums[4][kSlots];
  __shared__ int ints[4][3][kSlots];
  __shared__ int warp_live[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s = blockIdx.z;
  const long long sb = (long long)s * B + blockIdx.y;
  const int j0 = blockIdx.x * kSlots;

  Block k;
  k.len = blen[sb];
  k.bucket = entries + (long long)s * epad + boff[sb];
  k.chunk = chunk;
  k.nch = (k.len + chunk - 1) / chunk;
  k.low = (uint32_t)((1ull << (8 * s)) - 1ull);
  // bytes 0..s-1 of the collapsed low word are the earlier slices; the
  // others are forced nonzero so only those can test clean
  k.force = ~k.low;
  k.max_dist = max_dist;
  k.slot_of = slot_of;
  k.qcol = qcol;
  const Quads q[4] = {
      {ints[0][0], sums[0], ints[0][1], ints[0][2]},
      {ints[1][0], sums[1], ints[1][1], ints[1][2]},
      {ints[2][0], sums[2], ints[2][1], ints[2][2]},
      {ints[3][0], sums[3], ints[3][1], ints[3][2]}};
  k.ck[0] = q[0];
  k.ck[1] = q[1];
  k.sc = q[2];
  k.tot = q[3];
  k.out = out;
  k.at0 = sb * (nchmax + nsc + 1) * qb + j0;
  k.qb = qb;
  k.nchmax = nchmax;
  k.nsc = nsc;
  k.superchunk = superchunk;
  k.slots = min(kSlots, qb - j0);

  // the block's live slots (query id in [0, n)) become columns 0..nlive-1
  // in plan order
  int id = n;
  if (tid < k.slots) {
    id = qsp[sb * qb + j0 + tid];
    for (int i = 0; i < 4; ++i) q[i].clear(tid);
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

  const int nt = k.len > 0 ? (k.nlive + 7) / 8 : 0;
  switch (nt) {
    case 1: stream_bucket<1>(k); break;
    case 2: stream_bucket<2>(k); break;
    case 3: stream_bucket<3>(k); break;
    case 4: stream_bucket<4>(k); break;
    case 5: stream_bucket<5>(k); break;
    case 6: stream_bucket<6>(k); break;
    case 7: stream_bucket<7>(k); break;
    case 8: stream_bucket<8>(k); break;
    default: break;
  }
  if (tid < k.slots)
    finder_cells::finish(out, k.cells(tid), k.tot, tid, nt > 0 ? k.nch : 0);
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
  if (chunk % kTile != 0 || max_dist < 0 || max_dist > 20)
    return (int)cudaErrorInvalidValue;
  const Planes out{static_cast<int*>(cnt), static_cast<long long*>(rsum),
                   static_cast<int*>(rmin), static_cast<int*>(rmax)};
  const dim3 grid((qb + kSlots - 1) / kSlots, B, S);
  compact_finder_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(entries), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, chunk, nchmax, superchunk, nsc,
      max_dist, out);
  return (int)cudaGetLastError();
}
