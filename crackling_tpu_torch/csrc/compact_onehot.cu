// One-hot compact finder for Hopper (sm_90a): per-(chunk, query slot) hit
// moments, with every pair's distance screened on the tensor cores.
//
// Replaces: crackling_tpu/ops/issl_compact.py::_finder_kernel_onehot. It
// emits the same cells as csrc/compact_finder.cu (chunk quads, superchunk
// quads, bucket totals; empty cells read 0, 0, kRankEmpty, -1), from
// another input: the index's one-hot planes (S, epad, 80) int8, where lane
// 4p + b of an entry's row is 1 iff its base at position p is b.
//
// The hit test. The TPU kernel multiplies the rows by bf16 weight columns
// of 2^p (at lane 4p + b where the query's base at p is not b) to get each
// pair's 20-bit mismatch mask, then popcounts it. Here the rows are the A
// operand of int8 mma.sync m16n8k32 as they lie in the planes, and a live
// query slot's column holds 1 at the lanes of the bases its query does not
// have, so (row . column) counts the mismatched positions. A row's 16-byte
// piece s is slice s's four positions (lanes 16s..16s+15), which every
// entry and query of a bucket of slice s share, so the product takes the
// other four pieces (ldmatrix picks them per lane): K = 64, two k32 steps.
// The weights of the first of those positions are lowered by max_dist + 1
// (every entry row has exactly one base there), so a pair is a candidate
// iff its sum is negative; a padding column holds 2 at every lane (a
// positive sum). One OR tree and one warp vote per m-tile skip the tiles
// that hold no candidate (nearly all). A candidate is re-tested from its
// whole row in shared memory: the mismatch mask over the 20 positions, its
// popcount within max_dist, and no earlier slice (nibbles 0..s-1 of the
// mask) clean. Hits fold into per-slot chunk quads in shared memory with
// atomics; cells are written as csrc/finder_cells.cuh says (shared with
// compact_finder.cu).
//
// What bounds it on the H100: bytes. The product needs 64 B of each entry
// of a bucket with a live slot (1.62 GB at the 27 Mbp operating point,
// ~0.48 ms at 3.35 TB/s; with the plan and the cells ~0.54 ms at the
// 65,536-query page), and 2 x 64 int8 operations per live pair (0.42 ms at
// the int8 peak there). HBM moves 32-byte sectors, and every sector of a
// row holds bytes of the four pieces, so the card reads whole rows (80 B,
// 2.03 GB) whichever pieces are asked for: the kernel copies whole rows,
// which also keeps each candidate's re-test in shared memory.
//
// What the design does about it: one block of eight warps per (bucket,
// slice) covers all the bucket's slots, so its planes stream from HBM once
// per page, and two blocks share an SM. The block compacts its live slots
// into columns and splits its n-tiles (8 columns each) over wn warp columns
// of NT n-tiles (NT <= 8, the largest reuse of each A fragment) and its
// m-tiles over 8 / wn warp rows, so every warp works at any slot count.
// Each warp builds its B fragments in registers once. Tiles of 256 rows
// (one contiguous run of the planes) land in a ring of four shared stages
// (three where four would leave one block per SM) by the Tensor Memory
// Accelerator, each stage with an mbarrier that completes when its copy
// lands. Warps wait for their tile alone and the last warp done with a
// stage refills it, so a warp busy with candidates does not hold the
// others back; the block meets only at chunk ends. A bucket with no live
// slot streams nothing.
//
// Contract: launched on the caller's stream, allocates nothing, writes
// every output cell, and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "finder_cells.cuh"
#include "mma_screen.cuh"

namespace {

using finder_cells::Planes;
using finder_cells::Quads;
using finder_cells::SlotCells;
using mma_screen::kFull;
using mma_screen::kOnes;
using mma_screen::mma_acc;
using mma_screen::mma_first;
using mma_screen::or_tree;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanes = 80;              // one-hot lanes per entry (4 x 20)
constexpr int kPieces = kLanes / 16;    // 16-byte pieces of a row
constexpr int kTileRows = 256;          // entries per shared tile
constexpr int kTileBytes = kTileRows * kLanes;
constexpr int kMaxStages = 4;           // shared tiles in the ring, at most
constexpr int kMaxSlots = 512;          // qb <= 64 n-tiles of 8
constexpr int kSmemPerSm = 233472;      // an SM's shared memory (228 KB)
constexpr int kSmemReserved = 1024;     // the system's share of each block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The tile ring's barriers: stage st's barrier completes a phase when the
// bulk copy into it has landed (one arrival with the copy's byte count).
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar));
}

// Copy ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``
// with the Tensor Memory Accelerator; ``bar`` completes when they land.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  // the block's earlier reads of the stage come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait for phase ``parity`` of ``bar``. A copy that never lands (a fault)
// traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// The global piece of multiplied piece i (0..3): the pieces other than s.
__device__ __forceinline__ int piece_of(int i, int s) {
  return i + (i >= s ? 1 : 0);
}

// 1 at the lanes of the bases the query does not have at position p.
__device__ __forceinline__ uint32_t miss_lanes(unsigned long long q, int p) {
  return kOnes ^ (1u << (8 * (uint32_t)((q >> (2 * p)) & 3ull)));
}

// What every warp of a block reads while it streams its bucket.
struct Block {
  const int8_t* bucket;               // the bucket's plane rows
  int len;                            // its length
  int s;                              // its slice
  uint32_t force;                     // nibbles s.. of the mask forced set
  int max_dist;
  int nlive;                          // live slots = columns 0..nlive-1
  const int* slot_of;                 // column -> the block's slot
  const unsigned long long* qcol;     // column -> query signature
  Quads ck;                           // chunk quads, by slot
};

// The 20-bit mismatch mask of a row (in shared memory) against query q:
// bit p is set iff the row's base at p is one the query does not have.
__device__ __forceinline__ uint32_t row_mask(const unsigned char* row,
                                             unsigned long long q) {
  uint32_t m = 0u;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m |= (uint32_t)((w[j] & miss_lanes(q, 4 * p + j)) != 0u)
           << (4 * p + j);
  }
  return m;
}

// A warp's candidates of one m-tile (bit 4i + e of ``cand``: element e of
// the warp's n-tile i; tile rows r0 and r0 + 8) through the exact test into
// the chunk quads. A rolled loop: the candidate path stays small.
__device__ __forceinline__ void add_candidates(const Block& k,
                                               const unsigned char* stage,
                                               uint32_t cand, int t0, int r0,
                                               int col0, int t) {
#pragma unroll 1
  while (cand != 0u) {
    const int bit = __ffs(cand) - 1;
    cand &= cand - 1u;
    const int rl = r0 + 8 * ((bit >> 1) & 1);
    const int col = col0 + 8 * (bit >> 2) + 2 * t + (bit & 1);
    const int r = t0 + rl;
    if (r >= k.len || col >= k.nlive) continue;
    const uint32_t m = row_mask(stage + rl * kLanes, k.qcol[col]);
    if (__popc(m) > k.max_dist) continue;
    const uint32_t x = m | k.force;
    if (((x - 0x11111111u) & ~x & 0x88888888u) != 0u) continue;
    k.ck.add(k.slot_of[col], r);
  }
}

// The bucket's tiles against the warp's NT n-tiles; chunk ends write the
// chunk cells of every slot.
template <int NT, int STAGES>
__device__ __forceinline__ void stream_tiles(
    const Block& k, unsigned char* smem, const uint64_t* bars,
    int* released, int wn_count,
    int chunk, int nch,
    const Planes& out, const Quads& sc, const Quads& tot, long long at0,
    int qb, int nchmax, int nsc, int superchunk) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // rows g, g + 8; column g
  const int t = lane & 3;
  const int wn = warp % wn_count;
  const int wm = warp / wn_count;
  const int wm_count = kWarps / wn_count;
  const int col0 = wn * NT * 8;

  // B fragments: column g of n-tile i is column col0 + 8i + g; per k-step
  // ks, b0 holds lanes 4t..4t+3 of multiplied piece 2ks (position
  // 4 piece_of(2ks) + t, bases 0..3) and b1 those of piece 2ks + 1. The
  // first multiplied position (thread 0's b0 of k-step 0) has its four
  // weights lowered by max_dist + 1.
  const uint32_t bias = (uint32_t)(k.max_dist + 1) * kOnes;
  uint32_t bf[NT][2][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = col0 + 8 * i + g;
    const bool live = col < k.nlive;
    const unsigned long long q = live ? k.qcol[col] : 0ull;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 4 * piece_of(2 * ks + h, k.s) + t;
        bf[i][ks][h] = live ? miss_lanes(q, p) : 2u * kOnes;
      }
    if (live && t == 0) bf[i][0][0] = __vsub4(bf[i][0][0], bias);
  }

  // ldmatrix: lanes 0-15 give rows 0-15 of k-step ks's first multiplied
  // piece, lanes 16-31 those of its second
  const uint32_t col[2] = {16u * piece_of(lane >> 4, k.s),
                           16u * piece_of(2 + (lane >> 4), k.s)};
  const int ntiles = (k.len + kTileRows - 1) / kTileRows;
  const int per_chunk = chunk / kTileRows;
  const uint32_t base = smem_addr(smem);
  const uint32_t bar0 = smem_addr(bars);
  // tile u's rows (one contiguous run) into stage u % STAGES; rows of the
  // stage past the bucket keep older rows, which the rank test drops
  auto fetch = [&](int u) {
    const int st = u % STAGES;
    bulk_copy(base + st * kTileBytes, k.bucket + (long long)u * kTileBytes,
              (uint32_t)(min(kTileRows, k.len - u * kTileRows) * kLanes),
              bar0 + 8 * st);
  };
  if (tid == 0)
    for (int u = 0; u < STAGES && u < ntiles; ++u) fetch(u);
  for (int u = 0; u < ntiles; ++u) {
    // each warp waits for its tile alone: a warp busy with candidates does
    // not hold the others back (up to the ring's depth)
    bar_wait(bar0 + 8 * (u % STAGES), (uint32_t)(u / STAGES) & 1u);
    const int t0 = u * kTileRows;
    const int rows = min(kTileRows, k.len - t0);
    unsigned char* stage = smem + (u % STAGES) * kTileBytes;
    const uint32_t a_addr = base + (u % STAGES) * kTileBytes +
                            (lane & 15) * kLanes;
    // m-tile ms: tile rows 16 ms..16 ms + 15, two k-steps; the next
    // m-tile's A fragments are loaded while this one's products are in
    // flight
    uint32_t a[2][4];
    auto fragments = [&](int ms) {
      ldmatrix_x4(a_addr + ms * 16 * kLanes + col[0], a[0]);
      ldmatrix_x4(a_addr + ms * 16 * kLanes + col[1], a[1]);
    };
    if (wm * 16 < rows) fragments(wm);
    for (int ms = wm; ms * 16 < rows; ms += wm_count) {
      int d[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        mma_first(d[i], a[0], bf[i][0][0], bf[i][0][1]);
        mma_acc(d[i], a[1], bf[i][1][0], bf[i][1][1]);
      }
      if ((ms + wm_count) * 16 < rows) fragments(ms + wm_count);
      if (__any_sync(kFull, or_tree<NT>(d) < 0)) {
        uint32_t cand = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cand |= ((uint32_t)d[i][e] >> 31) << (4 * i + e);
        add_candidates(k, stage, cand, t0, ms * 16 + g, col0, t);
        __syncwarp();     // reconverge before the next ldmatrix / mma.sync
      }
    }
    // the warp is done with the stage; the last of the kWarps warps to be
    // done refills it with tile u + STAGES
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(released + u % STAGES, 1) % kWarps == kWarps - 1 &&
          u + STAGES < ntiles)
        fetch(u + STAGES);
    }
    if ((u + 1) % per_chunk == 0 || u + 1 == ntiles) {
      __syncthreads();                       // every hit of the chunk is in
      const int c = u / per_chunk;
      for (int j = tid; j < qb; j += kThreads)
        finder_cells::end_chunk(
            out, SlotCells{at0 + j, qb, nchmax, nsc, superchunk}, k.ck, sc,
            tot, j, c, nch);
      __syncthreads();                       // the chunk quads are clear
    }
  }
}

template <int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
compact_onehot_kernel(const int8_t* __restrict__ planes, long long epad,
                      const long long* __restrict__ boff,
                      const int* __restrict__ blen,
                      const unsigned long long* __restrict__ qsig,
                      const int* __restrict__ qsp, int B, int qb, int n,
                      int chunk, int nchmax, int superchunk, int nsc,
                      int max_dist, Planes out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qbpad = (qb + 7) / 8 * 8;
  unsigned long long* qcol =
      reinterpret_cast<unsigned long long*>(smem + STAGES * kTileBytes);
  unsigned long long* sums = qcol + qbpad;
  int* ints = reinterpret_cast<int*>(sums + 3 * qbpad);
  int* slot_of = ints + 9 * qbpad;
  const Quads ck{ints, sums, ints + qbpad, ints + 2 * qbpad};
  const Quads sc{ints + 3 * qbpad, sums + qbpad, ints + 4 * qbpad,
                 ints + 5 * qbpad};
  const Quads tot{ints + 6 * qbpad, sums + 2 * qbpad, ints + 7 * qbpad,
                  ints + 8 * qbpad};
  __shared__ int live_count;
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  __shared__ int released[kMaxStages];

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const long long sb = (long long)s * B + blockIdx.x;
  const long long at0 = sb * (nchmax + nsc + 1) * qb;  // cell 0 of slot 0

  Block k;
  k.len = blen[sb];
  k.bucket = planes + ((long long)s * epad + boff[sb]) * kLanes;
  k.s = s;
  // nibbles 0..s-1 of the mask (4 positions each) are the earlier slices;
  // the others are forced nonzero so only those can test clean
  k.force = ~((1u << (4 * s)) - 1u);
  k.max_dist = max_dist;
  k.slot_of = slot_of;
  k.qcol = qcol;
  k.ck = ck;

  // live slots (query id in [0, n)) become the block's columns
  if (tid == 0) {
    live_count = 0;
    for (int st = 0; st < STAGES; ++st) {
      bar_init(smem_addr(bars + st));
      released[st] = 0;
    }
    // the barriers' initialisation is seen by the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int j = tid; j < qb; j += kThreads) {
    const int id = qsp[sb * qb + j];
    if (id >= 0 && id < n) {
      const int col = atomicAdd(&live_count, 1);
      slot_of[col] = j;
      qcol[col] = qsig[id];
    }
    ck.clear(j);
    sc.clear(j);
    tot.clear(j);
  }
  __syncthreads();
  k.nlive = live_count;
  const int nch = (k.len + chunk - 1) / chunk;
  const bool work = k.len > 0 && k.nlive > 0;

  if (work) {
    // wn warp columns of NT n-tiles: the fewest columns that keep NT <= 8
    const int ntn = (k.nlive + 7) / 8;
    int wn = 1;
    while (wn < kWarps && (ntn + wn - 1) / wn > 8) wn *= 2;
    const int nt = (ntn + wn - 1) / wn;
#define ONEHOT_STREAM(NT)                                                    \
  case NT:                                                                   \
    stream_tiles<NT, STAGES>(k, smem, bars, released, wn, chunk, nch, out,  \
                             sc, tot, at0, qb, nchmax, nsc, superchunk);     \
    break;
    switch (nt) {
      ONEHOT_STREAM(1)
      ONEHOT_STREAM(2)
      ONEHOT_STREAM(3)
      ONEHOT_STREAM(4)
      ONEHOT_STREAM(5)
      ONEHOT_STREAM(6)
      ONEHOT_STREAM(7)
      ONEHOT_STREAM(8)
      default: break;
    }
#undef ONEHOT_STREAM
  }

  const int done = work ? nch : 0;
  for (int j = tid; j < qb; j += kThreads)
    finder_cells::finish(out, SlotCells{at0 + j, qb, nchmax, nsc, superchunk},
                         tot, j, done);
}

size_t smem_bytes(int qb, int stages) {
  const size_t qbpad = (size_t)((qb + 7) / 8) * 8;
  return (size_t)stages * kTileBytes +
         qbpad * 4 * sizeof(unsigned long long) + qbpad * 10 * sizeof(int);
}

// The ring's depth for qb slots: four tiles where two blocks still share
// an SM, else three.
int stages_for(int qb) {
  return 2 * (smem_bytes(qb, 4) + 64 + kSmemReserved) <= (size_t)kSmemPerSm
             ? 4 : 3;
}

using Kernel = void (*)(const int8_t*, long long, const long long*,
                        const int*, const unsigned long long*, const int*,
                        int, int, int, int, int, int, int, int, Planes);

Kernel kernel_for(int stages) {
  return stages == 4 ? compact_onehot_kernel<4> : compact_onehot_kernel<3>;
}

// The kernel's dynamic shared memory for qb slots, with the SM's carveout
// at its largest so that two blocks fit.
cudaError_t set_smem(int qb) {
  const int stages = stages_for(qb);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_for(stages), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(qb, stages));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel_for(stages),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// of contiguous tensors: planes (S, epad, 80) int8, boff (S, B) int64,
// blen (S, B) int32, qsig (n,) int64, qsp (S, B, qb) int32; outputs
// (S, B, nchmax + nsc + 1, qb): cnt/rmin/rmax int32, rsum int64. Slices
// are one byte of the signature (width 8, S <= 5).
extern "C" int crackling_compact_finder_onehot(
    const void* planes, long long epad, const void* boff, const void* blen,
    const void* qsig, const void* qsp, int S, int B, int qb, int n,
    int chunk, int nchmax, int superchunk, int nsc, int max_dist,
    void* cnt, void* rsum, void* rmin, void* rmax, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk % kTileRows != 0 || qb < 1 || qb > kMaxSlots || S > 5 ||
      max_dist < 0 || max_dist > 20)
    return (int)cudaErrorInvalidValue;
  err = set_smem(qb);
  if (err != cudaSuccess) return (int)err;
  const int stages = stages_for(qb);
  const size_t smem = smem_bytes(qb, stages);
  const Planes out{static_cast<int*>(cnt), static_cast<long long*>(rsum),
                   static_cast<int*>(rmin), static_cast<int*>(rmax)};
  const dim3 grid(B, S);
  kernel_for(stages)<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(planes), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, chunk, nchmax, superchunk, nsc,
      max_dist, out);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at a time for a plan of qb slots
// (the design's two), or a negative CUDA error.
extern "C" int crackling_compact_onehot_blocks_per_sm(int qb, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_smem(qb);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel_for(stages_for(qb)), kThreads,
        smem_bytes(qb, stages_for(qb)));
  return err == cudaSuccess ? blocks : -(int)err;
}
