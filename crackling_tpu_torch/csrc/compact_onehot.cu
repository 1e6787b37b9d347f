// One-hot compact finder for Hopper (sm_90a): per-(chunk, query slot) hit
// moments, with the hit test computed on the tensor cores.
//
// Replaces: crackling_tpu/ops/issl_compact.py::_finder_kernel_onehot. It
// emits the same cells as csrc/compact_finder.cu (chunk quads, superchunk
// quads, bucket totals; empty cells read 0, 0, kRankEmpty, -1), from
// another input: the index's one-hot planes (S, epad, 80) int8, where lane
// 4p + b of an entry's row is 1 iff its base at position p is b.
//
// The hit test is a matrix product. The TPU kernel multiplies the rows by
// bf16 weight columns of 2^p (at lane 4p + b where the query's base at p
// is not b) to get each pair's 20-bit mismatch mask, then popcounts it.
// Here every pair's distance comes from int8 mma.sync m16n8k32 (s8 in,
// s32 out) with weight 1 at those lanes: (row . column) counts the
// mismatched positions, exactly, with no popcount, at the tensor cores'
// int8 rate (twice bf16's). Only a (16-entry, 8-slot) tile in which some
// pair lies within max_dist (few: hits are rare) also computes the pairs'
// masks with the tensor cores, for the first-clean-slice dedup: int8
// cannot hold 2^19, so three more int8 products take mask bits 7q..7q+6
// as column group q (weights 2^(p - 7q) <= 64, sums <= 127). K is the 80
// lanes padded with zeros to 96, three k32 steps.
//
// What bounds it on the H100: per (entry, slot) pair the tensor cores do
// 2 x 96 int8 operations and the epilogue a compare and its share of a
// warp vote; the planes are 80 B per entry, read once per page. At the
// 27 Mbp operating point the plane bytes and the epilogue are the larger
// bounds; the product itself is the smallest.
//
// What the design does about it: one block of kWarps warps per (slice,
// bucket) covers all its slots, so a bucket's planes stream from HBM once
// per page. Each warp owns NT n-tiles (8 slots each) and builds their B
// fragments (the distance weight columns) in registers from the query
// signatures and the slot plan, once per block: no weight tensor goes
// through HBM or shared memory. Entries stream in tiles of kTileRows rows
// with cp.async straight into one of two shared buffers (rows padded to
// kRowBytes, so the eight rows of an 8x8 ldmatrix fall in distinct banks)
// while the warps multiply the other. A warp loads the A fragments of MT
// 16-entry m-tiles with ldmatrix and runs NT x MT independent chains of
// three mma.sync, so the tensor cores' latency is hidden within the warp.
// Hits fold into per-slot chunk quads in shared memory with atomics (ranks
// arrive in no order across threads); at a chunk's end the block writes
// the chunk cell and folds it into the superchunk and bucket quads
// (csrc/finder_cells.cuh, shared with compact_finder.cu). A bucket with no
// live slot streams nothing.
//
// Contract: launched on the caller's stream, allocates nothing, writes
// every output cell, and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "finder_cells.cuh"

namespace {

using finder_cells::Planes;
using finder_cells::Quads;
using finder_cells::SlotCells;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLanes = 80;              // one-hot lanes per entry (4 x 20)
constexpr int kK = 96;                  // lanes per shared row: 80 + 16 zero
constexpr int kKSteps = kK / 32;        // k32 steps of mma m16n8k32
constexpr int kRowBytes = kK + 16;      // shared row stride (bytes)
constexpr int kTileRows = 256;          // entries per shared tile
constexpr int kTileBytes = kTileRows * kRowBytes;
constexpr int kPieces = kTileRows * kLanes / 16;   // 16-byte global pieces

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

// int8 B fragments of n-tile nt: thread (g, t4) holds lanes k0..k0+3 and
// k0+16..k0+19 (k0 = 32 ks + 4 t4) of slot nt*8 + g's column. group < 0:
// the distance column (1 at every mismatched lane); group q in 0..2: the
// mask bits 7q..7q+6 (2^(p - 7q) at the mismatched lanes of those p).
__device__ __forceinline__ void s8_fragments(
    uint32_t (&b)[kKSteps][2], int id, unsigned long long q, int group,
    int t4) {
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t word = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = ks * 32 + h * 16 + 4 * t4 + e;
        const int p = k >> 2;
        uint32_t w = 0u;
        if (k < kLanes) {
          const int base = id >= 0 ? (int)((q >> (2 * p)) & 3ull) : -1;
          const bool miss = (k & 3) != base;
          if (group < 0) w = miss ? 1u : 0u;
          else if (p >= 7 * group && p < 7 * group + 7)
            w = miss ? (1u << (p - 7 * group)) : 0u;
        }
        word |= w << (8 * e);
      }
      b[ks][h] = word;
    }
  }
}

// NT n-tiles (8 slots each) per warp, MT m-tiles (16 entries each) per
// step: NT x MT independent accumulator chains per warp.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads)
compact_onehot_kernel(const int8_t* __restrict__ planes, long long epad,
                      const long long* __restrict__ boff,
                      const int* __restrict__ blen,
                      const unsigned long long* __restrict__ qsig,
                      const int* __restrict__ qsp, int B, int qb, int n,
                      int chunk, int nchmax, int superchunk, int nsc,
                      int max_dist, Planes out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntiles_n = (qb + 7) / 8;
  const int qbpad = ntiles_n * 8;
  unsigned long long* sums =
      reinterpret_cast<unsigned long long*>(smem + 2 * kTileBytes);
  int* ints = reinterpret_cast<int*>(sums + 3 * qbpad);
  int* qid_s = ints;
  const Quads ck{ints + qbpad, sums, ints + 2 * qbpad, ints + 3 * qbpad};
  const Quads sc{ints + 4 * qbpad, sums + qbpad, ints + 5 * qbpad,
                 ints + 6 * qbpad};
  const Quads tot{ints + 7 * qbpad, sums + 2 * qbpad, ints + 8 * qbpad,
                  ints + 9 * qbpad};
  __shared__ int live_count;

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const long long sb = (long long)s * B + blockIdx.x;
  const int len = blen[sb];
  // slot j's cell c at sb * (nchmax + nsc + 1) * qb + c * qb + j
  auto slot_cells = [&](int j) {
    return SlotCells{sb * (nchmax + nsc + 1) * qb + j, qb, nchmax, nsc,
                     superchunk};
  };

  if (tid == 0) live_count = 0;
  // lanes 80..95 of every shared row stay zero
  for (int r = tid; r < 2 * kTileRows; r += kThreads)
    *reinterpret_cast<uint4*>(smem + r * kRowBytes + kLanes) =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int j = tid; j < qbpad; j += kThreads) {
    const int id = j < qb ? qsp[sb * qb + j] : n;
    const bool live = id >= 0 && id < n;
    qid_s[j] = live ? id : -1;
    if (live) atomicAdd(&live_count, 1);
    ck.clear(j);
    sc.clear(j);
    tot.clear(j);
  }
  __syncthreads();
  const bool work = len > 0 && live_count > 0;

  const int8_t* bucket = planes + ((long long)s * epad + boff[sb]) * kLanes;
  const long long bucket_rows = epad - boff[sb];
  const int nch = (len + chunk - 1) / chunk;
  const int ntiles = work ? (len + kTileRows - 1) / kTileRows : 0;
  const int tiles_per_chunk = chunk / kTileRows;
  // nibbles 0..s-1 of the mask (4 positions each) are the earlier slices;
  // the others are forced nonzero so only those can test clean
  const uint32_t force = ~((1u << (4 * s)) - 1u);
  const uint32_t smem_base = smem_addr(smem);

  // tile t's rows into buffer t & 1; rows past the slice's end read zeros
  auto fetch = [&](int t) {
    const uint32_t buf = smem_base + (t & 1) * kTileBytes;
    for (int idx = tid; idx < kPieces; idx += kThreads) {
      const long long row = (long long)t * kTileRows + idx / 5;
      const bool in = row < bucket_rows;
      cp_async16(buf + (idx / 5) * kRowBytes + (idx % 5) * 16,
                 in ? bucket + row * kLanes + (idx % 5) * 16 : bucket,
                 in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // warps: wn_count n-groups of NT n-tiles, wm_count m-groups; a warp of
  // m-group wm takes the tile's m-steps wm, wm + wm_count, ...
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // accumulator rows g, g + 8
  const int t4 = lane & 3;          // accumulator columns 2*t4, 2*t4 + 1
  const int wn_count = (ntiles_n + NT - 1) / NT;
  const int wm_count = kWarps / wn_count;
  const int wn = warp % wn_count;
  const int wm = warp / wn_count;
  const bool active = wm < wm_count;              // uniform in the warp

  uint32_t b[NT][kKSteps][2];
  if (work && active) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int nt = wn * NT + i;
      const int id = nt < ntiles_n ? qid_s[nt * 8 + g] : -1;
      s8_fragments(b[i], id, id >= 0 ? qsig[id] : 0ull, -1, t4);
    }
  }

  if (ntiles > 0) fetch(0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) fetch(t + 1);
    const int t0 = t * kTileRows;
    const int rows = min(kTileRows, len - t0);
    const uint32_t a_addr = smem_base + (t & 1) * kTileBytes;
    for (int ms = wm; active && ms * MT * 16 < rows; ms += wm_count) {
      uint32_t a[MT][kKSteps][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint32_t row_addr =
            a_addr + ((ms * MT + mi) * 16 + (lane & 15)) * kRowBytes +
            (lane >> 4) * 16;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
          ldmatrix_x4(row_addr + ks * 32, a[mi][ks][0], a[mi][ks][1],
                      a[mi][ks][2], a[mi][ks][3]);
      }
      int c[MT][NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[mi][i][e] = 0;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int i = 0; i < NT; ++i)
            mma_s8(c[mi][i], a[mi][ks], b[i][ks][0], b[i][ks][1]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int nt = wn * NT + i;
          const bool near = (c[mi][i][0] <= max_dist) |
                            (c[mi][i][1] <= max_dist) |
                            (c[mi][i][2] <= max_dist) |
                            (c[mi][i][3] <= max_dist);
          if (!__any_sync(0xffffffffu, near) || nt >= ntiles_n) continue;
          // a candidate in this (16-entry, 8-slot) tile: its 20-bit masks,
          // seven bits per int8 column group
          const int id = qid_s[nt * 8 + g];
          const unsigned long long q = id >= 0 ? qsig[id] : 0ull;
          int mask[4] = {0, 0, 0, 0};
#pragma unroll
          for (int grp = 0; grp < 3; ++grp) {
            uint32_t bm[kKSteps][2];
            s8_fragments(bm, id, q, grp, t4);
            int cm[4] = {0, 0, 0, 0};
#pragma unroll
            for (int ks = 0; ks < kKSteps; ++ks)
              mma_s8(cm, a[mi][ks], bm[ks][0], bm[ks][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) mask[e] |= cm[e] << (7 * grp);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c[mi][i][e] > max_dist) continue;
            const int r = t0 + (ms * MT + mi) * 16 + g + (e >> 1) * 8;
            const int j = nt * 8 + 2 * t4 + (e & 1);
            if (r >= len || qid_s[j] < 0) continue;
            const uint32_t x = (uint32_t)mask[e] | force;
            if (((x - 0x11111111u) & ~x & 0x88888888u) != 0u) continue;
            ck.add(j, r);
          }
          __syncwarp();     // reconverge before the next ldmatrix / mma.sync
        }
      }
    }
    const bool chunk_end =
        (t + 1) % tiles_per_chunk == 0 || t + 1 == ntiles;
    if (chunk_end) {
      __syncthreads();                       // every hit of the chunk is in
      const int cc = t / tiles_per_chunk;
      for (int j = tid; j < qb; j += kThreads)
        finder_cells::end_chunk(out, slot_cells(j), ck, sc, tot, j, cc, nch);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  const int done = ntiles > 0 ? nch : 0;
  for (int j = tid; j < qb; j += kThreads)
    finder_cells::finish(out, slot_cells(j), tot, j, done);
}

size_t smem_bytes(int qb) {
  const size_t qbpad = (size_t)((qb + 7) / 8) * 8;
  return 2 * (size_t)kTileBytes + qbpad * 3 * sizeof(unsigned long long) +
         qbpad * 10 * sizeof(int);
}

using Kernel = void (*)(const int8_t*, long long, const long long*,
                        const int*, const unsigned long long*, const int*,
                        int, int, int, int, int, int, int, int, Planes);

// The instance for a plan of qb slots. From kWarps n-tiles up, the
// n-tiles spread over the warps, NT per warp (at most 4: qb <= 512), and
// one or two n-tiles a warp take four or two m-tiles a step. Below that,
// each warp takes one n-tile and as many m-tiles a step as keep kWarps
// warps busy. Every warp keeps several independent chains.
Kernel pick_kernel(int qb) {
  const int ntiles_n = (qb + 7) / 8;
  if (ntiles_n < kWarps) {
    if (2 * ntiles_n >= kWarps) return compact_onehot_kernel<1, 4>;
    if (4 * ntiles_n >= kWarps) return compact_onehot_kernel<1, 2>;
    return compact_onehot_kernel<1, 1>;
  }
  switch ((ntiles_n + kWarps - 1) / kWarps) {
    case 1: return compact_onehot_kernel<1, 4>;
    case 2: return compact_onehot_kernel<2, 2>;
    case 3: return compact_onehot_kernel<3, 1>;
    case 4: return compact_onehot_kernel<4, 1>;
    default: return nullptr;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// of contiguous tensors: planes (S, epad, 80) int8, boff (S, B) int64,
// blen (S, B) int32, qsig (n,) int64, qsp (S, B, qb) int32; outputs
// (S, B, nchmax + nsc + 1, qb): cnt/rmin/rmax int32, rsum int64.
extern "C" int crackling_compact_finder_onehot(
    const void* planes, long long epad, const void* boff, const void* blen,
    const void* qsig, const void* qsp, int S, int B, int qb, int n,
    int chunk, int nchmax, int superchunk, int nsc, int max_dist,
    void* cnt, void* rsum, void* rmin, void* rmax, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk % kTileRows != 0) return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick_kernel(qb);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;  // qb > 512
  const size_t smem = smem_bytes(qb);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Planes out{static_cast<int*>(cnt), static_cast<long long*>(rsum),
                   static_cast<int*>(rmin), static_cast<int*>(rmax)};
  const dim3 grid(B, S);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(planes), epad,
      static_cast<const long long*>(boff), static_cast<const int*>(blen),
      static_cast<const unsigned long long*>(qsig),
      static_cast<const int*>(qsp), B, qb, n, chunk, nchmax, superchunk, nsc,
      max_dist, out);
  return (int)cudaGetLastError();
}
