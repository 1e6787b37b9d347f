// The compact finders' output cells, shared by csrc/compact_finder.cu and
// csrc/compact_onehot.cu.
//
// Both finders fold their hits into per-slot quads (count, rank sum, min
// rank, max rank) in shared memory with atomics, since ranks reach a quad
// from many threads in no order. At the end of each chunk a block writes
// the chunk cell of every slot it owns, folds it into the bucket total and
// the superchunk quad, and writes the superchunk cell at its last chunk;
// after the last chunk it writes the empty cells past the bucket's end and
// the bucket totals. Output planes are (S, B, nchmax + nsc + 1, qb): cnt,
// rmin, rmax int32 and rsum int64; empty cells read 0, 0, kRankEmpty, -1.

#pragma once

#include <stdint.h>

namespace finder_cells {

// min rank of an empty cell: INT32_MAX, above every rank (buckets hold
// fewer than 2^30 entries: ops/issl_compact.py RANK_BOUND)
constexpr int kRankEmpty = 0x7FFFFFFF;

struct Planes {
  int* cnt;
  long long* rsum;
  int* rmin;
  int* rmax;
};

__device__ __forceinline__ void store_empty(const Planes& out, long long at) {
  out.cnt[at] = 0;
  out.rsum[at] = 0;
  out.rmin[at] = kRankEmpty;
  out.rmax[at] = -1;
}

// per-slot quads in shared memory (structure of arrays)
struct Quads {
  int* cnt;
  unsigned long long* sum;
  int* rmin;
  int* rmax;

  __device__ __forceinline__ void clear(int j) const {
    cnt[j] = 0;
    sum[j] = 0ull;
    rmin[j] = kRankEmpty;
    rmax[j] = -1;
  }
  __device__ __forceinline__ void fold(int j, const Quads& q) const {
    cnt[j] += q.cnt[j];
    sum[j] += q.sum[j];
    rmin[j] = min(rmin[j], q.rmin[j]);
    rmax[j] = max(rmax[j], q.rmax[j]);
  }
  // a hit at in-bucket rank r, from any thread
  __device__ __forceinline__ void add(int j, int r) const {
    atomicAdd(&cnt[j], 1);
    atomicAdd(&sum[j], (unsigned long long)r);
    atomicMin(&rmin[j], r);
    atomicMax(&rmax[j], r);
  }
  // quad j into the cell at ``at``
  __device__ __forceinline__ void store(const Planes& out, long long at,
                                        int j) const {
    out.cnt[at] = cnt[j];
    out.rsum[at] = (long long)sum[j];
    out.rmin[at] = rmin[j];
    out.rmax[at] = rmax[j];
  }
};

// Where one slot's cells lie: cell c of the slot at at0 + c * qb.
struct SlotCells {
  long long at0;
  long long qb;
  int nchmax;
  int nsc;
  int superchunk;

  __device__ __forceinline__ long long chunk(int c) const {
    return at0 + (long long)c * qb;
  }
  __device__ __forceinline__ long long super(int u) const {
    return at0 + (long long)(nchmax + u) * qb;
  }
  __device__ __forceinline__ long long total() const {
    return at0 + (long long)(nchmax + nsc) * qb;
  }
};

// The end of chunk cc (of nch) for quad j: its chunk cell, the fold into
// the bucket total and the superchunk quad (whose cell is written at its
// last chunk); the chunk quad is cleared for the next chunk.
__device__ __forceinline__ void end_chunk(const Planes& out,
                                          const SlotCells& at,
                                          const Quads& ck, const Quads& sc,
                                          const Quads& tot, int j, int cc,
                                          int nch) {
  ck.store(out, at.chunk(cc), j);
  tot.fold(j, ck);
  if (at.superchunk > 0) {
    sc.fold(j, ck);
    if ((cc + 1) % at.superchunk == 0 || cc == nch - 1) {
      sc.store(out, at.super(cc / at.superchunk), j);
      sc.clear(j);
    }
  }
  ck.clear(j);
}

// After the last chunk: the cells no chunk wrote (every chunk cell from
// ``done`` on, which is 0 for a bucket that streamed nothing, and the
// superchunks past them), then quad j's bucket total.
__device__ __forceinline__ void finish(const Planes& out, const SlotCells& at,
                                       const Quads& tot, int j, int done) {
  for (int cc = done; cc < at.nchmax; ++cc) store_empty(out, at.chunk(cc));
  const int sc_done = done > 0 && at.superchunk > 0
                          ? (done + at.superchunk - 1) / at.superchunk : 0;
  for (int u = sc_done; u < at.nsc; ++u) store_empty(out, at.super(u));
  tot.store(out, at.total(), j);
}

}  // namespace finder_cells
