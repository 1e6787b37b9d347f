// Compact decode for Hopper (sm_90a): the compact engine's steps 1-2, the
// moment-tree walk from the finder's cells down to the rescan list.
//
// Replaces: steps 1-2 of crackling_tpu/ops/issl_compact.py::decode_score
// (issl_compact.py:884-987). It is no Pallas kernel: XLA fuses those steps of
// the page program into a handful of passes. The port's first form of them
// was eager torch ops, about 400 launches per page; they stay as the plain
// version (ops/compact_decode.py::compact_decode_plain).
//
// The input is the finder's cells (count, min rank, max rank per cell of
// each query slot: chunk cells [0, nchmax), superchunk cells [nchmax,
// nchmax + nsc), the bucket total last) and the slot plan. At every level a
// cell of 1 or 2 hits is scored pointwise: its min rank is a hit, and its
// max rank the second when it holds 2; the entry sits at s*epad + boff[s,b]
// + rank. Its f32 terms come from pair_hit_terms (csrc/pair_terms.cuh, shared
// with the rescan and the full-scan kernels), each times its occurrence as an
// f32 product, widened to f64 and added into mit_sums[hq], cfd_sums[hq] by
// atomicAdd (never for a slot of query n). A cell of 3 or more hits descends
// a level: a slot into its superchunk cells, or straight into its chunk
// cells when the level is off; a superchunk into its chunks; a chunk becomes
// a row of the rescan list (ridx, q, hq, start, live, slice). The order of
// the rows and of the f64 additions is all that differs from the plain
// version.
//
// Two passes, launched one after the other on the caller's stream:
// * the slot pass, one thread per slot (neighbouring threads on neighbouring
//   slots of a bucket, so the bucket-total loads coalesce), scores the
//   1-2-hit slots, counts n_single and n_mslot and appends each >=3-hit slot
//   to a list (one atomicAdd per block on the n_mslot counter, written only
//   below cap_multi); its first cap_rescan threads also write the padding
//   rows of the rescan list (ridx -1, hq n, start and live 0);
// * the tree pass, one warp per entry of that list, its grid sized by
//   cap_multi: warps past the counter leave at once, so nothing waits for
//   the host. The lanes walk the slot's cells 32 at a time, only those of
//   the bucket's live chunks (ceil(blen / chunk)); a >=3-hit chunk
//   takes its row index from the n_rescan counter (one atomicAdd per warp
//   and round) and is written only below cap_rescan. The lanes' sums and
//   counts are reduced in the warp: one atomicAdd each per slot.
// Counters count past their caps; only the writes stop there.
//
// What bounds it on the H100: bytes. The 65,536-query page has 409,600
// slots: 1.6 MB of bucket totals, read once, and the plan of the slots with
// hits; the other reads (min and max rank of each 1-2-hit cell, the live
// cells of the >=3-hit slots, and per hit an 8-B entry, a 4-B occurrence
// and a 4-B MIT table entry) are scattered and few, ~6 MB in all, ~2 us. At
// that size the two launches and each warp's chain of dependent scattered
// loads (list, plan, cells, ranks, entries, table) set its time, not the
// bound. The design keeps the bulk read coalesced and makes everything
// else follow the data, not the caps.
//
// Contract: allocates nothing, adds into the sums and the counters the
// caller zeroed, and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace {

using pair_terms::pair_hit_terms;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the counters, in the header's order
enum Counter { kSingle, kMslot, kScell, kSresc, kMcell, kRescan };
// the rescan list's fields, one row of the (6, cap_rescan) block each
enum RowField { kRidx, kQ, kHq, kStart, kLive, kSlice };

struct Args {
  const int* cnt;                     // (S, B, C, qb)
  const int* rmin;
  const int* rmax;
  const int* qsp;                     // (S, B, qb)
  const unsigned long long* qsig;     // (n,)
  const long long* boff;              // (S, B)
  const int* blen;                    // (S, B)
  const unsigned long long* entries;  // (S, epad)
  const int* occ;                     // (S, epad)
  const float* mit_tab;
  const float* pen;
  float pam;
  int B, C, qb, n;
  long long epad;
  int nchmax, nsc, superchunk, chunk;
  long long slots, cap_multi, cap_rescan;
  int* multi;                         // (cap_multi,) flat slot ids
  unsigned long long* ctr;            // (6,) the populations
  double* mit_sums;                   // (n + 1,)
  double* cfd_sums;
  long long* rows;                    // (6, cap_rescan)
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// One hit at flat entry position pos: its terms times its occurrence.
__device__ __forceinline__ void score_hit(const Args& a, long long pos,
                                          unsigned long long q, double& m,
                                          double& c) {
  float mit, cfd;
  pair_hit_terms(__ldg(a.entries + pos), q, a.mit_tab, a.pen, a.pam, mit,
                 cfd);
  const float w = (float)__ldg(a.occ + pos);
  m += (double)__fmul_rn(mit, w);
  c += (double)__fmul_rn(cfd, w);
}

// A cell of 1 or 2 hits: the min rank, and the max rank when it holds 2.
__device__ __forceinline__ void score_cell(const Args& a, long long cell,
                                           int count, long long base,
                                           unsigned long long q, double& m,
                                           double& c) {
  score_hit(a, base + __ldg(a.rmin + cell), q, m, c);
  if (count == 2) score_hit(a, base + __ldg(a.rmax + cell), q, m, c);
}

__global__ void __launch_bounds__(kThreads) decode_slots_kernel(Args a) {
  __shared__ int direct_of[kWarps], multi_of[kWarps];
  __shared__ unsigned long long multi_base;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (i < a.cap_rescan) {
    a.rows[kRidx * a.cap_rescan + i] = -1;
    a.rows[kQ * a.cap_rescan + i] = 0;
    a.rows[kHq * a.cap_rescan + i] = a.n;
    a.rows[kStart * a.cap_rescan + i] = 0;
    a.rows[kLive * a.cap_rescan + i] = 0;
    a.rows[kSlice * a.cap_rescan + i] = 0;
  }
  long long sb = 0, total = 0;
  int count = 0;
  if (i < a.slots) {
    sb = i / a.qb;
    total = (sb * a.C + a.C - 1) * a.qb + i % a.qb;
    count = __ldg(a.cnt + total);
  }
  const bool direct = count == 1 || count == 2, multi = count >= 3;
  const unsigned dm = __ballot_sync(kFull, direct);
  const unsigned mm = __ballot_sync(kFull, multi);
  if (lane == 0) {
    direct_of[warp] = __popc(dm);
    multi_of[warp] = __popc(mm);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nd = 0, nm = 0;
    for (int w = 0; w < kWarps; ++w) {
      nd += direct_of[w];
      const int k = multi_of[w];
      multi_of[w] = nm;                 // the warp's offset in the block
      nm += k;
    }
    if (nd) atomicAdd(a.ctr + kSingle, (unsigned long long)nd);
    multi_base = nm ? atomicAdd(a.ctr + kMslot, (unsigned long long)nm) : 0;
  }
  __syncthreads();
  if (multi) {
    const unsigned long long k =
        multi_base + multi_of[warp] + __popc(mm & lanes_below(lane));
    if (k < (unsigned long long)a.cap_multi) a.multi[k] = (int)i;
  }
  if (!direct) return;
  const int hq = min(__ldg(a.qsp + i), a.n);
  if (hq >= a.n) return;
  const long long base = sb / a.B * a.epad + __ldg(a.boff + sb);
  double m = 0.0, c = 0.0;
  score_cell(a, total, count, base, __ldg(a.qsig + hq), m, c);
  atomicAdd(a.mit_sums + hq, m);
  atomicAdd(a.cfd_sums + hq, c);
}

// The slot a warp of the tree pass walks, and what its lanes gather.
struct Walk {
  long long cell0;            // flat cell 0 of the slot; cell k at + k*qb
  long long base;             // flat position of the bucket's rank 0
  long long blen;
  unsigned long long q;
  int hq, slice, lane;
  int scell = 0, sresc = 0, mcell = 0;
  double m = 0.0, c = 0.0;
};

// One round of chunk cells, ch on each lane where ``live``: 1-2-hit cells
// scored, >=3-hit ones appended to the rescan list. Warp-uniform.
__device__ __forceinline__ void visit_chunks(const Args& a, Walk& w, int ch,
                                             bool live) {
  const long long cell = w.cell0 + (long long)ch * a.qb;
  const int count = live ? __ldg(a.cnt + cell) : 0;
  w.mcell += count > 0;
  if ((count == 1 || count == 2) && w.hq < a.n)
    score_cell(a, cell, count, w.base, w.q, w.m, w.c);
  const unsigned big = __ballot_sync(kFull, count >= 3);
  if (!big) return;
  unsigned long long first = 0;
  if (w.lane == 0)
    first = atomicAdd(a.ctr + kRescan, (unsigned long long)__popc(big));
  first = __shfl_sync(kFull, first, 0);
  if (count < 3) return;
  const unsigned long long k = first + __popc(big & lanes_below(w.lane));
  if (k >= (unsigned long long)a.cap_rescan) return;
  const long long lead = (long long)ch * a.chunk;
  a.rows[kRidx * a.cap_rescan + k] = (long long)k;
  a.rows[kQ * a.cap_rescan + k] = (long long)w.q;
  a.rows[kHq * a.cap_rescan + k] = w.hq;
  a.rows[kStart * a.cap_rescan + k] = w.base + lead;
  a.rows[kLive * a.cap_rescan + k] = w.blen - lead;
  a.rows[kSlice * a.cap_rescan + k] = w.slice;
}

__global__ void __launch_bounds__(kThreads) decode_tree_kernel(Args a) {
  const long long listed = min((long long)a.ctr[kMslot], a.cap_multi);
  const long long e = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= listed) return;                        // uniform over the warp
  const long long slot = a.multi[e];
  const long long sb = slot / a.qb;
  Walk w;
  w.lane = threadIdx.x & 31;
  w.cell0 = sb * a.C * a.qb + slot % a.qb;
  w.slice = (int)(sb / a.B);
  w.base = w.slice * a.epad + __ldg(a.boff + sb);
  w.blen = __ldg(a.blen + sb);
  w.hq = min(__ldg(a.qsp + slot), a.n);
  w.q = __ldg(a.qsig + min(w.hq, a.n - 1));
  // the bucket's live chunks: a cell past its length holds no hit
  const int nlive = (int)min((long long)a.nchmax,
                             (w.blen + a.chunk - 1) / a.chunk);
  if (a.superchunk) {
    const int nsc = min(a.nsc, (nlive + a.superchunk - 1) / a.superchunk);
    for (int r = 0; r < nsc; r += 32) {
      const int sc = r + w.lane;
      const long long cell = w.cell0 + (long long)(a.nchmax + sc) * a.qb;
      const int count = sc < nsc ? __ldg(a.cnt + cell) : 0;
      w.scell += count > 0;
      w.sresc += count >= 3;
      if ((count == 1 || count == 2) && w.hq < a.n)
        score_cell(a, cell, count, w.base, w.q, w.m, w.c);
      for (unsigned big = __ballot_sync(kFull, count >= 3); big;
           big &= big - 1u) {
        const int first = (r + __ffs(big) - 1) * a.superchunk;
        for (int k = 0; k < a.superchunk; k += 32) {
          const int ch = first + k + w.lane;
          visit_chunks(a, w, ch, k + w.lane < a.superchunk && ch < nlive);
        }
      }
    }
  } else {
    for (int ch = w.lane; ch - w.lane < nlive; ch += 32)
      visit_chunks(a, w, ch, ch < nlive);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w.m += __shfl_down_sync(kFull, w.m, o);
    w.c += __shfl_down_sync(kFull, w.c, o);
    w.scell += __shfl_down_sync(kFull, w.scell, o);
    w.sresc += __shfl_down_sync(kFull, w.sresc, o);
    w.mcell += __shfl_down_sync(kFull, w.mcell, o);
  }
  if (w.lane != 0) return;
  if (w.hq < a.n) {
    atomicAdd(a.mit_sums + w.hq, w.m);
    atomicAdd(a.cfd_sums + w.hq, w.c);
  }
  if (w.scell) atomicAdd(a.ctr + kScell, (unsigned long long)w.scell);
  if (w.sresc) atomicAdd(a.ctr + kSresc, (unsigned long long)w.sresc);
  if (w.mcell) atomicAdd(a.ctr + kMcell, (unsigned long long)w.mcell);
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors: the finder's cnt, rmin, rmax (S, B, C, qb) int32 with
// C = nchmax + nsc + 1; the slot plan qsp (S, B, qb) int32 (n: padding);
// qsig (n,) int64; boff (S, B) int64 and blen (S, B) int32; entries (S, epad)
// int64 and occ (S, epad) int32; mit_tab (2^20,) f32, pen (20, 16) f32. The
// outputs: counters (6,) int64 and the sums (n + 1,) f64, zeroed by the
// caller; rows (6, cap_rescan) int64 and multi (cap_multi,) int32 scratch,
// written here. Two launches, the slot pass then the tree pass.
extern "C" int crackling_compact_decode(
    const void* cnt, const void* rmin, const void* rmax, const void* qsp,
    const void* qsig, const void* boff, const void* blen, const void* entries,
    const void* occ, const void* mit_tab, const void* pen, float pam, int S,
    int B, int C, int qb, int n, long long epad, int nchmax, int nsc,
    int superchunk, int chunk, long long cap_multi, long long cap_rescan,
    void* multi, void* counters, void* mit_sums, void* cfd_sums, void* rows,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)S * B * qb;
  if (S < 1 || B < 1 || qb < 1 || n < 1 || nchmax < 1 || nsc < 0 ||
      superchunk < 0 || (superchunk > 0) != (nsc > 0) ||
      C != nchmax + nsc + 1 || chunk < 1 || cap_multi < 0 ||
      cap_rescan < 0 || slots > 0x7FFFFFFFll || cap_multi > 0x7FFFFFFFll ||
      cap_rescan > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cnt = static_cast<const int*>(cnt);
  a.rmin = static_cast<const int*>(rmin);
  a.rmax = static_cast<const int*>(rmax);
  a.qsp = static_cast<const int*>(qsp);
  a.qsig = static_cast<const unsigned long long*>(qsig);
  a.boff = static_cast<const long long*>(boff);
  a.blen = static_cast<const int*>(blen);
  a.entries = static_cast<const unsigned long long*>(entries);
  a.occ = static_cast<const int*>(occ);
  a.mit_tab = static_cast<const float*>(mit_tab);
  a.pen = static_cast<const float*>(pen);
  a.pam = pam;
  a.B = B;
  a.C = C;
  a.qb = qb;
  a.n = n;
  a.epad = epad;
  a.nchmax = nchmax;
  a.nsc = nsc;
  a.superchunk = superchunk;
  a.chunk = chunk;
  a.slots = slots;
  a.cap_multi = cap_multi;
  a.cap_rescan = cap_rescan;
  a.multi = static_cast<int*>(multi);
  a.ctr = static_cast<unsigned long long*>(counters);
  a.mit_sums = static_cast<double*>(mit_sums);
  a.cfd_sums = static_cast<double*>(cfd_sums);
  a.rows = static_cast<long long*>(rows);
  cudaStream_t st = (cudaStream_t)stream;
  const long long threads = slots > cap_rescan ? slots : cap_rescan;
  decode_slots_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                        kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || cap_multi == 0) return (int)err;
  decode_tree_kernel<<<(unsigned)((cap_multi + kWarps - 1) / kWarps),
                       kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
