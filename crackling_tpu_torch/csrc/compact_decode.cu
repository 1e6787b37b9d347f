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
// What bounds it on the H100: bytes, ~6 MB at the 65,536-query page (the
// slot totals, the plan, the live cells of the >=3-hit slots, per hit an 8-B
// entry, a 4-B occurrence and a 4-B MIT table entry, the row block), ~2 us.
// Its work is a few dependent loads per slot, so latency sets its time.
//
// The design: one launch, bucket-major. A block of 128 threads owns one
// (slice, bucket) and, on grid.y, one share of its walk (at most
// kChunksPerBlock chunk cells, whole superchunks when that level is on), so
// a long bucket spreads over several blocks; blocks past a bucket's live
// cells only take their ticket. The bucket's qb slots are contiguous in the
// cells and the plan, so the block reads its bucket totals and plan
// coalesced, and lists its >=3-hit slots in shared memory in slot order.
// It then walks the superchunk cells of those slots (>=3-hit ones listed in
// (superchunk, slot) order) and their chunk cells, in (chunk offset, parent)
// order, so that a warp reads cells of one chunk row and the >=3-hit chunk
// cells of one chunk are adjacent pairs; each round records them as a
// ballot word in a shared bitmap. Counting first: one atomicAdd per block
// on the n_rescan word claims all its rows and takes the block's ticket
// (rows in its low bits, tickets above), and the bitmap's prefix sums place
// the rows, so the rows of a chunk are consecutive in the list (the
// rescan's blocks of one chunk's rows split it and read it once). The block that takes the last
// ticket sees every block's rows: it writes n_rescan and the padding rows
// (ridx -1, hq n, start and live 0) from there to cap_rescan; live rows lie
// below, so nothing races. Scoring last: the 1-2-hit cells are read again
// (from L1) and scored with no barrier after them, the loads of a thread's
// cells in stages, so its chains of dependent loads (plan, ranks, entries,
// table) overlap. The block's populations are tallied in shared memory and
// added once, each counter on a 128-B line of its own: 1,280 blocks' atomics
// on one line queue one after another. n_rescan counts past cap_rescan,
// the one cap; only the rows' writes stop there.
//
// Contract: allocates nothing, adds into the sums and the counters the
// caller zeroed, and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace {

using pair_terms::pair_hit_terms;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotRounds = 2;          // slots a thread loads at once
constexpr int kChunksPerBlock = 32;     // chunk cells of a block's walk
constexpr long long kMaxShared = 227 * 1024;

// the counters, in the header's order, one per 128-B line (kLine int64) so
// that the blocks' atomics on one never queue behind another's
enum Counter { kSingle, kMslot, kScell, kSresc, kMcell, kRescan };
constexpr int kLine = 16;
// a block claims its rows and takes its ticket in one atomicAdd on the
// n_rescan word: rows in the low kRowBits, tickets above them
constexpr int kRowBits = 40;
constexpr unsigned long long kRowMask = (1ull << kRowBits) - 1ull;
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
  int per_block;                      // walked cells (chunk or superchunk)
  int lcap;                           // >=3-hit superchunk cells listed
  long long cap_rescan;
  unsigned long long* ctr;            // (6, kLine): column 0 counts
  double* mit_sums;                   // (n + 1,)
  double* cfd_sums;
  long long* rows;                    // (6, cap_rescan)
};

// The block's scalars in shared memory.
struct Block {
  int scan[kWarps];
  int tally[kRescan + 1];             // kSingle .. kMcell, then its rows
  unsigned long long first;           // its first row
  unsigned long long final;           // the last block: rows written
};

// Exclusive prefix sum of v over the block's threads in thread order, and
// its total. Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return before + x - v;
}

// The warp's flags added into a tally of the block. Warp-uniform.
__device__ __forceinline__ void tally(int* t, bool flag) {
  const int k = __popc(__ballot_sync(kFull, flag));
  if ((threadIdx.x & 31) == 0 && k) atomicAdd(t, k);
}

// A thread's cells of 1 or 2 hits (count 1-2 and a query hq < n; the
// others are skipped): the min rank of each, and the max rank when it holds
// 2, added into its query's sums. The loads go in stages over all N cells
// (ranks and signatures, then entries and occurrences, then the table), so
// each stage's loads are in flight together.
template <int N>
__device__ __forceinline__ void score_cells(const Args& a,
                                            const long long (&cell)[N],
                                            const int (&count)[N],
                                            const int (&hq)[N],
                                            long long base) {
  unsigned long long q[N];
  long long lo[N], hi[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool ok = (count[i] == 1 || count[i] == 2) && hq[i] < a.n;
    q[i] = ok ? __ldg(a.qsig + hq[i]) : 0ull;
    lo[i] = ok ? base + __ldg(a.rmin + cell[i]) : -1;
    hi[i] = ok && count[i] == 2 ? base + __ldg(a.rmax + cell[i]) : -1;
  }
  unsigned long long e[N][2];
  int w[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    e[i][0] = lo[i] >= 0 ? __ldg(a.entries + lo[i]) : 0ull;
    w[i][0] = lo[i] >= 0 ? __ldg(a.occ + lo[i]) : 0;
    e[i][1] = hi[i] >= 0 ? __ldg(a.entries + hi[i]) : 0ull;
    w[i][1] = hi[i] >= 0 ? __ldg(a.occ + hi[i]) : 0;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (lo[i] < 0) continue;
    double m = 0.0, c = 0.0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && hi[i] < 0) break;
      float mit, cfd;
      pair_hit_terms(e[i][h], q[i], a.mit_tab, a.pen, a.pam, mit, cfd);
      const float wt = (float)w[i][h];
      m += (double)__fmul_rn(mit, wt);
      c += (double)__fmul_rn(cfd, wt);
    }
    atomicAdd(a.mit_sums + hq[i], m);
    atomicAdd(a.cfd_sums + hq[i], c);
  }
}

// Pair t of the chunk level: its chunk and the index of its >=3-hit slot.
// Pairs run in (chunk offset, parent) order: a parent is a listed slot
// (chunks lo + u) or a listed superchunk cell (chunks sc * superchunk + u).
__device__ __forceinline__ void chunk_pair(const Args& a, int t, int np,
                                           int lo, const int* sclist,
                                           int& ch, int& k) {
  const int u = t / np, l = t % np;
  if (a.superchunk) {
    const int e = sclist[l];
    ch = (e >> 16) * a.superchunk + u;
    k = e & 0xFFFF;
  } else {
    ch = lo + u;
    k = l;
  }
}

// 12 blocks an SM (40 registers): the 65,536-query page's 1,280 blocks are
// all resident at once
__global__ void __launch_bounds__(kThreads, 12) decode_kernel(Args a) {
  extern __shared__ int dyn[];
  __shared__ Block sh;
  int* mslot = dyn;                         // (qb) >=3-hit slots, in order
  int* mhq = mslot + a.qb;                  // (qb) their queries (n: none)
  int* sclist = mhq + a.qb;                 // (lcap) superchunk << 16 | k
  unsigned* big = reinterpret_cast<unsigned*>(sclist + a.lcap);

  const int tid = threadIdx.x, y = blockIdx.y;
  const long long sb = blockIdx.x;
  const int s = (int)(sb / a.B);
  const long long blen = __ldg(a.blen + sb);
  const long long base = s * a.epad + __ldg(a.boff + sb);
  // the bucket's live chunks: a cell past its length holds no hit
  const int nlive = (int)min((long long)a.nchmax,
                             (blen + a.chunk - 1) / a.chunk);
  const int nwalk =
      a.superchunk ? min(a.nsc, (nlive + a.superchunk - 1) / a.superchunk)
                   : nlive;
  const int lo = y * a.per_block, hi = min(lo + a.per_block, nwalk);
  const bool walk = lo < hi;
  const long long cell0 = sb * a.C * a.qb;  // cell c of slot j: + c*qb + j
  const long long total0 = cell0 + (long long)(a.C - 1) * a.qb;
  if (tid <= kRescan) sh.tally[tid] = 0;
  __syncthreads();

  // the slot level: bucket totals and plan, coalesced; the >=3-hit slots
  // listed in slot order
  int nm = 0;
  if (y == 0 || walk) {
    for (int j0 = 0; j0 < a.qb; j0 += kSlotRounds * kThreads) {
      int count[kSlotRounds], hq[kSlotRounds];
#pragma unroll
      for (int r = 0; r < kSlotRounds; ++r) {
        const int j = j0 + r * kThreads + tid;
        count[r] = j < a.qb ? __ldg(a.cnt + total0 + j) : 0;
        hq[r] = j < a.qb ? __ldg(a.qsp + sb * a.qb + j) : a.n;
      }
#pragma unroll
      for (int r = 0; r < kSlotRounds; ++r) {
        if (j0 + r * kThreads >= a.qb) break;       // uniform
        if (y == 0) {
          tally(sh.tally + kSingle, count[r] == 1 || count[r] == 2);
          tally(sh.tally + kMslot, count[r] >= 3);
        }
        int total;
        const int k = nm + block_scan(count[r] >= 3, sh.scan, total);
        if (count[r] >= 3) {
          mslot[k] = j0 + r * kThreads + tid;
          mhq[k] = min(hq[r], a.n);
        }
        nm += total;
      }
    }
  }
  __syncthreads();

  // the tree: superchunk cells (listing the >=3-hit ones), then chunk cells
  // (a ballot word of >=3-hit ones per warp and round)
  int np = 0, width = 0;
  if (walk && nm > 0) {
    if (a.superchunk) {
      const int pairs = (hi - lo) * nm;
      for (int p0 = 0; p0 < pairs; p0 += kThreads) {
        const int p = p0 + tid;
        int count = 0, sc = 0, k = 0;
        if (p < pairs) {
          sc = lo + p / nm;
          k = p % nm;
          count = __ldg(a.cnt + cell0 + (long long)(a.nchmax + sc) * a.qb +
                        mslot[k]);
        }
        tally(sh.tally + kScell, count > 0);
        tally(sh.tally + kSresc, count >= 3);
        int total;
        const int at = np + block_scan(count >= 3, sh.scan, total);
        if (count >= 3) sclist[at] = sc << 16 | k;
        np += total;
      }
      width = a.superchunk;
      __syncthreads();
    } else {
      np = nm;
      width = hi - lo;
    }
    const int pairs = width * np;
    for (int t0 = 0; t0 < pairs; t0 += kThreads) {
      const int t = t0 + tid;
      int count = 0;
      if (t < pairs) {
        int ch, k;
        chunk_pair(a, t, np, lo, sclist, ch, k);
        if (ch < nlive)
          count = __ldg(a.cnt + cell0 + (long long)ch * a.qb + mslot[k]);
      }
      tally(sh.tally + kMcell, count > 0);
      const unsigned word = __ballot_sync(kFull, count >= 3);
      if ((tid & 31) == 0 && t0 + (tid & ~31) < pairs) {
        big[(t0 >> 5) + (tid >> 5)] = word;
        if (word) atomicAdd(sh.tally + kRescan, __popc(word));
      }
    }
  }
  __syncthreads();

  // the block's populations added once; its rows claimed and its ticket
  // taken in one atomicAdd. The last ticket sees every block's rows, so
  // that block writes n_rescan and the padding after the rows.
  const unsigned long long cap = (unsigned long long)a.cap_rescan;
  if (tid == 0) {
    for (int c = kSingle; c <= kMcell; ++c)
      if (sh.tally[c])
        atomicAdd(a.ctr + c * kLine, (unsigned long long)sh.tally[c]);
    const unsigned long long rows = (unsigned long long)sh.tally[kRescan];
    const unsigned long long old =
        atomicAdd(a.ctr + kRescan * kLine, (1ull << kRowBits) + rows);
    sh.first = old & kRowMask;
    sh.final = cap + 1;                     // not the last block
    if ((old >> kRowBits) == (unsigned long long)gridDim.x * gridDim.y - 1) {
      const unsigned long long listed = sh.first + rows;
      a.ctr[kRescan * kLine] = listed;
      sh.final = min(listed, cap);
    }
  }
  __syncthreads();

  // the rows, placed by the bitmap's prefix sums: a chunk's are consecutive
  if (sh.tally[kRescan] > 0) {
    const int words = (width * np + 31) >> 5;
    unsigned long long at = sh.first;
    for (int w0 = 0; w0 < words; w0 += kThreads) {
      const int w = w0 + tid;
      unsigned bits = w < words ? big[w] : 0u;
      int total;
      unsigned long long k = at + block_scan(__popc(bits), sh.scan, total);
      for (; bits && k < cap; bits &= bits - 1u, ++k) {
        int ch, slot;
        chunk_pair(a, w * 32 + __ffs(bits) - 1, np, lo, sclist, ch, slot);
        const int hq = mhq[slot];
        const long long lead = (long long)ch * a.chunk;
        a.rows[kRidx * a.cap_rescan + k] = (long long)k;
        a.rows[kQ * a.cap_rescan + k] =
            (long long)__ldg(a.qsig + min(hq, a.n - 1));
        a.rows[kHq * a.cap_rescan + k] = hq;
        a.rows[kStart * a.cap_rescan + k] = base + lead;
        a.rows[kLive * a.cap_rescan + k] = blen - lead;
        a.rows[kSlice * a.cap_rescan + k] = s;
      }
      at += total;
    }
  }

  // the 1-2-hit cells scored, with no barrier after them, kSlotRounds
  // cells a thread at once
  if (y == 0) {
    for (int j0 = 0; j0 < a.qb; j0 += kSlotRounds * kThreads) {
      long long cell[kSlotRounds];
      int count[kSlotRounds], hq[kSlotRounds];
#pragma unroll
      for (int r = 0; r < kSlotRounds; ++r) {
        const int j = j0 + r * kThreads + tid;
        cell[r] = total0 + j;
        count[r] = j < a.qb ? __ldg(a.cnt + cell[r]) : 0;
        hq[r] = j < a.qb ? min(__ldg(a.qsp + sb * a.qb + j), a.n) : a.n;
      }
      score_cells(a, cell, count, hq, base);
    }
  }
  if (walk && nm > 0) {
    if (a.superchunk) {
      const int pairs = (hi - lo) * nm;
      for (int p0 = 0; p0 < pairs; p0 += kSlotRounds * kThreads) {
        long long cell[kSlotRounds];
        int count[kSlotRounds], hq[kSlotRounds];
#pragma unroll
        for (int r = 0; r < kSlotRounds; ++r) {
          const int p = p0 + r * kThreads + tid;
          const int k = p < pairs ? p % nm : 0;
          cell[r] = cell0 + (long long)(a.nchmax + lo + p / nm) * a.qb +
                    mslot[k];
          count[r] = p < pairs ? __ldg(a.cnt + cell[r]) : 0;
          hq[r] = mhq[k];
        }
        score_cells(a, cell, count, hq, base);
      }
    }
    const int pairs = width * np;
    for (int t0 = 0; t0 < pairs; t0 += kSlotRounds * kThreads) {
      long long cell[kSlotRounds];
      int count[kSlotRounds], hq[kSlotRounds];
#pragma unroll
      for (int r = 0; r < kSlotRounds; ++r) {
        const int t = t0 + r * kThreads + tid;
        int ch = 0, k = 0;
        if (t < pairs) chunk_pair(a, t, np, lo, sclist, ch, k);
        cell[r] = cell0 + (long long)ch * a.qb + mslot[k];
        count[r] = t < pairs && ch < nlive ? __ldg(a.cnt + cell[r]) : 0;
        hq[r] = mhq[k];
      }
      score_cells(a, cell, count, hq, base);
    }
  }

  // the last block: the padding rows past the list
  if (sh.final <= cap) {
    for (long long i = (long long)sh.final + tid; i < a.cap_rescan;
         i += kThreads) {
      a.rows[kRidx * a.cap_rescan + i] = -1;
      a.rows[kQ * a.cap_rescan + i] = 0;
      a.rows[kHq * a.cap_rescan + i] = a.n;
      a.rows[kStart * a.cap_rescan + i] = 0;
      a.rows[kLive * a.cap_rescan + i] = 0;
      a.rows[kSlice * a.cap_rescan + i] = 0;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors: the finder's cnt, rmin, rmax (S, B, C, qb) int32 with
// C = nchmax + nsc + 1; the slot plan qsp (S, B, qb) int32 (n: padding);
// qsig (n,) int64; boff (S, B) int64 and blen (S, B) int32; entries (S, epad)
// int64 and occ (S, epad) int32; mit_tab (2^20,) f32, pen (20, 16) f32. The
// outputs: counters (6, 16) int64 (column 0: the six populations) and the
// sums (n + 1,) f64, zeroed by the caller; rows (6, cap_rescan) int64,
// written here. One launch.
extern "C" int crackling_compact_decode(
    const void* cnt, const void* rmin, const void* rmax, const void* qsp,
    const void* qsig, const void* boff, const void* blen, const void* entries,
    const void* occ, const void* mit_tab, const void* pen, float pam, int S,
    int B, int C, int qb, int n, long long epad, int nchmax, int nsc,
    int superchunk, int chunk, long long cap_rescan, void* counters,
    void* mit_sums, void* cfd_sums, void* rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 1 || B < 1 || qb < 1 || qb > 0xFFFF || n < 1 || nchmax < 1 ||
      nsc < 0 || nsc > 0x7FFF || superchunk < 0 ||
      (superchunk > 0) != (nsc > 0) || C != nchmax + nsc + 1 || chunk < 1 ||
      cap_rescan < 0 || (long long)S * B * qb > 0x7FFFFFFFll ||
      (long long)S * B > 0x7FFFFFFFll || cap_rescan > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  // a block walks kChunksPerBlock chunk cells, or whole superchunks
  const int per_block =
      superchunk ? (kChunksPerBlock / superchunk > 1
                        ? kChunksPerBlock / superchunk : 1)
                 : kChunksPerBlock;
  const int walked = superchunk ? nsc : nchmax;
  const long long lcap = superchunk ? (long long)per_block * qb : 0;
  const long long pairs =
      (long long)(superchunk ? superchunk : 1) * per_block * qb;
  const long long smem = 4 * (2ll * qb + lcap + (pairs + 31) / 32);
  const long long blocks =
      (long long)S * B * ((walked + per_block - 1) / per_block);
  if (smem > kMaxShared || blocks >= (1ll << (64 - kRowBits)) ||
      (long long)S * B * qb * nchmax > (long long)kRowMask)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
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
  a.per_block = per_block;
  a.lcap = (int)lcap;
  a.cap_rescan = cap_rescan;
  a.ctr = static_cast<unsigned long long*>(counters);
  a.mit_sums = static_cast<double*>(mit_sums);
  a.cfd_sums = static_cast<double*>(cfd_sums);
  a.rows = static_cast<long long*>(rows);
  const dim3 grid((unsigned)(S * B), (unsigned)((walked + per_block - 1) /
                                                 per_block));
  decode_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
