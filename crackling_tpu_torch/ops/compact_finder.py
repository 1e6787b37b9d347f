"""The compact engine's finder: per-(chunk, query slot) hit moments.

For every (slice ``s``, bucket ``b``) of the ISSL index, every entry of
the bucket (in-bucket rank ``r < blen``) and every query slot ``j`` of
the page's slot plan, the pair is a **hit** iff

* the Hamming distance (mismatched positions) is ``<= max_dist``;
* no earlier slice ``s' < s`` matches the query exactly (first-clean-
  slice dedup: the hit was counted there);
* the slot holds a query (padding slots, id ``n``, have no hits).

Per 4096-entry chunk (``chunk``) and slot the finder emits the quad
(hit count, sum of in-bucket ranks, min rank, max rank); with
``superchunk > 0`` the same quad per superchunk of chunks; and always the
bucket totals. Output planes are (S, B, C, qb) with cells
``[0, nchmax)`` the chunks, ``[nchmax, nchmax + nsc)`` the superchunks and
``nchmax + nsc`` the totals; empty cells read (0, 0, RANK_EMPTY, -1).
Counts and min/max ranks are int32, rank sums int64: all exact.

Two implementations of the same function:

* :func:`compact_finder` — the wrapper. On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/compact_finder.cu`` (built with nvcc
  at first use, bound with ctypes); on a CPU tensor it runs the plain
  version. Nothing else: no fallback from one to the other.
* :func:`compact_finder_plain` — plain PyTorch over the list of
  (slot, entry) pairs, in bounded blocks; the CPU tests' engine and the
  reference the kernel is held to on the card.

The kernel takes every pair's distance from an int8 tensor-core product
(``mma.sync`` m16n8k32) of one-hot entry rows, built in registers from the
packed words, by the slots' weight columns, and re-tests only the pairs
within ``max_dist`` from their packed words. :func:`mma_rows` and
:func:`mma_columns` build the same operands in plain PyTorch, lane for
lane and from the same bit arithmetic, so the CPU tests can hold the
kernel's product to the distance.

Replaces crackling_tpu/ops/issl_compact.py::_finder_kernel.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import torch

from .bits import SIG40, collapse_pairs, earlier_slice_clean, popcount
from .kernel_build import KernelLibrary

# min rank of an empty cell: the int32 rank planes' largest value, above
# every rank (``issl_compact.RANK_BOUND`` keeps buckets below 2^30 entries)
RANK_EMPTY = (1 << 31) - 1
# entries per block round of the kernel (.cu kTile), a multiple of the
# one-hot kernel's shared tile (compact_onehot.cu kTileRows): chunks are
# multiples of it
KERNEL_TILE = 512
# plain version: (slot, entry) pairs evaluated per block, bounding memory
PLAIN_PAIR_BLOCK = 1 << 23

class FinderOut(NamedTuple):
    cnt: torch.Tensor     # (S, B, C, qb) int32 hit counts
    rsum: torch.Tensor    # (S, B, C, qb) int64 sums of in-bucket ranks
    rmin: torch.Tensor    # (S, B, C, qb) int32 min rank (RANK_EMPTY: none)
    rmax: torch.Tensor    # (S, B, C, qb) int32 max rank (-1: none)
    nchmax: int           # chunk cells [0, nchmax)
    nsc: int              # superchunk cells [nchmax, nchmax + nsc)

    @property
    def total_cell(self) -> int:
        return self.nchmax + self.nsc


def superchunk_cells(nchmax: int, superchunk: int) -> int:
    return -(-nchmax // superchunk) if superchunk else 0


# -- the kernel -----------------------------------------------------------


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crackling_compact_finder.restype = i
    lib.crackling_compact_finder.argtypes = [
        p, ll, p, p, p, p,    # entries, epad, boff, blen, qsig, qsp
        i, i, i, i,           # S, B, qb, n
        i, i, i, i, i,        # chunk, nchmax, superchunk, nsc, max_dist
        p, p, p, p,           # cnt, rsum, rmin, rmax
        i, p]                 # device, stream


KERNEL = KernelLibrary("compact_finder.cu", _bind)


def check_inputs(entries, boff, blen, q_sig, qsp, chunk, nchmax, max_dist,
                 lists_name="entries", lists_dtype=torch.int64,
                 lists_dim=2):
    """Raise on inputs the finders do not take; ``entries`` is the
    per-slice input, named and typed by the ``lists_*`` arguments."""
    dev = entries.device
    for name, t, dt, nd in ((lists_name, entries, lists_dtype, lists_dim),
                            ("boff", boff, torch.int64, 2),
                            ("blen", blen, torch.int32, 2),
                            ("q_sig", q_sig, torch.int64, 1),
                            ("qsp", qsp, torch.int32, 3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, entries on {dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d {dt} tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S, B, qb = qsp.shape
    if entries.shape[0] != S or boff.shape != (S, B) \
            or blen.shape != (S, B):
        raise ValueError(f"{lists_name}/boff/blen/qsp disagree on (S, B)")
    if not 1 <= S <= 5:
        raise ValueError("the finder takes 1..5 slices (l=20, w=8)")
    if chunk % KERNEL_TILE or nchmax < 1 or qb < 1:
        raise ValueError(f"chunk must be a multiple of {KERNEL_TILE}; "
                         "nchmax and qb must be >= 1")
    if not 0 <= max_dist <= 20:
        raise ValueError("max_dist must lie in [0, 20]")
    if q_sig.numel() >= (1 << 31):
        raise ValueError("query page too large for int32 slot ids")


def alloc_out(S, B, qb, nchmax, nsc, device):
    shape = (S, B, nchmax + nsc + 1, qb)
    return FinderOut(torch.empty(shape, dtype=torch.int32, device=device),
                     torch.empty(shape, dtype=torch.int64, device=device),
                     torch.empty(shape, dtype=torch.int32, device=device),
                     torch.empty(shape, dtype=torch.int32, device=device),
                     nchmax, nsc)


def compact_finder(entries: torch.Tensor, boff: torch.Tensor,
                   blen: torch.Tensor, q_sig: torch.Tensor,
                   qsp: torch.Tensor, *, chunk: int, nchmax: int,
                   superchunk: int, max_dist: int) -> FinderOut:
    """The finder (module docstring) on ``entries.device``.

    entries (S, Epad) int64 bucket-aligned packed site signatures (one
    slice per row); boff (S, B) int64 bucket starts within a row; blen
    (S, B) int32 bucket lengths; q_sig (n,) int64 query signatures; qsp
    (S, B, qb) int32 slot plan (query id per slot, ``n`` = padding).
    A CUDA tensor launches the kernel (counted in ``compact_finder.
    launches``); a CPU tensor runs :func:`compact_finder_plain`."""
    check_inputs(entries, boff, blen, q_sig, qsp, chunk, nchmax, max_dist)
    if entries.device.type == "cpu":
        return compact_finder_plain(entries, boff, blen, q_sig, qsp,
                                    chunk=chunk, nchmax=nchmax,
                                    superchunk=superchunk,
                                    max_dist=max_dist)
    if entries.device.type != "cuda":
        raise ValueError(f"no compact finder for device {entries.device}")
    lib = KERNEL.get()
    S, B, qb = qsp.shape
    nsc = superchunk_cells(nchmax, superchunk)
    out = alloc_out(S, B, qb, nchmax, nsc, entries.device)
    stream = torch.cuda.current_stream(entries.device).cuda_stream
    rc = lib.crackling_compact_finder(
        entries.data_ptr(), entries.shape[1], boff.data_ptr(),
        blen.data_ptr(), q_sig.data_ptr(), qsp.data_ptr(),
        S, B, qb, q_sig.numel(), chunk, nchmax, superchunk, nsc, max_dist,
        out.cnt.data_ptr(), out.rsum.data_ptr(), out.rmin.data_ptr(),
        out.rmax.data_ptr(), entries.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"compact finder kernel launch failed: CUDA "
                           f"error {rc}")
    compact_finder.launches += 1
    return out


compact_finder.launches = 0


# -- the kernel's operands, in plain PyTorch ------------------------------

MMA_K = 64            # product lanes: 16 positions outside the slice x 4
_ONES = 0x01010101


def _mma_lanes():
    """Lane ``k = 32 ks + 16 h + 4 t + m`` of the product: thread ``t`` of
    a quad holds byte ``m`` of the register for base ``2 ks + h``, which is
    position ``4 m + t`` of :func:`mma_word`. Returns (register, thread,
    byte), each (MMA_K,) int64."""
    k = torch.arange(MMA_K)
    return (2 * (k // 32) + (k // 16) % 2, (k // 4) % 4, k % 4)


def mma_lane_bases_positions():
    """(base, position) of every product lane, each (MMA_K,) int64: the
    position counts the 16 positions outside the bucket's slice."""
    reg, t, m = _mma_lanes()
    return reg, 4 * m + t


def mma_word(sig: torch.Tensor, s: int) -> torch.Tensor:
    """int64 signatures -> the 32-bit words of their 16 positions outside
    slice ``s`` (position ``i`` at bits ``2i..2i+1``; slice ``s``'s byte,
    bits ``8s..8s+7``, cut out): the kernel's ``outside_slice``."""
    low = (1 << (8 * s)) - 1
    return (sig & low) | ((sig >> 8) & (0xFFFFFFFF ^ low))


def mma_registers(word: torch.Tensor, t: int) -> torch.Tensor:
    """The kernel's ``onehot4``: thread ``t``'s four registers of each
    word's one-hot row, (..., 4) int64 of 32-bit values; register ``b``
    byte ``m`` is 1 iff position ``4 m + t`` has base ``b``."""
    c0 = word >> (2 * t)
    c1 = c0 >> 1
    n0, n1 = c0 ^ 0xFFFFFFFF, c1 ^ 0xFFFFFFFF
    return torch.stack([n0 & n1 & _ONES, c0 & n1 & _ONES, n0 & c1 & _ONES,
                        c0 & c1 & _ONES], -1)


def _lanes_of(regs_by_thread) -> torch.Tensor:
    """(..., MMA_K) int64 lanes from the four threads' (..., 4)
    registers."""
    reg, t, m = _mma_lanes()
    regs = torch.stack(regs_by_thread, -2)              # (..., 4 t, 4 b)
    return (regs[..., t, reg] >> (8 * m)) & 0xFF


def onehot_lanes(word: torch.Tensor) -> torch.Tensor:
    """(n,) 32-bit words of 16 positions -> (n, MMA_K) int64 lanes of
    their one-hot rows, as the kernels build them (``onehot4`` in each
    thread of a quad)."""
    return _lanes_of([mma_registers(word, t) for t in range(4)])


def weight_lanes(word: torch.Tensor, live: torch.Tensor,
                 max_dist: int | None = None) -> torch.Tensor:
    """(m,) 32-bit words of the slots' queries and their liveness -> (m,
    MMA_K) int64 lanes (bytes 0..255) of the kernels' weight columns: 1 at
    the lanes of the bases a live slot's query does not have (its
    registers XOR 0x01010101), 2 at every lane of a padding slot; with
    ``max_dist``, position 0's four weights lowered by ``max_dist + 1``
    (modulo 256, the int8 bytes the kernels hold)."""
    regs = [torch.where(live[:, None], mma_registers(word, t) ^ _ONES,
                        2 * _ONES) for t in range(4)]
    if max_dist is not None:
        low = regs[0] & 0xFF
        regs[0] = regs[0] - low + ((low - max_dist - 1) & 0xFF)
    return _lanes_of(regs)


def signed_columns(lanes: torch.Tensor) -> torch.Tensor:
    """(m, K) int64 weight bytes -> (K, m) int8 columns."""
    return torch.where(lanes > 127, lanes - 256, lanes).to(torch.int8).t() \
        .contiguous()


def mma_rows(sig: torch.Tensor, s: int) -> torch.Tensor:
    """(n,) int64 entry signatures of a bucket of slice ``s`` -> (n,
    MMA_K) int8: the A operand rows the kernel builds from packed words."""
    return onehot_lanes(mma_word(sig, s)).to(torch.int8)


def mma_columns(q: torch.Tensor, s: int, live: torch.Tensor,
                max_dist: int | None = None) -> torch.Tensor:
    """(m,) int64 query signatures of slots of slice ``s`` and their
    liveness -> (MMA_K, m) int8 weight columns (:func:`weight_lanes`);
    their product with :func:`mma_rows` is the distance outside slice
    ``s``. With ``max_dist``, the kernel's columns: every row has exactly
    one base at position 0, so every product is the distance less
    ``max_dist + 1``."""
    return signed_columns(weight_lanes(mma_word(q, s), live, max_dist))


def mma_candidates(rows: torch.Tensor, cols: torch.Tensor,
                   rank: torch.Tensor, blen: int) -> torch.Tensor:
    """The kernel's epilogue screen of rows (n, MMA_K) by the kernel's
    columns (MMA_K, m), lowered by ``max_dist + 1``: the product is
    negative and the row's in-bucket ``rank`` (n,) lies below the bucket
    length ``blen``. A candidate is a hit iff its packed words pass the
    exact test; padding columns (distance 32) never pass the screen."""
    d = rows.int() @ cols.int()
    return (d < 0) & (rank < blen)[:, None]


# -- the plain version ----------------------------------------------------


class PairBlock(NamedTuple):
    """One block of (query slot, bucket entry) pairs, one row per pair."""
    slot: torch.Tensor    # the slot's index in the flat plan
    sl: torch.Tensor      # slice s
    r: torch.Tensor       # the entry's in-bucket rank
    e: torch.Tensor       # the entry's packed signature (int64)
    q: torch.Tensor       # the slot's query signature (int64)
    at: torch.Tensor      # the entry's index in the flattened (S, Epad) lists


def slot_entry_pairs(entries: torch.Tensor, boff: torch.Tensor,
                     blen: torch.Tensor, q_sig: torch.Tensor,
                     qsp: torch.Tensor,
                     block: int = PLAIN_PAIR_BLOCK) -> Iterator[PairBlock]:
    """The (slot, entry) pairs of every occupied slot (a query id in
    ``[0, n)``) of the (S, B, qb) slot plan with every entry of its
    bucket, flat slot ``(s*B + b)*qb + j``: the enumeration the finders'
    plain versions test (:func:`bucket_entry_pairs`)."""
    S, B, qb = qsp.shape
    sb = torch.arange(S * B * qb, device=entries.device) // qb
    return bucket_entry_pairs(entries, boff, blen, q_sig,
                              qsp.reshape(-1).long(), sb, block)


def bucket_entry_pairs(entries: torch.Tensor, boff: torch.Tensor,
                       blen: torch.Tensor, q_sig: torch.Tensor,
                       qid: torch.Tensor, sb: torch.Tensor,
                       block: int = PLAIN_PAIR_BLOCK
                       ) -> Iterator[PairBlock]:
    """The (slot, entry) pairs of flat slots ``i`` holding query ``qid[i]``
    of bucket ``sb[i] = s*B + b``, with every entry of that bucket; slots
    whose id lies outside ``[0, n)`` are padding and have none. Pairs come
    in blocks of whole slots holding at most ``block`` pairs (a slot
    longer than that is its own block), so work follows the pairs the
    page really has."""
    dev = entries.device
    B = boff.shape[1]
    n = q_sig.numel()
    epad = entries.shape[1]
    slot = torch.arange(qid.numel(), device=dev)
    lens = blen.reshape(-1).long()[sb]
    live = (qid < n) & (qid >= 0) & (lens > 0)
    slot, sb, lens = slot[live], sb[live], lens[live]
    sl = sb // B
    q = q_sig[qid[live]]
    base = sl * epad + boff.reshape(-1)[sb]           # flat bucket start
    flat = entries.reshape(-1)
    ends = torch.cumsum(lens, 0).cpu()
    i0 = 0
    while i0 < slot.numel():
        start = int(ends[i0 - 1]) if i0 else 0
        i1 = int(torch.searchsorted(ends, start + block, right=True))
        i1 = max(i1, i0 + 1)
        blens = lens[i0:i1]
        rep = torch.repeat_interleave(
            torch.arange(i1 - i0, device=dev), blens)
        first = torch.cumsum(blens, 0) - blens
        r = torch.arange(rep.numel(), device=dev) - first[rep]
        at = base[i0:i1][rep] + r
        yield PairBlock(slot[i0:i1][rep], sl[i0:i1][rep], r, flat[at],
                        q[i0:i1][rep], at)
        i0 = i1


def compact_finder_plain(entries: torch.Tensor, boff: torch.Tensor,
                         blen: torch.Tensor, q_sig: torch.Tensor,
                         qsp: torch.Tensor, *, chunk: int, nchmax: int,
                         superchunk: int, max_dist: int) -> FinderOut:
    """The same function in plain PyTorch: test the hit predicate on
    every (slot, entry) pair (:func:`slot_entry_pairs`) and scatter hits
    into the chunk cells; superchunk and bucket cells reduce the chunk
    cells."""
    compact_finder_plain.calls += 1
    acc = ChunkMoments(qsp.shape, chunk, nchmax, entries.device)
    for pb in slot_entry_pairs(entries, boff, blen, q_sig, qsp):
        c40 = collapse_pairs((pb.e ^ pb.q) & SIG40)
        hit = ((popcount(c40) <= max_dist)
               & ~earlier_slice_clean(c40, pb.sl))
        h = torch.nonzero(hit).flatten()
        acc.add(pb.slot[h], pb.r[h])
    return acc.finder_out(superchunk)


compact_finder_plain.calls = 0


class ChunkMoments:
    """The plain finders' chunk quads, filled hit by hit: one (count, rank
    sum, min rank, max rank) per (flat slot, chunk)."""

    def __init__(self, plan_shape, chunk: int, nchmax: int, device):
        self.shape = tuple(plan_shape)             # (S, B, qb)
        self.chunk = chunk
        self.nchmax = nchmax
        cells = self.shape[0] * self.shape[1] * self.shape[2] * nchmax
        self.cnt = torch.zeros(cells, dtype=torch.int64, device=device)
        self.rsum = torch.zeros(cells, dtype=torch.int64, device=device)
        self.rmin = torch.full((cells,), RANK_EMPTY, dtype=torch.int64,
                               device=device)
        self.rmax = torch.full((cells,), -1, dtype=torch.int64,
                               device=device)

    def add(self, slot: torch.Tensor, r: torch.Tensor):
        """Hits at in-bucket ranks ``r`` of flat slots ``slot``
        (``(s*B + b)*qb + j``)."""
        cell = slot * self.nchmax + r // self.chunk
        self.cnt.index_add_(0, cell, torch.ones_like(r))
        self.rsum.index_add_(0, cell, r)
        self.rmin.scatter_reduce_(0, cell, r, "amin")
        self.rmax.scatter_reduce_(0, cell, r, "amax")

    def finder_out(self, superchunk: int) -> FinderOut:
        """The finder's output planes: the chunk cells, then the
        superchunk and bucket cells that reduce them."""
        S, B, qb = self.shape
        nchmax = self.nchmax
        dev = self.cnt.device
        nsc = superchunk_cells(nchmax, superchunk)
        # (S*B*qb, nchmax) slot-major -> (S, B, nchmax, qb) cell-major
        ch = [x.view(S, B, qb, nchmax).permute(0, 1, 3, 2)
              for x in (self.cnt, self.rsum, self.rmin, self.rmax)]
        empty = (0, 0, RANK_EMPTY, -1)
        fold = (torch.sum, torch.sum, torch.amin, torch.amax)

        def reduce_cells(k, width):
            """The four chunk planes folded over groups of ``width`` chunk
            cells -> (S, B, k, qb) each (the last group padded with empty
            cells)."""
            res = []
            for x, fill, op in zip(ch, empty, fold):
                pad = k * width - nchmax
                if pad:
                    x = torch.cat([x, torch.full((S, B, pad, qb), fill,
                                                 dtype=x.dtype, device=dev)],
                                  2)
                res.append(op(x.reshape(S, B, k, width, qb), 3))
            return res

        parts = [ch]
        if superchunk:
            parts.append(reduce_cells(nsc, superchunk))
        parts.append(reduce_cells(1, nchmax))
        out = [torch.cat([p[i] for p in parts], 2).contiguous()
               for i in range(4)]
        return FinderOut(out[0].int(), out[1], out[2].int(), out[3].int(),
                         nchmax, nsc)
