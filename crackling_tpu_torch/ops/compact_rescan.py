"""The compact engine's rescan: per-row screened MIT/CFD sums.

Step 3 of the moment-tree decode (``issl_compact.decode_score``). Every
chunk (of one query slot) whose finder cell holds 3 or more hits is a
**row** of the page's compacted rescan list, described by
:class:`RescanRows`. For each entry of a live row (``ridx >= 0`` and a
query id ``hq < n``) at a column below both ``scan_width`` and the row's
live length, the pair is a **hit** iff

* the Hamming distance (mismatched positions) is ``<= max_dist``;
* no earlier slice ``s' < s`` matches the query exactly (first-clean-
  slice dedup: the hit was counted there).

Each hit's f32 terms (:func:`pair_scores`: MIT from the dense table by
the 20-bit mismatch mask, 0 at distance 0; CFD the PAM penalty times the
position penalties in ascending order, exactly 1.0 at distance 0) times
its occurrence, an f32 product, are summed per row in f64 and the row's
sums added into ``mit_sums[hq]`` and ``cfd_sums[hq]``, in place.

Two implementations of the same function:

* :func:`compact_rescan` — the wrapper. On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/compact_rescan.cu`` (built with nvcc
  at first use, bound with ctypes), once for the whole list: the blocks
  of consecutive rows of one chunk (the decode lists them so; at most 8)
  split the chunk, each screening its part against all their queries, so
  the chunk is read once; a list in any order stays correct. On a CPU
  tensor it runs the plain version. Nothing else: no fallback from one to
  the other.
* :func:`compact_rescan_plain` — plain PyTorch, every (row, column) pair
  evaluated elementwise in blocks of ``rescan_block`` rows and row-summed;
  the CPU tests' engine and the reference the kernel is held to on the
  card.

Kernel and plain version differ only in the order of their f64 sums.

Replaces step 3 of crackling_tpu/ops/issl_compact.py::decode_score
(``scan_block``), which XLA fuses into one pass per block of rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .bits import SIG40, collapse_pairs, compress_even_bits, \
    earlier_slice_clean, popcount
from .kernel_build import KernelLibrary

# plain version: rows evaluated per block, bounding its temporaries at
# O(rescan_block x scan_width) pairs
RESCAN_BLOCK = 8192


class ScoreTables(NamedTuple):
    mit: torch.Tensor     # (2^20,) f32 local MIT score by 20-bit mask
    pen: torch.Tensor     # (20, 16) f32 CFD position penalties
    pam: float            # CFD PAM (NGG) penalty


class RescanRows(NamedTuple):
    """One page's compacted rescan list, each field (R,) int64."""
    ridx: torch.Tensor    # index into the >=3-hit chunk list; -1: padding
    q: torch.Tensor       # the row's query signature
    hq: torch.Tensor      # its query id, the sum slot; n: adds nothing
    start: torch.Tensor   # flat entry position of the chunk's first entry
    live: torch.Tensor    # the bucket's entries from there (blen - c*chunk)
    s: torch.Tensor       # the bucket's slice


def pair_scores(q: torch.Tensor, e: torch.Tensor, tabs: ScoreTables):
    """Per-(query, entry) terms for rows of one query each: q (R,) and
    e (R, W) int64 signatures -> (c40, mit, cfd), each (R, W): the
    collapsed 40-bit mismatch mask, the MIT local score and the CFD
    product (1.0 at distance 0), both f32 and not yet x occurrences."""
    dev = q.device
    c40 = collapse_pairs((e ^ q[:, None]) & SIG40)
    mit = tabs.mit[compress_even_bits(c40)]
    # per-row (20, 4) factor table, 1.0 at the query's own base, so each
    # position costs one gather by the entry's base
    p = torch.arange(20, device=dev)
    qcode = (q[:, None] >> (2 * p)) & 3                          # (R, 20)
    b4 = torch.arange(4, device=dev)
    rpen = tabs.pen[p[None, :, None], (qcode[:, :, None] << 2) | (b4 ^ 3)]
    rpen = torch.where(b4 == qcode[:, :, None], 1.0, rpen)      # (R, 20, 4)
    cfd = torch.full(e.shape, tabs.pam, dtype=torch.float32, device=dev)
    for pos in range(20):
        cfd = cfd * torch.gather(rpen[:, pos, :], 1, (e >> (2 * pos)) & 3)
    cfd = torch.where(c40 == 0, 1.0, cfd)
    return c40, mit, cfd


def check_tensors(named, max_dist, tabs):
    """Device, type, rank and contiguity of each (name, tensor, dtype,
    ndim), all on the first one's device, and the score tables there."""
    dev = named[0][1].device
    for name, t, dt, nd in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {named[0][0]} on "
                             f"{dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d {dt} tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tabs.mit.shape != (1 << 20,) or tabs.pen.shape != (20, 16) \
            or tabs.mit.device != dev or tabs.pen.device != dev \
            or tabs.mit.dtype != torch.float32 \
            or tabs.pen.dtype != torch.float32:
        raise ValueError("tables must be the (2^20,) MIT and (20, 16) CFD "
                         "f32 tables on the index's device")
    if not 0 <= max_dist <= 20:
        raise ValueError("max_dist must lie in [0, 20]")


def check_inputs(rows: RescanRows, entries, occ, tabs, mit_sums, cfd_sums,
                 n, scan_width, max_dist):
    """Raise on inputs the rescan does not take."""
    check_tensors([(name, t, torch.int64, 1)
                   for name, t in zip(RescanRows._fields, rows)]
                  + [("entries", entries, torch.int64, 1),
                     ("occ", occ, torch.int32, 1),
                     ("mit_sums", mit_sums, torch.float64, 1),
                     ("cfd_sums", cfd_sums, torch.float64, 1)],
                  max_dist, tabs)
    if len({t.numel() for t in rows}) != 1:
        raise ValueError("the row descriptors differ in length")
    if occ.numel() != entries.numel():
        raise ValueError("entries and occ differ in length")
    if not 0 <= n < (1 << 31) or mit_sums.numel() != n + 1 \
            or cfd_sums.numel() != n + 1:
        raise ValueError("the sums must be (n + 1,) with n < 2^31")
    if scan_width < 0:
        raise ValueError("scan_width must be >= 0")


# -- the kernel -----------------------------------------------------------


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.crackling_compact_rescan.restype = i
    lib.crackling_compact_rescan.argtypes = [
        p, p, p, p, p, p,     # ridx, qsig, hq, start, live, slice
        ll, i, i, i,          # rows, n, scan_width, max_dist
        p, p,                 # entries, occ
        p, p, f,              # mit table, penalties, pam
        p, p,                 # mit_sums, cfd_sums
        i, p]                 # device, stream


KERNEL = KernelLibrary("compact_rescan.cu", _bind)


def compact_rescan(rows: RescanRows, entries: torch.Tensor,
                   occ: torch.Tensor, tabs: ScoreTables,
                   mit_sums: torch.Tensor, cfd_sums: torch.Tensor, *,
                   n: int, scan_width: int, max_dist: int,
                   rescan_block: int = RESCAN_BLOCK) -> None:
    """The rescan (module docstring) on ``entries.device``, added into
    ``mit_sums`` and ``cfd_sums`` in place.

    rows: the descriptors, each (R,) int64; entries (E,) int64 packed
    site signatures and occ (E,) int32 occurrences, the flat bucket-aligned
    lists, holding ``start + scan_width`` entries from every row's start
    (the plain version reads that far; the kernel only below the live
    length); tabs: the f32 score tables; mit_sums and cfd_sums (n + 1,) f64
    (slot n takes the rows that add nothing, in the plain version only).
    A CUDA tensor launches the kernel once for the whole list (counted in
    ``compact_rescan.launches``); a CPU tensor runs
    :func:`compact_rescan_plain` in blocks of ``rescan_block`` rows."""
    check_inputs(rows, entries, occ, tabs, mit_sums, cfd_sums, n,
                 scan_width, max_dist)
    dev = entries.device
    if dev.type == "cpu":
        compact_rescan_plain(rows, entries, occ, tabs, mit_sums, cfd_sums,
                             n=n, scan_width=scan_width, max_dist=max_dist,
                             rescan_block=rescan_block)
        return
    if dev.type != "cuda":
        raise ValueError(f"no compact rescan for device {dev}")
    R = rows.ridx.numel()
    if R == 0:
        return
    lib = KERNEL.get()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.crackling_compact_rescan(
        *(t.data_ptr() for t in rows), R, n, scan_width, max_dist,
        entries.data_ptr(), occ.data_ptr(), tabs.mit.data_ptr(),
        tabs.pen.data_ptr(), tabs.pam, mit_sums.data_ptr(),
        cfd_sums.data_ptr(), dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"compact rescan kernel launch failed: CUDA "
                           f"error {rc}")
    compact_rescan.launches += 1


compact_rescan.launches = 0


# -- the plain version ----------------------------------------------------


def compact_rescan_plain(rows: RescanRows, entries: torch.Tensor,
                         occ: torch.Tensor, tabs: ScoreTables,
                         mit_sums: torch.Tensor, cfd_sums: torch.Tensor, *,
                         n: int, scan_width: int, max_dist: int,
                         rescan_block: int = RESCAN_BLOCK) -> None:
    """The same function in plain PyTorch: every (row, column) pair of a
    block of ``rescan_block`` rows scored by :func:`pair_scores` in one
    elementwise pass, the predicate applied as a 0 / occurrence weight,
    and the row sums added with ``index_add_`` (rows that add nothing at
    slot ``n``)."""
    compact_rescan_plain.calls += 1
    cols = torch.arange(scan_width, device=entries.device)
    for k in range(0, rows.ridx.numel(), rescan_block):
        ridx, q, hq, start, live, s = (t[k:k + rescan_block] for t in rows)
        rq_ok = (ridx >= 0) & (hq < n)
        pos = start[:, None] + cols[None, :]
        c40, mit, cfd = pair_scores(q, entries[pos], tabs)
        ok = ((popcount(c40) <= max_dist)
              & ~earlier_slice_clean(c40, s[:, None])
              & (cols[None, :] < live[:, None])
              & rq_ok[:, None])
        w = torch.where(ok, occ[pos].float(), 0.0)
        slot = torch.where(rq_ok, hq, n)
        mit_sums.index_add_(0, slot, (mit * w).sum(1, dtype=torch.float64))
        cfd_sums.index_add_(0, slot, (cfd * w).sum(1, dtype=torch.float64))


compact_rescan_plain.calls = 0
