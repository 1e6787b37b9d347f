"""The compact engine's decode, steps 1-2: the moment tree down to the
rescan list.

Steps 1-2 of the moment-tree decode (``issl_compact.decode_score``). The
input is one page's finder cells (:class:`~.compact_finder.FinderOut`:
per query slot the hit count, min rank and max rank of each chunk,
superchunk and bucket-total cell; the rank sums are not read), the slot
plan and the bucket-aligned lists. At every level (slot total, superchunk,
chunk) a cell of 1 or 2 hits is scored pointwise: the min rank is a hit,
the max rank the second when the cell holds 2, the entry sits at
``s*epad + boff[s, b] + rank``, and its f32 terms
(:func:`~.compact_rescan.pair_scores`) times its occurrence, an f32
product, are added in f64 into ``mit_sums[hq]`` and ``cfd_sums[hq]``
(nothing for a slot of query ``n``). A cell of 3 or more hits descends a
level: a slot into its superchunk cells (into its chunk cells when
``superchunk`` is 0), a superchunk into its chunks, and a chunk becomes a
row of :class:`~.compact_rescan.RescanRows` for step 3.

The result, :class:`Decoded`, holds the six populations (n_single,
n_mslot, n_scell, n_sresc, n_mcell, n_rescan), the sums and the rows,
at most ``cap_rescan`` of them: the rows are the one output a cap bounds.
Both implementations give the same populations and rows (the rows in
another order) and sums that differ only in the order of their f64
additions. On a page whose n_rescan passes ``cap_rescan`` both list the
first ``cap_rescan`` rows they find and count the rest; the host drops
such a page's sums and runs it again.

Two implementations of the same function:

* :func:`compact_decode` — the wrapper. On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/compact_decode.cu`` (built with nvcc
  at first use, bound with ctypes; one launch, a block per bucket, no
  host sync, the rows of one chunk consecutive in the list); on a CPU
  tensor it runs the plain version. Nothing else: no fallback from one
  to the other.
* :func:`compact_decode_plain` — plain PyTorch, each level's cells
  compacted (:func:`compact_indices`) and scored in batches;
  the CPU tests' engine and the reference the kernel is held to on the
  card.

Replaces steps 1-2 of crackling_tpu/ops/issl_compact.py::decode_score,
which XLA fuses into a few passes of the page program.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import trace
from .compact_finder import FinderOut, superchunk_cells
from .compact_rescan import RescanRows, ScoreTables, check_tensors, \
    pair_scores
from .kernel_build import KernelLibrary


class Decoded(NamedTuple):
    """Steps 1-2 of the decode and the rescan list of step 3."""
    pops: torch.Tensor      # (6,) int64 populations n_single .. n_rescan
    mit_sums: torch.Tensor  # (n + 1,) f64: the 1-2 hit cells' terms
    cfd_sums: torch.Tensor  # (n + 1,) f64
    rows: RescanRows        # the >=3-hit chunks, at most cap_rescan


def compact_indices(mask: torch.Tensor, cap: int, trim: bool) -> torch.Tensor:
    """Indices of the first ``cap`` True elements of a 1-d mask.

    On an accelerator the result has exactly ``cap`` entries, -1 filled
    (exclusive cumsum + bounded scatter), so the page program never waits
    for the host. With ``trim`` (the CPU, where nothing runs
    asynchronously) the -1 tail is cut off instead, so work follows the
    population rather than the cap; results are the same."""
    if trim:
        return torch.nonzero(mask).flatten()[:cap]
    pos = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), -1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(mask.numel(), device=mask.device))
    return out[:cap]


def check_inputs(q_sig, qsp, fo: FinderOut, boff, blen, entries, occ,
                 tabs: ScoreTables, chunk, superchunk, cap_rescan):
    """Raise on inputs the decode does not take."""
    check_tensors([("q_sig", q_sig, torch.int64, 1),
                   ("qsp", qsp, torch.int32, 3),
                   ("cnt", fo.cnt, torch.int32, 4),
                   ("rmin", fo.rmin, torch.int32, 4),
                   ("rmax", fo.rmax, torch.int32, 4),
                   ("boff", boff, torch.int64, 2),
                   ("blen", blen, torch.int32, 2),
                   ("entries", entries, torch.int64, 2),
                   ("occ", occ, torch.int32, 2)], 0, tabs)
    S, B, C, qb = fo.cnt.shape
    if fo.rmin.shape != fo.cnt.shape or fo.rmax.shape != fo.cnt.shape:
        raise ValueError("the finder's cells differ in shape")
    if qsp.shape != (S, B, qb) or boff.shape != (S, B) \
            or blen.shape != (S, B):
        raise ValueError("qsp/boff/blen disagree with the cells on "
                         "(S, B, qb)")
    if occ.shape != entries.shape or entries.shape[0] != S:
        raise ValueError("entries and occ must be (S, epad) alike")
    if fo.nchmax < 1 or superchunk < 0 or chunk < 1 \
            or fo.nsc != superchunk_cells(fo.nchmax, superchunk) \
            or C != fo.nchmax + fo.nsc + 1:
        raise ValueError("the cells do not match nchmax and superchunk")
    if not 1 <= q_sig.numel() < (1 << 31) \
            or S * B * qb >= (1 << 31):
        raise ValueError("the page needs 1 <= n < 2^31 queries and fewer "
                         "than 2^31 slots")
    if not 0 <= int(cap_rescan) < (1 << 31):
        raise ValueError("cap_rescan must be an integer in [0, 2^31)")


# -- the kernel -----------------------------------------------------------


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.crackling_compact_decode.restype = i
    lib.crackling_compact_decode.argtypes = [
        p, p, p, p,           # cnt, rmin, rmax, qsp
        p, p, p, p, p,        # qsig, boff, blen, entries, occ
        p, p, f,              # mit table, penalties, pam
        i, i, i, i, i, ll,    # S, B, C, qb, n, epad
        i, i, i, i,           # nchmax, nsc, superchunk, chunk
        ll,                   # cap_rescan
        p, p, p, p,           # counters, mit_sums, cfd_sums, rows
        i, p]                 # device, stream


KERNEL = KernelLibrary("compact_decode.cu", _bind)


def compact_decode(q_sig: torch.Tensor, qsp: torch.Tensor, fo: FinderOut,
                   boff: torch.Tensor, blen: torch.Tensor,
                   entries: torch.Tensor, occ: torch.Tensor, *, chunk: int,
                   superchunk: int, cap_rescan: int, tabs: ScoreTables,
                   trim: bool) -> Decoded:
    """Steps 1-2 (module docstring) of one page on ``q_sig.device``.

    q_sig (n,) int64 query signatures; qsp (S, B, qb) int32 slot plan;
    fo the finder's cells; boff (S, B) int64 and blen (S, B) int32 bucket
    starts and lengths within a row of entries (S, epad) int64 and occ
    (S, epad) int32; ``chunk`` entries per chunk cell, ``superchunk``
    chunks per superchunk cell (0: no such level); ``cap_rescan`` the
    rows the list holds at most. A CUDA tensor launches the kernel
    (counted in ``compact_decode.launches``); a CPU tensor runs
    :func:`compact_decode_plain` (``trim`` cuts its compactions to their
    populations)."""
    check_inputs(q_sig, qsp, fo, boff, blen, entries, occ, tabs, chunk,
                 superchunk, cap_rescan)
    dev = q_sig.device
    if dev.type == "cpu":
        return compact_decode_plain(
            q_sig, qsp, fo, boff, blen, entries, occ, chunk=chunk,
            superchunk=superchunk, cap_rescan=cap_rescan, tabs=tabs,
            trim=trim)
    if dev.type != "cuda":
        raise ValueError(f"no compact decode for device {dev}")
    n = q_sig.numel()
    S, B, C, qb = fo.cnt.shape
    # the six populations in column 0, one 128-B line each
    counters = torch.zeros((6, 16), dtype=torch.int64, device=dev)
    sums = torch.zeros((2, n + 1), dtype=torch.float64, device=dev)
    rows = torch.empty((6, cap_rescan), dtype=torch.int64, device=dev)
    lib = KERNEL.get()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with trace.span("compact.decode.direct_tree"):
        rc = lib.crackling_compact_decode(
            fo.cnt.data_ptr(), fo.rmin.data_ptr(), fo.rmax.data_ptr(),
            qsp.data_ptr(), q_sig.data_ptr(), boff.data_ptr(),
            blen.data_ptr(), entries.data_ptr(), occ.data_ptr(),
            tabs.mit.data_ptr(), tabs.pen.data_ptr(), tabs.pam, S, B, C, qb,
            n, entries.shape[1], fo.nchmax, fo.nsc, superchunk, chunk,
            cap_rescan, counters.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), rows.data_ptr(),
            dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"compact decode kernel launch failed: CUDA "
                           f"error {rc}")
    compact_decode.launches += 1
    return Decoded(counters[:, 0], sums[0], sums[1],
                   RescanRows(*rows.unbind(0)))


compact_decode.launches = 0


# -- the plain version ----------------------------------------------------


def compact_decode_plain(q_sig: torch.Tensor, qsp: torch.Tensor,
                         fo: FinderOut, boff: torch.Tensor,
                         blen: torch.Tensor, entries: torch.Tensor,
                         occ: torch.Tensor, *, chunk: int, superchunk: int,
                         cap_rescan: int, tabs: ScoreTables,
                         trim: bool) -> Decoded:
    """The same function in plain PyTorch: each level's cells compacted
    with :func:`compact_indices` (to their population with ``trim``, else
    at the mask's own size, with no host sync; the rows at ``cap_rescan``)
    and the 1-2 hit cells of each batch scored by
    :func:`~.compact_rescan.pair_scores` and added with ``index_add_``."""
    compact_decode_plain.calls += 1
    dev = q_sig.device
    n = q_sig.numel()
    S, B, C, qb = fo.cnt.shape
    nchmax, nsc = fo.nchmax, fo.nsc
    epad = entries.shape[1]
    cnt_f = fo.cnt.reshape(-1)
    min_f = fo.rmin.reshape(-1)
    max_f = fo.rmax.reshape(-1)
    qsp_f = qsp.reshape(-1).long()
    boff_f = boff.reshape(-1)
    blen_f = blen.reshape(-1).long()
    ent_f = entries.reshape(-1)
    occ_f = occ.reshape(-1)
    mit_sums = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    cfd_sums = torch.zeros(n + 1, dtype=torch.float64, device=dev)

    def cell_at(slot, cell):
        """Flat (S, B, C, qb) index of ``cell`` of flat slot
        ``(s*B + b)*qb + j``."""
        return ((slot // qb) * C + cell) * qb + slot % qb

    def q_of(slot):
        return qsp_f[slot].clamp(max=n)

    def every(mask):
        """Indices of every True element of a 1-d mask."""
        return compact_indices(mask, mask.numel(), trim)

    def add(hq, mit, cfd, w):
        mit_sums.index_add_(0, hq, (mit * w).sum(1, dtype=torch.float64))
        cfd_sums.index_add_(0, hq, (cfd * w).sum(1, dtype=torch.float64))

    def add_direct(slot, cnt, rmin, rmax, valid):
        """Score a compacted batch of 1-2 hit cells pointwise: the min
        rank is the (first) hit, the max rank the second when cnt == 2."""
        hq = q_of(slot)
        ok = valid & (hq < n)
        v = torch.stack([ok & (cnt >= 1) & (cnt <= 2), ok & (cnt == 2)], 1)
        rank = torch.where(v, torch.stack([rmin, rmax], 1).long(), 0)
        sb = slot // qb
        pos = ((sb // B) * epad + boff_f[sb])[:, None] + rank     # (N, 2)
        _, mit, cfd = pair_scores(q_sig[hq.clamp(max=n - 1)], ent_f[pos],
                                  tabs)
        add(hq, mit, cfd, torch.where(v, occ_f[pos].float(), 0.0))

    # 1) direct slots: 1-2 hits in the whole bucket resolve from the
    # bucket totals alone
    tot = fo.total_cell
    slot_cnt = fo.cnt[:, :, tot, :].reshape(-1)
    direct = (slot_cnt == 1) | (slot_cnt == 2)
    n1 = direct.sum()
    sidx = every(direct)
    si = sidx.clamp(min=0)
    v1 = sidx >= 0
    cidx = cell_at(si, tot)
    add_direct(si, torch.where(v1, slot_cnt[si], 0), min_f[cidx],
               max_f[cidx], v1)

    # 2) >=3-hit slots expand down the moment tree: with the superchunk
    # level, into their superchunk cells (1-2 hit cells resolve there,
    # >=3-hit ones expand into their chunks); without it, straight into
    # their chunk cells. 1-2 hit chunk cells resolve pointwise.
    multi = slot_cnt >= 3
    nm = multi.sum()
    midx = every(multi)
    mi = midx.clamp(min=0)
    vm = (midx >= 0)[:, None]
    n_sc = n_sr = torch.zeros((), dtype=torch.int64, device=dev)
    if superchunk:
        cells = nchmax + torch.arange(nsc, device=dev)
        msc = torch.where(
            vm, cnt_f[cell_at(mi[:, None], cells[None, :])], 0)
        n_sc = (msc > 0).sum()
        scz = every((msc > 0).reshape(-1))
        szi = scz.clamp(min=0)
        vsz = scz >= 0
        s_sc = szi % nsc
        sslot = mi[szi // nsc]
        scnt = msc.reshape(-1)[szi]
        cidx = cell_at(sslot, nchmax + s_sc)
        add_direct(sslot, torch.where(vsz, scnt, 0), min_f[cidx],
                   max_f[cidx], vsz)
        c2sc = vsz & (scnt >= 3)
        n_sr = c2sc.sum()
        sridx = every(c2sc)
        sri = sridx.clamp(min=0)
        src_slot = sslot[sri]
        ch = (s_sc[sri][:, None] * superchunk
              + torch.arange(superchunk, device=dev)[None, :])
        live = (sridx >= 0)[:, None] & (ch < nchmax)
        cidx = cell_at(src_slot[:, None], ch.clamp(max=nchmax - 1))
        mc = torch.where(live, cnt_f[cidx], 0)
        width = superchunk
        ch_flat = ch.reshape(-1)

        def chunk_of(z):
            return ch_flat[z]
    else:
        chj = torch.arange(nchmax, device=dev)
        mc = torch.where(
            vm, cnt_f[cell_at(mi[:, None], chj[None, :])], 0)
        src_slot = mi
        width = nchmax

        def chunk_of(z):
            return z % nchmax
    nc = (mc > 0).sum()
    mz = every((mc > 0).reshape(-1))
    mzc = mz.clamp(min=0)
    vz = mz >= 0
    mslot = src_slot[mzc // width]
    mchk = chunk_of(mzc)
    mcnt = mc.reshape(-1)[mzc]
    cidx = cell_at(mslot, mchk)
    add_direct(mslot, torch.where(vz, mcnt, 0), min_f[cidx],
               max_f[cidx], vz)

    # 3) >=3-hit chunks: the rescan list, one row per chunk
    c2 = vz & (mcnt >= 3)
    n2c = c2.sum()
    ridx = compact_indices(c2, int(cap_rescan), trim)
    ri = ridx.clamp(min=0)
    rslot = mslot[ri]
    first = mchk[ri] * chunk
    sb = rslot // qb
    rs = sb // B
    hq = q_of(rslot)
    rows = RescanRows(ridx, q_sig[hq.clamp(max=n - 1)], hq,
                      rs * epad + boff_f[sb] + first,
                      blen_f[sb] - first, rs)
    return Decoded(torch.stack([n1, nm, n_sc, n_sr, nc, n2c]), mit_sums,
                   cfd_sums, rows)


compact_decode_plain.calls = 0
