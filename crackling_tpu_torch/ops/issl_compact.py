"""Compact two-phase ISSL engine: finder kernel -> hit moments -> scoring.

The PyTorch port of crackling_tpu/ops/issl_compact.py. One query page
runs four steps, all on the scorer's device and with no host sync inside
the page (the rescan list alone is capped, at ``cap_rescan`` rows):

1. **Slot plan** (:func:`plan_slots`): each (slice, bucket) of the index
   gets ``qb`` query slots holding the page's queries whose slice value
   selects that bucket; spare slots hold the padding id ``n``. ``qb``
   (:func:`plan_query_occupancy`) is the page's only data-dependent shape.
2. **Finder** (:func:`compact_finder`, the hand-written Hopper kernel on
   CUDA): per (chunk, slot) the hit count / rank-sum / min rank / max
   rank of the hit predicate (distance <= max_dist, first-clean-slice
   dedup), plus superchunk cells on deep indexes and bucket totals.
3. **Moment-tree decode** (:func:`decode_score`): 1-2 hit cells resolve
   pointwise from their min/max ranks at every tree level (slot total ->
   superchunk -> chunk; :func:`~.compact_decode.compact_decode`, the
   hand-written Hopper kernel on CUDA); only >=3-hit chunks are
   **rescanned** (:func:`~.compact_rescan.compact_rescan`, the
   hand-written Hopper kernel on CUDA, one launch for the page's whole
   list), with the hit predicate and per-pair MIT/CFD evaluated and
   row-summed.
4. Per-query MIT/CFD sums (f64) plus a 6-int header of compaction
   populations return to the host. A page whose rescan rows passed the
   cap it ran at runs again whole at a grown cap, or in halves where the
   grown page would not fit the device.

Per-hit arithmetic is f32 (MIT from the exact local-score table, CFD
as the reference's penalty product in position order); each (query,
site) hit is counted once thanks to the in-finder dedup. Distance-0
self-hits add CFD += occ and MIT += 0, the reference's semantics.
Full-scan semantics: verdicts exact for mit/cfd/and/or; wrap in
:class:`~crackling_tpu_torch.ops.hybrid.HybridIsslScorer` for
reference-exact verdicts on all five methods.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..device import free_bytes, resolve_device
from ..index.build import IsslIndex
from ..pipeline.logger import printer
from .compact_decode import Decoded, compact_decode
from .compact_finder import FinderOut, compact_finder, superchunk_cells
from .compact_onehot import LANES, compact_finder_onehot, onehot_planes
from .compact_rescan import RESCAN_BLOCK, ScoreTables, compact_rescan
from .tables import (CFD_PAM_NGG_INDEX, cfd_pam_penalties,
                     cfd_pos_penalties, mit_dense_table)

ALIGN = 1024        # bucket starts are padded to multiples of this
# the deepest bucket the engine takes: below it every in-bucket rank, and
# every index the kernels form from one (a rank plus a batch's lanes), is
# exact in int32 under the empty cell's RANK_EMPTY (2^31 - 1). The JAX
# engine's moment decoder keeps ranks in f32 and stops at 2^22 (PARITY.md)
RANK_BOUND = 1 << 30
# a finder cell's bytes: count, min and max rank (int32), rank sum (int64)
CELL_BYTES = 4 + 4 + 4 + 8
SLOT_ALIGN = 64     # slot counts are multiples of this (the finder's block)
# the rescan rows' cap a scorer starts at (on CUDA its first page tunes it)
CAP_RESCAN = 1 << 15
# the JAX engine's one-hot plane budget, over its 128-lane plane bytes
PLANE_BUDGET = 4 << 30
JAX_PLANE_LANES = 128


def auto_superchunk(nchmax: int) -> int:
    """Superchunk size (chunks per superchunk) for a given moment-plane
    depth: 0 (level disabled) while the direct slot->chunk expansion is
    cheap, ~sqrt(depth) once it is not, so both tree levels expand
    O(sqrt(depth)) cells."""
    if nchmax <= 64:
        return 0
    return max(8, 4 * int(round(float(np.sqrt(nchmax)) / 4.0)))


def _quant_cap(pop: int, floor: int = 4096) -> int:
    """Smallest multiple of 4096 >= 1.25x the measured population
    (>= floor): the auto-tuned compaction capacity for a population.
    Every decode gather/score runs at cap size, so quantization waste is
    throughput lost; the 4096 grain absorbs page-to-page population
    jitter, and a page that does overflow grows its cap and retries."""
    need = max(floor, int(1.25 * pop) + 1)
    return -(-need // 4096) * 4096


def plan_query_occupancy(sigs: np.ndarray, S: int, B: int,
                         slice_width: int, qb_cap: int):
    """Padded max per-(slice, bucket) query occupancy QB — the only
    data-dependent *shape* of the page program, a property of the query
    page alone. Returns (None, needed) on qb_cap overflow."""
    sigs = np.asarray(sigs, dtype=np.uint64)
    counts = np.zeros((S, B), dtype=np.int64)
    mask = np.uint64(B - 1)
    for s in range(S):
        vals = ((sigs >> np.uint64(s * slice_width)) & mask).astype(np.int64)
        counts[s] = np.bincount(vals, minlength=B)
    qb = int(counts.max())
    if qb > qb_cap:
        return None, qb
    return -(-qb // 64) * 64, qb


def plan_slots(q_sig: torch.Tensor, S: int, B: int,
               qb: int) -> torch.Tensor:
    """(S, B, qb) int32 slot plan: slot ``j`` of (s, b) holds the id of
    the page's ``j``-th query (in page order) whose slice-``s`` value is
    ``b``; unused slots hold ``n`` (padding)."""
    dev = q_sig.device
    n = q_sig.numel()
    shifts = torch.arange(S, device=dev)[:, None] * 8     # w = 8
    vals = (q_sig[None, :] >> shifts) & (B - 1)                    # (S, n)
    order = torch.argsort(vals, dim=1, stable=True)
    sorted_vals = torch.gather(vals, 1, order)
    counts = torch.zeros((S, B), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, vals, torch.ones_like(vals))
    starts = torch.cumsum(counts, 1) - counts
    rank = (torch.arange(n, device=dev)[None, :]
            - torch.gather(starts, 1, sorted_vals))
    s_idx = torch.arange(S, device=dev)[:, None].expand(S, n)
    qsp = torch.full((S, B, qb), n, dtype=torch.int32, device=dev)
    qsp[s_idx, sorted_vals, rank] = order.int()
    return qsp


class AlignedLists(NamedTuple):
    """An index's bucket-aligned lists on a device (one slice per row)."""
    entries: torch.Tensor   # (S, Epad) int64 packed site signatures
    occ: torch.Tensor       # (S, Epad) int32 occurrences (0 in padding)
    boff: torch.Tensor      # (S, B) int64 bucket starts within a row
    blen: torch.Tensor      # (S, B) int32 bucket lengths


def aligned_layout(index: IsslIndex, tail: int = 0):
    """Where :func:`aligned_lists` puts each bucket: (starts (S, B + 1)
    int64, with every bucket start on an ALIGN boundary and the last
    column each slice's aligned length, and the row length ``epad``, which
    adds ``tail`` dead entries and rounds up to ALIGN)."""
    lens = np.diff(index.bucket_offsets, axis=1).astype(np.int64)
    starts = np.zeros((lens.shape[0], lens.shape[1] + 1), dtype=np.int64)
    np.cumsum(-(-lens // ALIGN) * ALIGN, axis=1, out=starts[:, 1:])
    epad = int(starts[:, -1].max(initial=0)) + max(tail, 0)
    return starts, -(-epad // ALIGN) * ALIGN


def aligned_lists(index: IsslIndex, device, tail: int = 0) -> AlignedLists:
    """The index's lists with every bucket start on an ALIGN boundary and
    ``tail`` dead entries after each slice (signature -1, occurrence 0):
    the layout of ``IsslIndex.device_arrays_aligned``, each entry's
    signature one int64, built on ``device`` a slice at a time from the
    sites and each slice's order, with no host copy of the layout."""
    dev = torch.device(device)
    S, B, N = index.slice_count, index.bucket_count, index.num_sites
    starts, epad = aligned_layout(index, tail)
    src = index.bucket_offsets.astype(np.int64)
    lens = np.diff(src, axis=1)
    entries = torch.full((S, epad), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((S, epad), dtype=torch.int32, device=dev)
    sigs = torch.as_tensor(
        np.ascontiguousarray(index.site_sigs, dtype=np.uint64)
        .view(np.int64), device=dev)
    counts = torch.as_tensor(index.occurrences.astype(np.int32), device=dev)
    for s in range(S):
        # rank k of bucket b goes to starts[s, b] + k
        at = torch.repeat_interleave(
            torch.as_tensor(starts[s, :B] - src[s, :B], device=dev),
            torch.as_tensor(lens[s], device=dev), output_size=N)
        at += torch.arange(N, device=dev)
        ids = torch.as_tensor(index.order[s], device=dev).long()
        entries[s, at] = sigs[ids]
        occ[s, at] = counts[ids]
        del at, ids
    return AlignedLists(entries, occ,
                        torch.as_tensor(np.ascontiguousarray(starts[:, :B]),
                                        device=dev),
                        torch.as_tensor(lens.astype(np.int32), device=dev))


def score_tables(max_dist: int, device) -> ScoreTables:
    return ScoreTables(
        torch.as_tensor(mit_dense_table(20, max_dist).astype(np.float32),
                        device=device),
        torch.as_tensor(cfd_pos_penalties().astype(np.float32),
                        device=device),
        float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX]))


def decode_score(q_sig: torch.Tensor, qsp: torch.Tensor, fo: FinderOut,
                 boff: torch.Tensor, blen: torch.Tensor,
                 entries: torch.Tensor, occ: torch.Tensor, *, chunk: int,
                 superchunk: int, max_dist: int, cap_rescan: int,
                 tabs: ScoreTables, scan_width: int, trim: bool,
                 rescan_block: int = RESCAN_BLOCK):
    """Moment-tree decode and rescan of one page's finder output.

    Returns (header, mit_sums, cfd_sums): header is the (6,) int64
    compaction populations (n_single, n_mslot, n_scell, n_sresc,
    n_mcell, n_rescan), sums are (n,) f64. ``n_rescan`` above
    ``cap_rescan`` means the rescan list was cut and the sums are
    incomplete. Step 3 is :func:`~.compact_rescan.compact_rescan` over
    the rows of steps 1-2, :func:`~.compact_decode.compact_decode`
    (``rescan_block`` bounds the plain rescan's temporaries)."""
    n = q_sig.numel()
    d = compact_decode(q_sig, qsp, fo, boff, blen, entries, occ,
                       chunk=chunk, superchunk=superchunk,
                       cap_rescan=cap_rescan, tabs=tabs, trim=trim)
    with trace.span("compact.decode.rescan"):
        compact_rescan(d.rows, entries.reshape(-1), occ.reshape(-1), tabs,
                       d.mit_sums, d.cfd_sums, n=n, scan_width=scan_width,
                       max_dist=max_dist, rescan_block=rescan_block)
    return d.pops, d.mit_sums[:n], d.cfd_sums[:n]


class CompactIsslScorer:
    """Single-GPU compact two-phase ISSL scorer (full-scan, f32 tier)."""

    # Near-threshold re-score band advertised to HybridIsslScorer: the
    # half-width (score units) within which f32 rounding could flip a
    # threshold comparison. Per-hit arithmetic is plain f32 and sums are
    # f64; the JAX engine, whose per-hit arithmetic is also f32, measured
    # ~1e-4 largest deviation from the binary, so 0.05 is a wide margin.
    score_band = 0.05

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 query_page: int = 65536, chunk: int = 4096,
                 qb_cap: int = 512, superchunk: int | None = None,
                 rescan_block: int | None = None,
                 onehot: bool | None = None, reserve: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        if index.slice_width != 8 or index.seq_length != 20:
            raise ValueError("compact engine supports l=20, w=8")
        if chunk % ALIGN:
            raise ValueError(f"chunk must be a multiple of {ALIGN}")
        self.index = index
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.query_page = int(query_page)
        self.chunk = int(chunk)
        self.qb_cap = int(qb_cap)
        # the rescan rows' capacity, the only one the decode bounds: a
        # page over its cap grows it and runs again. On CUDA, where the
        # row block and the rescan's padding run at cap size, the first
        # page runs at CAP_RESCAN and the cap then shrinks to ~1.25x
        # its measured rows; the CPU's plain decode trims the list to its
        # rows, so the cap costs nothing there and stays. A page shorter
        # than the tuning page runs at the cap scaled to its length
        # (``_cap(rows)``), at least a floor, which a scaled page's
        # overflow grows
        self.cap_rescan = CAP_RESCAN
        self._tuned = self.device.type != "cuda"
        self._cap_rows = 0              # the tuning page's guides; 0: none
        self._cap_floor = 0
        self._drained_rows = 0          # guides of the last drained page
        self.S = index.slice_count
        self.B = index.bucket_count

        maxblen = int(np.diff(index.bucket_offsets, axis=1).max())
        if maxblen >= RANK_BOUND:
            raise ValueError(
                f"bucket with {maxblen:,} entries exceeds the moment "
                f"decoder's rank-exactness bound ({RANK_BOUND:,} entries: "
                "int32 ranks below the empty-cell sentinel)")
        self._nchmax = max(1, -(-maxblen // self.chunk))
        self.superchunk = (auto_superchunk(self._nchmax)
                           if superchunk is None else int(superchunk))
        # the plain rescan's (CPU) row block: bounds its gathered
        # temporaries at O(rescan_block x chunk) pairs however large
        # cap_rescan is; the kernel takes the whole list at once
        self.rescan_block = (RESCAN_BLOCK if rescan_block is None
                             else int(rescan_block))
        # rescan width: a chunk, or less when every bucket is shorter
        # (entries past a bucket's end never hit)
        self._scan_width = min(self.chunk, max(64, -(-maxblen // 64) * 64))
        # device bytes a page takes per slot of qb (finder cells, plan)
        cells = (self._nchmax
                 + superchunk_cells(self._nchmax, self.superchunk) + 1)
        self._slot_bytes = self.S * self.B * (cells * CELL_BYTES + 4)
        # device bytes the pages leave free for a companion: by default
        # the hybrid's exact re-scorer, which reads these lists
        if reserve is None:
            from .issl_mxu import added_bytes

            reserve = added_bytes(index, self.chunk, shared=True)
        self.reserve = int(reserve)

        # memory BEFORE any device work: the lists, their build's
        # transients (each site's signature and count, and a slice's
        # positions, its arange and its site ids, int64) and the least page
        # (SLOT_ALIGN slots, as many guides) must fit; else ValueError, so
        # the pipeline falls back to the dense engine
        epad = aligned_layout(index, self.chunk)[1]
        lists = self.S * epad * (8 + 4)
        build = index.num_sites * (8 + 4 + 3 * 8)
        need = lists + build + self.page_bytes(SLOT_ALIGN, SLOT_ALIGN)
        free = free_bytes(self.device)
        if need > free:
            raise ValueError(
                f"the compact engine needs ~{need / 1e9:.2f} GB on "
                f"{self.device} (lists {lists / 1e9:.2f} GB + their build "
                f"{build / 1e9:.2f} GB + one page of {SLOT_ALIGN} slots) "
                f"but {free / 1e9:.2f} GB are free at "
                f"{index.num_sites:,} sites")

        with trace.span("compact.build.lists"):
            (self.entries, self.occ, self.bucket_offsets,
             self.bucket_lens) = aligned_lists(index, self.device,
                                               self.chunk)
        with trace.span("compact.build.tables"):
            self.tables = score_tables(self.max_dist, self.device)
        self.onehot = self._want_onehot(onehot)
        # the one-hot finder's input, built once; the decode still gathers
        # the packed entries
        self.planes = (onehot_planes(self.entries, index.seq_length)
                       if self.onehot else None)
        # per-page compaction populations (n_single, n_mslot, n_scell,
        # n_sresc, n_mcell, n_rescan) recorded by every drain — the
        # cap-tuning instrumentation
        self.page_stats: list[tuple[int, ...]] = []
        self._fit_pages()

    def _want_onehot(self, onehot: bool | None) -> bool:
        """The finder choice, made as the JAX engine makes it: ``None``
        reads CRACKLING_TPU_COMPACT_ONEHOT=1 and keeps the packed finder
        when JAX's plane bytes (S x Epad x 128) pass
        CRACKLING_TPU_COMPACT_PLANE_BUDGET (default 4 GiB), so one index
        and one environment pick the same finder in both packages. The
        port's own planes (80 lanes) must also fit the device's free
        memory: an explicit ``onehot=True`` that does not fit raises
        ``ValueError``; the variable's choice keeps the packed finder."""
        epad = self.entries.shape[1]
        if onehot is None:
            if os.environ.get("CRACKLING_TPU_COMPACT_ONEHOT") != "1":
                return False
            jax_bytes = self.S * epad * JAX_PLANE_LANES
            budget = int(os.environ.get("CRACKLING_TPU_COMPACT_PLANE_BUDGET",
                                        PLANE_BUDGET))
            if jax_bytes > budget:
                printer(f"one-hot planes ({jax_bytes:,} B) exceed "
                        f"CRACKLING_TPU_COMPACT_PLANE_BUDGET ({budget:,} B); "
                        "using the packed compact finder")
                return False
        elif not onehot:
            return False
        need = self.S * epad * LANES
        free = free_bytes(self.device)
        if need > free:
            msg = (f"the one-hot planes need {need / 1e9:.2f} GB on "
                   f"{self.device} but {free / 1e9:.2f} GB are free")
            if onehot:
                raise ValueError(msg)
            printer(f"{msg}; using the packed compact finder")
            return False
        return True

    # -- the page program --------------------------------------------------

    @property
    def lists(self) -> AlignedLists:
        """The engine's resident lists, which the hybrid's exact re-scorer
        reads too (one copy on the device)."""
        return AlignedLists(self.entries, self.occ, self.bucket_offsets,
                            self.bucket_lens)

    def page_bytes(self, qb: int, n: int) -> int:
        """Device bytes a page of ``n`` guides at ``qb`` slots a bucket
        allocates: its finder cells, slot plan and signatures, and its
        decode's counters, sums and rescan rows (at the cap it runs at)."""
        return (self._slot_bytes * qb + 8 * n + 2 * 8 * (n + 1)
                + 6 * 16 * 8 + 6 * 8 * self._cap(n))

    def _fit_pages(self):
        """Size the pages to the device, once the lists are on it: where a
        page at ``qb_cap`` slots does not fit the free memory, less
        ``reserve`` and a sixteenth of slack for the allocator, cut
        ``qb_cap`` to the slots that fit (a multiple of SLOT_ALIGN) and
        ``query_page`` in the same ratio, so a page's occupancy keeps its
        share of the cap. Pages that fit keep both; where fewer than
        SLOT_ALIGN slots fit, ValueError, naming the bytes needed and
        free. The room stays ``self.room``: a page whose rows cap grows
        past it runs in halves."""
        free = free_bytes(self.device)
        room = free - self.reserve
        self.room = room - room // 16
        fit = (self.room - self.page_bytes(0, self.query_page)) \
            // self._slot_bytes
        fit = fit // SLOT_ALIGN * SLOT_ALIGN
        if fit < SLOT_ALIGN:
            need = self.page_bytes(SLOT_ALIGN, self.query_page)
            raise ValueError(
                f"a compact page of {SLOT_ALIGN} slots needs "
                f"~{need / 1e9:.2f} GB on {self.device} beside the lists "
                f"and {self.reserve / 1e9:.2f} GB reserved for the exact "
                f"re-scorer, but {free / 1e9:.2f} GB are free")
        if fit < self.qb_cap:
            self.query_page = max(SLOT_ALIGN,
                                  self.query_page * fit // self.qb_cap)
            self.qb_cap = fit

    def _cap(self, rows: int | None = None) -> int:
        """The rows cap, or the one a page of ``rows`` guides runs at: once
        tuned on a longer page, scaled by ``rows`` over its length to the
        4096 grain, and at least its floor."""
        cap = self.cap_rescan
        if rows is None or rows >= self._cap_rows:
            return cap
        scaled = -(-cap * rows // self._cap_rows)
        return min(cap, max(self._cap_floor, -(-scaled // 4096) * 4096))

    def query_tensor(self, page: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(page, dtype=np.uint64).view(np.int64),
            device=self.device)

    def finder(self, q_sig: torch.Tensor, qsp: torch.Tensor) -> FinderOut:
        """Step 2 of the page program (the kernel on CUDA): the one-hot
        finder when ``self.onehot`` is set, else the packed one."""
        if self.onehot:
            return compact_finder_onehot(
                self.planes, self.bucket_offsets, self.bucket_lens, q_sig,
                qsp, chunk=self.chunk, nchmax=self._nchmax,
                superchunk=self.superchunk, max_dist=self.max_dist)
        return compact_finder(self.entries, self.bucket_offsets,
                              self.bucket_lens, q_sig, qsp,
                              chunk=self.chunk, nchmax=self._nchmax,
                              superchunk=self.superchunk,
                              max_dist=self.max_dist)

    def decode(self, q_sig, qsp, fo: FinderOut):
        """Step 3 of the page program."""
        return decode_score(
            q_sig, qsp, fo, self.bucket_offsets, self.bucket_lens,
            self.entries, self.occ, chunk=self.chunk,
            superchunk=self.superchunk, max_dist=self.max_dist,
            cap_rescan=self._cap(q_sig.shape[0]), tabs=self.tables,
            rescan_block=self.rescan_block, scan_width=self._scan_width,
            trim=self.device.type == "cpu")

    def decode_tree(self, q_sig, qsp, fo: FinderOut) -> Decoded:
        """Steps 1-2 of the decode, down to its rescan list
        (:func:`~.compact_decode.compact_decode`)."""
        return compact_decode(
            q_sig, qsp, fo, self.bucket_offsets, self.bucket_lens,
            self.entries, self.occ, chunk=self.chunk,
            superchunk=self.superchunk, cap_rescan=self._cap(q_sig.shape[0]),
            tabs=self.tables, trim=self.device.type == "cpu")

    def run_page(self, page: np.ndarray, qb: int):
        """The whole page program, enqueued: (header, mit_sums,
        cfd_sums) device tensors."""
        with trace.span("compact.enqueue"):
            q_sig = self.query_tensor(page)
            with trace.span("compact.plan"):
                qsp = plan_slots(q_sig, self.S, self.B, qb)
            with trace.span("compact.finder"):
                fo = self.finder(q_sig, qsp)
            return self.decode(q_sig, qsp, fo)

    @staticmethod
    def trace_session() -> trace.Session:
        """The tracer's session (:mod:`crackling_tpu_torch.trace`): the
        page path's spans and counters since tracing last turned on."""
        return trace.session()

    # -- public API --------------------------------------------------------

    def _plan(self, page):
        return plan_query_occupancy(page, self.S, self.B,
                                    self.index.slice_width, self.qb_cap)

    def _dispatch(self, pos, page, pending):
        """Plan and enqueue ``page``, the batch's guides at the positions
        in the ``range`` ``pos``, halving both while it overflows qb_cap."""
        # the span sits here: the dense engine shares plan_query_occupancy
        with trace.span("compact.occupancy"):
            qb, _need = self._plan(page)
        trace.count("compact.occupancy_calls")
        if qb is None:
            trace.count("compact.splits")
            if page.shape[0] < 2:
                raise RuntimeError("query bucket overflow; raise qb_cap")
            self._halve(pos, page, pending)
            return
        # record the cap the program RAN at: self._cap() can grow
        # mid-drain when an earlier page overflows, and a later page that
        # ran under the old smaller cap must still be checked against it
        # (its rescan list was cut there)
        pending.append((pos, page, qb, self._cap(page.shape[0]),
                        self.run_page(page, qb)))
        trace.count("compact.pages")
        if trace.active():
            trace.count("compact.plane_bytes",
                        self.page_bytes(qb, page.shape[0]))

    def _halve(self, pos, page, pending):
        half = page.shape[0] // 2
        self._dispatch(pos[:half], page[:half], pending)
        self._dispatch(pos[half:], page[half:], pending)

    def _run_pages(self, pages, out_mit, out_cfd):
        pending = []
        for pos, page in pages:
            with trace.span("compact.dispatch"):
                self._dispatch(pos, page, pending)
        # drain after every page is enqueued; a page over its rows cap
        # grows the cap and runs again, whole where it still fits the room,
        # else in halves
        while pending:
            retry = []
            for pos, page, qb, ran_cap, (header, m, c) in pending:
                with trace.span("compact.drain"):
                    with trace.span("compact.drain.wait"):
                        header = header.cpu()
                    pops = tuple(int(x) for x in header)
                    self.page_stats.append(pops)
                    self._drained_rows = page.shape[0]
                    if pops[5] > ran_cap:
                        trace.count("compact.retries")
                        retry.append((pos, page, self._grow_cap(
                            pops[5], page.shape[0], qb)))
                        continue
                    at = slice(pos.start, pos.stop, pos.step)
                    out_mit[at] = m.cpu().numpy()
                    out_cfd[at] = c.cpu().numpy()
            pending = []
            for pos, page, fits in retry:
                with trace.span("compact.dispatch"):
                    if fits:
                        self._dispatch(pos, page, pending)
                    elif page.shape[0] > 1:
                        trace.count("compact.retry_halves")
                        self._halve(pos, page, pending)
                    else:
                        raise RuntimeError(
                            f"the rescan rows of one guide ({self._cap(1):,}"
                            f" at its cap) do not fit the {self.room:,} B "
                            f"of room for a page on {self.device}")

    def _grow_cap(self, pop: int, rows: int, qb: int) -> bool:
        """The rows cap after a page of ``rows`` guides at ``qb`` slots
        listed ``pop`` rows past the cap it ran at: a cap below ``pop``
        grows to cover it; on a page shorter than the tuning page, so does
        the floor, so the retry fits and longer pages keep their cap.
        Whether the page fits the room at the grown cap."""
        if pop > self.cap_rescan:
            self.cap_rescan = _quant_cap(pop)
        if rows < self._cap_rows:
            self._cap_floor = max(self._cap_floor, _quant_cap(pop))
        return self.page_bytes(qb, rows) <= self.room

    def _pages(self, sigs: np.ndarray) -> list:
        """The batch cut into (positions, page) pairs: ``page`` is a view of
        ``sigs`` at the ``range`` of positions.

        A batch over ``query_page`` guides whose first strided page fits
        ``qb_cap`` is cut into ``P = ceil(n / query_page)`` pages, page
        ``k`` taking positions ``k, k + P, k + 2P, ...``: on a sorted batch
        (the pipeline hands over ``np.unique``-sorted batches, whose pages
        in input order crowd one slice-4 bucket and would halve down to
        ``qb_cap`` guides) each samples every bucket evenly. Otherwise
        pages take ``query_page`` guides in input order. Each guide's sums
        are computed the same way in either order."""
        n, qp = sigs.shape[0], self.query_page
        P = -(-n // qp)
        # a page of at most qb_cap guides cannot overflow it
        if P > 1 and qp > self.qb_cap:
            with trace.span("compact.repage"):
                stride = self._plan(sigs[::P])[0] is not None
            if stride:
                trace.count("compact.repaged")
                return [(range(k, n, P), sigs[k::P]) for k in range(P)]
        return [(range(lo, min(lo + qp, n)), sigs[lo:lo + qp])
                for lo in range(0, n, qp)]

    def score_sums(self, query_sigs: np.ndarray):
        """Per-query full-scan MIT and CFD sums (f64 numpy)."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        out_mit = np.zeros(n, dtype=np.float64)
        out_cfd = np.zeros(n, dtype=np.float64)
        with trace.span("compact.score"):
            pages = self._pages(sigs)
            if not self._tuned and pages:
                # run the first page at the initial cap, then shrink it to
                # ~1.25x the rows it listed before the rest
                self._run_pages(pages[:1], out_mit, out_cfd)
                self.cap_rescan = _quant_cap(self.page_stats[-1][5])
                self._cap_rows = self._drained_rows
                self._tuned = True
                pages = pages[1:]
            self._run_pages(pages, out_mit, out_cfd)
        return out_mit, out_cfd

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)
