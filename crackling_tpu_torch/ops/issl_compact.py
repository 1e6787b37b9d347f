"""Compact two-phase ISSL engine: finder kernel -> hit moments -> scoring.

The PyTorch port of crackling_tpu/ops/issl_compact.py. One query page
runs four steps, all on the scorer's device and with no host sync inside
the page (every compaction is capped, as in the JAX program):

1. **Slot plan** (:func:`plan_slots`): each (slice, bucket) of the index
   gets ``qb`` query slots holding the page's queries whose slice value
   selects that bucket; spare slots hold the padding id ``n``.
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
4. Per-query MIT/CFD sums (f64) plus a 7-int header of compaction
   populations return to the host, which checks them against the caps
   the page ran with (grow-and-retry or split on overflow).

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
from .hybrid import plan_query_occupancy
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


def normalize_caps(caps, nz_cap: int) -> tuple:
    """Seven compaction capacities: direct 1-2 hit slots, >=3-hit slots,
    nonzero superchunk cells, >=3-hit superchunk cells, nonzero chunk
    cells, >=3-hit rescan chunks, and a seventh that nothing fills (its
    population is always 0; kept so caps and page stats line up with the
    JAX engine's)."""
    if caps is None:
        nz = int(nz_cap)
        caps = (nz, max(1024, nz // 2), max(2048, nz),
                max(1024, nz // 4), max(2048, nz), max(1024, nz // 4),
                4 * max(1024, nz // 4))
    caps = tuple(int(c) for c in caps)
    if len(caps) != 7:
        raise ValueError("caps must have 7 entries")
    return caps


def _quant_cap(pop: int, floor: int = 4096) -> int:
    """Smallest multiple of 4096 >= 1.25x the measured population
    (>= floor): the auto-tuned compaction capacity for a population.
    Every decode gather/score runs at cap size, so quantization waste is
    throughput lost; the 4096 grain absorbs page-to-page population
    jitter, and a page that does overflow grows its cap and retries."""
    need = max(floor, int(1.25 * pop) + 1)
    return -(-need // 4096) * 4096


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
                 superchunk: int, max_dist: int, caps: tuple,
                 tabs: ScoreTables, scan_width: int, trim: bool,
                 rescan_block: int = RESCAN_BLOCK):
    """Moment-tree decode and rescan of one page's finder output.

    Returns (header, mit_sums, cfd_sums): header is the (7,) int64
    compaction populations (n_single, n_mslot, n_scell, n_sresc,
    n_mcell, n_rescan, 0), sums are (n,) f64. Populations above their
    cap mean that step truncated and the sums are incomplete. Step 3 is
    :func:`~.compact_rescan.compact_rescan` over the rows of steps 1-2,
    :func:`~.compact_decode.compact_decode` (``rescan_block`` bounds the
    plain rescan's temporaries)."""
    n = q_sig.numel()
    d = compact_decode(q_sig, qsp, fo, boff, blen, entries, occ,
                       chunk=chunk, superchunk=superchunk, caps=caps,
                       tabs=tabs, trim=trim)
    with trace.span("compact.decode.rescan"):
        compact_rescan(d.rows, entries.reshape(-1), occ.reshape(-1), tabs,
                       d.mit_sums, d.cfd_sums, n=n, scan_width=scan_width,
                       max_dist=max_dist, rescan_block=rescan_block)
    header = torch.cat([d.pops, d.pops.new_zeros(1)])
    return header, d.mit_sums[:n], d.cfd_sums[:n]


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
                 qb_cap: int = 512, nz_cap: int = 1 << 17,
                 caps: tuple | None = None,
                 superchunk: int | None = None,
                 rescan_block: int | None = None,
                 auto_caps: bool | None = None,
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
        # compaction capacities: every decode gather/score runs at cap
        # size on the GPU. ``caps`` pins all seven and an overflow splits
        # the page in half; with caps=None on CUDA the scorer auto-tunes:
        # the first page runs at the generous nz_cap defaults, caps
        # shrink to ~1.25x its measured populations, and later overflows
        # grow the exceeded cap and retry instead of splitting. A page
        # shorter than the tuning page runs at caps scaled to its length
        # (``_caps(rows)``), each at least its own floor, which a scaled
        # page's overflow grows
        (self.cap_single, self.cap_mslot, self.cap_scell, self.cap_sresc,
         self.cap_mcell, self.cap_rescan,
         self.cap_hits) = normalize_caps(caps, nz_cap)
        if auto_caps is None:
            auto_caps = caps is None and self.device.type == "cuda"
        self._auto = bool(auto_caps)
        self._tuned = False
        self._cap_rows = 0              # the tuning page's guides; 0: none
        self._cap_floor = (0,) * 7
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
        # n_sresc, n_mcell, n_rescan, 0) recorded by every drain — the
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
                + 6 * 16 * 8 + 6 * 8 * self._caps(n)[5])

    def _fit_pages(self):
        """Size the pages to the device, once the lists are on it: where a
        page at ``qb_cap`` slots does not fit the free memory, less
        ``reserve`` and a sixteenth of slack for the allocator, cut
        ``qb_cap`` to the slots that fit (a multiple of SLOT_ALIGN) and
        ``query_page`` in the same ratio, so a page's occupancy keeps its
        share of the cap. Pages that fit keep both; where fewer than
        SLOT_ALIGN slots fit, ValueError, naming the bytes needed and
        free."""
        free = free_bytes(self.device)
        room = free - self.reserve
        room -= room // 16
        fit = (room - self.page_bytes(0, self.query_page)) \
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

    def _caps(self, rows: int | None = None):
        """The seven caps, or those a page of ``rows`` guides runs at:
        once auto caps are tuned on a longer page, each scaled by ``rows``
        over its length to the 4096 grain, and at least its floor."""
        caps = (self.cap_single, self.cap_mslot, self.cap_scell,
                self.cap_sresc, self.cap_mcell, self.cap_rescan,
                self.cap_hits)
        if rows is None or rows >= self._cap_rows:
            return caps
        scaled = (-(-c * rows // self._cap_rows) for c in caps)
        return tuple(min(c, max(f, -(-x // 4096) * 4096))
                     for c, f, x in zip(caps, self._cap_floor, scaled))

    def _set_caps(self, caps):
        (self.cap_single, self.cap_mslot, self.cap_scell, self.cap_sresc,
         self.cap_mcell, self.cap_rescan, self.cap_hits) = caps

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
            caps=self._caps(q_sig.shape[0]), tabs=self.tables,
            rescan_block=self.rescan_block, scan_width=self._scan_width,
            trim=self.device.type == "cpu")

    def decode_tree(self, q_sig, qsp, fo: FinderOut) -> Decoded:
        """Steps 1-2 of the decode, down to its rescan list
        (:func:`~.compact_decode.compact_decode`)."""
        return compact_decode(
            q_sig, qsp, fo, self.bucket_offsets, self.bucket_lens,
            self.entries, self.occ, chunk=self.chunk,
            superchunk=self.superchunk, caps=self._caps(q_sig.shape[0]),
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
        # record the caps the program RAN with: self._caps() can grow
        # mid-drain when an earlier page overflows, and a later page that
        # ran under the old smaller caps must still be checked against
        # those (its compaction truncated at them)
        pending.append((pos, page, self._caps(page.shape[0]),
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
        # drain after every page is enqueued; overflowed pages grow their
        # caps and retry (auto mode) or split in half (explicit caps)
        while pending:
            retry = []
            for pos, page, ran_caps, (header, m, c) in pending:
                with trace.span("compact.drain"):
                    with trace.span("compact.drain.wait"):
                        header = header.cpu()
                    pops = tuple(int(x) for x in header)
                    self.page_stats.append(pops)
                    self._drained_rows = page.shape[0]
                    if any(p > cap for p, cap in zip(pops, ran_caps)):
                        trace.count("compact.retries")
                        if self._auto:
                            self._grow_caps(pops, ran_caps, page.shape[0])
                            retry.append((pos, page, False))
                        else:
                            if page.shape[0] < 2:
                                raise RuntimeError(
                                    "hit compaction overflow on a single "
                                    "query; raise nz_cap")
                            retry.append((pos, page, True))
                        continue
                    at = slice(pos.start, pos.stop, pos.step)
                    out_mit[at] = m.cpu().numpy()
                    out_cfd[at] = c.cpu().numpy()
            pending = []
            for pos, page, split in retry:
                with trace.span("compact.dispatch"):
                    if split:
                        self._halve(pos, page, pending)
                    else:
                        self._dispatch(pos, page, pending)

    def _grow_caps(self, pops, ran_caps, rows):
        """Auto caps after a page of ``rows`` guides overflowed: a cap
        below its population grows to cover it; on a page shorter than the
        tuning page, so does the floor of each cap the page overflowed, so
        the retry fits and longer pages keep their caps."""
        self._set_caps(tuple(_quant_cap(p) if p > cap else cap
                             for p, cap in zip(pops, self._caps())))
        if rows < self._cap_rows:
            self._cap_floor = tuple(
                max(f, _quant_cap(p)) if p > ran else f
                for p, ran, f in zip(pops, ran_caps, self._cap_floor))

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
            if self._auto and not self._tuned and pages:
                # run the first page at the generous defaults, then shrink
                # every cap to ~1.25x its measured population before the
                # rest
                self._run_pages(pages[:1], out_mit, out_cfd)
                self._set_caps(tuple(
                    _quant_cap(p) for p in self.page_stats[-1]))
                self._cap_rows = self._drained_rows
                self._tuned = True
                pages = pages[1:]
            self._run_pages(pages, out_mit, out_cfd)
        return out_mit, out_cfd

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)
