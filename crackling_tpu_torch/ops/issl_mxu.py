"""The bit-exact ISSL engine: device neighbour finder, decode and f64 replay.

The PyTorch port of crackling_tpu/ops/issl_mxu.py (``engine = exact`` /
``mxu``, and the hybrid's first exact re-scorer). Its scores equal
``isslScoreOfftargets``' for every method, ``avg`` included. One query
page runs:

1. **Slot plan** (:meth:`MxuIsslScorer._plan`, host numpy): each
   (slice, bucket) gets ``qb`` query slots; spare slots hold the padding
   id ``query_page``.
2. **Neighbour finder** (:func:`mxu_finder`, the hand-written Hopper
   kernel on CUDA): per (512-entry segment, slot) the count and rank sum
   of the bucket's entries at distance 1..max_dist.
3. **Hit decode** (:func:`decode_neighbours`, torch ops on the device):
   single-neighbour slots resolve from their slot totals, multi-neighbour
   slots through their segment cells, and segments with several
   neighbours are rescanned; the result is a compact (query, slice, site
   id) hit table. Every compaction is capped, so the page never waits on
   the host; a population above its cap grows the cap and runs the page
   again, or splits the page where the grown one does not fit.
4. **Replay** (:func:`~.mxu_replay.mxu_replay`, the hand-written Hopper
   kernel on CUDA): each query's hits and its own site, found by a binary
   search over the lexicographically sorted sites on the host, in the
   reference's scan order (slice, then site id), deduplicated by first
   occurrence, summed in f64 with the reference's early exit. Only the
   (n, 2) sums come back to the host.

Discovery parity: the reference finds an off-target only through a slice
that matches exactly (isslScoreOfftargets.cpp:330-344), and the finder
scans exactly those (slice value == query slice value) buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import free_bytes, resolve_device
from ..index.build import IsslIndex, _lofirst_to_lex
from .bits import collapse_pairs, popcount
from .compact_decode import compact_indices
from .issl_compact import (ALIGN, RANK_BOUND, AlignedLists, _quant_cap,
                           aligned_layout, aligned_lists)
from .mxu_finder import NeighbourPlanes, mxu_finder, signature_mask
from .mxu_replay import maximum_sum, mxu_replay, replay_tables, \
    scratch_bytes

SLOT_ALIGN = 64       # slot count granule (the kernel's block of slots)
NZ_CAP = 1 << 18      # the caps' scale (``nz_cap``): the single-slot cap
# multi-neighbour segments rescanned per block, bounding the rescan's
# temporaries to O(RESCAN_BLOCK x segw) however large its cap is
RESCAN_BLOCK = 4096


def decode_neighbours(q_sig: torch.Tensor, qsp: torch.Tensor,
                      planes: NeighbourPlanes, order: torch.Tensor,
                      uoff: torch.Tensor, entries: torch.Tensor,
                      boff: torch.Tensor, blen: torch.Tensor, *, segw: int,
                      max_dist: int, seq_length: int, caps: tuple,
                      trim: bool):
    """One page's finder planes -> its compact hit table, on the device
    (the JAX engine's ``epilogue``).

    ``order`` (S, N) int32 per-slice site ids in bucket order and
    ``uoff`` (S, B+1) int64 their (unaligned) CSR offsets turn in-bucket
    ranks into site ids; ``entries``/``boff``/``blen`` are the finder's
    aligned packed lists, which the rescan reads. Returns (header, hits):
    header (6,) int64 populations (hits, single-neighbour slots,
    multi-neighbour slots, their nonzero segments, multi-neighbour
    segments, rescan hits), and hits (4, <= hitcap) int64 rows (query,
    slice, site id, the site's flat position in ``entries``), valid in
    their first ``header[0]`` columns unless a population exceeds its
    cap."""
    dev = q_sig.device
    n = q_sig.numel()
    S, B, nseg, qb = planes.cnt.shape
    cap1, capm, capm2, capr, capr2, hitcap = caps
    N = order.shape[1]
    epad = entries.shape[1]
    cnt_f = planes.cnt.reshape(-1)
    pos_f = planes.rsum.reshape(-1)
    qsp_f = qsp.reshape(-1).long()
    order_f = order.reshape(-1)
    uoff_f = uoff.reshape(-1)
    boff_f = boff.reshape(-1)
    blen_f = blen.reshape(-1).long()
    ent_f = entries.reshape(-1)
    mask = signature_mask(seq_length)

    def split_slot(slot):
        """Flat slot (s*B + b)*qb + j -> (s, b)."""
        sb = slot // qb
        return sb // B, sb % B

    def order_at(s, b, k):
        # ranks index the UNALIGNED CSR lists (the rescan, below, reads
        # the aligned ones)
        return order_f[s * N + uoff_f[s * (B + 1) + b] + k].long()

    def entry_at(s, b, k):
        """The flat position of rank ``k`` of bucket (s, b) in the aligned
        lists, where the replay reads the site's signature and count."""
        return s * epad + boff_f[s * B + b] + k

    # 1) single-neighbour slots: the rank sum IS the in-bucket rank
    with trace.span("mxu.decode.single"):
        # an int32 sum (a slot's neighbours are fewer than its bucket's
        # entries): a wider one would copy the whole plane first
        slot_cnt = planes.cnt.sum(2, dtype=torch.int32).reshape(-1).long()
        slot_pos = planes.rsum.sum(2).reshape(-1)
        one = slot_cnt == 1
        n1 = one.sum()
        sidx = compact_indices(one, cap1, trim)
        v1 = sidx >= 0
        si = sidx.clamp(min=0)
        s1, b1 = split_slot(si)
        r1 = torch.where(v1, slot_pos[si], 0)
        hid1, hpos1 = order_at(s1, b1, r1), entry_at(s1, b1, r1)
        hq1 = qsp_f[si]

    # 2) multi-neighbour slots -> their nonzero segment cells; a
    # single-neighbour segment pins its rank
    with trace.span("mxu.decode.multi"):
        multi = slot_cnt >= 2
        nm = multi.sum()
        midx = compact_indices(multi, capm, trim)
        mi = midx.clamp(min=0)
        vm = (midx >= 0)[:, None]
        g = torch.arange(nseg, device=dev)
        cidx = ((mi // qb)[:, None] * nseg + g[None, :]) * qb \
            + (mi % qb)[:, None]
        mc = torch.where(vm, cnt_f[cidx], 0)              # (capm, nseg)
        mp = torch.where(vm, pos_f[cidx], 0)
        nc = (mc > 0).sum()
        mz = compact_indices((mc > 0).reshape(-1), capm2, trim)
        vz = mz >= 0
        mzc = mz.clamp(min=0)
        msg = mzc % nseg
        mslot = mi[mzc // nseg]
        mcnt = mc.reshape(-1)[mzc]
        mpos = mp.reshape(-1)[mzc]
        sM, bM = split_slot(mslot)
        hqM = qsp_f[mslot]
        c1 = vz & (mcnt == 1)
        rM = torch.where(c1, mpos, 0)
        hidM, hposM = order_at(sM, bM, rM), entry_at(sM, bM, rM)

    # 3) multi-neighbour segments: rescan their <= segw entries, in blocks
    # of RESCAN_BLOCK segments
    with trace.span("mxu.decode.rescan"):
        c2 = vz & (mcnt >= 2)
        n2c = c2.sum()
        ridx = compact_indices(c2, capr, trim)
        ri_all = ridx.clamp(min=0)
        cols = torch.arange(segw, device=dev)
        rhit = torch.zeros((ridx.numel(), segw), dtype=torch.bool,
                           device=dev)
        for k in range(0, ridx.numel(), RESCAN_BLOCK):
            ri = ri_all[k:k + RESCAN_BLOCK]
            rs, rb, rseg = sM[ri], bM[ri], msg[ri]
            rq = qsp_f[mslot[ri]].clamp(max=n - 1)
            start = rs * epad + boff_f[rs * B + rb] + rseg * segw
            gpos = (start[:, None] + cols).clamp(max=ent_f.numel() - 1)
            d = popcount(collapse_pairs(
                (ent_f[gpos] ^ q_sig[rq][:, None]) & mask))
            inseg = cols < (blen_f[rs * B + rb] - rseg * segw)[:, None]
            rhit[k:k + RESCAN_BLOCK] = ((d >= 1) & (d <= max_dist) & inseg
                                        & (ridx[k:k + RESCAN_BLOCK]
                                           >= 0)[:, None])
        nrh = rhit.sum()
        rz = compact_indices(rhit.reshape(-1), capr2, trim)
        vrz = rz >= 0
        rzc = rz.clamp(min=0)
        rr = ri_all[rzc // segw]
        hsR = sM[rr]
        rR = torch.where(vrz, msg[rr] * segw + rzc % segw, 0)
        hidR, hposR = order_at(hsR, bM[rr], rR), entry_at(hsR, bM[rr], rR)
        hqR = qsp_f[mslot[rr]]

    # assemble + final compaction
    val_all = torch.cat([v1, c1, vrz])
    nh = val_all.sum()
    hz = compact_indices(val_all, hitcap, trim).clamp(min=0)
    hits = torch.stack([torch.cat([hq1, hqM, hqR]),
                        torch.cat([s1, sM, hsR]),
                        torch.cat([hid1, hidM, hidR]),
                        torch.cat([hpos1, hposM, hposR])])[:, hz]
    header = torch.stack([nh, n1, nm, nc, n2c, nrh])
    return header, hits


def default_caps(nz_cap: int = NZ_CAP) -> tuple:
    """The six compaction caps at scale ``nz_cap``: single-neighbour slots,
    multi-neighbour slots, their nonzero segment cells, multi-neighbour
    segments, rescan hits, and the final hit table."""
    nz = int(nz_cap)
    return (nz, max(1024, nz // 8), max(2048, nz // 4), max(1024, nz // 16),
            max(2048, nz // 8), 2 * nz)


def cut_caps(caps: tuple, n: int, S: int, nseg: int, segw: int) -> tuple:
    """``caps`` cut to the most a page of ``n`` guides can fill (``n`` x S
    live slots, ``nseg`` segments a slot, ``segw`` entries a segment; the
    hit table the rows of its three sources), so a short re-score call
    allocates no more than it can fill."""
    slots = max(1, n * S)
    cap1, capm = min(caps[0], slots), min(caps[1], slots)
    capm2 = min(caps[2], capm * nseg)
    capr = min(caps[3], capm2)
    capr2 = min(caps[4], capr * segw)
    return (cap1, capm, capm2, capr, capr2,
            min(caps[5], cap1 + capm2 + capr2))


def page_bytes(qb: int, caps: tuple, S: int, B: int, nseg: int,
               segw: int) -> int:
    """Device bytes one page with ``qb`` slots per bucket allocates at
    ``caps``: the finder's planes (int32 counts + int64 rank sums); per
    slot the decode's totals, flags and compaction (~50 B); per segment
    cell of a capped multi-neighbour slot its count, rank sum, index, flag
    and compaction (~49 B); the rescan block; the hit table; and the
    replay's scratch for it and for the page's queries (at most B x qb:
    one slot of slice 0 each)."""
    _cap1, capm, _capm2, capr, _capr2, hitcap = caps
    planes = S * B * nseg * qb * 12
    slots = S * B * qb * 50
    cells = capm * nseg * 49
    rescan = capr * segw + min(RESCAN_BLOCK, capr) * segw * 8 * 6
    hits = 4 * hitcap * 8 * 4
    replay = scratch_bytes(hitcap, B * qb)
    return planes + slots + cells + rescan + hits + replay


def segments(index: IsslIndex, chunk: int) -> tuple[int, int, int]:
    """(deepest bucket, segments a slot, entries a segment) of ``index``
    at ``chunk``."""
    lens = np.diff(index.bucket_offsets, axis=1)
    maxblen = int(lens.max()) if lens.size else 0
    return maxblen, max(8, -(-maxblen // chunk) * 8), chunk // 8


def resident_bytes(index: IsslIndex, chunk: int, shared: bool) -> int:
    """Device bytes of the engine's resident index: each slice's site
    order and CSR offsets, and the packed lists (signatures and counts)
    and their bucket arrays unless they are another engine's
    (``shared``)."""
    S, B = index.slice_count, index.bucket_count
    own = 0 if shared else S * (aligned_layout(index, chunk)[1] * 12
                                + B * 12)
    return index.order.size * 4 + S * (B + 1) * 8 + own


def added_bytes(index: IsslIndex, chunk: int = 4096,
                shared: bool = False) -> int:
    """Device bytes the engine adds beside another engine: its resident
    index (with its own lists unless ``shared``) and its least page
    (SLOT_ALIGN slots, as many guides, at the default caps)."""
    S, B = index.slice_count, index.bucket_count
    _maxblen, nseg, segw = segments(index, chunk)
    caps = cut_caps(default_caps(), SLOT_ALIGN, S, nseg, segw)
    return (resident_bytes(index, chunk, shared)
            + page_bytes(SLOT_ALIGN, caps, S, B, nseg, segw))


class MxuIsslScorer:
    """Bit-exact ISSL scorer: device neighbour finder, decode and replay.

    ``score`` reproduces the reference binary's output exactly (f64, scan
    order, early exit) for every method."""

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 method: str = "and", threshold: float = 75.0,
                 query_page: int = 32768, chunk: int = 4096,
                 nz_cap: int = NZ_CAP,
                 lists: AlignedLists | None = None, device=None):
        self.device = resolve_device(device)
        if index.seq_length > 20:
            raise ValueError("the neighbour finder supports seq_length <= 20")
        if chunk % ALIGN:
            raise ValueError(f"chunk must be a multiple of {ALIGN}")
        self.index = index
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.method = method
        self.threshold = float(threshold)
        self.query_page = int(query_page)
        self.chunk = int(chunk)
        # compaction capacities (:func:`default_caps`), which a page runs
        # at cut to what its guides can fill (``_caps(n)``) and which grow
        # to a page's populations where it overflows them
        (self.cap_single, self.cap_mslot, self.cap_mcell, self.cap_rescan,
         self.cap_rhit, self.hit_cap) = default_caps(nz_cap)
        self.S = index.slice_count
        self.B = index.bucket_count
        self.maxblen, self.nseg, self.segw = segments(index, self.chunk)
        # per-page populations (header) of every decoded (sub)page
        self.page_stats: list[tuple[int, ...]] = []
        with trace.span("mxu.build"):
            self._build(index, lists)

    def _build(self, index: IsslIndex, lists: AlignedLists | None):
        """The resident index on the device: the packed lists (``lists``,
        another engine's, when given: the compact engine's in the hybrid),
        each slice's site order and CSR offsets, and the host's lex keys."""
        # the port's sums and ranks are integers: the compact engine's
        # bound (the JAX engine's f32 decode stops at 2^22; PARITY.md)
        if self.maxblen >= RANK_BOUND:
            raise ValueError(
                f"bucket with {self.maxblen:,} entries exceeds the MXU "
                f"engine's rank-exactness bound ({RANK_BOUND:,} entries); "
                "use IsslScorer (ops/issl_flat.py) for this index")
        if lists is not None and (
                lists.entries.device.type != self.device.type
                or lists.boff.shape != (self.S, self.B)):
            raise ValueError("the shared lists are not this index's on "
                             f"{self.device}")

        # memory BEFORE any device work: what this engine adds to the
        # device and its least page must fit beside whatever the device
        # already holds (the hybrid's fast engine); else the same
        # ValueError as the JAX engine's plane budget, so the hybrid and
        # the pipeline fall back to another exact engine. Each call's
        # pages are sized to the memory free then
        resident = resident_bytes(index, self.chunk, lists is not None)
        free = free_bytes(self.device)
        need = resident + self.page_bytes(SLOT_ALIGN, self._caps(SLOT_ALIGN))
        if need > free:
            raise ValueError(
                f"the MXU engine needs ~{need / 1e9:.2f} GB on "
                f"{self.device} (index {resident / 1e9:.2f} GB + one "
                f"{SLOT_ALIGN}-slot page) but "
                f"{free / 1e9:.2f} GB are free at {index.num_sites:,} "
                "sites; use IsslScorer (ops/issl_flat.py) for this index")

        dev = self.device
        if lists is None:
            lists = aligned_lists(index, dev, tail=self.chunk)
        self.entries = lists.entries
        self.occ = lists.occ
        self.bucket_offsets = lists.boff
        self.bucket_lens = lists.blen
        self.order = torch.as_tensor(index.order, device=dev)
        self._tables = replay_tables(index.seq_length, self.max_dist, dev)
        self.uoff = torch.as_tensor(
            index.bucket_offsets.astype(np.int64), device=dev)

        # lexicographic keys for the self-hit binary search: site ids are
        # assigned in lex order (isslCreateIndex.cpp:184-207), so the
        # id-ordered lex packing is ascending
        self._site_lex = self._lex(index.site_sigs)

    # -- sizes -------------------------------------------------------------

    @staticmethod
    def _round_slots(load: int) -> int:
        return max(SLOT_ALIGN, -(-int(load) // SLOT_ALIGN) * SLOT_ALIGN)

    def _caps(self, n: int | None = None) -> tuple:
        """The six caps, or those a page of ``n`` guides runs at
        (:func:`cut_caps`)."""
        caps = (self.cap_single, self.cap_mslot, self.cap_mcell,
                self.cap_rescan, self.cap_rhit, self.hit_cap)
        if n is None:
            return caps
        return cut_caps(caps, n, self.S, self.nseg, self.segw)

    def _grow_caps(self, pops: tuple, caps: tuple, n: int, qb: int) -> bool:
        """The caps after a page of ``n`` guides at ``qb`` slots overflowed
        ``caps``: each cap a population passed grows to cover it (1.25x, to
        the 4,096 grain; a population counted past an earlier overflow may
        read low, so a page can grow more than once). Whether the page
        fits the device's free memory at the grown caps."""
        grown = tuple(_quant_cap(p) if p > c else c
                      for p, c in zip(pops, caps))
        (self.cap_single, self.cap_mslot, self.cap_mcell, self.cap_rescan,
         self.cap_rhit, self.hit_cap) = (
            max(g, c) for g, c in zip(grown, self._caps()))
        return self.page_bytes(qb, self._caps(n)) <= self._room()

    def page_bytes(self, qb: int, caps: tuple) -> int:
        """Device bytes one page with ``qb`` slots per bucket allocates at
        ``caps`` (:func:`page_bytes`)."""
        return page_bytes(qb, caps, self.S, self.B, self.nseg, self.segw)

    # -- per-page planning (host) ------------------------------------------

    def _plan(self, sigs: np.ndarray):
        """Sort queries into (slice, bucket) slots.

        Returns (qsp, qb): qsp is (S, B, qb) int32 of query ids with
        ``query_page`` as the padding id; qb is the slot count (a
        multiple of 64, sized to the fullest bucket so no query is ever
        dropped)."""
        n = sigs.shape[0]
        vals = self.index.slice_values(sigs).astype(np.int64)   # (S, n)
        counts = np.zeros((self.S, self.B), dtype=np.int64)
        for s in range(self.S):
            counts[s] = np.bincount(vals[s], minlength=self.B)
        qb = self._round_slots(counts.max() if counts.size else 1)
        offs = np.zeros((self.S, self.B), dtype=np.int64)
        np.cumsum(counts[:, :-1], axis=1, out=offs[:, 1:])
        qsp = np.full((self.S, self.B * qb), self.query_page, dtype=np.int32)
        ar = np.arange(n, dtype=np.int64)
        for s in range(self.S):
            order = np.argsort(vals[s], kind="stable")
            sv = vals[s][order]
            qsp[s][sv * qb + ar - offs[s][sv]] = order
        return qsp.reshape(self.S, self.B, qb), qb

    # -- the page program ----------------------------------------------------

    def query_tensor(self, page: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(page, dtype=np.uint64).view(np.int64),
            device=self.device)

    def finder(self, q_sig: torch.Tensor, qsp: torch.Tensor):
        """Step 2 of the page program (the kernel on CUDA)."""
        return mxu_finder(self.entries, self.bucket_offsets,
                          self.bucket_lens, q_sig, qsp, segw=self.segw,
                          nseg=self.nseg, max_dist=self.max_dist,
                          seq_length=self.index.seq_length)

    def decode(self, q_sig: torch.Tensor, qsp: torch.Tensor,
               planes: NeighbourPlanes):
        """Step 3 of the page program."""
        return decode_neighbours(
            q_sig, qsp, planes, self.order, self.uoff, self.entries,
            self.bucket_offsets, self.bucket_lens, segw=self.segw,
            max_dist=self.max_dist, seq_length=self.index.seq_length,
            caps=self._caps(q_sig.numel()),
            trim=self.device.type == "cpu")

    def _room(self) -> int:
        """Bytes a page may take: the device's free memory less an eighth
        of slack for the allocator."""
        free = free_bytes(self.device)
        return free - free // 8

    def _run_pages(self, sigs: np.ndarray, consume=None) -> list:
        """Finder + device decode over all pages of ``sigs``, each
        (sub)page handed to ``consume(pos, page, q_sig, hits)`` as soon as
        it is decoded: ``page`` is ``sigs`` at positions ``pos``, ``q_sig``
        its signatures on the device and ``hits`` (4, H) its hit table
        there (page-local query index, slice, site id, entry position).
        Returns what ``consume`` returned, page by page (by default those
        four). A page's device memory is free once ``consume`` returns, so
        the next page finds the allocator's blocks as this one did.

        Pages, and the halves a page splits into, take every P-th guide (P
        = ceil(n / query_page), then 2), so that on a sorted batch each
        samples every bucket and its slot count shrinks with it. Planes
        larger than the device's room split a page; a compaction overflow
        grows the caps it passed and runs the page again where it still
        fits, else splits it."""
        consume = consume or (lambda *page: page)
        out = []

        def halves(pos, page):
            run_one(pos[0::2], page[0::2])
            run_one(pos[1::2], page[1::2])

        def run_one(pos, page):
            n = page.shape[0]
            with trace.span("mxu.plan"):
                qsp_np, qb = self._plan(page)
            caps = self._caps(n)
            if n >= 2 and self.page_bytes(qb, caps) > self._room():
                halves(pos, page)
                return
            q_sig = self.query_tensor(page)
            qsp = torch.as_tensor(qsp_np, device=self.device)
            header, hits = self.decode(q_sig, qsp, self.finder(q_sig, qsp))
            pops = tuple(int(x) for x in header.cpu())
            self.page_stats.append(pops)
            nh, n1, nm, nc, n2c, nrh = pops
            pops = (n1, nm, nc, n2c, nrh, nh)           # in the caps' order
            if any(p > c for p, c in zip(pops, caps)):
                if self._grow_caps(pops, caps, n, qb):
                    run_one(pos, page)
                    return
                if n < 2:
                    raise RuntimeError("hit compaction overflow on a single "
                                       "query; raise the engine caps")
                halves(pos, page)
                return
            out.append(consume(pos, page, q_sig, hits[:, :nh]))

        n = sigs.shape[0]
        P = -(-n // self.query_page)
        pos = np.arange(n)
        for k in range(P):
            run_one(pos[k::P], sigs[k::P])
        return out

    def neighbour_counts(self, query_sigs: np.ndarray) -> np.ndarray:
        """Per-query count of (slice-discoverable, pre-dedup) sites at
        distance 1..max_dist — the finder's raw output."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        if not sigs.size:
            return np.zeros(0, dtype=np.float64)
        counts = np.zeros(sigs.shape[0], dtype=np.float64)

        def count(pos, _page, _q_sig, hits):
            counts[pos] = torch.bincount(hits[0], minlength=pos.size).cpu()

        self._run_pages(sigs, count)
        return counts

    # -- own sites (host) --------------------------------------------------

    def _lex(self, sigs: np.ndarray) -> np.ndarray:
        from .. import native

        lex = native.lex_convert_native(sigs, self.index.seq_length)
        return (lex if lex is not None
                else _lofirst_to_lex(sigs, self.index.seq_length))

    def _self_lookup(self, sigs: np.ndarray):
        """Binary search each query in the lex-sorted site list.
        Returns (found, site_id, occurrences)."""
        if self.index.num_sites == 0:
            z = np.zeros(sigs.shape[0], dtype=np.int64)
            return np.zeros(sigs.shape[0], dtype=bool), z, z
        qlex = self._lex(sigs)
        pos = np.searchsorted(self._site_lex, qlex)
        pos = np.minimum(pos, self.index.num_sites - 1)
        found = self._site_lex[pos] == qlex
        occ = np.where(found, self.index.occurrences[pos].astype(np.int64), 0)
        return found, pos.astype(np.int64), occ

    # -- public API ----------------------------------------------------------

    def score(self, query_sigs: np.ndarray, method: str | None = None,
              threshold: float | None = None):
        """Reference-exact (mit, cfd) scores, already 10000/(100+sum).

        Each page's hit table stays on the device: the replay
        (:func:`~.mxu_replay.mxu_replay`) takes it with each query's own
        site, found on the host, and returns the (n, 2) sums. A query with
        no neighbour scores from its own site alone: distance 0 gives MIT 0
        and CFD its occurrences (isslScoreOfftargets.cpp:393,407-408)."""
        method = self.method if method is None else method
        threshold = self.threshold if threshold is None else float(threshold)
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]

        mit = np.full(n, 100.0, dtype=np.float64)
        cfd = np.full(n, 100.0, dtype=np.float64)
        if n == 0:
            return mit, cfd
        kw = dict(method=method, maximum_sum=maximum_sum(threshold),
                  slice_width=self.index.slice_width)
        entries, occ = self.entries.reshape(-1), self.occ.reshape(-1)

        def replay(rows, page, q_sig, hits):
            found, sid, occ_self = self._self_lookup(page)
            own = torch.as_tensor(np.stack([np.where(found, sid, -1),
                                            occ_self]), device=self.device)
            trace.count("mxu.replay_hits", hits.shape[1])
            with trace.span("mxu.replay"):
                rep = mxu_replay(hits, q_sig, own, entries, occ,
                                 self._tables, **kw)
                sums = rep.sums.cpu().numpy()
            if trace.active():
                trace.count("mxu.replay_spilled", int(rep.spilled))
            mit[rows] = 10000.0 / (100.0 + sums[:, 0])
            cfd[rows] = 10000.0 / (100.0 + sums[:, 1])

        self._run_pages(sigs, replay)
        return mit, cfd
