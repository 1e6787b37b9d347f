"""Specificity positioning: exact-match genome search replacing Bowtie2.

The reference writes 8 PAM variants per guide (4x NGG + 4x NAG,
Crackling.py:628-641), aligns them with Bowtie2 and counts perfect
alignments: each variant contributes +1 if it has a perfect alignment
(``XM:i:0``) and +1 more if a second perfect alignment exists (``XS:i:0``);
a guide with a total > 1 is rejected (Crackling.py:694-715).

That is exactly ``sum(min(exact_occurrences(variant), 2))`` over the eight
variants, where occurrences are counted on both genome strands. This module
computes it by direct exact search over 2-bit-packed genome windows —
no aligner, no SAM round trip.

Recorded coordinates: the reference stores the chromosome/position of the
**first variant's** (guide20 + AGG) reported alignment — SAM fields of
``bowtieLines[i]`` at Crackling.py:670-689 — which Bowtie2 reports even
when inexact. We emulate that: the AGG read's best alignment by mismatch
count (exact, then 1-mismatch, then 2-mismatch over both strands), with a
deterministic lowest-genomic-position tie-break where Bowtie2's choice
among equals is pseudo-random; unaligned reads record the SAM no-hit
fields ('*', 0, 22). Alignments are searched over the PAM-candidate
window universe (windows ending GG/AG or starting CC/CT — the persistent
index below): exact matches of a PAM-variant read always live there, and
a real guide's own locus is always covered, so for pipeline guides this
only replaces Bowtie2's pseudo-random equal-score choice; a window whose
mismatches fall inside the PAM itself is not considered. Coordinates are 1-based like SAM POS, end = pos + 22.
The shim Bowtie2 binary (utils/shims.py) implements the identical policy,
so the CSV-parity harness closes column-for-column; only the tie-break
among equal-score alignments can differ from a real Bowtie2 run
(documented in PARITY.md).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

from ..codec import pack_lofirst
from ..index.extract import encode_seq

# PAM variants appended to guide[0:20] (reference Crackling.py:629-637):
# AGG CGG GGG TGG AAG CAG GAG TAG -> codes for positions 20,21,22.
PAM_VARIANTS = [
    (0, 2, 2), (1, 2, 2), (2, 2, 2), (3, 2, 2),
    (0, 0, 2), (1, 0, 2), (2, 0, 2), (3, 0, 2),
]


@dataclass
class GenomeIndex:
    """Concatenated 2-bit genome with per-record boundaries.

    Carries a lazily-built persistent window index (sorted 23-mer
    signatures of every window that can ever match a guide PAM variant),
    so positioning pages cost O(page * log windows) instead of a full
    genome rescan per page (the Bowtie2 FM-index role in the reference,
    Crackling.py:600-725). Only ~1/4 of genome windows survive the PAM
    prefilter (forward windows ending GG/AG, reverse-candidate windows
    starting CC/CT), so the index costs ~4 bytes/bp signature + 8
    bytes/bp position at 25% density."""

    names: list[str]
    codes: np.ndarray        # uint8 concatenated, 255 at separators
    starts: np.ndarray       # int64 offset of each record in codes
    _win_sigs: np.ndarray | None = None
    _win_pos: np.ndarray | None = None
    _mmdir: object = field(default=None, repr=False)

    @classmethod
    def from_fasta(cls, path: str) -> "GenomeIndex":
        names: list[str] = []
        chunks: list[np.ndarray] = []
        starts: list[int] = []
        offset = 0
        sep = np.full(23, 255, dtype=np.uint8)
        with open(path, "r") as fp:
            cur: list[str] = []

            def flush():
                nonlocal offset
                if names:
                    seq = "".join(cur)
                    codes = encode_seq(seq, to_upper=True)
                    starts.append(offset)
                    chunks.append(codes)
                    chunks.append(sep)
                    offset += codes.shape[0] + sep.shape[0]

            for line in fp:
                line = line.strip()
                if not line:
                    continue
                if line[0] == ">":
                    flush()
                    names.append(line[1:].split()[0])
                    cur = []
                else:
                    cur.append(line)
            flush()
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.uint8))
        return cls(names=names, codes=codes,
                   starts=np.asarray(starts, dtype=np.int64))

    def locate(self, flat_pos: np.ndarray):
        """Flat concatenated offsets -> (record index, 1-based position)."""
        rec = np.searchsorted(self.starts, flat_pos, side="right") - 1
        return rec, flat_pos - self.starts[rec] + 1

    def _scan_windows(self, chunk: int):
        """Yield (sig23, flat position) of PAM-candidate windows, chunk by
        chunk in ascending genome order (native scanner when available,
        numpy fallback otherwise). Bounded memory: one chunk at a time."""
        from ..native import pam_windows_native

        codes = self.codes
        total = codes.shape[0]
        for c0 in range(0, total, chunk):
            c1 = min(total, c0 + chunk + 22)
            native = pam_windows_native(codes[c0:c1])
            if native is not None:
                sigs, pos = native
                if c0 > 0 or c1 < total:
                    keep = pos < chunk
                    sigs, pos = sigs[keep], pos[keep]
                if sigs.size:
                    yield sigs, pos + c0
                continue
            sigs, pos = _window_sigs23(codes[c0:c1])
            keep = pos < chunk
            sigs, pos = sigs[keep], pos[keep]
            if sigs.size == 0:
                continue
            p = pos + c0
            # PAM prefilter: a window can match a forward variant key only
            # when bases 21,22 are GG/AG; it can match the rc of a variant
            # key only when bases 0,1 are CC/CT (A=0 C=1 G=2 T=3)
            w0, w1 = codes[p], codes[p + 1]
            w21, w22 = codes[p + 21], codes[p + 22]
            m = ((w22 == 2) & ((w21 == 2) | (w21 == 0))) \
                | ((w0 == 1) & ((w1 == 1) | (w1 == 3)))
            if m.any():
                yield sigs[m], p[m]

    def window_index(self, chunk: int = 1 << 24,
                     memmap_threshold: int | None = None):
        """(sorted window signatures, flat positions) — built once.

        Windows are ordered by (signature, position), so for any signature
        the first entry in its searchsorted range is its lowest genomic
        occurrence.

        For genomes whose estimated window count exceeds
        ``memmap_threshold`` (default 2^27 ≈ 134M windows ≈ 2 GB of
        index; override with ``CRACKLING_WINDOW_MEMMAP_THRESHOLD``), the
        index is built *on disk* with a two-scan bucket sort — peak host
        RAM is one genome chunk plus one of 256 signature buckets — and
        served from ``np.memmap`` arrays, so >10 Gbp inputs position in
        bounded memory (the binary searches page in only what they touch).
        """
        if self._win_sigs is not None:
            return self._win_sigs, self._win_pos
        if memmap_threshold is None:
            memmap_threshold = int(os.environ.get(
                "CRACKLING_WINDOW_MEMMAP_THRESHOLD", 1 << 27))
        # both-strand PAM-candidate density on random sequence is ~25%;
        # decide the build mode upfront from a conservative 30% estimate
        if self.codes.shape[0] * 0.3 > memmap_threshold:
            return self._window_index_memmap(chunk)
        sig_parts: list[np.ndarray] = []
        pos_parts: list[np.ndarray] = []
        for sigs, pos in self._scan_windows(chunk):
            sig_parts.append(sigs)
            pos_parts.append(pos)
        if sig_parts:
            sigs = np.concatenate(sig_parts)
            pos = np.concatenate(pos_parts)
            # stable sort on the signature preserves the scan's ascending
            # position order within equal signatures
            order = np.argsort(sigs, kind="stable")
            self._win_sigs = sigs[order]
            self._win_pos = pos[order]
        else:
            self._win_sigs = np.zeros(0, dtype=np.uint64)
            self._win_pos = np.zeros(0, dtype=np.int64)
        return self._win_sigs, self._win_pos

    def _window_index_memmap(self, chunk: int):
        """Disk-resident window index: scan 1 histograms the 256 top-byte
        signature buckets, scan 2 scatters (sig, pos) into per-bucket
        regions of memmapped arrays (chunk order keeps positions ascending
        within a bucket), then each bucket is stable-sorted in RAM."""
        SHIFT = np.uint64(38)          # top byte of the 46-bit 23-mer sig
        counts = np.zeros(256, dtype=np.int64)
        for sigs, _ in self._scan_windows(chunk):
            counts += np.bincount((sigs >> SHIFT).astype(np.int64),
                                  minlength=256)
        n = int(counts.sum())
        self._mmdir = tempfile.TemporaryDirectory(prefix="crackling_winidx_")
        sig_mm = np.memmap(os.path.join(self._mmdir.name, "win_sigs.u64"),
                           dtype=np.uint64, mode="w+", shape=(max(n, 1),))
        pos_mm = np.memmap(os.path.join(self._mmdir.name, "win_pos.i64"),
                           dtype=np.int64, mode="w+", shape=(max(n, 1),))
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cursor = offsets[:-1].copy()
        for sigs, pos in self._scan_windows(chunk):
            b = (sigs >> SHIFT).astype(np.int64)
            order = np.argsort(b, kind="stable")
            b_sorted = b[order]
            runs = np.flatnonzero(np.diff(b_sorted)) + 1
            bounds = np.concatenate([[0], runs, [b_sorted.shape[0]]])
            for r0, r1 in zip(bounds[:-1], bounds[1:]):
                bb = int(b_sorted[r0])
                c = cursor[bb]
                sel = order[r0:r1]
                sig_mm[c:c + (r1 - r0)] = sigs[sel]
                pos_mm[c:c + (r1 - r0)] = pos[sel]
                cursor[bb] += r1 - r0
        for bb in range(256):
            o0, o1 = int(offsets[bb]), int(offsets[bb + 1])
            if o1 - o0 < 2:
                continue
            seg = np.asarray(sig_mm[o0:o1])
            order = np.argsort(seg, kind="stable")
            sig_mm[o0:o1] = seg[order]
            pos_mm[o0:o1] = np.asarray(pos_mm[o0:o1])[order]
        sig_mm.flush()
        pos_mm.flush()
        self._win_sigs = sig_mm[:n]
        self._win_pos = pos_mm[:n]
        return self._win_sigs, self._win_pos


def _window_sigs23(codes: np.ndarray):
    """All valid 23-mer window signatures (forward strand) and positions."""
    n = codes.shape[0]
    if n < 23:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    bad = (codes == 255).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(bad)])
    valid = (cum[23:] - cum[:-23]) == 0
    pos = np.flatnonzero(valid)
    wins = codes[pos[:, None] + np.arange(23)[None, :]]
    return pack_lofirst(wins), pos


def variant_sigs(sigs: np.ndarray) -> np.ndarray:
    """(n, 8) uint64 signatures of the eight PAM variants per guide.

    Accepts 23-mer or 20-mer signatures (only the low 40 bits are used)."""
    base20 = np.asarray(sigs, dtype=np.uint64) & np.uint64((1 << 40) - 1)
    out = np.empty((base20.shape[0], 8), dtype=np.uint64)
    for k, (b20, b21, b22) in enumerate(PAM_VARIANTS):
        pam = (np.uint64(b20) << np.uint64(40)) | (np.uint64(b21) << np.uint64(42)) \
            | (np.uint64(b22) << np.uint64(44))
        out[:, k] = base20 | pam
    return out


def rc_sig23(sigs: np.ndarray) -> np.ndarray:
    """Reverse complement of packed 23-mer signatures."""
    out = np.zeros_like(sigs)
    for j in range(23):
        base = (sigs >> np.uint64(2 * j)) & np.uint64(3)
        out |= (base ^ np.uint64(3)) << np.uint64(2 * (22 - j))
    return out


NOPOS = np.iinfo(np.int64).max


def window_range(win_sigs: np.ndarray, win_pos: np.ndarray,
                 keys: np.ndarray):
    """Sorted-window-index range lookup shared by the positioning stage,
    the best-alignment search, and the bowtie2 shim (utils/shims.py) —
    one implementation so the pipeline and the shim cannot diverge.

    Returns ``(count, first_pos)`` per key; ``first_pos`` is NOPOS for
    keys with no window."""
    if win_sigs.size == 0:
        return (np.zeros(keys.shape, np.int64),
                np.full(keys.shape, NOPOS, np.int64))
    lo = np.searchsorted(win_sigs, keys, side="left")
    hi = np.searchsorted(win_sigs, keys, side="right")
    cnt = hi - lo
    first = np.where(
        cnt > 0, win_pos[np.minimum(lo, win_pos.shape[0] - 1)], NOPOS)
    return cnt, first


def best_alignment(reads: np.ndarray, genome: GenomeIndex,
                   max_mm: int = 2) -> np.ndarray:
    """Deterministic Bowtie2-style best alignment of 23-mer reads.

    Returns ``(pos, dist)``: the flat genomic position of each read's
    best alignment — fewest mismatches first (up to ``max_mm``), lowest
    position among equals, both strands — or (int64.max, -1) when
    unaligned.
    """
    n = reads.shape[0]
    win_sigs, win_pos = genome.window_index()
    best = np.full(n, NOPOS, dtype=np.int64)
    best_d = np.full(n, -1, dtype=np.int64)
    if win_sigs.size == 0 or n == 0:
        return best, best_d

    def min_pos(keys2d):
        """(m, K) keys -> per-row min window position over keys + rc."""
        m, K = keys2d.shape
        flat = keys2d.reshape(-1)
        allk = np.concatenate([flat, rc_sig23(flat)])
        _, first = window_range(win_sigs, win_pos, allk)
        return np.minimum(first[: m * K], first[m * K:]) \
            .reshape(m, K).min(axis=1)

    unresolved = np.arange(n)
    shifts = np.uint64(2) * np.arange(23, dtype=np.uint64)
    # dist-2 expands each read to 253*16 keys (~32 KB with rc): bound the
    # per-call allocation by processing unresolved reads in chunks
    READ_CHUNK = 2048
    for dist in range(max_mm + 1):
        if unresolved.size == 0:
            break
        pos_parts = []
        for c0 in range(0, unresolved.size, READ_CHUNK):
            pos_parts.append(_dist_keys_min_pos(
                reads[unresolved[c0:c0 + READ_CHUNK]], dist, shifts,
                min_pos))
        pos = np.concatenate(pos_parts)
        hit = pos != NOPOS
        best[unresolved[hit]] = pos[hit]
        best_d[unresolved[hit]] = dist
        unresolved = unresolved[~hit]
    return best, best_d


def _dist_keys_min_pos(sub, dist, shifts, min_pos):
    """All exact-``dist`` substitution keys of ``sub`` -> per-read min
    window position (via ``min_pos``)."""
    if dist == 0:
        keys = sub[:, None]
    elif dist == 1:
        # all single-position substitutions (originals included: they
        # cannot hit, or the read would have resolved at dist-1)
        keys = ((sub[:, None, None]
                 & ~(np.uint64(3) << shifts[None, :, None]))
                | (np.arange(4, dtype=np.uint64)[None, None, :]
                   << shifts[None, :, None])).reshape(sub.shape[0], -1)
    else:
        p1, p2 = np.triu_indices(23, k=1)
        b = np.arange(4, dtype=np.uint64)
        bb1 = np.repeat(b, 4)
        bb2 = np.tile(b, 4)
        cleared = (sub[:, None, None]
                   & ~(np.uint64(3) << shifts[p1])[None, :, None]
                   & ~(np.uint64(3) << shifts[p2])[None, :, None])
        keys = (cleared
                | (bb1[None, None, :] << shifts[p1][None, :, None])
                | (bb2[None, None, :] << shifts[p2][None, :, None])
                ).reshape(sub.shape[0], -1)
    return min_pos(keys)


def position_guides(
    guide_sigs23: np.ndarray,
    genome: GenomeIndex,
    chunk: int = 1 << 22,
):
    """Positioning of guides against a genome (Bowtie2-stage equivalent).

    Returns ``(passed, chrom, start, end)`` where ``passed`` is the
    Bowtie2-stage verdict (True == accepted: at most one perfect hit
    across the 8 PAM variants), and chrom/start/end are the AGG-variant
    read's best-alignment coordinates ('*', 0, 22 when unaligned) — see
    the module docstring for the exact emulation policy.
    """
    n = guide_sigs23.shape[0]
    variants = variant_sigs(guide_sigs23)              # (n, 8)
    flat = variants.reshape(-1)
    rc_flat = rc_sig23(flat)

    win_sigs, win_pos = genome.window_index(chunk)

    # forward-match key and the key a reverse-strand hit shows
    c_fwd, _ = window_range(win_sigs, win_pos, flat)
    c_rc, _ = window_range(win_sigs, win_pos, rc_flat)
    counts = (c_fwd + c_rc).reshape(n, 8)
    nb = np.minimum(counts, 2).sum(axis=1)
    passed = nb <= 1

    # coordinates: the AGG-variant read's best alignment (SAM line i of
    # the reference's 8-line block, Crackling.py:670-689)
    best, _ = best_alignment(variants[:, 0], genome)
    any_hit = best != NOPOS
    chrom = np.array(["*"] * n, dtype=object)
    start = np.zeros(n, dtype=np.int64)
    if any_hit.any():
        rec, pos1 = genome.locate(best[any_hit])
        chrom[any_hit] = [genome.names[r] for r in rec]
        start[any_hit] = pos1
    end = start + 22
    return passed, chrom, start, end
