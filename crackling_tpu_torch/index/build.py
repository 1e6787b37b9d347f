"""ISSL index construction (host numpy; device arrays for the TPU scorer).

Re-designs the reference index builder
(/root/reference/src/ISSL/isslCreateIndex.cpp:173-252) as vectorized
sort/unique/counting-sort passes:

* distinct sites and occurrence counts come from ``np.unique`` over the
  big-endian (lexicographic) packing, so site ids match the reference's
  sorted-text-file ids exactly;
* each slice's inverted lists become a CSR layout — a stable argsort of the
  slice values concatenated with per-bucket offsets. Stability preserves the
  reference's within-bucket id ordering (isslCreateIndex.cpp:218-234);
* the device layout is struct-of-arrays with the *site signature stored
  inline per list entry* (lo/hi int32 + occurrence count), so the TPU scorer
  streams contiguous memory instead of random-gathering signatures by id.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..codec import lex_to_lofirst, sig_split


@dataclass
class IsslIndex:
    """An in-memory ISSL index over distinct 20-mer off-target sites."""

    seq_length: int
    slice_width: int  # bits per slice (must be even; reference default 8)
    seq_count: int    # total sites pre-dedup (header parity field)
    site_sigs: np.ndarray     # uint64[N] low-first signatures, id order
    occurrences: np.ndarray   # uint32[N]
    # CSR per slice, filled by _build_slices:
    order: np.ndarray = field(default=None)           # int32[S, N]
    bucket_offsets: np.ndarray = field(default=None)  # int64[S, B+1]

    @property
    def slice_count(self) -> int:
        return (self.seq_length * 2) // self.slice_width

    @property
    def bucket_count(self) -> int:
        return 1 << self.slice_width

    @property
    def max_dist(self) -> int:
        """Default scoring distance bound: sliceCount - 1 guarantees every
        site within the bound shares at least one exact slice with the query
        (pigeonhole), cf. isslCreateIndex.cpp:241."""
        return self.slice_count - 1

    @property
    def num_sites(self) -> int:
        return int(self.site_sigs.shape[0])

    def __post_init__(self):
        if self.slice_width % 2 != 0:
            raise ValueError("slice width must be an even number of bits")
        if (self.seq_length * 2) % self.slice_width != 0:
            raise ValueError("2*seq_length must be divisible by slice width")
        if self.order is None:
            self._build_slices()

    def slice_values(self, sigs: np.ndarray) -> np.ndarray:
        """(S, n) slice values of low-first signatures."""
        s = np.arange(self.slice_count, dtype=np.uint64)
        shifts = (s * np.uint64(self.slice_width))[:, None]
        mask = np.uint64(self.bucket_count - 1)
        return ((np.asarray(sigs, dtype=np.uint64)[None, :] >> shifts) & mask)

    def _build_slices(self) -> None:
        from .. import native

        n = self.num_sites
        s_count, b_count = self.slice_count, self.bucket_count
        order = np.empty((s_count, n), dtype=np.int32)
        offsets = np.empty((s_count, b_count + 1), dtype=np.int64)
        for s in range(s_count):
            # the native counting sort gives numpy's stable argsort, in
            # parallel
            if native.bucket_order_native(self.site_sigs, s * self.slice_width,
                                          b_count, order[s], offsets[s]):
                continue
            shift = np.uint64(s * self.slice_width)
            mask = np.uint64(b_count - 1)
            # narrow to the smallest dtype before sorting: numpy radix-sorts
            # small ints, and the cast avoids (S, N) uint64 intermediates
            v = ((self.site_sigs >> shift) & mask).astype(
                np.uint8 if b_count <= 256 else np.uint16)
            order[s] = np.argsort(v, kind="stable").astype(np.int32)
            counts = np.bincount(v, minlength=b_count)
            offsets[s, 0] = 0
            np.cumsum(counts, out=offsets[s, 1:])
        self.order = order
        self.bucket_offsets = offsets

    # ------------------------------------------------------------------
    # Device layout
    # ------------------------------------------------------------------

    def device_arrays(self, pad_to: int | None = None) -> dict[str, np.ndarray]:
        """SoA arrays for the TPU scorer.

        Returns int32 arrays ``list_lo``/``list_hi``/``list_occ`` of shape
        (S, N') — per-slice bucket-sorted entries with the signature stored
        inline — and int32 ``bucket_offsets`` of shape (S, B+1). ``pad_to``
        pads the entry dimension (padding entries have occ == 0 and an
        impossible signature, so they never contribute)."""
        lo, hi = sig_split(self.site_sigs)
        occ = self.occurrences.astype(np.int64)
        n = self.num_sites
        npad = n if pad_to is None else int(pad_to)
        if npad < n:
            raise ValueError("pad_to smaller than the number of sites")
        s_count = self.slice_count
        list_lo = np.full((s_count, npad), -1, dtype=np.int32)
        list_hi = np.full((s_count, npad), -1, dtype=np.int32)
        list_occ = np.zeros((s_count, npad), dtype=np.int32)
        for s in range(s_count):
            o = self.order[s]
            list_lo[s, :n] = lo[o]
            list_hi[s, :n] = hi[o]
            list_occ[s, :n] = occ[o].astype(np.int32)
        return {
            "list_lo": list_lo,
            "list_hi": list_hi,
            "list_occ": list_occ,
            "bucket_offsets": self.bucket_offsets.astype(np.int32),
        }


    def device_arrays_aligned(self, align: int = 1024, tail: int = 0):
        """SoA arrays with every bucket start padded to an ``align`` multiple.

        Layout required by the Pallas kernel: DMA source offsets must be
        tile-aligned, so each (slice, bucket) list is placed at an aligned
        offset with dead padding (occ == 0, impossible signature) between
        buckets. Returns the same keys as :meth:`device_arrays` plus
        ``bucket_lens`` (true lengths); ``bucket_offsets`` are the aligned
        starts. ``tail`` adds extra dead entries at the end of each slice so
        fixed-size chunk DMAs never run past the allocation."""
        lo, hi = sig_split(self.site_sigs)
        occ = self.occurrences.astype(np.int32)
        s_count, b_count = self.slice_count, self.bucket_count
        lens = np.diff(self.bucket_offsets, axis=1)          # (S, B)
        alens = ((lens + align - 1) // align) * align
        npad = int(alens.sum(axis=1).max()) + max(tail, 0)
        npad = ((npad + align - 1) // align) * align
        list_lo = np.full((s_count, npad), -1, dtype=np.int32)
        list_hi = np.full((s_count, npad), -1, dtype=np.int32)
        list_occ = np.zeros((s_count, npad), dtype=np.int32)
        aoffs = np.zeros((s_count, b_count + 1), dtype=np.int64)
        np.cumsum(alens, axis=1, out=aoffs[:, 1:])
        for s in range(s_count):
            o = self.order[s]
            for b in range(b_count):
                src0, src1 = self.bucket_offsets[s, b], self.bucket_offsets[s, b + 1]
                ids = o[src0:src1]
                dst = aoffs[s, b]
                n = src1 - src0
                list_lo[s, dst:dst + n] = lo[ids]
                list_hi[s, dst:dst + n] = hi[ids]
                list_occ[s, dst:dst + n] = occ[ids]
        return {
            "list_lo": list_lo,
            "list_hi": list_hi,
            "list_occ": list_occ,
            "bucket_offsets": aoffs.astype(np.int32),
            "bucket_lens": lens.astype(np.int32),
        }


def build_index(
    site_sigs_with_dups: np.ndarray,
    seq_length: int = 20,
    slice_width: int = 8,
) -> IsslIndex:
    """Build an :class:`IsslIndex` from (possibly duplicated) site signatures.

    ``site_sigs_with_dups`` are low-first uint64 signatures. Sites are
    deduplicated with occurrence counts; ids are assigned in lexicographic
    (sorted-text-file) order for parity with the reference
    (isslCreateIndex.cpp:184-207).
    """
    sigs = np.asarray(site_sigs_with_dups, dtype=np.uint64)
    total = int(sigs.shape[0])
    # lexicographic order == numeric order of the bit-reversed (big-endian)
    # packing; sort numerically in lex space, then convert back.
    from .. import native

    lex = native.lex_convert_native(sigs, seq_length)
    if lex is None:
        lex = _lofirst_to_lex(sigs, seq_length)
    # sorted in place: ``lex`` is read again only where the lib is missing
    lex_sorted = native.sort_u64_native(lex)
    uc = (native.unique_counts_native(lex_sorted)
          if lex_sorted is not None else None)
    if uc is not None:
        uniq_lex, counts = uc
    else:
        uniq_lex, counts = np.unique(lex, return_counts=True)
    uniq = native.lex_convert_native(uniq_lex, seq_length)
    if uniq is None:
        uniq = lex_to_lofirst(uniq_lex, seq_length)
    return IsslIndex(
        seq_length=seq_length,
        slice_width=slice_width,
        seq_count=total,
        site_sigs=uniq,
        occurrences=counts.astype(np.uint32),
    )


def lex_to_lofirst_checked(lex: np.ndarray, length: int) -> np.ndarray:
    """lex -> low-first packing via the native lib, numpy fallback."""
    from .. import native

    out = native.lex_convert_native(lex, length)
    if out is None:
        out = lex_to_lofirst(lex, length)
    return out


def _lofirst_to_lex(sig: np.ndarray, length: int) -> np.ndarray:
    out = np.zeros_like(sig)
    for j in range(length):
        base = (sig >> np.uint64(2 * j)) & np.uint64(3)
        out |= base << np.uint64(2 * (length - 1 - j))
    return out
