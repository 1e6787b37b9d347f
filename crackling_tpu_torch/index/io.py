"""(De)serialization of ISSL indexes.

Two formats:

* the **reference binary format** (layout documented at
  /root/reference/src/ISSL/isslCreateIndex.cpp:256-289 and parsed at
  isslScoreOfftargets.cpp:145-243): header of six u64, then
  (mask u64, score f64) precalculated MIT pairs in ascending mask order
  (std::map order), then distinct site signatures, then sliceCount×2^w
  bucket sizes, then the flat bucket contents as ``occurrences<<32 | id``.
  Our writer is byte-compatible so reference-built and our-built indexes are
  interchangeable (and byte-identical given the same input);

* a **native .npz format** storing the dataclass fields directly — faster to
  load, and the basis for sharded multi-host layouts;

* a **native directory format** (any ``save_native`` path not ending in
  ``.npz``): one ``.npy`` per field plus ``meta.json``, loaded with
  ``np.load(..., mmap_mode="r")``. Opening is O(1) — arrays page in on
  first touch — so genome-scale indexes (the compressed-npz decompress
  of a 1.5 GB mouse-scale index costs minutes) start scoring
  immediately and never need 2x RAM for the decompress staging.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops.tables import precalculated_mit_scores
from .build import IsslIndex

_HEADER_FIELDS = 6


def write_reference_issl(index: IsslIndex, path: str) -> None:
    """Serialize in the reference's .issl binary layout (byte-compatible)."""
    n = index.num_sites
    scores = precalculated_mit_scores(index.seq_length, index.max_dist)
    with open(path, "wb") as fp:
        header = np.array(
            [n, index.seq_length, index.seq_count, index.slice_width,
             index.slice_count, len(scores)],
            dtype=np.uint64,
        )
        header.tofile(fp)
        # interleaved (u64 mask, f64 score) pairs, ascending mask order
        pairs = np.empty(len(scores) * 2, dtype=np.uint64)
        pairs[0::2] = np.fromiter(scores.keys(), dtype=np.uint64, count=len(scores))
        pairs[1::2] = np.array(list(scores.values()), dtype=np.float64).view(np.uint64)
        pairs.tofile(fp)
        index.site_sigs.astype(np.uint64).tofile(fp)
        sizes = np.diff(index.bucket_offsets, axis=1).astype(np.uint64)
        sizes.tofile(fp)
        occ = index.occurrences.astype(np.uint64)
        ids = np.arange(n, dtype=np.uint64)
        entries = (occ << np.uint64(32)) | ids
        for s in range(index.slice_count):
            entries[index.order[s]].tofile(fp)


def read_reference_issl(path: str):
    """Parse a reference-format .issl file.

    Returns ``(index, precalc_scores)`` where ``precalc_scores`` is the
    mask->score dict stored in the file (useful for cross-validation).
    The CSR is rebuilt from the stored bucket sizes/contents rather than
    recomputed, preserving the file's exact list order.
    """
    with open(path, "rb") as fp:
        header = np.fromfile(fp, dtype=np.uint64, count=_HEADER_FIELDS)
        n, seq_length, seq_count, slice_width, slice_count, scores_count = (
            int(x) for x in header
        )
        pairs = np.fromfile(fp, dtype=np.uint64, count=scores_count * 2)
        masks = pairs[0::2]
        scores = pairs[1::2].view(np.float64)
        site_sigs = np.fromfile(fp, dtype=np.uint64, count=n)
        bucket_count = 1 << slice_width
        sizes = np.fromfile(fp, dtype=np.uint64, count=slice_count * bucket_count)
        sizes = sizes.reshape(slice_count, bucket_count).astype(np.int64)
        total_entries = int(sizes.sum())
        flat = np.fromfile(fp, dtype=np.uint64, count=total_entries)
    offsets = np.zeros((slice_count, bucket_count + 1), dtype=np.int64)
    np.cumsum(sizes, axis=1, out=offsets[:, 1:])
    order = np.empty((slice_count, n), dtype=np.int32)
    occurrences = np.zeros(n, dtype=np.uint32)
    pos = 0
    for s in range(slice_count):
        chunk = flat[pos:pos + n]
        ids = (chunk & np.uint64(0xFFFFFFFF)).astype(np.int64)
        occurrences[ids] = (chunk >> np.uint64(32)).astype(np.uint32)
        order[s] = ids.astype(np.int32)
        pos += n
    index = IsslIndex(
        seq_length=seq_length,
        slice_width=slice_width,
        seq_count=seq_count,
        site_sigs=site_sigs,
        occurrences=occurrences,
        order=order,
        bucket_offsets=offsets,
    )
    return index, dict(zip((int(m) for m in masks), (float(s) for s in scores)))


_DIR_ARRAYS = ("site_sigs", "occurrences", "order", "bucket_offsets")


def save_native(index: IsslIndex, path: str) -> None:
    """Save in a native layout: ``*.npz`` -> compressed single file;
    any other path -> memmap-friendly directory (one .npy per field)."""
    if path.endswith(".npz"):
        np.savez_compressed(
            path,
            seq_length=np.int64(index.seq_length),
            slice_width=np.int64(index.slice_width),
            seq_count=np.int64(index.seq_count),
            site_sigs=index.site_sigs,
            occurrences=index.occurrences,
            order=index.order,
            bucket_offsets=index.bucket_offsets,
        )
        return
    os.makedirs(path, exist_ok=True)
    meta = dict(format="crackling_tpu-issl-dir", version=1,
                seq_length=int(index.seq_length),
                slice_width=int(index.slice_width),
                seq_count=int(index.seq_count))
    for name in _DIR_ARRAYS:
        np.save(os.path.join(path, name + ".npy"), getattr(index, name))
    with open(os.path.join(path, "meta.json"), "w") as fp:
        json.dump(meta, fp)


def load_native(path: str) -> IsslIndex:
    if os.path.isdir(path):
        with open(os.path.join(path, "meta.json")) as fp:
            meta = json.load(fp)
        arrs = {name: np.load(os.path.join(path, name + ".npy"),
                              mmap_mode="r")
                for name in _DIR_ARRAYS}
        return IsslIndex(
            seq_length=meta["seq_length"],
            slice_width=meta["slice_width"],
            seq_count=meta["seq_count"],
            **arrs,
        )
    with np.load(path) as z:
        return IsslIndex(
            seq_length=int(z["seq_length"]),
            slice_width=int(z["slice_width"]),
            seq_count=int(z["seq_count"]),
            site_sigs=z["site_sigs"],
            occurrences=z["occurrences"],
            order=z["order"],
            bucket_offsets=z["bucket_offsets"],
        )
