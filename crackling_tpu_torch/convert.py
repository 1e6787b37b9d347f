"""Hand an index over from the JAX package to this one.

The two packages share the ISSL index's state and nothing else: the
distinct site signatures, their occurrence counts and the per-slice CSR
layout. Scoring tables come from this package's own ``data/``. Index
files (``.issl``, ``.npz``) are interchangeable through ``index/io.py``.
"""

from __future__ import annotations

import numpy as np

from .index.build import IsslIndex


def index_from_arrays(d: dict[str, np.ndarray]) -> IsslIndex:
    """An :class:`IsslIndex` from the arrays of either package's index:
    ``seq_length``, ``slice_width``, ``seq_count`` (scalars or 0-d
    arrays), ``site_sigs`` (uint64), ``occurrences`` (uint32), ``order``
    (int32, (S, N)) and ``bucket_offsets`` (int64, (S, B+1))."""
    return IsslIndex(
        seq_length=int(d["seq_length"]),
        slice_width=int(d["slice_width"]),
        seq_count=int(d["seq_count"]),
        site_sigs=np.asarray(d["site_sigs"], dtype=np.uint64),
        occurrences=np.asarray(d["occurrences"], dtype=np.uint32),
        order=np.asarray(d["order"], dtype=np.int32),
        bucket_offsets=np.asarray(d["bucket_offsets"], dtype=np.int64),
    )
