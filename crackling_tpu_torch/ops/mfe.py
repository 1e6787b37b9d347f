"""RNA sequence encoding for the MFE fold engines.

Only the host encoder lives here: the native C++ Zuker engine
(native/fold.cpp) takes its code arrays. The batched on-device fold DP
is not ported yet (the ``tpu`` fold backend of
pipeline/secondary_structure.py raises until it is).
"""

from __future__ import annotations

import numpy as np


def encode_rna(seq: str) -> np.ndarray:
    """RNA/DNA string -> codes (A=0, C=1, G=2, U/T=3)."""
    table = np.full(256, 255, dtype=np.uint8)
    for ch, c in zip("ACGUacgu", [0, 1, 2, 3, 0, 1, 2, 3]):
        table[ord(ch)] = c
    table[ord("T")] = 3
    table[ord("t")] = 3
    codes = table[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError(f"non-ACGU character in RNA sequence: {seq!r}")
    return codes
