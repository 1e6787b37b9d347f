"""Consensus efficiency scorers as batched array ops.

Replaces the reference's per-guide Python loops (Crackling.py:310-598) with
vectorized predicates over 2-bit-packed 23-mer target signatures
(position j at bits 2j..2j+1; 46 bits used).

All functions take/return numpy arrays and are written with the jnp-compatible
subset of numpy so they can be jitted on device via ``jax.numpy`` when fused
into the TPU pipeline step (consumed by pipeline/run.py's batch stages).
"""

from __future__ import annotations

import json
from functools import lru_cache
from importlib import resources

import numpy as np


def _base_at(sigs: np.ndarray, pos: int) -> np.ndarray:
    return (sigs >> np.uint64(2 * pos)) & np.uint64(3)


def g20_pass(sigs23: np.ndarray) -> np.ndarray:
    """CHOPCHOP G20 rule: accept iff position 20 (index 19) is G
    (reference Crackling.py:316)."""
    return _base_at(sigs23, 19) == 2


def leading_t_trailing_a_pass(sigs23: np.ndarray) -> np.ndarray:
    """mm10db: reject targets ending GG that start with T, or starting CC
    that end with A (reference Crackling.py:334-335). Accept otherwise."""
    ends_gg = (_base_at(sigs23, 21) == 2) & (_base_at(sigs23, 22) == 2)
    starts_cc = (_base_at(sigs23, 0) == 1) & (_base_at(sigs23, 1) == 1)
    lead_t = _base_at(sigs23, 0) == 3
    trail_a = _base_at(sigs23, 22) == 0
    return ~((ends_gg & lead_t) | (starts_cc & trail_a))


def at_percentages(sigs23: np.ndarray) -> np.ndarray:
    """AT% of the first 20 nt (reference Crackling.py:354 via
    Helpers.AT_percentage): 100 * count / 20."""
    count = np.zeros(sigs23.shape, dtype=np.float64)
    for p in range(20):
        b = _base_at(sigs23, p)
        count += ((b == 0) | (b == 3)).astype(np.float64)
    return 100.0 * count / 20.0


def at_percent_pass(at: np.ndarray) -> np.ndarray:
    """mm10db AT% gate: reject if < 20 or > 65 (reference Crackling.py:356)."""
    return ~((at < 20) | (at > 65))


def tttt_pass(sigs23: np.ndarray) -> np.ndarray:
    """mm10db: reject targets containing TTTT anywhere in the 23-mer
    (reference Crackling.py:377)."""
    has = np.zeros(sigs23.shape, dtype=bool)
    for start in range(20):
        window = np.ones(sigs23.shape, dtype=bool)
        for p in range(start, start + 4):
            window &= _base_at(sigs23, p) == 3
        has |= window
    return ~has


@lru_cache(maxsize=1)
def sgrnascorer2_model() -> tuple[np.ndarray, float]:
    """(weights (20, 4), intercept) of the shipped linear SVM.

    Channel order follows the reference one-hot encoding
    (Crackling.py:545-550): string '0001' for A means channels are
    [G, T, C, A] — channel index 0 fires for G, 1 for T, 2 for C, 3 for A.
    """
    with resources.files("crackling_tpu_torch.data").joinpath(
        "sgrnascorer2_model.json"
    ).open() as fp:
        d = json.load(fp)
    return np.asarray(d["weights"], dtype=np.float64).reshape(20, 4), float(d["intercept"])


# Map 2-bit base code -> one-hot channel index of the reference encoding:
# A(0)->3, C(1)->2, G(2)->0, T(3)->1.
_CODE_TO_CHANNEL = np.array([3, 2, 0, 1], dtype=np.int64)


def sgrnascorer2_scores(sigs23: np.ndarray) -> np.ndarray:
    """Linear-SVM decision values for the first 20 nt
    (reference Crackling.py:556-567). One weight gathered per position —
    equivalent to the 80-dim one-hot dot product."""
    w, b = sgrnascorer2_model()
    score = np.full(sigs23.shape, b, dtype=np.float64)
    for p in range(20):
        code = _base_at(sigs23, p).astype(np.int64)
        score = score + w[p][_CODE_TO_CHANNEL[code]]
    return score


def consensus_counts(accepted_mm10db, accepted_sgrnascorer, passed_g20) -> np.ndarray:
    """consensusCount = number of accepting tools (reference
    Crackling.py:587-591). Inputs are boolean arrays (True == accepted)."""
    return (
        accepted_mm10db.astype(np.int64)
        + accepted_sgrnascorer.astype(np.int64)
        + passed_g20.astype(np.int64)
    )
