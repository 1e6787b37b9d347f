"""Scoring tables: MIT local-score weights and CFD penalties (host, f64).

The MIT (Hsu et al. 2013, "zhang-lab") per-position weights and the closed
form of the local score replicate the reference's ``single_score`` /
``sscore`` (/root/reference/src/ISSL/isslCreateIndex.cpp:93-130) operation by
operation so that f64 results are bit-identical.

CFD penalties (Doench et al. 2016) are loaded from
``crackling_tpu_torch/data/cfd_penalties.json``; the table layout matches the
reference lookup ``cfdPosPenalties[pos<<4 | guide<<2 | comp(offtarget)]``
(isslScoreOfftargets.cpp:399-461).
"""

from __future__ import annotations

import json
from functools import lru_cache
from importlib import resources
from itertools import combinations

import numpy as np

# Per-position MIT mismatch weights (reference isslCreateIndex.cpp:96).
MIT_WEIGHTS = np.array(
    [0.0, 0.0, 0.014, 0.0, 0.0, 0.395, 0.317, 0.0, 0.389, 0.079,
     0.445, 0.508, 0.613, 0.851, 0.732, 0.828, 0.615, 0.804, 0.685, 0.583],
    dtype=np.float64,
)


@lru_cache(maxsize=1)
def _cfd_data() -> dict:
    with resources.files("crackling_tpu_torch.data").joinpath("cfd_penalties.json").open() as fp:
        return json.load(fp)


@lru_cache(maxsize=1)
def cfd_pos_penalties() -> np.ndarray:
    """(20, 16) f64: [position, guide_base<<2 | comp(offtarget_base)]."""
    arr = np.asarray(_cfd_data()["position_penalties"], dtype=np.float64)
    return arr.reshape(20, 16)


@lru_cache(maxsize=1)
def cfd_pam_penalties() -> np.ndarray:
    """(16,) f64 indexed by the last two PAM bases (b1<<2 | b2).

    The reference hard-codes PAM=NGG, i.e. index 0b1010 == 10
    (isslScoreOfftargets.cpp:411)."""
    return np.asarray(_cfd_data()["pam_penalties"], dtype=np.float64)


CFD_PAM_NGG_INDEX = 0b1010


def mit_local_score(mismatch_positions: np.ndarray) -> float:
    """MIT local score for one hit given ascending mismatch positions.

    Bit-exact replication of ``single_score``
    (isslCreateIndex.cpp:93-118): T1 multiplied in ascending position order,
    d = mean consecutive gap, T2 = 1/(((19-d)/19)*4+1), T3 = 1/m^2.
    """
    m = len(mismatch_positions)
    if m == 0:
        return 0.0
    t1 = 1.0
    for p in mismatch_positions:
        t1 = t1 * (1.0 - MIT_WEIGHTS[p])
    if m == 1:
        d = 19.0
    else:
        d = 0.0
        for i in range(m - 1):
            d += float(mismatch_positions[i + 1] - mismatch_positions[i])
        d = d / (m - 1)
    t2 = 1.0 / ((19.0 - d) / 19.0 * 4.0 + 1.0)
    t3 = 1.0 / (m * m)
    return t1 * t2 * t3 * 100.0


def mit_local_score_from_mask40(mask40: int) -> float:
    """MIT local score from the reference's 2-bit collapsed mismatch mask
    (bit ``2j`` set when position ``j`` mismatches), cf. ``sscore``
    (isslCreateIndex.cpp:120-130)."""
    positions = [j for j in range(20) if (mask40 >> (2 * j)) & 0x3]
    return mit_local_score(np.asarray(positions))


def precalculated_mit_scores(seq_length: int = 20, max_dist: int = 4) -> dict[int, float]:
    """All (mask40 -> local MIT score) pairs for 1..max_dist mismatches.

    Matches the set the reference index builder serializes
    (isslCreateIndex.cpp:239-252). Returned dict iterates in ascending mask
    order — the same order a ``std::map<uint64_t,double>`` serializes in.
    """
    out: dict[int, float] = {}
    for dist in range(1, max_dist + 1):
        for combo in combinations(range(seq_length), dist):
            mask = 0
            for p in combo:
                mask |= 1 << (2 * p)
            out[mask] = mit_local_score(np.asarray(combo))
    return dict(sorted(out.items()))


@lru_cache(maxsize=4)
def mit_dense_table(seq_length: int = 20, max_dist: int = 4) -> np.ndarray:
    """Dense f64 table of local MIT scores indexed by the *20-bit* mismatch
    mask (bit j set when position j mismatches). Entries with popcount
    outside 1..max_dist are 0 (they are filtered before lookup).

    Built vectorized for the 2^seq_length mask space (4 MB f32 / 8 MB f64
    for 20-mers) — the TPU scoring path gathers from the f32 cast of this.
    """
    n = 1 << seq_length
    masks = np.arange(n, dtype=np.uint64)
    bits = ((masks[:, None] >> np.arange(seq_length, dtype=np.uint64)) & 1).astype(np.float64)
    count = bits.sum(axis=1)
    pos = np.arange(seq_length, dtype=np.float64)
    first = np.where(bits.astype(bool), pos, np.inf).min(axis=1)
    last = np.where(bits.astype(bool), pos, -np.inf).max(axis=1)
    # T1 multiplied position-by-position in ascending order (vectorized over
    # masks, sequential over positions) so the f64 result is bit-identical to
    # the reference's sequential product — non-mismatch factors are exact 1.0.
    t1 = np.ones(n, dtype=np.float64)
    for j in range(seq_length):
        t1 = t1 * np.where(bits[:, j] != 0.0, 1.0 - MIT_WEIGHTS[j], 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.where(count == 1, 19.0, (last - first) / np.maximum(count - 1.0, 1.0))
        t2 = 1.0 / ((19.0 - d) / 19.0 * 4.0 + 1.0)
        t3 = 1.0 / np.maximum(count * count, 1.0)
    score = t1 * t2 * t3 * 100.0
    score[(count < 1) | (count > max_dist)] = 0.0
    return score


def mask40_to_mask20(mask40: np.ndarray) -> np.ndarray:
    """Collapse the reference's 2-bit-per-position mismatch mask (40-bit,
    ``01`` in mismatched slots) to a 20-bit one-bit-per-position mask."""
    mask40 = np.asarray(mask40, dtype=np.uint64)
    out = np.zeros_like(mask40)
    for j in range(20):
        bit = (mask40 >> np.uint64(2 * j)) & np.uint64(1)
        out |= bit << np.uint64(j)
    return out
