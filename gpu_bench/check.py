"""The comparison that decides ``correct``.

Every answer the window returned for a sampled guide (every batch, every
pass) is held to the reference's: the verdict must be the reference
binary's, and each score must lie within ``score_gap`` of one of the two
valid answers, the full scan or the binary's early exit (the hybrid
re-scores guides near the threshold exactly, and those the binary exits
on early report its partial sums). A sampled answer that is not a finite
number, and every answer of a call that returns the wrong number of
them, is missing.
"""

from __future__ import annotations

import numpy as np

from .reference.offtarget import Expected, accepted

NAMES = ("missing", "verdict_mismatches", "score_gap")


class Answers:
    """What the window's calls returned for the sampled guides."""

    def __init__(self, traffic):
        self.traffic = traffic
        self.pos, self.mit, self.cfd = [], [], []
        self.attempted = 0
        self.missing = 0

    def record(self, lo: int, hi: int, mit, cfd) -> None:
        """Keep the sampled guides' answers of one call (inside the window:
        a gather of the sample and nothing over the whole batch)."""
        n = hi - lo
        self.attempted += n
        if np.shape(mit) != (n,) or np.shape(cfd) != (n,):
            self.missing += n
            return
        p = self.traffic.sampled(lo, hi)
        self.pos.append(p)
        self.mit.append(mit[p - lo])
        self.cfd.append(cfd[p - lo])

    def arrays(self):
        if not self.pos:
            z = np.zeros(0)
            return z.astype(np.int64), z, z
        return (np.concatenate(self.pos), np.concatenate(self.mit),
                np.concatenate(self.cfd))


def compare(pos: np.ndarray, mit: np.ndarray, cfd: np.ndarray,
            sample: np.ndarray, exp: Expected, threshold: float,
            method: str, missing: int = 0) -> dict:
    """The compared numbers: ``pos`` are positions among the traffic's
    queries, ``sample`` the sorted positions ``exp`` was computed for."""
    i = np.searchsorted(sample, pos)
    with np.errstate(invalid="ignore"):
        full = np.maximum(np.abs(mit - exp.full_mit[i]),
                          np.abs(cfd - exp.full_cfd[i]))
        early = np.maximum(np.abs(mit - exp.exit_mit[i]),
                           np.abs(cfd - exp.exit_cfd[i]))
    finite = np.isfinite(mit) & np.isfinite(cfd)
    gap = np.where(np.isfinite(full) & np.isfinite(early),
                   np.minimum(full, early), np.inf)
    verdicts = accepted(mit, cfd, threshold, method)
    return {"missing": int(missing) + int((~finite).sum()),
            "verdict_mismatches": int((verdicts != exp.accepted[i]).sum()),
            "score_gap": float(gap.max()) if gap.size else 0.0}


def judge(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit, in a fixed order."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
