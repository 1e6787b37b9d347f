"""A whole run on the CPU (the harness's look for a card skipped) with the
timed path broken underneath: each fault the bulk cells can have must
turn ``correct`` false, and the unbroken path must read true."""

import json

import numpy as np
import pytest

from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
from gpu_bench.harness import run_cell


def stale(score_sums):
    """A call that returns the previous call's answers: the scorer's state
    left as it was."""
    last = {}

    def broken(self, sigs):
        out = score_sums(self, sigs)
        prev = last.get("out")
        last["out"] = out
        if prev is not None and prev[0].shape == out[0].shape:
            return prev
        return out

    return broken


def half_left_out(score_sums):
    """Only the first half of each batch scored; the rest left at 0."""
    def broken(self, sigs):
        mit, cfd = score_sums(self, sigs[: len(sigs) // 2])
        out = [np.zeros(len(sigs)), np.zeros(len(sigs))]
        out[0][: mit.shape[0]], out[1][: cfd.shape[0]] = mit, cfd
        return out[0], out[1]

    return broken


def altered(score_sums):
    """Each answer altered where it is produced: a CFD sum off by 0.01."""
    def broken(self, sigs):
        mit, cfd = score_sums(self, sigs)
        return mit, cfd + 0.01

    return broken


@pytest.mark.parametrize("fault", [None, stale, half_left_out, altered],
                         ids=["sound", "stale", "half", "altered"])
def test_fault_turns_correct_false(fault, tiny_root, monkeypatch):
    if fault is not None:
        monkeypatch.setattr(CompactIsslScorer, "score_sums",
                            fault(CompactIsslScorer.score_sums))
    result, checks = run_cell(tiny_root, "tiny.small", 2**31 + 11, 0.5,
                              False, 0.0, device="cpu")
    json.dumps(result)
    assert result["correct"] is (fault is None), checks
    assert list(result)[-1] == "checks"
