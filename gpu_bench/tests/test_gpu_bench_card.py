"""A short run of each cell on the card (``cuda`` marker; skips here).

    python -m pytest -p no:cacheprovider -m cuda gpu_bench/tests
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from gpu_bench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yeast-s288c.bulk", "fly-dm6.bulk"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    c = spec.find_cell(ROOT, cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < m["value"] <= 100
    assert res.stderr.strip().splitlines()[-1].startswith("check score_gap")
