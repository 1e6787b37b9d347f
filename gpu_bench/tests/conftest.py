"""CPU tests of the benchmark: ``python -m pytest gpu_bench/tests`` from
the root of the repository. Tests marked ``cuda`` run only on a card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a throwaway configuration and traffic mix small enough for the CPU: the
# yeast configuration at 60 kbp, on the compact engine by name (``auto``
# picks it on the card only), in batches of 3,000 guides
TINY_CONFIG = {"genome_bp": 60_000, "engine": "compact",
               "page_length": 3000}
TINY_TRAFFIC = {"check_sample": 600, "trace_guides": 2000}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout with the benchmark plus a cell ``tiny.small`` and a
    per-layer metric ``batches_in_window`` added as new files and new
    entries only."""
    shutil.copytree(ROOT / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "gpu_bench"
    cfg = json.loads((here / "configs" / "yeast-s288c.json").read_text())
    cfg.update(TINY_CONFIG, name="tiny")
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "bulk.json").read_text())
    mix.update(TINY_TRAFFIC, name="small")
    (here / "traffic" / "small.json").write_text(json.dumps(mix))
    (here / "metrics" / "batches_in_window.py").write_text(
        "def read(run):\n    return float(run.window['batches'])\n")
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "gpu_bench/configs/tiny.json",
                             "reduced": ["genome_bp"], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.small", "config": "tiny",
                               "traffic": "small", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.small")
    bench["per_layer"].append({
        "name": "batches_in_window", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "hybrid re-score",
        "moves": "guides_per_s", "workloads": ["tiny.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
