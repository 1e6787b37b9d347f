"""BENCHMARK.json against the contract's shape, and each cell's files
found by name."""

import json
import re

import pytest

from conftest import ROOT
from gpu_bench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TEXT = re.compile(r"[^\n\t]{1,200}\Z")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpu_bench"]
    assert BENCH["command"] == ["python3", "gpu_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)


def test_metrics_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = spec.find_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.per_layer}, w["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(ROOT, metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert path.parent == spec.bench_dir(ROOT) / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert (spec.bench_dir(ROOT) / cfg["reference"]).is_file()
    assert set(cfg["limits"]) == {"missing", "verdict_mismatches",
                                  "score_gap"}


def test_new_cell_and_metric_are_files_and_entries(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries (the ``tiny_root`` fixture) run with no edit."""
    from gpu_bench.harness import main

    cell = spec.find_cell(tiny_root, "tiny.small")
    assert cell.config["genome_bp"] == 60_000
    assert "batches_in_window" in {m["name"] for m in cell.per_layer}
    assert main(["--workload", "tiny.small", "--seed", "5", "--seconds",
                 "0.5", "--trace", "1"], root=tiny_root, device="cpu") == 0
