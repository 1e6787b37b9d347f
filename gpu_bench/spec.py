"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<configuration>.<traffic>`` reads ``configs/<configuration>.json``
and ``traffic/<traffic>.json``; a per-layer metric ``<metric>`` is read by
``metrics/<metric>.py``, whose ``read(run)`` returns a number or ``None``
(nothing to read in this run).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = "gpu_bench"


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def bench_dir(root: Path) -> Path:
    return Path(root) / BENCH


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str) -> Cell:
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    here = bench_dir(root)
    config = json.loads((here / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name, w, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(root: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpu_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
