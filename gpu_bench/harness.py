"""One run of one cell: set-up, the measured window, an optional traced
window, the reference's check, and the result line.

Set-up makes the genome and the traffic from the seed in memory, builds
the port's index and scorer, and warms the mix's first batches and the
exact re-scorer. The window then calls the scorer on batch after
batch, closed loop, one caller, for ``--seconds``: ``guides_per_s`` is
every guide answered over the window's whole time (the window ends with
the batch that passes ``--seconds``). ``--trace 1`` instead reports the
per-layer metrics: the window runs with the probes of
``system.instrument`` on, and then the first ``trace_guides`` guides of
the first batch are scored again, as one call, under the profiler.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, devtrace, guard, spec, system
from .genome import genome_bytes, make_genome
from .reference import offtarget
from .roofline import slice_counts
from .traffic import make_traffic

ROOT = Path(__file__).resolve().parent.parent
# the reference's one-hot products, in elements per block
REF_BLOCK = {"cuda": 1 << 32, "cpu": 1 << 24}


def log(msg: str) -> None:
    print(f"[gpu_bench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="gpu_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def streams(seed: int, n: int):
    """``n`` independent generators from the seed (any whole number)."""
    seq = np.random.SeedSequence(seed & ((1 << 128) - 1))
    return [np.random.default_rng(s) for s in seq.spawn(n)]


@dataclass
class RunRecord:
    """What the per-layer readers (``metrics/<name>.py``) read."""
    window: dict            # new_tally()'s counts over the window
    probe: dict             # system.Probe counts over the window
    trace: devtrace.DeviceTrace | None
    trace_pages: list       # (page, qb) of each page the traced window ran
    system: system.System

    def page_counts(self):
        """Per traced page: (queries on the device, (S, B) query counts,
        qb, n)."""
        S, B = self.system.bucket_lens.shape
        for page, qb in self.trace_pages:
            q = self.system.query_tensor(page)
            yield q, slice_counts(q, S, B), qb, q.numel()


def run_batches(sysm, traffic, answers, count: int | None,
                seconds: float | None, tally: dict) -> None:
    """Call the scorer on the batches in turn from the first: ``count`` of
    them, or until ``seconds`` have passed."""
    nb = len(traffic.batches)
    b = 0
    pages = sysm.pages_run
    t0 = last = time.perf_counter()
    while True:
        lo, hi = traffic.batches[b % nb]
        mit, cfd = sysm.score(traffic.queries[lo:hi])
        answers.record(lo, hi, mit, cfd)
        tally["batches"] += 1
        tally["guides"] += hi - lo
        tally["rescored"] += sysm.rescored()
        b += 1
        now = time.perf_counter()
        tally["batch_s"].append(now - last)
        last = now
        if count is not None and b >= count:
            break
        if seconds is not None and now - t0 >= seconds:
            break
    tally["seconds"] += time.perf_counter() - t0
    tally["pages"] += sysm.pages_run - pages


def new_tally() -> dict:
    return dict(batches=0, guides=0, rescored=0, pages=0, seconds=0.0,
                batch_s=[])


def trace_call(sysm, traffic, answers) -> None:
    """The traced run's call: the first ``trace_guides`` guides of the
    first batch."""
    lo, hi = traffic.batches[0]
    hi = min(hi, lo + traffic.trace_guides)
    mit, cfd = sysm.score(traffic.queries[lo:hi])
    answers.record(lo, hi, mit, cfd)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str | None = None):
    """One run; returns (result line, checks). ``device`` None means the
    card, checked first; tests pass ``cpu``."""
    t_start = time.perf_counter()
    cell = spec.find_cell(root, name)
    cfg = cell.config
    if device is None:
        guard.check_cards(int(cell.workload["chips"]))
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # -- set-up ----------------------------------------------------------
    g_genome, g_traffic = streams(seed, 2)
    codes = make_genome(g_genome, int(cfg["genome_bp"]))
    codes_t = torch.from_numpy(codes).to(dev)
    t_genome = time.perf_counter()
    traffic = make_traffic(cell.traffic, cfg, codes_t, g_traffic)
    t_data = time.perf_counter()
    sysm = system.build(genome_bytes(codes), cfg, dev)
    t_build = time.perf_counter()
    warm = new_tally()
    run_batches(sysm, traffic, check.Answers(traffic),
                traffic.warmup_batches, None, warm)
    t_warm = time.perf_counter()
    sysm.warm_exact(traffic.queries[:2])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    guard.check_no_jax("end of set-up")
    setup_s = time.perf_counter() - t0
    log(f"{name}: set-up {setup_s:.3f} s (imports {t_start - t0:.3f}, "
        f"card and genome {t_genome - t_start:.3f}, traffic "
        f"{t_data - t_genome:.3f}, index and scorer "
        f"{t_build - t_data:.3f}, warm batches {t_warm - t_build:.3f} "
        f"with {warm['pages']} pages, exact re-scorer "
        f"{t0 + setup_s - t_warm:.3f}); {traffic.queries.shape[0]:,} "
        f"guides in {len(traffic.batches)} batches; "
        f"{sysm.index.num_sites:,} sites")

    # -- the window --------------------------------------------------------
    answers = check.Answers(traffic)
    tally = new_tally()
    record = None
    if not trace:
        run_batches(sysm, traffic, answers, None, seconds, tally)
    else:
        probe = system.Probe()
        with system.instrument(sysm, probe):
            run_batches(sysm, traffic, answers, None, seconds, tally)
            window_probe = probe.snapshot()
            probe.page_log = []
            dtrace = devtrace.traced(
                lambda: trace_call(sysm, traffic, answers), dev)
        record = RunRecord(dict(tally), window_probe, dtrace, probe.page_log,
                           sysm)
    bs = np.asarray(tally["batch_s"])
    log(f"{name}: window {tally['seconds']:.3f} s, {tally['batches']} "
        f"batches, {tally['guides']:,} guides, {tally['rescored']} "
        f"re-scored, {tally['pages']} pages; batch s min "
        f"{bs.min():.4f} median {np.median(bs):.4f} max {bs.max():.4f}")
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    if not trace:
        metrics = {"guides_per_s": tally["guides"] / tally["seconds"],
                   "setup_s": setup_s}
        metrics = {m["name"]: {"value": metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(root, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the check, with the program's state freed -------------------------
    sysm.close()
    record = sysm = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    guard.check_no_jax("after the window")
    t = time.perf_counter()
    sites = offtarget.site_table(codes_t)
    exp = offtarget.expected_scores(
        traffic.queries[traffic.sample], sites,
        max_dist=int(cfg["max_distance"]),
        threshold=float(cfg["score_threshold"]), method=cfg["method"],
        block_elems=REF_BLOCK[dev.type])
    pos, mit, cfd = answers.arrays()
    numbers = check.compare(pos, mit, cfd, traffic.sample, exp,
                            float(cfg["score_threshold"]), cfg["method"],
                            answers.missing)
    checks = check.judge(numbers, cfg["limits"])
    log(f"{name}: reference {time.perf_counter() - t:.3f} s over "
        f"{traffic.sample.shape[0]:,} guides ({exp.hits:,} hits), "
        f"{pos.shape[0]:,} answers checked")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if dev.type == "cuda":
        device_info["power_limit"] = guard.power_limit()
    result = {"correct": check.correct(checks),
              "attempted": answers.attempted, "failed": numbers["missing"],
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        result["breakdown"] = dtrace.breakdown()
    result["checks"] = checks
    return result, checks


def main(argv=None, t0: float | None = None, root: Path | None = None,
         device: str | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    try:
        result, checks = run_cell(root or ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace), t0, device)
    except guard.RunRefused as e:
        log(f"refused: {e}")
        return 2
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
