"""The control of a cell's check: the plain reference put in the program's
place, with every per-hit term rounded to bfloat16 (the step below the
configuration's float32 terms), judged by the same comparison at the
cell's own size. It must come out not correct.

    python3 gpu_bench/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line per seed: the control's compared numbers beside the
cell's limits. The control needs no window: it answers each sampled
guide once, as a batch of the window would.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from gpu_bench import check, guard, spec  # noqa: E402
from gpu_bench.genome import make_genome  # noqa: E402
from gpu_bench.harness import REF_BLOCK, ROOT, streams  # noqa: E402
from gpu_bench.reference import offtarget  # noqa: E402
from gpu_bench.traffic import make_traffic  # noqa: E402


def control_numbers(cell: spec.Cell, seed: int, device: str) -> dict:
    """The reference's and the control's answers for the cell's sampled
    guides at ``seed``, compared as a run compares the program's."""
    cfg = cell.config
    g_genome, g_traffic = streams(seed, 2)
    codes = torch.from_numpy(make_genome(g_genome, int(cfg["genome_bp"])))
    codes = codes.to(device)
    traffic = make_traffic(cell.traffic, cfg, codes, g_traffic)
    sites = offtarget.site_table(codes)
    kw = dict(max_dist=int(cfg["max_distance"]),
              threshold=float(cfg["score_threshold"]), method=cfg["method"],
              block_elems=REF_BLOCK[torch.device(device).type])
    queries = traffic.queries[traffic.sample]
    exp = offtarget.expected_scores(queries, sites, **kw)
    ctl = offtarget.expected_scores(queries, sites,
                                    terms_dtype=torch.bfloat16, **kw)
    numbers = check.compare(traffic.sample, ctl.full_mit, ctl.full_cfd,
                            traffic.sample, exp,
                            float(cfg["score_threshold"]), cfg["method"])
    return {"seed": seed, "guides": int(traffic.sample.shape[0]),
            "hits": exp.hits,
            "checks": check.judge(numbers, cfg["limits"]),
            "correct": check.correct(check.judge(numbers, cfg["limits"]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.find_cell(ROOT, args.workload)
    try:
        guard.check_cards(int(cell.workload["chips"]))
    except guard.RunRefused as e:
        print(f"[gpu_bench] refused: {e}", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_numbers(cell, seed, "cuda")
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
