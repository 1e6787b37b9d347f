#!/usr/bin/env python3
"""The compact decode and rescan of this tree and another, timed in turns.

    python3 compact_turns.py --other TREE [--turns N]

TREE is another commit's tree (e.g. the parent's, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists). Both packages have
one name, so each run is a process of its own that imports one tree's
``crackling_tpu_torch`` and this tree's ``chip_smoke.py`` helpers. On
``chip_smoke.py``'s 65,536-query page of the 27 Mbp operating point (its
cached dataset, built when absent) a run tunes the scorer's rows cap on the
page, then times with CUDA events: steps 1-2 (``decode_tree``: the decode
kernel and the wrapper's fills, queued back to back), the rescan on the
list the tree's own decode gives (the L2 flushed before each launch, and
warm), and steps 1-3 (``decode``); it prints the list's live rows and
its runs of rows sharing a chunk, and profiles one call of steps 1-2 and
the rescan (the kernels by name with their device time). The runs go
other, this, this, other, ``N`` times over (default 1), each printing one
JSON line with the card's name and power limit. Needs one CUDA GPU and
nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def time_tree(tree: Path) -> None:
    """One run: ``tree``'s package on the page (module docstring)."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import torch

    import crackling_tpu_torch
    from crackling_tpu_torch.ops.compact_rescan import compact_rescan
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script times kernels on a GPU")
    pkg = Path(crackling_tpu_torch.__file__).resolve()
    if tree.resolve() not in pkg.parents:
        cs.fail(f"imported {pkg}, not the package of {tree}")
    dev = "cuda"
    index, queries, _ = cs.bench_dataset()
    scorer = CompactIsslScorer(index, max_dist=4, device=dev)
    scorer.score_sums(queries)                 # the first page tunes the cap
    q, qsp = cs.finder_inputs(scorer, queries)
    fo = scorer.finder(q, qsp)
    rows = scorer.decode_tree(q, qsp, fo).rows
    n = q.numel()
    sums = cs.zero_sums(n, dev)
    opts = cs.rescan_options(scorer, n)

    def rescan():
        compact_rescan(rows, *cs.rescan_lists(scorer), *sums, **opts)

    live = int(((rows.ridx >= 0) & (rows.hq < n)).sum())
    cs.emit({"tree": str(tree), "card": cs.card_line(),
             "cap_rescan": scorer.cap_rescan, "rescan_rows": rows.ridx.numel(),
             "rescan_live_rows": live,
             "rescan_runs": cs.chunk_runs(rows, n)[0],
             "decode_ms": cs.queued_ms(
                 lambda: scorer.decode_tree(q, qsp, fo), 20, dev),
             "rescan_flushed_ms": cs.flushed_ms(rescan, 20, dev),
             "rescan_warm_ms": cs.queued_ms(rescan, 20, dev),
             "steps_1_3_ms": cs.queued_ms(
                 lambda: scorer.decode(q, qsp, fo), 20, dev)})

    def steps():
        scorer.decode_tree(q, qsp, fo)
        rescan()

    cs.phase_profile(dev, steps, "compact.")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="the other tree (e.g. the parent's)")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time is not None:
        time_tree(args.time)
        return 0
    if args.other is None or not (args.other / "crackling_tpu_torch").is_dir():
        ap.error("--other must name a tree that holds crackling_tpu_torch/")
    for _ in range(args.turns):
        for tree in (args.other, ROOT, ROOT, args.other):
            res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                  "--time", str(tree.resolve())],
                                 cwd=str(ROOT), text=True,
                                 capture_output=True)
            sys.stdout.write(res.stdout)
            sys.stderr.write(res.stderr[-4000:])
            if res.returncode != 0:
                print(f"compact_turns: the run of {tree} failed "
                      f"({res.returncode})", file=sys.stderr)
                return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
