#!/usr/bin/env python3
"""Variants of the full-scan kernels, timed side by side on a GPU.

    python3 fullscan_variants.py [--other TREE] [name ...]

Each variant is a copy of ``crackling_tpu_torch/csrc/`` with a few text
substitutions in ``fullscan.cu`` or in ``mma_screen.cuh``, which holds
the kernels' bucket loop (``VARIANTS``); ``--other TREE`` adds the
``fullscan.cu`` of another tree (an unpacked ``git archive`` of another
commit, e.g. the parent, in a directory that ``.gitignore`` lists) as the
build ``other``. All are built with nvcc for sm_90a into
``crackling_tpu_torch/_build/variants/`` (``finder_variants.py``'s
builder, at once) and loaded with ctypes beside each other: their C entry
points share one signature. On the
27 Mbp operating point of ``chip_smoke.py`` (its cached dataset) every
build runs ``dense_scan`` on the 65,536-query page and ``bucket_scan`` on
the first 8,192-query page, in turns (the list, then the list reversed),
timed with CUDA events (mean of 3 launches). The unchanged kernel and
``other`` are held to the plain version (``FULLSCAN_RTOL`` /
``FULLSCAN_ATOL``); the other variants are compared with the kernel, and
those that change the hit test on purpose (``no_candidates``) are expected
to differ. One JSON line per build (its ``ptxas`` report) and per kernel
(times), with the card's name and power limit. Needs one CUDA GPU and
nvcc.

The variants isolate what bounds the kernels: the candidate path (the
exact re-test and the scoring of the hits), one more ``mma.sync`` per
tile, loading two batches ahead, and two blocks per SM for the bucket
scan's K = 64 instance (the kernel takes three).
"""

from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs
from finder_variants import OUT, build_variant, compile_lib

_FS, _MS = "fullscan.cu", "mma_screen.cuh"
_VOTE = "if (__any_sync(kFull, or_tree<NT>(d) < 0)) {"
_ACC = "        mma_acc(d[i], a[1], bf[i][2], bf[i][3]);\n"
_NXT = """  unsigned long long nxt[2];
  auto load = [&](int bt) {
    const int r = bt * kStreamBatch + lane;
    nxt[0] = r < k.len ? k.entry(__ldg(k.bucket + r)) : 0ull;
    nxt[1] = r + 32 < k.len ? k.entry(__ldg(k.bucket + r + 32)) : 0ull;
  };"""
_FIRST = """  if (bt < nb) load(bt);
"""
_NEXT = """    if (bt + kStreamWarps < nb) load(bt + kStreamWarps);"""
# each variant a list of (file, old, new)
VARIANTS = {
    "kernel": [],
    # the vote never fires: the products, the OR fold and the vote without
    # the exact re-test and the scoring of the candidates (sums differ)
    "no_candidates": [(_MS, _VOTE, _VOTE.replace("< 0", "< -100000"))],
    # a third mma.sync per (m-tile, n-tile) at K = 64, on a zero operand
    # pair: the marginal cost of an mma.sync
    "three_mma": [(_MS, _ACC,
                   _ACC + "        mma_acc(d[i], a[1], 0u, 0u);\n")],
    # each lane loads its entries two batches ahead in place of one
    "prefetch2": [
        (_MS, _NXT, _NXT.replace("nxt[2];", "nxt[2], far[2];")
         .replace("(int bt)", "(unsigned long long (&dst)[2], int bt)")
         .replace("    nxt[", "    dst[")),
        (_MS, _FIRST, "  if (bt < nb) load(nxt, bt);\n"
                      "  if (bt + kStreamWarps < nb) "
                      "load(far, bt + kStreamWarps);\n"),
        (_MS, _NEXT, "    nxt[0] = far[0];\n    nxt[1] = far[1];\n"
                     "    if (bt + 2 * kStreamWarps < nb) "
                     "load(far, bt + 2 * kStreamWarps);")],
    # the bucket scan's K = 64 instance at two blocks per SM
    "blocks2": [(_FS, "__launch_bounds__(kThreads, KS == 2 ? 3 : 2)",
                 "__launch_bounds__(kThreads, 2)")],
}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the variants run on a GPU")
    from crackling_tpu_torch.ops import fullscan as fs

    other = None
    if argv[:1] == ["--other"]:
        other, argv = Path(argv[1]).resolve(), argv[2:]
    names = argv or list(VARIANTS)
    names = ["kernel"] + [n for n in names if n != "kernel"]
    OUT.mkdir(parents=True, exist_ok=True)
    # (source, include directory) of each build
    sources = {}
    for n in names:
        src = build_variant(f"fullscan_{n}", _FS, VARIANTS[n])
        sources[n] = (src, src.parent)
    if other is not None:
        names.append("other")
        csrc = other / "crackling_tpu_torch" / "csrc"
        sources["other"] = (csrc / _FS, csrc)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(
            lambda n: (n,) + compile_lib(f"fullscan_{n}", *sources[n])[1:],
            names))
    libs = {}
    for name, lib, ptxas in built:
        cs.emit({"variant": name, "source": str(sources[name][0]),
                 "ptxas": ptxas})
        libs[name] = ctypes.CDLL(str(lib))
        fs._bind(libs[name])

    card = cs.card_line()
    index, queries, _ = cs.bench_dataset()
    dense, scan = cs.fullscan_engines(index, "cuda")
    q, qsp = cs.dense_inputs(dense, queries)
    dargs = (dense.entries, dense.occ, dense.bucket_offsets,
             dense.bucket_lens, q, qsp)
    dkw = dict(max_dist=dense.max_dist, tabs=dense.tables)
    page = scan.query_tensor(queries[:scan.query_page])
    sargs = (scan.entries, scan.occ, scan.bucket_offsets, scan.bucket_lens,
             page, *scan.plan(page))
    skw = dict(slice_width=index.slice_width, max_dist=scan.max_dist,
               tabs=scan.tables)
    runs = {"dense_scan": (lambda: fs.dense_scan(*dargs, **dkw),
                           lambda: fs.dense_scan_plain(*dargs, **dkw),
                           int(q.numel())),
            "bucket_scan": (lambda: fs.bucket_scan(*sargs, **skw),
                            lambda: fs.bucket_scan_plain(*sargs, **skw),
                            int(page.numel()))}
    try:
        for kernel, (run, plain, n) in runs.items():
            want = plain()
            got = {}
            for name in names:
                # the wrapper launches this build
                fs.KERNEL._lib = libs[name]
                got[name] = run()
            cs.sync("cuda")
            for name in ("kernel", "other"):
                if name in got:
                    cs.check_sums(f"{kernel} ({name})", got[name], want)
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                fs.KERNEL._lib = libs[name]
                ms[name].append(cs.timed_ms(run, 3, "cuda"))
            for name in names:
                cs.emit({"card": card, "kernel": kernel, "queries": n,
                         "variant": name, "ms": ms[name],
                         "sums_equal_to_kernel": all(
                             torch.allclose(a, b, rtol=cs.FULLSCAN_RTOL,
                                            atol=cs.FULLSCAN_ATOL)
                             for a, b in zip(got[name], got["kernel"]))})
    finally:
        fs.KERNEL._lib = None


if __name__ == "__main__":
    main(sys.argv[1:])
