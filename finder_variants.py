#!/usr/bin/env python3
"""Variants of the packed compact finder kernel, timed side by side on a GPU.

    python3 finder_variants.py [name ...]

Each variant is ``crackling_tpu_torch/csrc/compact_finder.cu`` with a few
text substitutions (``VARIANTS``), built with nvcc for sm_90a into
``crackling_tpu_torch/_build/variants/`` (all at once) and loaded with
ctypes beside the others. On the 27 Mbp operating point of
``chip_smoke.py`` (its cached dataset) every variant runs on the same
65,536-query and 4,096-query pages, in turns (the list, then the list
reversed), timed with CUDA events. The unchanged kernel is held to the
plain version in every cell; the others are compared with it, and those
that change the hit test on purpose (``no_candidates``) are expected to
differ. One JSON line per variant and page, with the card's name and power
limit. Needs one CUDA GPU and nvcc.

The variants isolate what bounds the kernel: the candidate path, one more
``mma.sync`` per tile, the block size and occupancy, and one instance
(NT = 8) in place of one per live n-tile count.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "crackling_tpu_torch" / "csrc"
OUT = ROOT / "crackling_tpu_torch" / "_build" / "variants"

_VOTE = "if (__any_sync(kFull, or_tree<NT>(d) < 0)) {"
_ACC = "          mma_acc(d[i], a[1], bf[i][2], bf[i][3]);\n"
_WARPS = "constexpr int kWarps = 8;"
_BOUNDS = "__launch_bounds__(kThreads, 2)"
VARIANTS = {
    "kernel": [],
    # the vote never fires: the products and the OR fold without the
    # exact test of the candidates (cells differ)
    "no_candidates": [(_VOTE, _VOTE.replace("< 0", "< -100000"))],
    # a third mma.sync per (m-tile, n-tile), on a zero operand pair: the
    # marginal cost of an mma.sync
    "three_mma": [(_ACC,
                   _ACC + "          mma_acc(d[i], a[1], 0u, 0u);\n")],
    "warps4": [(_WARPS, "constexpr int kWarps = 4;"),
               (_BOUNDS, "__launch_bounds__(kThreads, 4)")],
    "warps16": [(_WARPS, "constexpr int kWarps = 16;"),
                (_BOUNDS, "__launch_bounds__(kThreads, 1)")],
    "blocks3": [(_BOUNDS, "__launch_bounds__(kThreads, 3)")],
    # every block with a live slot runs the NT = 8 instance
    "nt8_only": [("  switch (nt) {\n", "  switch (nt > 0 ? 8 : 0) {\n")],
}


def build(name: str, subs) -> tuple[str, Path, list[str]]:
    src = (CSRC / "compact_finder.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(src)
    lib = OUT / f"lib{name}.so"
    nvcc = "/usr/local/cuda/bin/nvcc"
    res = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
         f"-I{CSRC}", "-o", str(lib), str(path)],
        capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"variant {name} did not build:\n{res.stderr}")
    return name, lib, [ln.strip() for ln in res.stderr.splitlines()
                       if "registers" in ln or "spill" in ln]


def load(lib: Path):
    from crackling_tpu_torch.ops.compact_finder import _bind

    handle = ctypes.CDLL(str(lib))
    _bind(handle)
    return handle


def main(names):
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the variants run on a GPU")
    from crackling_tpu_torch.ops.compact_finder import (
        alloc_out, compact_finder_plain, superchunk_cells)
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    OUT.mkdir(parents=True, exist_ok=True)
    names = names or list(VARIANTS)
    if names[0] != "kernel":
        names = ["kernel"] + [n for n in names if n != "kernel"]
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: build(n, VARIANTS[n]), names))
    libs = {}
    for name, lib, ptxas in built:
        cs.emit({"variant": name, "ptxas": ptxas})
        libs[name] = load(lib)

    card = cs.card_line()
    index, queries, _ = cs.bench_dataset()
    sc = CompactIsslScorer(index, max_dist=4, device="cuda")
    for size in (cs.N_QUERIES, cs.SMALL_PAGE):
        q, qsp = cs.finder_inputs(sc, queries[:size])
        S, B, qb = qsp.shape
        nsc = superchunk_cells(sc._nchmax, sc.superchunk)
        kw = dict(chunk=sc.chunk, nchmax=sc._nchmax,
                  superchunk=sc.superchunk, max_dist=sc.max_dist)

        def run(lib):
            out = alloc_out(S, B, qb, sc._nchmax, nsc, q.device)
            rc = lib.crackling_compact_finder(
                sc.entries.data_ptr(), sc.entries.shape[1],
                sc.bucket_offsets.data_ptr(), sc.bucket_lens.data_ptr(),
                q.data_ptr(), qsp.data_ptr(), S, B, qb, q.numel(), sc.chunk,
                sc._nchmax, sc.superchunk, nsc, sc.max_dist,
                out.cnt.data_ptr(), out.rsum.data_ptr(), out.rmin.data_ptr(),
                out.rmax.data_ptr(), 0,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                cs.fail(f"variant launch failed: CUDA error {rc}")
            return out

        ref = run(libs["kernel"])
        want = compact_finder_plain(sc.entries, sc.bucket_offsets,
                                    sc.bucket_lens, q, qsp, **kw)
        cs.sync("cuda")
        cs.finder_diff("the kernel disagrees with its plain version", ref,
                       want)
        ms = {}
        for name in names + names[::-1]:
            ms.setdefault(name, []).append(
                cs.timed_ms(lambda: run(libs[name]), 3, "cuda"))
        for name in names:
            got = run(libs[name])
            cs.sync("cuda")
            cs.emit({"card": card, "queries": size, "qb": qb,
                     "variant": name, "ms": ms[name],
                     "cells_equal_to_kernel": all(
                         torch.equal(a, b) for a, b in zip(got[:4],
                                                           ref[:4]))})


if __name__ == "__main__":
    main(sys.argv[1:])
