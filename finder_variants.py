#!/usr/bin/env python3
"""Variants of the finder kernels, timed side by side on a GPU.

    python3 finder_variants.py [--other TREE] [KERNEL[:VARIANT,...] ...]

KERNEL is ``compact`` (``csrc/compact_finder.cu``, the packed compact
finder), ``onehot`` (``csrc/compact_onehot.cu``, the one-hot compact
finder) or ``mxu`` (``csrc/mxu_finder.cu``, the exact engine's neighbour
finder); with no KERNEL, all three with all their variants. Each variant
is a copy of ``crackling_tpu_torch/csrc/`` with a few text substitutions
in its sources or headers (``KERNELS``); ``--other TREE`` adds each
kernel's source as it is in another tree (an unpacked ``git archive`` of
another commit, e.g. the parent, in a directory that ``.gitignore``
lists) as the build ``other``. All are built with nvcc for sm_90a into
``crackling_tpu_torch/_build/variants/`` (at once) and loaded with ctypes
in turn behind the kernel's own wrapper: their C entry points share one
signature. On the 27 Mbp operating point of ``chip_smoke.py`` (its cached
dataset) every build runs on the kernel's two pages, in turns (the list,
then the list reversed), timed with CUDA events: the compact and the
one-hot finder on 65,536 and 4,096 queries, the neighbour finder on
32,768 queries and on 2 (the hybrid's re-score). The unchanged kernel and
``other`` are held to the plain version in every cell; the other variants
are compared with the kernel, and those that change the hit test on
purpose (``no_candidates``) are expected to differ. One JSON line per
build (its ``ptxas`` report) and per page and build (times), with the
card's name and power limit. Needs one CUDA GPU and nvcc.

The variants isolate what bounds the kernels: the candidate path (the
vote never fires), one more ``mma.sync`` per tile, the block size and
occupancy, and one instance (NT = 8) in place of one per live n-tile
count.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "crackling_tpu_torch" / "csrc"
OUT = ROOT / "crackling_tpu_torch" / "_build" / "variants"

_VOTE = "if (__any_sync(kFull, or_tree<NT>(d) < 0)) {"
_NO_VOTE = _VOTE.replace("< 0", "< -100000")
_ACC = "          mma_acc(d[i], a[1], bf[i][2], bf[i][3]);\n"
_WARPS = "constexpr int kWarps = 8;"
_BOUNDS = "__launch_bounds__(kThreads, 2)"
_CF = "compact_finder.cu"
_OH_MMA = """        mma_first(d[i], a[0], bf[i][0][0], bf[i][0][1]);
        mma_acc(d[i], a[1], bf[i][1][0], bf[i][1][1]);
"""
_OH_NO_MMA = """        d[i][0] = (int)((a[0][0] ^ bf[i][0][0]) & 0x7fffffffu);
        d[i][1] = (int)((a[1][1] ^ bf[i][1][1]) & 0x7fffffffu);
        d[i][2] = d[i][0];
        d[i][3] = d[i][1];
"""
# per kernel: its source and its variants, each a list of (file, old, new)
KERNELS = {
    "compact": (_CF, {
        "kernel": [],
        # the vote never fires: the products and the OR fold without the
        # exact test of the candidates (cells differ)
        "no_candidates": [(_CF, _VOTE, _NO_VOTE)],
        # a third mma.sync per (m-tile, n-tile), on a zero operand pair:
        # the marginal cost of an mma.sync
        "three_mma": [(_CF, _ACC,
                       _ACC + "          mma_acc(d[i], a[1], 0u, 0u);\n")],
        "warps4": [(_CF, _WARPS, "constexpr int kWarps = 4;"),
                   (_CF, _BOUNDS, "__launch_bounds__(kThreads, 4)")],
        "warps16": [(_CF, _WARPS, "constexpr int kWarps = 16;"),
                    (_CF, _BOUNDS, "__launch_bounds__(kThreads, 1)")],
        "blocks3": [(_CF, _BOUNDS, "__launch_bounds__(kThreads, 3)")],
        # every block with a live slot runs the NT = 8 instance
        "nt8_only": [(_CF, "  switch (nt) {\n",
                      "  switch (nt > 0 ? 8 : 0) {\n")],
    }),
    "onehot": ("compact_onehot.cu", {
        "kernel": [],
        "no_candidates": [("compact_onehot.cu", _VOTE, _NO_VOTE)],
        # the products replaced by a non-negative stand-in that keeps the
        # fragments live: the stream, ldmatrix, OR fold and vote alone
        "no_mma": [("compact_onehot.cu", _OH_MMA, _OH_NO_MMA)],
        # at most 4 n-tiles per warp (more warp columns, less reuse)
        "nt4": [("compact_onehot.cu", "/ wn > 8) wn *= 2;",
                 "/ wn > 4) wn *= 2;")],
        # a ring of three stages at every qb
        "stages3": [("compact_onehot.cu", "? 4 : 3;", "? 3 : 3;")],
    }),
    "mxu": ("mxu_finder.cu", {
        "kernel": [],
        # the vote of mma_screen.cuh's stream_bucket, which this build
        # alone sees changed
        "no_candidates": [("mma_screen.cuh", _VOTE, _NO_VOTE)],
    }),
}


def build_variant(tag: str, source: str, subs) -> Path:
    """A copy of csrc/ under OUT/tag with the substitutions ``subs`` (file,
    old, new) applied; returns the path of its ``source``."""
    d = OUT / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for name, old, new in subs:
        text = (d / name).read_text()
        if old not in text:
            cs.fail(f"variant {tag}: {old!r} is not in {name}")
        (d / name).write_text(text.replace(old, new))
    return d / source


def compile_lib(tag: str, source: Path, include: Path):
    """nvcc ``source`` for sm_90a into OUT/lib<tag>.so; returns (tag, the
    library, its ptxas lines by kernel)."""
    lib = OUT / f"lib{tag}.so"
    res = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode",
         "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas",
         "-v", "-shared", "-Xcompiler", "-fPIC", f"-I{include}", "-o",
         str(lib), str(source)],
        capture_output=True, text=True)
    if res.returncode:
        cs.fail(f"build {tag} did not compile:\n{res.stderr}")
    return tag, lib, cs.ptxas_by_kernel(res.stderr)


def pages(kernel: str):
    """The kernel's module and, per page, (queries, a launch through the
    wrapper, the plain version) on the card."""
    index, queries, _ = cs.bench_dataset()
    if kernel == "mxu":
        from crackling_tpu_torch.ops import mxu_finder as mod
        from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer

        eng = MxuIsslScorer(index, max_dist=4, device="cuda")
        out = []
        for size in (cs.MXU_PAGE, 2):
            q, qsp = cs.mxu_inputs(eng, queries[:size])
            args = (eng.entries, eng.bucket_offsets, eng.bucket_lens, q, qsp)
            kw = dict(segw=eng.segw, nseg=eng.nseg, max_dist=eng.max_dist,
                      seq_length=index.seq_length)
            out.append((size, lambda a=args, k=kw: mod.mxu_finder(*a, **k),
                        lambda a=args, k=kw: mod.mxu_finder_plain(*a, **k)))
        return mod, out
    from crackling_tpu_torch.ops import compact_finder as cf
    from crackling_tpu_torch.ops import compact_onehot as co

    sc = cs.onehot_scorer(index, "cuda")
    out = []
    for size in (cs.N_QUERIES, cs.SMALL_PAGE):
        q, qsp = cs.finder_inputs(sc, queries[:size])
        args, kw = cs.onehot_args(sc, q, qsp)
        if kernel == "onehot":
            out.append((size,
                        lambda a=args, k=kw: co.compact_finder_onehot(*a, **k),
                        lambda a=args, k=kw:
                        co.compact_finder_onehot_plain(*a, **k)))
        else:
            packed = (sc.entries,) + args[1:]
            out.append((size,
                        lambda a=packed, k=kw: cf.compact_finder(*a, **k),
                        lambda a=packed, k=kw:
                        cf.compact_finder_plain(*a, **k)))
    return (co if kernel == "onehot" else cf), out


def equal(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))


def run_kernel(kernel, names, other, card):
    source, variants = KERNELS[kernel]
    with ThreadPoolExecutor(len(names) + 1) as ex:
        jobs = [ex.submit(compile_lib, f"{kernel}_{n}",
                          build_variant(f"{kernel}_{n}", source,
                                        variants[n]), OUT / f"{kernel}_{n}")
                for n in names]
        if other is not None:
            csrc = other / "crackling_tpu_torch" / "csrc"
            jobs.append(ex.submit(compile_lib, f"{kernel}_other",
                                  csrc / source, csrc))
        built = [j.result() for j in jobs]
    builds = names + (["other"] if other is not None else [])
    mod, runs = pages(kernel)
    libs = {}
    for name, (tag, lib, ptxas) in zip(builds, built):
        cs.emit({"kernel": kernel, "variant": name, "ptxas": ptxas})
        libs[name] = ctypes.CDLL(str(lib))
        mod._bind(libs[name])
    try:
        for size, run, plain in runs:
            want = plain()
            got = {}
            for name in builds:
                mod.KERNEL._lib = libs[name]        # the wrapper runs it
                got[name] = run()
            cs.sync("cuda")
            for name in ("kernel", "other"):
                if name in got and not equal(got[name], want):
                    cs.fail(f"{kernel} ({name}) disagrees with its plain "
                            f"version on the {size}-query page")
            ms = {name: [] for name in builds}
            reps = 10 if size <= 2 else 3
            for name in builds + builds[::-1]:
                mod.KERNEL._lib = libs[name]
                ms[name].append(cs.timed_ms(run, reps, "cuda"))
            for name in builds:
                cs.emit({"card": card, "kernel": kernel, "queries": size,
                         "variant": name, "ms": ms[name],
                         "cells_equal_to_kernel": equal(got[name],
                                                        got["kernel"])})
    finally:
        mod.KERNEL._lib = None


def main(argv):
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the variants run on a GPU")
    other = None
    if argv[:1] == ["--other"]:
        other, argv = Path(argv[1]).resolve(), argv[2:]
    todo = {}
    for arg in argv or list(KERNELS):
        kernel, _, vs = arg.partition(":")
        names = vs.split(",") if vs else list(KERNELS[kernel][1])
        todo[kernel] = ["kernel"] + [n for n in names if n != "kernel"]
    OUT.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    for kernel, names in todo.items():
        run_kernel(kernel, names, other, card)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
