#!/usr/bin/env python3
"""GPU smoke run of the PyTorch package (crackling_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` (PATH or /usr/local/cuda/bin) and ``g++``.
Phases, each fatal on failure:

1. build the kernel library (nvcc, sm_90a) and the native host library
   (g++) from the package's sources, in parallel; print the card;
2. hold the compact finder kernel against its plain PyTorch version,
   cell for cell (exact), on a small index, a skewed index whose deep
   bucket turns the superchunk level on, and 16 buckets of the full page;
3. score one 65,536-query page at the 27 Mbp operating point (synthetic
   genome, seed 20260816, cached under .cache/chip_smoke/): time the
   finder and the decode with CUDA events and the page with the host
   clock; check a 2,048-query sample against the exact host scorer
   (sums within rtol 1e-4, hybrid verdicts identical for ``and``);
   then profile one warm page (device busy share, per-span device time);
4. the hybrid's verdicts for all five methods against ``score_exact``
   on the small index;
5. ``Crackling -c config.ini`` through its CLI entry point on the GPU,
   with the finder's launch counter reset just before and read just
   after (it must have launched; the plain finder must not have run);
6. print the kernels line and, last, the device line.

The first, uncached run also builds the 27 Mbp dataset (~17 s of host
work on an 8-core H100 host); ``CHIP_SMOKE_GENOME_MBP`` /
``CHIP_SMOKE_QUERIES`` shrink it for a quicker look.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / ".cache" / "chip_smoke"
GENOME_MBP = int(os.environ.get("CHIP_SMOKE_GENOME_MBP", "27"))
N_QUERIES = int(os.environ.get("CHIP_SMOKE_QUERIES", "65536"))
SEED = 20260816
H100_BYTES_PER_S = 3.35e12
# the published float32 rate outside the tensor cores: the peak table's
# only rate for scalar 32-bit ALU work
H100_ALU_OPS_PER_S = 67e12
# 32-bit integer operations per (slot, entry) pair of the finder's hit
# test: 2 xor, 2 shift, 2 or, 2 and (pair collapse), 2 popc, add, compare
FINDER_OPS_PER_PAIR = 12


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def timed_ms(fn, reps, dev):
    """Mean ms per call: CUDA events on the GPU, the host clock else."""
    import torch

    fn()
    sync(dev)
    if torch.device(dev).type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# -- inputs ---------------------------------------------------------------


def small_world(seed=11):
    """tests/test_compact.py's small index: random sites, mutated
    neighbours, hot duplicated sites; queries with self-hits, neighbours,
    absent sequences and duplicates (padding slots everywhere)."""
    from crackling_tpu_torch.index import build_index

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 40, size=600).astype(np.uint64)
    mut = []
    for sig in base[:150]:
        pos = rng.integers(0, 20)
        mut.append((np.uint64(sig) & ~(np.uint64(3) << np.uint64(2 * pos)))
                   | (np.uint64(rng.integers(0, 4)) << np.uint64(2 * pos)))
    hot = np.repeat(base[:4], 64)
    index = build_index(np.concatenate([base, np.array(mut, np.uint64),
                                        hot]))
    queries = np.concatenate([
        base[:16], rng.integers(0, 1 << 40, 8).astype(np.uint64),
        np.repeat(base[3:5], 4)])
    return index, queries


def skewed_world(seed=23, n_deep=70_000):
    """~70K sites share one slice-0 value (one bucket deeper than 64
    chunks at chunk=1024), with clustered variants so deep chunks hold
    several hits."""
    from crackling_tpu_torch.index import build_index

    rng = np.random.default_rng(seed)

    def pin(sigs):
        return (sigs & ~np.uint64(0xFF)) | np.uint64(0x55)

    base = pin(rng.integers(0, 1 << 40, size=64).astype(np.uint64))
    variants = []
    for sig in base:
        for _ in range(32):
            v = int(sig)
            for pos in rng.integers(4, 20, size=int(rng.integers(1, 4))):
                v = (v & ~(3 << (2 * int(pos)))) | (int(rng.integers(0, 4))
                                                    << (2 * int(pos)))
            variants.append(v)
    deep = pin(rng.integers(0, 1 << 40, size=n_deep).astype(np.uint64))
    filler = rng.integers(0, 1 << 40, size=5000).astype(np.uint64)
    index = build_index(np.concatenate(
        [base, np.array(variants, np.uint64), deep, filler]))
    queries = np.concatenate([base, filler[:64],
                              rng.integers(0, 1 << 40, 64).astype(np.uint64)])
    return index, queries


def bench_dataset():
    """The 27 Mbp operating point (bench.py's genome, index and queries),
    built once and cached: index .npz, .issl, queries, genome FASTA and
    a ~200 kbp exon FASTA."""
    from crackling_tpu_torch.codec import sigs_to_strings
    from crackling_tpu_torch.index import (build_index, load_native,
                                           save_native, write_reference_issl)
    from crackling_tpu_torch.index.extract import (extract_offtarget_sites_seq,
                                                   find_candidate_guides_seq)

    tag = f"g{GENOME_MBP}m"
    d = CACHE / tag
    files = dict(npz=d / "index.npz", issl=d / "index.issl",
                 queries=d / f"queries{N_QUERIES}.npy",
                 genome=d / "genome.fa", exons=d / "exons.fa")
    if all(p.exists() for p in files.values()):
        return load_native(str(files["npz"])), np.load(files["queries"]), files
    d.mkdir(parents=True, exist_ok=True)
    t = time.time()
    rng = np.random.default_rng(SEED)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                        size=GENOME_MBP * 1_000_000).tobytes()
    sites = extract_offtarget_sites_seq(genome, to_upper=False)
    index = build_index(sites, seq_length=20, slice_width=8)
    save_native(index, str(files["npz"]))
    write_reference_issl(index, str(files["issl"]))
    _, _, cand = find_candidate_guides_seq(
        genome[:min(len(genome), 8 * N_QUERIES * 30)])
    queries = np.unique(cand & np.uint64((1 << 40) - 1))
    rng.shuffle(queries)
    queries = queries[:N_QUERIES]
    if queries.shape[0] < N_QUERIES:
        fail(f"only {queries.shape[0]} candidate queries")
    np.save(files["queries"], queries)
    text = genome.decode()
    with open(files["genome"], "w") as fp:
        fp.write(">chr1 synthetic\n")
        for i in range(0, len(text), 80):
            fp.write(text[i:i + 80] + "\n")
    ex0 = min(1_000_000, len(text) // 4)
    files["exons"].write_text(
        ">exon1\n" + text[ex0:ex0 + 200_000] + "\n")
    log(f"dataset {tag}: {index.num_sites:,} sites, {len(queries):,} "
        f"queries ({sigs_to_strings(queries[:1], 20)[0]}...), built in "
        f"{time.time() - t:.1f} s")
    return index, queries, files


# -- phases ---------------------------------------------------------------


def phase_build():
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops import compact_finder as cf

    with ThreadPoolExecutor(2) as ex:
        kern = ex.submit(cf.build_kernel_library)
        host = ex.submit(native.get_lib)
        lib_path = kern.result()
        if host.result() is None:
            fail("the native host library did not build (g++)")
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel_library": str(lib_path.name),
          "ptxas": ptxas})


def finder_inputs(scorer, queries, qb=None):
    """The finder's inputs for one page of ``queries`` on the scorer's
    device (the slot plan the scorer itself would make)."""
    from crackling_tpu_torch.ops.hybrid import plan_query_occupancy
    from crackling_tpu_torch.ops.issl_compact import plan_slots

    if qb is None:
        qb, _ = plan_query_occupancy(queries, scorer.S, scorer.B, 8,
                                     scorer.qb_cap)
    q = scorer.query_tensor(queries)
    return q, plan_slots(q, scorer.S, scorer.B, qb)


def compare_finder(scorer, q, qsp, blen=None):
    """Kernel vs plain version on the same device tensors; exact."""
    from crackling_tpu_torch.ops.compact_finder import (compact_finder,
                                                        compact_finder_plain)

    args = (scorer.entries, scorer.bucket_offsets,
            scorer.bucket_lens if blen is None else blen, q, qsp)
    kw = dict(chunk=scorer.chunk, nchmax=scorer._nchmax,
              superchunk=scorer.superchunk, max_dist=scorer.max_dist)
    got = compact_finder(*args, **kw)
    want = compact_finder_plain(*args, **kw)
    sync(q.device)
    err = 0
    for name, a, b in zip(("cnt", "rsum", "rmin", "rmax"), got[:4],
                          want[:4]):
        diff = int((a.long() - b.long()).abs().max())
        err = max(err, diff)
        if diff:
            fail(f"finder kernel disagrees with its plain version on {name}"
                 f" ({int((a != b).sum())} cells)")
    return err, int(want.cnt[:, :, -1].sum())


def phase_kernel_vs_plain(dev, bench_scorer, bench_queries):
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    errs = []
    index, queries = small_world()
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    e, hits = compare_finder(sc, *finder_inputs(sc, queries))
    errs.append(e)
    emit({"phase": "kernel_vs_plain", "input": "small", "hits": hits,
          "max_abs_err": e})

    index, queries = skewed_world()
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    if sc.superchunk <= 0:
        fail(f"skewed index did not turn the superchunk level on "
             f"(nchmax {sc._nchmax})")
    e, hits = compare_finder(sc, *finder_inputs(sc, queries))
    errs.append(e)
    emit({"phase": "kernel_vs_plain", "input": "skewed",
          "nchmax": sc._nchmax, "superchunk": sc.superchunk, "hits": hits,
          "max_abs_err": e})

    # 8 buckets each of slices 0 and 4 of the full page: other buckets
    # are given length 0, so both versions skip them
    q, qsp = finder_inputs(bench_scorer, bench_queries)
    blen = bench_scorer.bucket_lens.clone()
    keep = blen.new_zeros(blen.shape, dtype=bool)
    keep[0, 40:48] = True
    keep[-1, 200:208] = True
    blen[~keep] = 0
    e, hits = compare_finder(bench_scorer, q, qsp, blen)
    errs.append(e)
    emit({"phase": "kernel_vs_plain", "input": "bench page, 16 buckets",
          "qb": qsp.shape[2], "hits": hits, "max_abs_err": e})
    return max(errs)


def finder_bound_ms(scorer, q, qsp, C):
    """Least time for the finder's work on this page: the larger of its
    operations over the ALU peak and its bytes over HBM bandwidth."""
    n = q.numel()
    qcount = (qsp < n).sum(-1).long()
    blen = scorer.bucket_lens.long()
    pairs = int((blen * qcount).sum())
    S, B, qb = qsp.shape
    nbytes = (int(blen.sum()) * 8 + qsp.numel() * 4 + n * 8 + S * B * 12
              + S * B * C * qb * 20)
    t_ops = pairs * FINDER_OPS_PER_PAIR / H100_ALU_OPS_PER_S * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), pairs


def phase_scorer(dev, scorer, queries, card):
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.compact_finder import compact_finder_plain
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.pipeline.run import verdicts

    t = time.perf_counter()
    scorer.score_sums(queries)                 # first page: tunes the caps
    tune_s = time.perf_counter() - t
    mit_sum, cfd_sum = scorer.score_sums(queries)          # warm
    walls = []
    for _ in range(3):
        sync(dev)
        t = time.perf_counter()
        mit_sum, cfd_sum = scorer.score_sums(queries)
        walls.append(time.perf_counter() - t)
    q, qsp = finder_inputs(scorer, queries)
    fo = scorer.finder(q, qsp)
    C = fo.cnt.shape[2]
    finder_ms = timed_ms(lambda: scorer.finder(q, qsp), 3, dev)
    decode_ms = timed_ms(lambda: scorer.decode(q, qsp, fo), 3, dev)
    plan_ms = timed_ms(lambda: finder_inputs(scorer, queries), 3, dev)
    sync(dev)
    t = time.perf_counter()
    compact_finder_plain(scorer.entries, scorer.bucket_offsets,
                         scorer.bucket_lens, q, qsp, chunk=scorer.chunk,
                         nchmax=scorer._nchmax, superchunk=scorer.superchunk,
                         max_dist=scorer.max_dist)
    sync(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    bound_ms, bound_by, pairs = finder_bound_ms(scorer, q, qsp, C)

    # the sample against the exact host scorer (no early exit: raw sums)
    rng = np.random.default_rng(SEED + 1)
    pick = rng.choice(queries.shape[0], size=min(2048, queries.shape[0]),
                      replace=False)
    sample = queries[pick]
    ex = native.exact_score_native(scorer.index, sample, 4, None, "and")
    if ex is None:
        fail("native exact scorer unavailable")
    ex_sums = [10000.0 / s - 100.0 for s in ex]
    for name, got, want in (("mit", mit_sum[pick], ex_sums[0]),
                            ("cfd", cfd_sum[pick], ex_sums[1])):
        if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            bad = np.abs(got - want) / np.maximum(np.abs(want), 1e-4)
            fail(f"compact {name} sums disagree with the exact scorer "
                 f"(max rel err {bad.max():.3e})")
    rel_err = max(float((np.abs(g - w) / np.maximum(np.abs(w), 1e-4)).max())
                  for g, w in ((mit_sum[pick], ex_sums[0]),
                               (cfd_sum[pick], ex_sums[1])))
    hyb = HybridIsslScorer(scorer.index, max_dist=4, method="and",
                           threshold=75.0, dense=scorer)
    hm, hc = hyb.score(sample)
    em, ec = native.exact_score_native(scorer.index, sample, 4, 75.0, "and")
    if not np.array_equal(verdicts(hm, hc, 75.0, "and"),
                          verdicts(em, ec, 75.0, "and")):
        fail("hybrid verdicts differ from the exact scorer's (and, 75)")
    sync(dev)
    t = time.perf_counter()
    hyb.score(queries)
    hybrid_s = time.perf_counter() - t
    page_s = float(np.median(walls))
    emit({"phase": "scorer", "card": card, "device": str(dev),
          "sites": scorer.index.num_sites, "queries": int(queries.shape[0]),
          "qb": int(qsp.shape[2]), "nchmax": scorer._nchmax,
          "superchunk": scorer.superchunk, "pairs": pairs,
          "page_stats": list(scorer.page_stats[-1]),
          "caps": list(scorer._caps()), "tune_page_s": tune_s,
          "page_wall_s": walls, "plan_ms": plan_ms, "finder_ms": finder_ms,
          "decode_ms": decode_ms, "finder_plain_ms": plain_ms,
          "finder_bound_ms": bound_ms, "finder_bound_by": bound_by,
          "compact_guides_per_s": queries.shape[0] / page_s,
          "hybrid_page_s": hybrid_s,
          "hybrid_guides_per_s": queries.shape[0] / hybrid_s,
          "rescored": hyb.last_rescored,
          "sample_max_rel_err": rel_err})
    return dict(ms=finder_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_profile(dev, scorer, queries):
    """One warm page under torch.profiler: device busy time and idle
    share over the page's wall time, kernel launches, the device time of
    each span of the page program (compact.plan / compact.decode.*) and
    the torch ops that take the most device time (the finder kernel is
    timed on its own in phase 3)."""
    from torch.profiler import ProfilerActivity, profile

    scorer.score_sums(queries)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        scorer.score_sums(queries)
        sync(dev)
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else
                     ("device_time_total", "cuda_time_total")):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    # kernels on the device timeline; the spans' own device-side copies
    # (user annotations) would count their kernels twice
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("compact.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    avgs = prof.key_averages()
    spans = {e.key: dev_us(e, False) / 1e3 for e in avgs
             if e.key.startswith("compact.")}
    top = sorted(((dev_us(e, True) / 1e3, e.count, e.key[:60])
                  for e in avgs if dev_us(e, True) > 0
                  and e.key.startswith("aten::")), reverse=True)[:10]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "kernel_launches": len(kernels), "span_device_ms": spans,
          "top_ops_device_ms": [[k, c, ms] for ms, c, k in top]})


def phase_hybrid_methods(dev):
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.ops.oracle import score_exact
    from crackling_tpu_torch.pipeline.run import verdicts

    index, queries = small_world()
    res = {}
    for method, thr in (("mit", 80.0), ("cfd", 80.0), ("and", 75.0),
                        ("or", 75.0), ("avg", 90.0)):
        want = verdicts(*score_exact(index, queries, 4, thr, method), thr,
                        method)
        for band in (None, np.inf):
            hy = HybridIsslScorer(index, max_dist=4, method=method,
                                  threshold=thr, band=band, device=dev,
                                  chunk=1024)
            got = verdicts(*hy.score(queries), thr, method)
            if not np.array_equal(got, want):
                fail(f"hybrid verdicts differ from score_exact ({method})")
        res[method] = int(want.sum())
    emit({"phase": "hybrid_methods", "accepted": res})


def phase_pipeline(dev, files):
    from crackling_tpu_torch.constants import GUIDE_COLUMNS
    from crackling_tpu_torch.ops.compact_finder import (compact_finder,
                                                        compact_finder_plain)
    from crackling_tpu_torch.utils import cli

    out = CACHE / "pipeline_out"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg = out / "config.ini"
    cfg.write_text(f"""[general]
name = smoke
optimisation = high

[consensus]
n = 2
mm10db = True
sgrnascorer2 = True
chopchop = True

[input]
exon-sequences = {files['exons']}
offtarget-sites = {files['issl']}
gff-annotation =
bowtie2-index = {files['genome']}
batch-size = 5000000

[output]
dir = {out}
filename = guides.txt
delimiter = ,

[offtargetscore]
enabled = True
binary = unused
method = and
threads = 8
page-length = 5000000
score-threshold = 75
max-distance = 4

[sgrnascorer2]
model = shipped
score-threshold = 0

[bowtie2]
binary = unused
threads = 8
page-length = 5000000

[rnafold]
binary = unused-rnafold
threads = 8
page-length = 5000000
low_energy_threshold = -30
high_energy_threshold = -18

[tpu]
engine = auto
""")
    import torch

    on_gpu = torch.device(dev).type == "cuda"
    if on_gpu:
        os.environ.pop("CRACKLING_PLATFORM", None)
    else:
        os.environ["CRACKLING_PLATFORM"] = "cpu"
    # the main path's run: counts start at 0 just before, are read after
    compact_finder.launches = 0
    compact_finder_plain.calls = 0
    t = time.perf_counter()
    cli.main_crackling(["-c", str(cfg)])
    sync(dev)
    wall = time.perf_counter() - t
    launches = compact_finder.launches
    plain_calls = compact_finder_plain.calls
    if on_gpu:
        if launches <= 0:
            fail("Crackling ran without launching the finder kernel")
        if plain_calls:
            fail("the plain finder ran on the GPU path")
    import csv

    out_csv = out / "smoke-guides.txt"
    with open(out_csv) as fp:
        rows = list(csv.reader(fp))
    if rows[0] != GUIDE_COLUMNS or len(rows[0]) != 26:
        fail("pipeline CSV header is not the 26-column reference header")
    col = {c: i for i, c in enumerate(rows[0])}
    scored = [r for r in rows[1:]
              if r[col["mitOfftargetscore"]] not in ("?", "")]
    if not scored:
        fail("no guide reached off-target scoring")
    for r in scored:
        for c in ("mitOfftargetscore", "cfdOfftargetscore"):
            if not 0.0 < float(r[col[c]]) <= 100.0:
                fail(f"{c} out of (0, 100]: {r[col[c]]}")
    metrics = json.loads((out / "smoke-guides.txt.metrics.json").read_text())
    emit({"phase": "pipeline", "guides": len(rows) - 1,
          "scored": len(scored),
          "accepted": sum(r[col["passedOffTargetScore"]] == "1"
                          for r in scored),
          "finder_launches": launches, "plain_finder_calls": plain_calls,
          "wall_s": wall, "stage_seconds": metrics["stage_seconds"]})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import crackling_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the crackling_tpu_torch package is not beside this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    print(card, flush=True)
    t0 = time.time()

    phase_build()
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    index, queries, files = bench_dataset()
    scorer = CompactIsslScorer(index, max_dist=4, device=dev)
    max_err = phase_kernel_vs_plain(dev, scorer, queries)
    timing = phase_scorer(dev, scorer, queries, card)
    phase_profile(dev, scorer, queries)
    del scorer
    torch.cuda.empty_cache()
    phase_hybrid_methods(dev)
    launches = phase_pipeline(dev, files)
    log(f"all phases passed in {time.time() - t0:.1f} s")

    print(card, flush=True)
    emit({"kernels": [{
        "name": "compact_finder", "route": "cuda",
        "source": "crackling_tpu_torch/csrc/compact_finder.cu",
        "replaces": "crackling_tpu/ops/issl_compact.py:247",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
