#!/usr/bin/env python3
"""GPU smoke run of the PyTorch package (crackling_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` (PATH or /usr/local/cuda/bin) and ``g++``.
Phases, each fatal on failure:

1. build the six kernel libraries (nvcc, sm_90a: the compact finder,
   the one-hot compact finder, the neighbour finder, the full-scan
   scorers, the compact rescan and the compact decode) and the native
   host library (g++)
   from the package's sources, in parallel; print the card and each
   kernel's ``ptxas`` registers, shared memory and spills by kernel name;
2. hold the compact finder kernel (int8 tensor-core distance over one-hot
   rows built from the packed lists) against its plain PyTorch version,
   cell for cell (exact), on a small index (max-distance 4, 0 and 2, and
   a plan whose qb is not a multiple of 8), a skewed index whose deep
   bucket turns the superchunk level on, and 16 buckets of the full page
   (its own plan, and one whose qb is not a multiple of 8);
3. score one 65,536-query page at the 27 Mbp operating point (synthetic
   genome, seed 20260816, cached under .cache/chip_smoke/) with the
   compact engine: time the finder, the decode, its steps 1-2 alone (the
   decode kernel, one launch) and the rescan alone (on the page's own
   rescan list, at the tuned rows cap; with the 50 MB L2 flushed before each
   launch, and warm beside it) with CUDA events, the plain decode steps,
   the plain rescan and the page with the host clock; the decode kernel's
   and the rescan's bounds with their operations and bytes terms; check a
   2,048-query sample against the exact host scorer (sums within rtol
   1e-4, hybrid verdicts identical for ``and``); then profile one warm
   page (device busy share, per-span device time);
3b. hold the one-hot compact finder kernel (tensor-core int8 ``mma``) against
    its plain version, cell for cell (exact), on the small index
    (max-distance 4, 0 and 2, and a plan whose qb is not a multiple of
    8), the skewed index and 16 buckets of the 65,536-query page, then against
    the packed compact finder kernel on the whole page (every cell
    equal: two independent tensor-core designs, one over planes, one
    over packed words);
3c. the compact engine with the one-hot finder on a 65,536-query and a
    4,096-query page of the 27 Mbp index: the one-hot and the packed
    finder kernels timed in turns on the same page (CUDA events), both
    finders' bounds with their terms, the one-hot kernel's blocks per
    SM, the page wall time and guides/s with each finder, the planes'
    bytes and build time;
3d. the 65,536-query page with the sharded compact engine at 1, 2 and 4
    site-range shards listed on the one card: the compact finder, the
    compact decode and the compact rescan must each launch shards x pages
    times, with no plain version, and the sums must
    lie within rtol 1e-9 of the one-shard page's; page wall (host clock)
    and each shard's finder and decode (CUDA events) timed; at 4 shards a
    2,048-query sample within rtol 1e-4 of the exact sums, hybrid ``and``
    verdicts identical to native exact, and a profile of one warm page;
3e. (run before 3) hold the compact rescan kernel (the blocks of a run of
    rows sharing a chunk split it) against its plain version on the
    same row descriptors, per-query f64 sums within rtol 1e-12 / atol
    1e-9: every chunk of the small index's live slots as a row, with two
    padding rows and a row of query n (max-distance 4, 0 and 2), the
    skewed index's own rescan list (superchunk level on), the
    65,536-query page's (grouped by chunk) and a shuffled copy of it; each
    prints its rows, live rows, runs and errors;
3f. (run before 3) hold the compact decode kernel (steps 1-2) against its
    plain version on the same finder cells: the small index at
    max-distance 4, 0 and 2, the skewed index's page (superchunk level on)
    and the 65,536-query page, each at the rows cap the tuning sets from
    it: populations equal, sums within rtol 1e-12 / atol 1e-9, the live
    rescan rows equal as a set, and the kernel's rows of each chunk one
    consecutive run; then with the rows cap one below the page's rows
    (the skewed page and the 65,536-query page) both must flag the page,
    keep every population and list exactly the cap's rows; each prints
    its cap, populations, live rows, runs and errors;
4. hold the neighbour finder kernel (the MXU engine's, an int8
   tensor-core distance screen: K = 64 at slice width 8, 96 at the
   others) against its plain version, cell for cell (exact), on the small
   index (max-distance 4, 0, 1 and 2, and a plan whose qb is not a
   multiple of 8), the small index at slice width 4 (the K = 96 instance)
   and at seq_length 16, the skewed index and 16 buckets of a
   32,768-query page of the 27 Mbp index;
5. score that page with the MXU engine: finder and decode times (CUDA
   events; the finder also on a 2-query page, the hybrid's re-score
   size, both with their bound's terms), host plan, self-lookup and
   replay times, page wall time, and
   a 2,048-query sample ``np.array_equal`` to the native exact scorer
   (both f64, the reference's scan order and early exit); profile one
   warm page; and on the small index all five methods
   ``np.array_equal`` to ``score_exact``;
6. the flat exact engine on the card: the small index, five methods, f64
   (rtol 1e-12) and f32 (identical verdicts) against ``score_exact``;
   and a 2,048-query sample of the 27 Mbp index in f32, timed, with
   verdicts identical to the native exact scorer's; then a 256-query
   page timed at the GPU's work block and at the JAX engine's 2^17, in
   turns;
7. hold both full-scan kernels (the dense engine's ``dense_scan``, the
   scan-style engine's ``bucket_scan``, both an int8 tensor-core distance
   screen over one-hot rows built from the packed lists) against their
   plain versions, every cell within rtol 1e-12 / atol 1e-9 (f64 sums of
   the same f32 terms in another order), on the small index (max-distance
   4, 0 and 2; a ragged qb for ``dense_scan``; ``bucket_scan`` also at
   slice widths 4 and 16, its K = 96 path), the skewed index and 16
   buckets of the 65,536-query page (max-distance 4, 0 and 2; a ragged
   qb);
8. score that page with the dense engine (kernel time with CUDA events,
   plan and page on the host clock, the kernel's bound with its tensor,
   operations and bytes terms, a 2,048-query sample within rtol 1e-4 of
   the exact sums); then the hybrid over it (``last_rescored``, page wall
   time, sample verdicts identical to native exact for ``and``); then
   the same 65,536 queries with the scan-style engine in 8,192-query
   pages, timed and checked the same way;
9. the deep bucket: an index with one bucket of more than 2^22 entries
   (the JAX engine's rank bound, not the port's), written to a ``.issl``,
   through ``Pipeline._get_issl_scorer`` with ``engine = compact``, then
   ``engine = sharded``: each must build the hybrid over the compact
   engine (the sharded compact engine) with no fallback logged and
   launch ``compact_finder``; then both again with the compact engine's
   lists made not to fit (``issl_compact.free_bytes`` reading one byte
   while the pipeline builds its scorer): each must log the fallback and
   build the hybrid over the dense engine (the sharded dense engine) and
   launch ``dense_scan``. In all four runs the verdicts on 256 queries
   (half in the deep bucket) must equal native exact, with no plain
   version run;
10. the hybrid's verdicts for all five methods against ``score_exact`` on
    the small index, over each fast engine (compact and dense), with its
    own band and with an infinite one, which re-scores every query
    through the neighbour finder on the card;
11. ``Crackling -c config.ini`` through its CLI entry point on the GPU
    six times, every kernel's launch counter and plain-call counter
    reset just before each run and read just after: ``engine = auto``
    (the compact finder must have launched, and in every run the compact
    decode and the compact rescan as often as a compact finder; the
    ``auto`` run also times its off-target stage's parts from here: index
    load, scorer build, the cap-tuning page, later pages, the re-scorer's
    build and its re-scores), ``auto`` with
    ``CRACKLING_TPU_COMPACT_ONEHOT=1`` (the one-hot finder, and not the
    packed one), ``sharded`` in one process (the compact finder), then
    ``exact`` (the neighbour finder), ``dense`` (``dense_scan``) and
    ``pallas`` (``bucket_scan``) on the same files, with no plain version
    run in any; each run's ``passedOffTargetScore`` column must equal the
    ``auto`` run's row by row;
11a. the batched MFE fold (the ``tpu`` fold backend) on the card: the
    unique mm10db constructs of the ``auto`` run (its ``ssL1`` column),
    topped up to at least 4,096 with constructs of the dataset's guides,
    folded chunk by chunk with ``ops/mfe.fold_chunks`` (chunks of half
    the card's free memory, at most 4,096 guides) and traced back on the
    host; every
    energy within 1e-6 of the native C++ fold's (``fold_batch_native``) on
    the same codes and every structure equal; printed: guides, chunk size
    and count, peak ``max_memory_allocated``, each chunk's precompute and
    DP (CUDA events), host fold and traceback seconds, the whole fold's
    wall time and guides/s, the native fold's wall time; then a profile
    of one chunk (its ``mfe.`` spans: precompute, DP, the DP's interior
    window). Then ``Crackling -c`` with ``engine = auto`` and ``[tpu]
    rnafold-backend = tpu``: the compact finder must launch, the compact
    decode and rescan as often, with no plain
    version, its CSV must be byte-equal to the ``auto`` run's (which folds
    with the native engine), and its secondary-structure stage time is
    printed beside ``auto``'s;
11b. ``Crackling -c`` with ``engine = sharded`` in two processes on the
    one card (``process-count = 2``, a free localhost port,
    CRACKLING_PROCESS_ID 0 and 1, an output directory each): each prints
    its kernel launch counts on a line of its own and must have launched
    the compact finder and as often the compact decode and the compact
    rescan, with no plain version; both must exit 0, their
    CSVs must be byte-equal and their ``passedOffTargetScore`` the
    ``auto`` run's;
12. ``scoreOfftargets`` through its CLI entry point on the GPU against a
    2,048-query file of the 27 Mbp index: with CRACKLING_PLATFORM unset
    the work is below the JAX CLI's 5e8, so it scores in f64 on the card
    and every printed line must equal ``%f`` of the native exact
    scorer's scores, apart from counted rounding ties
    (``PRINT_TIE_RTOL``); with CRACKLING_PLATFORM=cuda (TwoSum f32)
    verdicts identical and scores within its f32 tier (``SCORE_RTOL``);
13. print the kernels line and, last, the device line.

The first, uncached run also builds the 27 Mbp dataset (~17 s of host
work on an 8-core H100 host); ``CHIP_SMOKE_GENOME_MBP`` /
``CHIP_SMOKE_QUERIES`` shrink it for a quicker look.
"""

from __future__ import annotations

import contextlib
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
# 32-bit integer operations per (slot, entry) pair of a scalar hit test:
# 2 xor, 2 shift, 2 or, 2 and (pair collapse), 2 popc, add, compare (the
# packed compact finder's bound before its tensor-core design, kept as its
# "alu_12op" term for history)
FINDER_OPS_PER_PAIR = 12
# the packed compact finder's bound: per live pair 2 x 64 int8 operations
# on the tensor cores (the 16 positions outside the bucket's slice x 4
# bases) and half an epilogue operation (a 3-input OR folds two sums);
# per entry and 64-slot group with a live slot, 24 operations to build its
# one-hot row (four quad threads, two shifts and four logic ops each); the
# packed lists at 8 B per entry
PACKED_K = 64
PACKED_OR_OPS_PER_PAIR = 0.5
PACKED_BUILD_OPS_PER_ENTRY = 24
PACKED_SLOT_GROUP = 64
# ... and of the neighbour finder's scalar design: the same and a
# subtract, for the 1..max_dist range test (its "alu_13op" term, kept for
# history); its tensor-core design has the full-scan scorers' screen and
# each candidate ~16 operations (the re-test, the cell, two atomics)
MXU_OPS_PER_PAIR = 13
MXU_CANDIDATE_OPS = 16
# the one-hot finder's bound: per live pair, 2 x 64 int8 operations on the
# tensor cores (the four 16-byte pieces of a row outside the bucket's
# slice) and half an epilogue operation (the OR fold); the planes at 64
# streamed bytes per entry
H100_INT8_OPS_PER_S = 1979e12
ONEHOT_K = 64
ONEHOT_ROW_BYTES = 64
ONEHOT_LANES = 80
# the small page of the one-hot comparison
SMALL_PAGE = 4096
# the full-scan scorers' bound: their int8 screen is the packed finder's
# (2 x K operations per live pair on the tensor cores, K = 64 at w = 8 and
# 96 at the bucket scan's other widths; half an OR per pair; 24 operations
# per entry and 64-query group to build its one-hot row, 36 at K = 96,
# whose third k-step adds a shift, a mask and a shift per quad thread),
# and each hit costs ~64 more (the exact re-test, the 20-bit mask, the CFD
# product over its mismatches, two f64 products and atomics); the packed
# lists at 8 B per entry, the occurrence and MIT table entry of each hit
# at 4 B each. The scalar design's predicate, 12 ops per pair, is kept as
# the "alu_12op" term for history.
FULLSCAN_OPS_PER_PAIR = FINDER_OPS_PER_PAIR
FULLSCAN_BUILD_OPS_PER_ENTRY = {64: PACKED_BUILD_OPS_PER_ENTRY, 96: 36}
FULLSCAN_HIT_OPS = 64
# the full-scan kernels against their plain versions: f64 sums of the
# same f32 terms, summed in another order
FULLSCAN_RTOL, FULLSCAN_ATOL = 1e-12, 1e-9
# the compact rescan's bound: per (row, column) pair of a live row ~20
# 32-bit operations for the screen (2 xor, 2 shift, 2 or, 2 and of the
# pair collapse, 2 popc, an add and a compare, the earlier-slice test's
# or, subtract, and-not, and, compare, the column test); each hit the
# full-scan scorers' ~64; bytes, each input read once: the 8-B entries of
# the distinct chunks the live rows cover (the slots of one bucket share
# its chunks), the 4-B occurrence of every distinct hit entry and the 4-B
# MIT table entry of every distinct hit mask, the six 8-B row descriptors
# of every row of the list and the two f64 sums of every query it adds to
RESCAN_OPS_PER_PAIR = 20
RESCAN_DESCRIPTOR_BYTES = 6 * 8
# the compact decode's bound (steps 1-2): bytes, each input read once and
# each output written once: the bucket-total count of every slot, the plan
# entry of every slot with a hit, the min rank of every scored 1-2-hit cell
# and its max rank at 2 hits, the count of every cell the tree walk
# visits, the 8-B entry and 4-B occurrence of every distinct hit entry and
# the 4-B MIT table entry of every distinct hit mask, the 8-B signature and
# two f64 sums of every query it scores, the whole (6, cap_rescan) row block
# written, and the 4-B bucket length of every >=3-hit slot (its cells are
# counted only up to that length: a cell past it holds no hit); a
# kernel's own scratch is not counted; operations: ~8 32-bit operations
# per slot (the count tests, two ballots, the list offset) and per scored
# hit the full-scan scorers' ~64
DECODE_SLOT_OPS = 8
# the scan-style engine's page (its default query_page)
SCAN_PAGE = 8192
# the MXU engine's page (its default query_page)
MXU_PAGE = min(32768, N_QUERIES)
SAMPLE = 2048
# scoreOfftargets' f32 tier against the exact f64 scores: per-hit f32
# terms carry ~1e-6 relative error, sums are TwoSum-compensated, and the
# printed %f rounds to 5e-7
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# scoreOfftargets in f64 against the native exact scorer's %f lines: a
# printed field may differ only where the exact value lies this close
# (relative) to a %f rounding boundary, where the order of the f64 sums
# decides the last digit
PRINT_TIE_RTOL = 1e-12
METHODS = (("mit", 80.0), ("cfd", 80.0), ("and", 75.0), ("or", 75.0),
           ("avg", 90.0))
# the fold phase: at least this many constructs, energies held to the
# native fold's within the cross-engine test's bound (tests/test_mfe.py),
# and a profile of one chunk of this many guides
FOLD_MIN_GUIDES = 4096
FOLD_ENERGY_ATOL = 1e-6
FOLD_PROFILE_GUIDES = 2048


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


def queued_ms(fn, reps, dev):
    """Mean device ms per call of ``fn`` with no host gap between calls:
    the stream is held by a ~20 ms spin kernel while the host enqueues
    all ``reps`` calls, so CUDA events time only the device's work (a
    call whose host side is slower than its device work is launch-bound,
    and ``timed_ms`` times that instead)."""
    import torch

    if torch.device(dev).type != "cuda":
        return timed_ms(fn, reps, dev)
    fn()
    sync(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7 * reps / 10))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def flushed_ms(fn, reps, dev):
    """Mean device ms per call of ``fn`` with the L2 cache flushed before
    each: a 256 MB buffer (the H100's L2 holds 50 MB) is written between
    calls, and CUDA events time each call alone; a spin kernel holds the
    stream while the host enqueues them all."""
    import torch

    if torch.device(dev).type != "cuda":
        return timed_ms(fn, reps, dev)
    fn()
    sync(dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e7 * reps / 10))
    for t0, t1 in events:
        flush.fill_(1)
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in events) / reps


def host_walls(fn, dev, reps=3):
    """Host-clock seconds of ``reps`` calls of ``fn``, each ending in a
    device synchronise."""
    out = []
    for _ in range(reps):
        sync(dev)
        t = time.perf_counter()
        fn()
        sync(dev)
        out.append(time.perf_counter() - t)
    return out


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


def kernel_name(mangled):
    """A kernel's name and template arguments from its mangled name
    (``c++filt`` where it exists), e.g. ``mxu_finder_kernel<2>``."""
    import re

    name = mangled
    if shutil.which("c++filt"):
        res = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True)
        name = res.stdout.strip() or mangled
    m = re.search(r"(\w+_kernel(?:<[^>(]*>)?)\(", name)
    return m.group(1) if m else name


def ptxas_by_kernel(report):
    """The ``-Xptxas -v`` report per kernel: {name: [registers / shared
    memory line, spill line]}."""
    import re

    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return out


def phase_build():
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.kernel_build import build_library

    sources = ("compact_finder.cu", "compact_onehot.cu", "mxu_finder.cu",
               "fullscan.cu", "compact_rescan.cu", "compact_decode.cu",
               "mxu_replay.cu")
    with ThreadPoolExecutor(len(sources) + 1) as ex:
        kerns = [ex.submit(build_library, src) for src in sources]
        host = ex.submit(native.get_lib)
        libs = [k.result() for k in kerns]
        if host.result() is None:
            fail("the native host library did not build (g++)")
    emit({"phase": "build", "kernel_libraries": [p.name for p in libs],
          "ptxas": {src: ptxas_by_kernel(lib.with_suffix(".log").read_text())
                    for src, lib in zip(sources, libs)}})


def finder_inputs(scorer, queries, qb=None):
    """The finder's inputs for one page of ``queries`` on the scorer's
    device (the slot plan the scorer itself would make)."""
    from crackling_tpu_torch.ops.issl_compact import plan_query_occupancy
    from crackling_tpu_torch.ops.issl_compact import plan_slots

    if qb is None:
        qb, _ = plan_query_occupancy(queries, scorer.S, scorer.B, 8,
                                     scorer.qb_cap)
    q = scorer.query_tensor(queries)
    return q, plan_slots(q, scorer.S, scorer.B, qb)


def compare_finder(scorer, q, qsp, blen=None, max_dist=None):
    """Kernel vs plain version on the same device tensors; exact."""
    from crackling_tpu_torch.ops.compact_finder import (compact_finder,
                                                        compact_finder_plain)

    args = (scorer.entries, scorer.bucket_offsets,
            scorer.bucket_lens if blen is None else blen, q, qsp)
    kw = dict(chunk=scorer.chunk, nchmax=scorer._nchmax,
              superchunk=scorer.superchunk,
              max_dist=scorer.max_dist if max_dist is None else max_dist)
    got = compact_finder(*args, **kw)
    want = compact_finder_plain(*args, **kw)
    sync(q.device)
    err = finder_diff("finder kernel disagrees with its plain version", got,
                      want)
    return err, int(want.cnt[:, :, -1].sum())


def ragged_qb(scorer, queries):
    """A slot count that holds every bucket's queries and is not a multiple
    of 8 (the plan's own qb is a multiple of 64)."""
    from crackling_tpu_torch.ops.issl_compact import plan_query_occupancy

    _, needed = plan_query_occupancy(queries, scorer.S, scorer.B, 8,
                                     scorer.qb_cap)
    return needed + 1 if needed % 8 == 0 else needed


def phase_kernel_vs_plain(dev, bench_scorer, bench_queries):
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    errs = []
    index, queries = small_world()
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    inputs = finder_inputs(sc, queries)
    for max_dist in (4, 0, 2):
        e, hits = compare_finder(sc, *inputs, max_dist=max_dist)
        errs.append(e)
        emit({"phase": "kernel_vs_plain", "input": "small",
              "max_dist": max_dist, "hits": hits, "max_abs_err": e})
    q, qsp = finder_inputs(sc, queries, ragged_qb(sc, queries))
    e, hits = compare_finder(sc, q, qsp)
    errs.append(e)
    emit({"phase": "kernel_vs_plain", "input": "small, ragged qb",
          "qb": qsp.shape[2], "hits": hits, "max_abs_err": e})

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
    q, qsp = finder_inputs(bench_scorer, bench_queries,
                           ragged_qb(bench_scorer, bench_queries))
    e, hits = compare_finder(bench_scorer, q, qsp, blen)
    errs.append(e)
    emit({"phase": "kernel_vs_plain",
          "input": "bench page, 16 buckets, ragged qb",
          "qb": qsp.shape[2], "hits": hits, "max_abs_err": e})
    return max(errs)


def finder_bound_ms(scorer, q, qsp, C):
    """Least time for the packed finder's work on this page: the largest of
    its tensor operations over the int8 peak, its ALU operations (the OR
    fold of every live pair's sum, the one-hot rows of every entry for
    every 64-slot group with a live slot) over the ALU peak, and its bytes
    over HBM bandwidth (the lists of buckets with a live slot, the plan,
    the queries, the offsets and the output cells, each once). Returns
    (ms, bound by, live pairs, terms in ms); the terms keep the scalar
    design's 12-op ALU term as "alu_12op"."""
    import torch.nn.functional as F

    n = q.numel()
    S, B, qb = qsp.shape
    live = (qsp >= 0) & (qsp < n)
    qcount = live.sum(-1).long()
    blen = scorer.bucket_lens.long()
    pairs = int((blen * qcount).sum())
    pad = -qb % PACKED_SLOT_GROUP
    groups = F.pad(live, (0, pad)).reshape(S, B, -1, PACKED_SLOT_GROUP)
    groups = groups.any(-1).sum(-1).long()
    entry_groups = int((blen * groups).sum())
    nbytes = (int((blen * (qcount > 0)).sum()) * 8 + qsp.numel() * 4
              + n * 8 + S * B * 12 + S * B * C * qb * 20)
    terms = {"tensor": pairs * 2 * PACKED_K / H100_INT8_OPS_PER_S,
             "operations": (pairs * PACKED_OR_OPS_PER_PAIR
                            + entry_groups * PACKED_BUILD_OPS_PER_ENTRY)
             / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    terms["alu_12op"] = pairs * FINDER_OPS_PER_PAIR / H100_ALU_OPS_PER_S
    return terms[by] * 1e3, by, pairs, {k: v * 1e3 for k, v in terms.items()}


# -- the compact rescan -----------------------------------------------------


def rescan_lists(scorer):
    """The rescan's flat lists and score tables of ``scorer``."""
    return scorer.entries.reshape(-1), scorer.occ.reshape(-1), scorer.tables


def rescan_options(scorer, n):
    return dict(n=n, scan_width=scorer._scan_width, max_dist=scorer.max_dist)


def zero_sums(n, dev):
    import torch

    return [torch.zeros(n + 1, dtype=torch.float64, device=dev)
            for _ in range(2)]


def page_rescan_rows(scorer, queries):
    """The rescan list the scorer's decode builds for one page of
    ``queries`` (``decode_tree``), and the page's query count."""
    q, qsp = finder_inputs(scorer, queries)
    return scorer.decode_tree(q, qsp, scorer.finder(q, qsp)).rows, q.numel()


def all_chunk_rows(scorer, queries):
    """A rescan list of every chunk of every live slot's bucket, as if each
    held 3 or more hits, ending in two padding rows and a row whose query
    is ``n``; and the page's query count."""
    import torch

    from crackling_tpu_torch.ops.compact_rescan import RescanRows

    q, qsp = finder_inputs(scorer, queries)
    n, dev, chunk = q.numel(), q.device, scorer.chunk
    nch = (scorer.bucket_lens.long() + chunk - 1) // chunk
    cells = ((qsp < n)[..., None]
             & (torch.arange(scorer._nchmax, device=dev)
                < nch[:, :, None, None]))
    s, b, j, c = torch.nonzero(cells, as_tuple=True)
    if not s.numel():
        fail("the small index gave no chunk with a live slot")
    first = c * chunk
    hq = torch.cat([qsp[s, b, j].long(), qsp.new_tensor([0, 0, n]).long()])
    ridx = torch.arange(hq.numel(), device=dev)
    ridx[-3:-1] = -1

    def ext(t):
        return torch.cat([t, t[:1].expand(3)])

    return RescanRows(
        ridx, q[hq.clamp(max=n - 1)], hq,
        ext(s * scorer.entries.shape[1] + scorer.bucket_offsets[s, b]
            + first),
        ext(scorer.bucket_lens[s, b].long() - first), ext(s)), n


def compare_rescan(scorer, rows, n):
    """Kernel vs plain version on the same rows into fresh sums; fails
    outside rtol 1e-12 / atol 1e-9 (f64 sums of the same f32 terms in
    another order). Returns (max abs err, max rel err, rows, live rows)."""
    import torch

    from crackling_tpu_torch.ops.compact_rescan import (compact_rescan,
                                                        compact_rescan_plain)

    dev = rows.q.device
    got, want = zero_sums(n, dev), zero_sums(n, dev)
    opts = rescan_options(scorer, n)
    compact_rescan(rows, *rescan_lists(scorer), *got, **opts)
    compact_rescan_plain(rows, *rescan_lists(scorer), *want, **opts)
    sync(dev)
    for name, g, w in zip(("mit", "cfd"), got, want):
        if not torch.allclose(g, w, rtol=FULLSCAN_RTOL, atol=FULLSCAN_ATOL):
            fail(f"rescan kernel {name} sums disagree with its plain "
                 f"version (max abs err {float((g - w).abs().max()):.3e})")
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                  for g, w in zip(got, want))
    live = int(((rows.ridx >= 0) & (rows.hq < n)).sum())
    return abs_err, rel_err, rows.ridx.numel(), live


def chunk_runs(rows, n):
    """(runs, distinct): the runs of equal start among the list's live
    rows (``ridx >= 0``, ``hq < n``) in list order, and their distinct
    starts; equal when the rows of each chunk are consecutive."""
    starts = rows.start[(rows.ridx >= 0) & (rows.hq < n)].tolist()
    runs = sum(1 for i, st in enumerate(starts)
               if i == 0 or st != starts[i - 1])
    return runs, len(set(starts))


def shuffled_rows(rows, seed):
    """A copy of a rescan list in a random order (seeded)."""
    import torch

    from crackling_tpu_torch.ops.compact_rescan import RescanRows

    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(rows.ridx.numel(), generator=gen).to(rows.q.device)
    return RescanRows(*(t[perm].contiguous() for t in rows))


def phase_rescan_kernel_vs_plain(dev, bench_scorer, bench_queries):
    """Phase 3e: the rescan kernel against its plain version on the same
    row descriptors: every chunk of the small index's live slots at
    max-distance 4, 0 and 2 (with padding rows and a row of query n), the
    skewed index's own rescan list (superchunk level on), the
    65,536-query page's (grouped by chunk, as the decode kernel lists it)
    and a shuffled copy of it (runs of one row). Each prints its runs of
    rows sharing a chunk. Returns the largest absolute error."""
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    errs = []

    def check(what, sc, rows, n, **extra):
        abs_err, rel_err, total, live = compare_rescan(sc, rows, n)
        if not live:
            fail(f"the rescan comparison on {what} has no live row")
        errs.append(abs_err)
        runs, chunks = chunk_runs(rows, n)
        emit({"phase": "rescan_kernel_vs_plain", "input": what,
              "max_dist": sc.max_dist, "rows": total, "live_rows": live,
              "runs": runs, "chunks": chunks, **extra,
              "max_abs_err": abs_err, "max_rel_err": rel_err})

    index, queries = small_world()
    for max_dist in (4, 0, 2):
        sc = CompactIsslScorer(index, max_dist=max_dist, chunk=1024,
                               device=dev)
        check("small, every chunk", sc, *all_chunk_rows(sc, queries))
    index, queries = skewed_world()
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    if sc.superchunk <= 0:
        fail(f"skewed index did not turn the superchunk level on "
             f"(nchmax {sc._nchmax})")
    check("skewed, its rescan list", sc, *page_rescan_rows(sc, queries),
          superchunk=sc.superchunk)
    rows, n = page_rescan_rows(bench_scorer, bench_queries)
    check("bench page, its rescan list", bench_scorer, rows, n)
    check("bench page, its rescan list shuffled", bench_scorer,
          shuffled_rows(rows, SEED), n)
    return max(errs)


def decode_args(scorer, q, qsp, fo, cap):
    """The decode's arguments for the scorer's lists at rows cap ``cap``."""
    return ((q, qsp, fo, scorer.bucket_offsets, scorer.bucket_lens,
             scorer.entries, scorer.occ),
            dict(chunk=scorer.chunk, superchunk=scorer.superchunk,
                 cap_rescan=int(cap), tabs=scorer.tables, trim=False))


def live_rows(d):
    """The live rows of a decode as sorted (hq, start, live, s, q)."""
    live = d.rows.ridx >= 0
    return sorted(zip(*(t[live].tolist() for t in (
        d.rows.hq, d.rows.start, d.rows.live, d.rows.s, d.rows.q))))


def compare_decode(scorer, q, qsp, fo, cap):
    """Kernel vs plain version of the decode's steps 1-2 on the same cells
    at rows cap ``cap``. The populations must be equal. Within the cap the
    sums must lie within rtol 1e-12 / atol 1e-9 (the same f32 terms summed
    in f64 in another order) and the live rows be equal as a set; over it
    both must flag the page and list exactly ``cap`` rows. The kernel's
    rows of each chunk must be consecutive. Returns (populations, max abs
    err, max rel err, live rows, whether the rows passed the cap, runs of
    rows sharing a chunk)."""
    import torch

    from crackling_tpu_torch.ops.compact_decode import (compact_decode,
                                                        compact_decode_plain)

    args, kw = decode_args(scorer, q, qsp, fo, cap)
    got = compact_decode(*args, **kw)
    want = compact_decode_plain(*args, **kw)
    sync(q.device)
    runs = grouped_runs(got, q.numel(), "the decode comparison")
    gp, wp = got.pops.tolist(), want.pops.tolist()
    if gp != wp:
        fail(f"decode kernel populations {gp} differ from the plain "
             f"version's {wp}")
    if wp[5] > cap:
        listed = (len(live_rows(got)), len(live_rows(want)))
        if listed != (cap, cap):
            fail(f"over its rows cap {cap} the decode listed {listed[0]} "
                 f"rows (kernel) and {listed[1]} (plain version)")
        return wp, 0.0, 0.0, cap, True, runs
    errs = []
    for name, g, w in (("mit", got.mit_sums, want.mit_sums),
                       ("cfd", got.cfd_sums, want.cfd_sums)):
        if not torch.allclose(g, w, rtol=FULLSCAN_RTOL, atol=FULLSCAN_ATOL):
            fail(f"decode kernel {name} sums disagree with its plain "
                 f"version (max abs err {float((g - w).abs().max()):.3e})")
        errs.append((float((g - w).abs().max()),
                     float(((g - w).abs() / w.abs().clamp(min=1e-30))
                           .max())))
    rows = live_rows(got)
    if rows != live_rows(want):
        fail("the decode kernel's rescan rows differ from the plain "
             "version's as a set")
    return (wp, max(e[0] for e in errs), max(e[1] for e in errs),
            len(rows), False, runs)


def grouped_runs(d, n, what):
    """The runs of a decode's live rows sharing a chunk; the kernel's (on
    the card) fail unless each chunk's rows are one consecutive run (the
    plain version, which the CPU runs, lists a slot's chunks together)."""
    runs, chunks = chunk_runs(d.rows, n)
    if d.rows.start.device.type == "cuda" and runs != chunks:
        fail(f"{what}: the decode kernel's rows of {chunks} chunks come in "
             f"{runs} runs, not grouped by chunk")
    return runs


def tuned_cap(scorer, q, qsp, fo):
    """The rows cap the scorer's tuning would set from this page: ~1.25x
    the rows of a decode at the initial cap."""
    from crackling_tpu_torch.ops.compact_decode import compact_decode_plain
    from crackling_tpu_torch.ops.issl_compact import CAP_RESCAN, _quant_cap

    args, kw = decode_args(scorer, q, qsp, fo, CAP_RESCAN)
    return _quant_cap(int(compact_decode_plain(*args, **kw).pops[5]))


def phase_decode_kernel_vs_plain(dev, bench_scorer, bench_queries):
    """Phase 3f: the decode kernel (steps 1-2) against its plain version on
    the same finder cells: the small index at max-distance 4, 0 and 2, the
    skewed index's page (superchunk level on) and the 65,536-query page,
    each at the rows cap the tuning sets from it; then the rows cap one
    below the page's rows on the skewed and the 65,536-query page: both
    must flag it. Every kernel list must come grouped by chunk; each line
    prints its runs. Returns the largest absolute error."""
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    errs = []

    def check(what, sc, queries, over=False):
        q, qsp = finder_inputs(sc, queries)
        fo = sc.finder(q, qsp)
        cap = tuned_cap(sc, q, qsp, fo)
        pops, *_ = compare_decode(sc, q, qsp, fo, cap)
        if over:
            if not pops[5]:
                fail(f"{what} has no rescan rows to overflow")
            cap = pops[5] - 1
        pops, abs_err, rel_err, rows, flagged, runs = compare_decode(
            sc, q, qsp, fo, cap)
        if flagged != over:
            fail(f"{what}: the rows cap {cap} flagged {flagged}")
        errs.append(abs_err)
        emit({"phase": "decode_kernel_vs_plain", "input": what,
              "max_dist": sc.max_dist, "superchunk": sc.superchunk,
              "cap_rescan": cap, "populations": pops, "live_rows": rows,
              "runs": runs, "flagged": flagged, "max_abs_err": abs_err,
              "max_rel_err": rel_err})
        return pops

    index, queries = small_world()
    for max_dist in (4, 0, 2):
        sc = CompactIsslScorer(index, max_dist=max_dist, chunk=1024,
                               device=dev)
        check("small", sc, queries)
    index, queries = skewed_world()
    sk = CompactIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    if sk.superchunk <= 0:
        fail(f"skewed index did not turn the superchunk level on "
             f"(nchmax {sk._nchmax})")
    check("skewed", sk, queries)
    pops = check("bench page", bench_scorer, bench_queries)
    if not all(pops[k] for k in (0, 1, 4, 5)):
        fail(f"the bench page lacks a population: {pops}")
    check("skewed, over the rows cap", sk, queries, True)
    check("bench page, over the rows cap", bench_scorer, bench_queries, True)
    return max(errs)


def decode_bound_ms(scorer, q, qsp, fo, cap):
    """Least time for the decode's steps 1-2 on this page: the larger of
    its bytes (DECODE_SLOT_OPS' comment) over HBM bandwidth and its 32-bit
    operations over the ALU peak. Returns (ms, bound by, scored cells,
    hits, terms in ms)."""
    import torch

    from crackling_tpu_torch.ops.bits import (SIG40, collapse_pairs,
                                              compress_even_bits)

    n = q.numel()
    S, B, C, qb = fo.cnt.shape
    nch, nsc, sup = fo.nchmax, fo.nsc, scorer.superchunk
    cnt = fo.cnt
    multi = (cnt[:, :, C - 1, :] >= 3)[:, :, None, :]

    def one_two(c):
        return (c == 1) | (c == 2)

    # the live chunks (and superchunks) of each bucket: cells past them
    # hold no hit, so the function need not read them
    nlive = (scorer.bucket_lens.long() + scorer.chunk - 1) // scorer.chunk
    live_ch = (torch.arange(nch, device=q.device)[None, None, :]
               < nlive[:, :, None])[..., None]
    visited = torch.zeros_like(cnt, dtype=torch.bool)
    if sup:
        live_sc = (torch.arange(nsc, device=q.device)[None, None, :] * sup
                   < nlive[:, :, None])[..., None]
        visited[:, :, nch:nch + nsc] = multi & live_sc
        big = visited[:, :, nch:nch + nsc] & (cnt[:, :, nch:nch + nsc] >= 3)
        owner = torch.arange(nch, device=q.device) // sup
        visited[:, :, :nch] = big[:, :, owner] & live_ch
    else:
        visited[:, :, :nch] = multi & live_ch
    scored = visited & one_two(cnt)
    scored[:, :, C - 1] = one_two(cnt[:, :, C - 1])
    s_i, b_i, c_i, j_i = torch.nonzero(scored, as_tuple=True)
    two = cnt[s_i, b_i, c_i, j_i] == 2
    hq = qsp[s_i, b_i, j_i].long()
    keep = torch.cat([hq, hq[two]]) < n
    sl = torch.cat([s_i, s_i[two]])
    pos = (sl * scorer.entries.shape[1]
           + scorer.bucket_offsets[sl, torch.cat([b_i, b_i[two]])]
           + torch.cat([fo.rmin[s_i, b_i, c_i, j_i],
                        fo.rmax[s_i, b_i, c_i, j_i][two]]).long())[keep]
    hq_hit = torch.cat([hq, hq[two]])[keep]
    ent = scorer.entries.reshape(-1)[pos]
    masks = compress_even_bits(collapse_pairs((ent ^ q[hq_hit]) & SIG40))
    queries = int(torch.unique(hq_hit).numel())
    live_slots = int((cnt[:, :, C - 1] > 0).sum())
    nm = int(multi.sum())
    nbytes = (S * B * qb * 4 + live_slots * 4
              + int(scored.sum()) * 4 + int(two.sum()) * 4
              + int(visited.sum()) * 4
              + int(torch.unique(pos).numel()) * 12
              + int(torch.unique(masks).numel()) * 4
              + queries * (8 + 16) + cap * RESCAN_DESCRIPTOR_BYTES
              + nm * 4)
    hits = int(pos.numel())
    terms = {"operations": (S * B * qb * DECODE_SLOT_OPS
                            + hits * FULLSCAN_HIT_OPS) / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return (terms[by] * 1e3, by, int(scored.sum()), hits,
            {k: v * 1e3 for k, v in terms.items()})


def rescan_bound_ms(scorer, rows, n):
    """Least time for the rescan's work on these rows: the larger of its
    32-bit operations (RESCAN_OPS_PER_PAIR per pair of a live row below its
    live length and scan width, FULLSCAN_HIT_OPS per hit) over the ALU peak
    and its bytes (each input read once: the distinct chunks' entries, the
    distinct hits' occurrences and table entries, the list's descriptors,
    two f64 sums per query it adds to) over HBM bandwidth. Returns (ms,
    bound by, pairs, hits, terms in ms, distinct entries read)."""
    import torch

    from crackling_tpu_torch.ops.bits import (SIG40, collapse_pairs,
                                              compress_even_bits,
                                              earlier_slice_clean, popcount)

    live_row = (rows.ridx >= 0) & (rows.hq < n)
    width = scorer._scan_width
    cols = torch.arange(width, device=rows.q.device)
    ent = scorer.entries.reshape(-1)
    pairs = hits = 0
    hit_pos, hit_mask = [], []
    for k in range(0, rows.ridx.numel(), 4096):
        sl = slice(k, k + 4096)
        inrow = (cols[None, :] < rows.live[sl, None]) & live_row[sl, None]
        pos = rows.start[sl, None] + cols[None, :]
        c40 = collapse_pairs((ent[pos] ^ rows.q[sl, None]) & SIG40)
        hit = (inrow & (popcount(c40) <= scorer.max_dist)
               & ~earlier_slice_clean(c40, rows.s[sl, None]))
        pairs += int(inrow.sum())
        hits += int(hit.sum())
        hit_pos.append(pos[hit])
        hit_mask.append(compress_even_bits(c40[hit]))
    # the rows of one chunk share its start and its live length
    starts, inv = torch.unique(rows.start[live_row], return_inverse=True)
    span = torch.zeros_like(starts).scatter_(
        0, inv, rows.live[live_row].clamp(min=0, max=width))
    entries_read = int(span.sum())
    queries = int(torch.unique(rows.hq[live_row]).numel())
    nbytes = (entries_read * 8
              + 4 * int(torch.unique(torch.cat(hit_pos)).numel())
              + 4 * int(torch.unique(torch.cat(hit_mask)).numel())
              + rows.ridx.numel() * RESCAN_DESCRIPTOR_BYTES + queries * 16)
    terms = {"operations": (pairs * RESCAN_OPS_PER_PAIR
                            + hits * FULLSCAN_HIT_OPS) / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return (terms[by] * 1e3, by, pairs, hits,
            {k: v * 1e3 for k, v in terms.items()}, entries_read)


def phase_scorer(dev, scorer, queries, card):
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.compact_finder import compact_finder_plain
    from crackling_tpu_torch.ops.compact_rescan import (compact_rescan,
                                                        compact_rescan_plain)
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.pipeline.run import verdicts

    t = time.perf_counter()
    scorer.score_sums(queries)                 # first page: tunes the cap
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
    bound_ms, bound_by, pairs, terms = finder_bound_ms(scorer, q, qsp, C)

    # steps 1-2 alone (the decode kernel) at the tuned cap, its plain
    # version on the card and its bound
    from crackling_tpu_torch.ops.compact_decode import compact_decode_plain

    decode_call_ms = timed_ms(lambda: scorer.decode_tree(q, qsp, fo), 10,
                              dev)
    decode_kernel_ms = queued_ms(lambda: scorer.decode_tree(q, qsp, fo), 10,
                                 dev)
    args, kw = decode_args(scorer, q, qsp, fo, scorer._cap())
    sync(dev)
    t = time.perf_counter()
    compact_decode_plain(*args, **kw)
    sync(dev)
    decode_plain_ms = (time.perf_counter() - t) * 1e3
    (decode_bound, decode_by, decode_cells, decode_hits,
     decode_terms) = decode_bound_ms(scorer, q, qsp, fo, scorer._cap())

    # the rescan alone, on the page's own list at the tuned cap
    rows = scorer.decode_tree(q, qsp, fo).rows
    n = q.numel()
    sums = zero_sums(n, dev)
    opts = rescan_options(scorer, n)
    # its 66 MB of distinct chunks exceed the L2, which the page's finder
    # streams over first: timed with the L2 flushed before each launch,
    # and warm (back to back) beside it
    rescan_flushed_ms = flushed_ms(lambda: compact_rescan(
        rows, *rescan_lists(scorer), *sums, **opts), 10, dev)
    rescan_ms = timed_ms(lambda: compact_rescan(
        rows, *rescan_lists(scorer), *sums, **opts), 10, dev)
    rescan_queued_ms = queued_ms(lambda: compact_rescan(
        rows, *rescan_lists(scorer), *sums, **opts), 10, dev)
    sync(dev)
    t = time.perf_counter()
    compact_rescan_plain(rows, *rescan_lists(scorer), *sums, **opts)
    sync(dev)
    rescan_plain_ms = (time.perf_counter() - t) * 1e3
    (rescan_bound, rescan_by, rescan_pairs, rescan_hits, rescan_terms,
     rescan_entries) = rescan_bound_ms(scorer, rows, n)
    del sums

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
          "cap_rescan": scorer._cap(), "tune_page_s": tune_s,
          "page_wall_s": walls, "plan_ms": plan_ms, "finder_ms": finder_ms,
          "decode_ms": decode_ms, "decode_kernel_ms": decode_kernel_ms,
          "decode_call_ms": decode_call_ms,
          "decode_plain_ms": decode_plain_ms,
          "decode_bound_ms": decode_bound, "decode_bound_by": decode_by,
          "decode_bound_terms_ms": decode_terms,
          "decode_scored_cells": decode_cells, "decode_hits": decode_hits,
          "finder_plain_ms": plain_ms,
          "finder_bound_ms": bound_ms, "finder_bound_by": bound_by,
          "finder_bound_terms_ms": terms,
          "rescan_rows": rows.ridx.numel(),
          "rescan_live_rows": int(((rows.ridx >= 0) & (rows.hq < n)).sum()),
          "rescan_runs": chunk_runs(rows, n)[0],
          "rescan_pairs": rescan_pairs, "rescan_hits": rescan_hits,
          "rescan_distinct_entries": rescan_entries,
          "rescan_flushed_ms": rescan_flushed_ms, "rescan_ms": rescan_ms,
          "rescan_queued_ms": rescan_queued_ms,
          "rescan_plain_ms": rescan_plain_ms,
          "rescan_bound_ms": rescan_bound, "rescan_bound_by": rescan_by,
          "rescan_bound_terms_ms": rescan_terms,
          "compact_guides_per_s": queries.shape[0] / page_s,
          "hybrid_page_s": hybrid_s,
          "hybrid_guides_per_s": queries.shape[0] / hybrid_s,
          "rescored": hyb.last_rescored,
          "sample_max_rel_err": rel_err})
    return (dict(ms=finder_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 **bound_label(bound_by)),
            dict(ms=rescan_flushed_ms, warm_ms=rescan_queued_ms,
                 plain_ms=rescan_plain_ms, bound_ms=rescan_bound,
                 **bound_label(rescan_by)),
            dict(ms=decode_kernel_ms, plain_ms=decode_plain_ms,
                 bound_ms=decode_bound, **bound_label(decode_by)))


def bound_label(term):
    """The kernels line's labels of a bound: ``bound_by`` in the line's two
    words (a tensor-core bound counts operations, at the int8 rate) and
    ``bound_term``, the phase's own term."""
    return {"bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term}


def phase_profile(dev, run, prefix):
    """One warm call of ``run`` (a page) under torch.profiler: device busy
    time and idle share over the page's wall time, kernel launches, the
    device time of each ``prefix`` span of the page program, the torch
    ops and the kernels (by name, with their launches) that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
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
               and not e.name.startswith(prefix)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    avgs = prof.key_averages()
    spans = {e.key: dev_us(e, False) / 1e3 for e in avgs
             if e.key.startswith(prefix)}
    top = sorted(((dev_us(e, True) / 1e3, e.count, e.key[:60])
                  for e in avgs if dev_us(e, True) > 0
                  and e.key.startswith("aten::")), reverse=True)[:10]
    by_kernel = {}
    for e in kernels:
        ms, count = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top_kernels = sorted(((ms, c, k[:60]) for k, (ms, c) in by_kernel.items()),
                         reverse=True)[:8]
    emit({"phase": "profile", "spans": prefix, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "kernel_launches": len(kernels), "span_device_ms": spans,
          "top_ops_device_ms": [[k, c, ms] for ms, c, k in top],
          "top_kernels_device_ms": [[k, c, ms] for ms, c, k in top_kernels]})


def finder_diff(what, got, want):
    """Fail unless two FinderOuts agree in every cell; their largest
    difference (0)."""
    err = 0
    for name, a, b in zip(("cnt", "rsum", "rmin", "rmax"), got[:4],
                          want[:4]):
        diff = int((a.long() - b.long()).abs().max())
        err = max(err, diff)
        if diff:
            fail(f"{what} on {name} ({int((a != b).sum())} cells)")
    return err


def onehot_args(scorer, q, qsp, blen=None, max_dist=None):
    return ((scorer.planes, scorer.bucket_offsets,
             scorer.bucket_lens if blen is None else blen, q, qsp),
            dict(chunk=scorer.chunk, nchmax=scorer._nchmax,
                 superchunk=scorer.superchunk,
                 max_dist=scorer.max_dist if max_dist is None
                 else max_dist))


def compare_onehot(scorer, q, qsp, blen=None, max_dist=None):
    """One-hot finder kernel vs its plain version on the same device
    tensors; exact."""
    from crackling_tpu_torch.ops.compact_onehot import (
        compact_finder_onehot, compact_finder_onehot_plain)

    args, kw = onehot_args(scorer, q, qsp, blen, max_dist)
    got = compact_finder_onehot(*args, **kw)
    want = compact_finder_onehot_plain(*args, **kw)
    sync(q.device)
    err = finder_diff("one-hot finder kernel disagrees with its plain "
                      "version", got, want)
    return err, int(want.cnt[:, :, -1].sum())


def onehot_scorer(index, dev, **kw):
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    sc = CompactIsslScorer(index, max_dist=4, device=dev, onehot=True, **kw)
    if not sc.onehot:
        fail("CompactIsslScorer(onehot=True) did not take the one-hot finder")
    return sc


def phase_onehot_kernel_vs_plain(dev, bench_scorer, bench_queries):
    """The one-hot kernel against its plain version (small at
    max-distance 4, 0 and 2 and with a ragged qb, skewed, 16 buckets of
    the page), then against the packed kernel on the whole page; returns
    the largest difference (0)."""
    from crackling_tpu_torch.ops.compact_finder import compact_finder
    from crackling_tpu_torch.ops.compact_onehot import compact_finder_onehot

    errs = []
    index, queries = small_world()
    sc = onehot_scorer(index, dev, chunk=1024)
    inputs = finder_inputs(sc, queries)
    for max_dist in (4, 0, 2):
        e, hits = compare_onehot(sc, *inputs, max_dist=max_dist)
        errs.append(e)
        emit({"phase": "onehot_kernel_vs_plain", "input": "small",
              "max_dist": max_dist, "hits": hits, "max_abs_err": e})
    q, qsp = finder_inputs(sc, queries, ragged_qb(sc, queries))
    e, hits = compare_onehot(sc, q, qsp)
    errs.append(e)
    emit({"phase": "onehot_kernel_vs_plain", "input": "small, ragged qb",
          "qb": qsp.shape[2], "hits": hits, "max_abs_err": e})

    index, queries = skewed_world()
    sc = onehot_scorer(index, dev, chunk=1024)
    if sc.superchunk <= 0:
        fail(f"skewed index did not turn the superchunk level on "
             f"(nchmax {sc._nchmax})")
    e, hits = compare_onehot(sc, *finder_inputs(sc, queries))
    errs.append(e)
    emit({"phase": "onehot_kernel_vs_plain", "input": "skewed",
          "nchmax": sc._nchmax, "superchunk": sc.superchunk, "hits": hits,
          "max_abs_err": e})
    del sc

    # 8 buckets each of slices 0 and 4 of the full page: other buckets
    # are given length 0, so both versions skip them
    q, qsp = finder_inputs(bench_scorer, bench_queries)
    blen = bench_scorer.bucket_lens.clone()
    keep = blen.new_zeros(blen.shape, dtype=bool)
    keep[0, 40:48] = True
    keep[-1, 200:208] = True
    blen[~keep] = 0
    e, hits = compare_onehot(bench_scorer, q, qsp, blen)
    errs.append(e)
    emit({"phase": "onehot_kernel_vs_plain", "input": "bench page, 16 buckets",
          "qb": qsp.shape[2], "hits": hits, "max_abs_err": e})

    # the whole page: the one-hot kernel against the packed kernel
    args, kw = onehot_args(bench_scorer, q, qsp)
    got = compact_finder_onehot(*args, **kw)
    want = compact_finder(bench_scorer.entries, *args[1:], **kw)
    sync(dev)
    e = finder_diff("one-hot finder kernel disagrees with the packed finder "
                    "kernel", got, want)
    errs.append(e)
    emit({"phase": "onehot_kernel_vs_plain",
          "input": "bench page vs the packed kernel", "qb": qsp.shape[2],
          "cells": got.cnt.numel(), "hits": int(want.cnt[:, :, -1].sum()),
          "max_abs_err": e})
    return max(errs)


def onehot_bound_ms(scorer, q, qsp, C):
    """Least time for the one-hot finder's work on this page: the largest
    of its tensor operations (2 x 64 per live (slot, entry) pair: the four
    pieces of a row outside the bucket's slice) over the int8 peak, its
    epilogue operations (the OR fold of every sum) over the ALU peak and
    its bytes over HBM bandwidth: the 64 bytes of each plane row of a
    bucket with a live slot that the product needs, the plan, the queries,
    the offsets and the output cells. Beside them, not in the bound,
    "bytes_whole_rows": the same with whole 80-byte rows, which is what
    HBM's 32-byte sectors move whichever pieces of a row are read."""
    n = q.numel()
    qcount = ((qsp >= 0) & (qsp < n)).sum(-1).long()
    blen = scorer.bucket_lens.long()
    pairs = int((blen * qcount).sum())
    S, B, qb = qsp.shape
    rows = int((blen * (qcount > 0)).sum())
    nbytes = (rows * ONEHOT_ROW_BYTES + qsp.numel() * 4 + n * 8
              + S * B * 12 + S * B * C * qb * 20)
    terms = {"tensor": pairs * 2 * ONEHOT_K / H100_INT8_OPS_PER_S,
             "operations": pairs * PACKED_OR_OPS_PER_PAIR
             / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    terms["bytes_whole_rows"] = (nbytes + rows * (ONEHOT_LANES
                                                  - ONEHOT_ROW_BYTES)) \
        / H100_BYTES_PER_S
    return terms[by] * 1e3, by, pairs, {k: v * 1e3 for k, v in terms.items()}


def phase_onehot_page(dev, sc, queries, size, card):
    """The compact engine with the one-hot finder on a ``size``-query page:
    both finder kernels timed in turns on the same page, the one-hot
    finder's bound and plain time, the page with each finder, the planes'
    bytes and build time."""
    from crackling_tpu_torch.ops.compact_finder import compact_finder
    import torch

    from crackling_tpu_torch.ops.compact_onehot import (
        blocks_per_sm, compact_finder_onehot, compact_finder_onehot_plain,
        onehot_planes)
    from crackling_tpu_torch.ops.issl_compact import CAP_RESCAN

    page = queries[:size]
    q, qsp = finder_inputs(sc, page)
    args, kw = onehot_args(sc, q, qsp)
    ms = {"packed": [], "onehot": []}
    for which in ("packed", "onehot", "onehot", "packed"):
        if which == "onehot":
            ms[which].append(timed_ms(
                lambda: compact_finder_onehot(*args, **kw), 3, dev))
        else:
            ms[which].append(timed_ms(
                lambda: compact_finder(sc.entries, *args[1:], **kw), 3, dev))
    C = compact_finder_onehot(*args, **kw).cnt.shape[2]
    bound_ms, bound_by, pairs, terms = onehot_bound_ms(sc, q, qsp, C)
    packed_bound = finder_bound_ms(sc, q, qsp, C)
    sync(dev)
    t = time.perf_counter()
    compact_finder_onehot_plain(*args, **kw)
    sync(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    build_ms = float(np.median(host_walls(
        lambda: onehot_planes(sc.entries, sc.index.seq_length), dev))) * 1e3

    # the page program with each finder, each from a freshly tuned cap
    walls, sums = {}, {}
    for onehot in (False, True, True, False):
        which = "onehot" if onehot else "packed"
        sc.onehot = onehot
        sc.cap_rescan = CAP_RESCAN
        sc._tuned = False
        sums[which] = sc.score_sums(page)                  # tunes the cap
        walls.setdefault(which, []).extend(
            host_walls(lambda: sc.score_sums(page), dev, reps=2))
    sc.onehot = True
    # the same finder cells decode to the same hits; only the order of
    # the f64 sums (CUDA index_add_) may differ
    for a, b in zip(sums["packed"], sums["onehot"]):
        if not np.allclose(a, b, rtol=1e-12, atol=1e-9):
            fail("the compact page's sums differ between the packed and "
                 "the one-hot finder")
    emit({"phase": "onehot_page", "card": card, "device": str(dev),
          "queries": int(page.shape[0]), "qb": int(qsp.shape[2]),
          "pairs": pairs, "onehot_finder_ms": ms["onehot"],
          "packed_finder_ms": ms["packed"], "onehot_plain_ms": plain_ms,
          "onehot_bound_ms": bound_ms, "onehot_bound_by": bound_by,
          "onehot_bound_terms_ms": terms,
          "onehot_blocks_per_sm": (blocks_per_sm(int(qsp.shape[2]),
                                                 torch.device(dev))
                                   if torch_is_cuda(dev) else None),
          "packed_bound_ms": packed_bound[0],
          "packed_bound_by": packed_bound[1],
          "packed_bound_terms_ms": packed_bound[3],
          "page_wall_s": walls,
          "guides_per_s": {k: page.shape[0] / float(np.median(v))
                           for k, v in walls.items()},
          "plane_bytes": sc.planes.numel(), "plane_build_ms": build_ms})
    return dict(ms=float(np.mean(ms["onehot"])), plain_ms=plain_ms,
                bound_ms=bound_ms,
                **bound_label(bound_by))


def compare_mxu(eng, q, qsp, blen=None, max_dist=None):
    """Neighbour finder kernel vs its plain version on the same device
    tensors; exact."""
    from crackling_tpu_torch.ops.mxu_finder import (mxu_finder,
                                                    mxu_finder_plain)

    args = (eng.entries, eng.bucket_offsets,
            eng.bucket_lens if blen is None else blen, q, qsp)
    kw = dict(segw=eng.segw, nseg=eng.nseg,
              max_dist=eng.max_dist if max_dist is None else max_dist,
              seq_length=eng.index.seq_length)
    got = mxu_finder(*args, **kw)
    want = mxu_finder_plain(*args, **kw)
    sync(q.device)
    err = 0
    for name, a, b in zip(("cnt", "rsum"), got, want):
        diff = int((a.long() - b.long()).abs().max())
        err = max(err, diff)
        if diff:
            fail(f"neighbour finder kernel disagrees with its plain version "
                 f"on {name} ({int((a != b).sum())} cells)")
    return err, int(want.cnt.sum())


def mxu_inputs(eng, page):
    """The neighbour finder's inputs for one page on the engine's device
    (the slot plan the engine itself makes)."""
    import torch

    qsp, _qb = eng._plan(page)
    return eng.query_tensor(page), torch.as_tensor(qsp, device=eng.device)


def ragged_mxu_inputs(eng, queries):
    """The engine's slot plan cut to a slot count that still holds every
    bucket's queries and is not a multiple of 8 (the plan's own qb is a
    multiple of 64)."""
    q, qsp = mxu_inputs(eng, queries)
    need = int((qsp < q.numel()).sum(-1).max())
    qb = need + 1 if need % 8 == 0 else need
    return q, qsp[:, :, :qb].contiguous()


def mxu_at(index, dev, width=8, seq_length=20):
    """The MXU engine over the index's sites, cut to ``seq_length``-mers
    and sliced at ``width``: width 4 runs the kernel's K = 96 instance."""
    from crackling_tpu_torch.index.build import IsslIndex
    from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer

    mask = np.uint64((1 << (2 * seq_length)) - 1)
    other = IsslIndex(seq_length=seq_length, slice_width=width,
                      seq_count=index.seq_count,
                      site_sigs=index.site_sigs & mask,
                      occurrences=index.occurrences)
    return MxuIsslScorer(other, max_dist=4, chunk=1024, device=dev)


def phase_mxu_kernel_vs_plain(dev, bench_eng, page):
    """The neighbour finder kernel against its plain version: the small
    index at max-distance 4, 0, 1 and 2 and with a ragged qb, at slice
    width 4 (the K = 96 instance) and at seq_length 16 (queries left at
    20 positions: the kernel cuts them), the skewed index and 16 buckets of
    the page; returns the largest difference (0)."""
    from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer

    errs = []
    index, queries = small_world()
    eng = MxuIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    inputs = mxu_inputs(eng, queries)
    for max_dist in (4, 0, 1, 2):
        e, hits = compare_mxu(eng, *inputs, max_dist=max_dist)
        errs.append(e)
        emit({"phase": "mxu_kernel_vs_plain", "input": "small",
              "max_dist": max_dist, "neighbours": hits, "max_abs_err": e})
    q, qsp = ragged_mxu_inputs(eng, queries)
    e, hits = compare_mxu(eng, q, qsp)
    errs.append(e)
    emit({"phase": "mxu_kernel_vs_plain", "input": "small, ragged qb",
          "qb": qsp.shape[2], "neighbours": hits, "max_abs_err": e})
    for width, seq_length in ((4, 20), (8, 16)):
        other = mxu_at(index, dev, width, seq_length)
        for max_dist in (4, 2):
            e, hits = compare_mxu(other, *mxu_inputs(other, queries),
                                  max_dist=max_dist)
            if hits == 0:
                fail(f"neighbour finder at width {width}, seq_length "
                     f"{seq_length}: no neighbour, so the input tests "
                     "nothing")
            errs.append(e)
            emit({"phase": "mxu_kernel_vs_plain",
                  "input": f"small, slice width {width}, seq_length "
                           f"{seq_length}", "slices": other.S,
                  "max_dist": max_dist, "neighbours": hits,
                  "max_abs_err": e})

    index, queries = skewed_world()
    eng = MxuIsslScorer(index, max_dist=4, chunk=1024, device=dev)
    e, hits = compare_mxu(eng, *mxu_inputs(eng, queries))
    errs.append(e)
    emit({"phase": "mxu_kernel_vs_plain", "input": "skewed",
          "nseg": eng.nseg, "segw": eng.segw, "neighbours": hits,
          "max_abs_err": e})

    # 8 buckets each of slices 0 and 4 of the page: other buckets are
    # given length 0, so both versions skip them
    q, qsp = mxu_inputs(bench_eng, page)
    blen = bench_eng.bucket_lens.clone()
    keep = blen.new_zeros(blen.shape, dtype=bool)
    keep[0, 40:48] = True
    keep[-1, 200:208] = True
    blen[~keep] = 0
    e, hits = compare_mxu(bench_eng, q, qsp, blen)
    errs.append(e)
    emit({"phase": "mxu_kernel_vs_plain", "input": "bench page, 16 buckets",
          "qb": qsp.shape[2], "nseg": bench_eng.nseg, "neighbours": hits,
          "max_abs_err": e})
    return max(errs)


def mxu_bound_ms(eng, q, qsp, neighbours):
    """Least time for the neighbour finder's work on this page: the largest
    of its tensor operations (2 x K per live (slot, entry) pair, K = 64 at
    slice width 8, else 96) over the int8 peak, its ALU operations (the OR
    fold of every sum, the one-hot rows of every entry for every 64-slot
    group with a live slot, ~16 per neighbour for its re-test and cell)
    over the ALU peak, and its bytes (the entries of buckets with a live
    slot, the plan, the queries and the offsets read once, the two planes
    written once) over HBM bandwidth. Returns (ms, bound by, live pairs,
    terms in ms); the terms keep the scalar design's 13-op term as
    "alu_13op"."""
    import torch.nn.functional as F

    n = q.numel()
    S, B, qb = qsp.shape
    live = (qsp >= 0) & (qsp < n)
    qcount = live.sum(-1).long()
    blen = eng.bucket_lens.long().clamp(max=eng.nseg * eng.segw)
    pairs = int((blen * qcount).sum())
    groups = F.pad(live, (0, -qb % PACKED_SLOT_GROUP)).reshape(
        S, B, -1, PACKED_SLOT_GROUP).any(-1).sum(-1).long()
    k = PACKED_K if B == 256 else 96
    nbytes = (int((blen * (qcount > 0)).sum()) * 8 + qsp.numel() * 4
              + n * 8 + S * B * 12 + S * B * eng.nseg * qb * 12)
    terms = {"tensor": pairs * 2 * k / H100_INT8_OPS_PER_S,
             "operations": (pairs * PACKED_OR_OPS_PER_PAIR
                            + int((blen * groups).sum())
                            * FULLSCAN_BUILD_OPS_PER_ENTRY[k]
                            + neighbours * MXU_CANDIDATE_OPS)
             / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    terms["alu_13op"] = pairs * MXU_OPS_PER_PAIR / H100_ALU_OPS_PER_S
    return terms[by] * 1e3, by, pairs, {k: v * 1e3 for k, v in terms.items()}


def phase_mxu_page(dev, eng, page, card):
    """The MXU engine on one page of the 27 Mbp index."""
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.mxu_finder import mxu_finder_plain

    eng.score(page)                                     # warm
    walls = host_walls(lambda: eng.score(page), dev)
    page_s = float(np.median(walls))
    # the page's parts, host clock, medians of 3: plan + finder + decode
    # (the hit table stays on the card), plan alone, self-lookup; the
    # replay (its launch and the sums' copy) is what the page spends
    # beyond them
    device_s = float(np.median(host_walls(lambda: eng._run_pages(page),
                                          dev)))
    plan_ms = float(np.median(host_walls(lambda: eng._plan(page), dev))) \
        * 1e3
    lookup_ms = float(np.median(host_walls(lambda: eng._self_lookup(page),
                                           dev))) * 1e3
    stats = eng.page_stats[-1]
    # the replay's rows: the decoded hits and each query's own site once
    flagged = eng.neighbour_counts(page) > 0
    replay_rows = (sum(r[3].shape[1] for r in eng._run_pages(page))
                   + int(eng._self_lookup(page)[0].sum()))
    q, qsp = mxu_inputs(eng, page)
    planes = eng.finder(q, qsp)
    neighbours = int(planes.cnt.sum())
    finder_ms = timed_ms(lambda: eng.finder(q, qsp), 3, dev)
    decode_ms = timed_ms(lambda: eng.decode(q, qsp, planes), 3, dev)
    del planes
    # the hybrid's re-score size: a page of 2 queries (qb 64)
    q2, qsp2 = mxu_inputs(eng, page[:2])
    small = eng.finder(q2, qsp2)
    small_ms = timed_ms(lambda: eng.finder(q2, qsp2), 10, dev)
    small_bound = mxu_bound_ms(eng, q2, qsp2, int(small.cnt.sum()))
    del small
    sync(dev)
    t = time.perf_counter()
    mxu_finder_plain(eng.entries, eng.bucket_offsets, eng.bucket_lens, q,
                     qsp, segw=eng.segw, nseg=eng.nseg,
                     max_dist=eng.max_dist, seq_length=eng.index.seq_length)
    sync(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    bound_ms, bound_by, pairs, terms = mxu_bound_ms(eng, q, qsp, neighbours)

    rng = np.random.default_rng(SEED + 2)
    sample = page[rng.choice(page.shape[0], size=min(SAMPLE, page.shape[0]),
                             replace=False)]
    got = eng.score(sample)
    want = native.exact_score_native(eng.index, sample, 4, 75.0, "and")
    if want is None:
        fail("native exact scorer unavailable")
    for name, g, w in zip(("mit", "cfd"), got, want):
        if not np.array_equal(g, w):
            fail(f"MXU engine {name} scores differ from the native exact "
                 f"scorer on {int((g != w).sum())} of {len(sample)} queries")
    emit({"phase": "mxu_page", "card": card, "device": str(dev),
          "sites": eng.index.num_sites, "queries": int(page.shape[0]),
          "qb": int(qsp.shape[2]), "nseg": eng.nseg, "segw": eng.segw,
          "pairs": pairs, "page_stats": list(stats),
          "flagged_queries": int(flagged.sum()), "replay_rows": replay_rows,
          "page_wall_s": walls, "device_pages_s": device_s,
          "plan_ms": plan_ms, "self_lookup_ms": lookup_ms,
          "replay_ms": (page_s - device_s) * 1e3 - lookup_ms,
          "finder_ms": finder_ms, "decode_ms": decode_ms,
          "finder_plain_ms": plain_ms, "finder_bound_ms": bound_ms,
          "finder_bound_by": bound_by, "finder_bound_terms_ms": terms,
          "neighbours": neighbours, "finder_2q_ms": small_ms,
          "finder_2q_qb": int(qsp2.shape[2]),
          "finder_2q_bound_ms": small_bound[0],
          "finder_2q_bound_by": small_bound[1],
          "finder_2q_bound_terms_ms": small_bound[3],
          "exact_guides_per_s": page.shape[0] / page_s,
          "sample_equal": len(sample)})
    return dict(ms=finder_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                **bound_label(bound_by))


def phase_sharded_page(dev, index, queries, card):
    """The 65,536-query page with ``ShardedCompactIsslScorer`` at 1, 2 and
    4 site-range shards, all listed on the one card (the port's form of the
    JAX package's virtual-device layout). After a first call that tunes
    each shard's cap, the counts are set to 0 and one call must launch
    the compact finder shards x pages times and run no plain version; its
    sums must lie within rtol 1e-9 of the one-shard page's (the same f32
    terms summed in f64 in another order). The page wall (host clock) and
    each shard's finder and decode (CUDA events) are timed; at 4 shards a
    2,048-query sample must be within rtol 1e-4 of the exact sums and the
    hybrid's ``and`` verdicts equal to native exact, and one warm page is
    profiled. Returns the launch counts by shard count."""
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.parallel.sharded import (ShardedCompactIsslScorer,
                                                      make_mesh)
    from crackling_tpu_torch.pipeline.run import verdicts

    kernels = kernel_counters()
    ref, launches = None, {}
    for k in (1, 2, 4):
        t = time.perf_counter()
        sc = ShardedCompactIsslScorer(index, make_mesh(k, 1, [dev] * k),
                                      max_dist=4)
        build_s = time.perf_counter() - t
        sc.score_sums(queries)                  # tunes each shard's cap
        reset_counters(kernels)
        sync(dev)
        t = time.perf_counter()
        mit_sum, cfd_sum = sc.score_sums(queries)
        sync(dev)
        walls = [time.perf_counter() - t]
        got, plain_calls = read_counters(kernels)
        pages = k * -(-queries.shape[0] // sc.engines[0][0].query_page)
        launches[k] = got["compact_finder"]
        if torch_is_cuda(dev) and (launches[k] != pages
                                   or got["compact_decode"] != pages
                                   or got["compact_rescan"] != pages
                                   or any(plain_calls.values())):
            fail(f"the {k}-shard page launched {got} with plain calls "
                 f"{plain_calls}; expected {pages} compact finder, decode "
                 "and rescan launches")
        walls += host_walls(lambda: sc.score_sums(queries), dev, reps=2)
        finder_ms, decode_ms = [], []
        for eng in sc.engines[0]:
            q, qsp = finder_inputs(eng, queries)
            fo = eng.finder(q, qsp)
            finder_ms.append(timed_ms(lambda: eng.finder(q, qsp), 3, dev))
            decode_ms.append(timed_ms(lambda: eng.decode(q, qsp, fo), 3,
                                      dev))
        if ref is None:
            ref = (mit_sum, cfd_sum)
        rel = max(float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
                  for g, w in zip((mit_sum, cfd_sum), ref))
        if rel > 1e-9:
            fail(f"the {k}-shard sums differ from the one-shard page's by "
                 f"{rel:.3e} (relative)")
        line = {"phase": "sharded_page", "card": card, "shards": k,
                "queries": int(queries.shape[0]), "build_s": build_s,
                "page_wall_s": walls,
                "guides_per_s": queries.shape[0] / float(np.median(walls)),
                "finder_ms_by_shard": finder_ms,
                "finder_ms_total": float(np.sum(finder_ms)),
                "decode_ms_by_shard": decode_ms,
                "rescan_chunks_by_shard": [e.page_stats[-1][5]
                                           for e in sc.engines[0]],
                "shard_sites": [e.index.num_sites for e in sc.engines[0]],
                "launches": got, "plain_calls": plain_calls,
                "max_rel_diff_vs_one_shard": rel}
        if k == 4:
            rng = np.random.default_rng(SEED + 6)
            pick = rng.choice(queries.shape[0],
                              size=min(SAMPLE, queries.shape[0]),
                              replace=False)
            sample = queries[pick]
            line["sample_max_rel_err"], line["sample_max_score_dev"] = \
                sample_vs_exact(sc, "sharded compact", index, mit_sum,
                                cfd_sum, pick, sample)
            hyb = HybridIsslScorer(index, max_dist=4, method="and",
                                   threshold=75.0, dense=sc)
            em, ec = native.exact_score_native(index, sample, 4, 75.0, "and")
            if not np.array_equal(verdicts(*hyb.score(sample), 75.0, "and"),
                                  verdicts(em, ec, 75.0, "and")):
                fail("hybrid verdicts over the 4-shard engine differ from "
                     "the exact scorer's (and, 75)")
            line["hybrid_sample_rescored"] = hyb.last_rescored
            del hyb
        emit(line)
        if k == 4:
            phase_profile(dev, lambda: sc.score_sums(queries), "compact.")
        del sc
    return launches


# a mouse re-score page: ~31,000 guides a batch in 4 MXU pages, ~198
# distinct sites a guide, each found in ~1.5 slices
REPLAY_QUERIES = 7750
REPLAY_ROWS = 300
REPLAY_CROWDED = 4          # guides with 3,000 rows: past shared memory
REPLAY_LIST = 1 << 27       # entries of the flat list the rows point into


def replay_page(n=REPLAY_QUERIES, rows=REPLAY_ROWS, seed=SEED + 5,
                crowded=REPLAY_CROWDED):
    """A synthetic page for the exact replay, on the CPU: ``n`` guides with
    ``rows`` +- 50 hit rows each (the last ``crowded`` with 3,000),
    each row a site 0-4 bases from its guide at a distinct position
    (spread by an odd multiplier) of a 2^27-entry list (1 GB, far past the
    L2), in a random slice with a distinct site id, the table shuffled; a
    tenth of the guides have their own site. Returns the replay's
    arguments before the tables: (hits, q_sig, own, entries, occ)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(rows - 50, rows + 51, (n,), generator=g)
    counts[n - crowded:] = 3000
    H = int(counts.sum())
    hq = torch.repeat_interleave(torch.arange(n), counts)
    q_sig = torch.randint(0, 1 << 40, (n,), generator=g)
    sig = q_sig[hq].clone()
    for k, share in enumerate((1.0, 0.8, 0.5, 0.3)):
        p = torch.randint(0, 20, (H,), generator=g)
        d = torch.randint(1, 4, (H,), generator=g)
        sig ^= torch.where(torch.rand(H, generator=g) < share,
                           d << (2 * p), 0)
    pos = (torch.arange(H) * 2654435761) % REPLAY_LIST
    entries = torch.full((REPLAY_LIST,), -1, dtype=torch.int64)
    entries[pos] = sig
    occ = torch.randint(1, 4, (REPLAY_LIST,), generator=g,
                        dtype=torch.int32)
    hits = torch.stack([hq, torch.randint(0, 5, (H,), generator=g),
                        torch.randperm(H, generator=g), pos])
    hits = hits[:, torch.randperm(H, generator=g)].contiguous()
    own = torch.stack([
        torch.where(torch.rand(n, generator=g) < 0.1, H + torch.arange(n),
                    -1),
        torch.randint(1, 4, (n,), generator=g)])
    return hits, q_sig, own, entries, occ


def replay_bound_ms(hit_rows, n):
    """Least time for the replay's bytes: per row its query read by the
    count, its four words by the scatter, its key and position written and
    read back, and its site's signature, count and MIT table value
    gathered (92 B); per guide its own site twice, signature, count,
    offsets and sums (~92 B); over HBM bandwidth."""
    return (92 * hit_rows + 92 * n) / H100_BYTES_PER_S * 1e3


def phase_mxu_replay(dev, card):
    """The exact replay kernel on a mouse-like page (``replay_page``): its
    sums against the plain version's with max error 0 for all five
    methods, its spilled guides, its time (CUDA events) beside its byte
    bound and the plain version's (host clock); then its time on the same
    page with no crowded guide, all in shared memory."""
    import torch

    from crackling_tpu_torch.ops import mxu_replay as mr

    cpu_args = replay_page()
    dev_args = [t.to(dev) for t in cpu_args]
    tabs_cpu = mr.replay_tables(20, 4, "cpu")
    tabs = mr.replay_tables(20, 4, dev)
    hit_rows, n = cpu_args[0].shape[1], cpu_args[1].numel()
    err, plain_ms, spilled = 0.0, {}, None
    for method, thr in METHODS:
        kw = dict(method=method, maximum_sum=mr.maximum_sum(thr),
                  slice_width=8)
        t = time.perf_counter()
        want = mr.mxu_replay_plain(*cpu_args, tabs_cpu, **kw)
        plain_ms[method] = (time.perf_counter() - t) * 1e3
        got = mr.mxu_replay(*dev_args, tabs, **kw)
        err = max(err, float((got.sums.cpu() - want.sums).abs().max()))
        if not torch.equal(got.sums.cpu(), want.sums):
            fail(f"replay kernel sums differ from the plain version's "
                 f"({method}): max error {err}")
        spilled = int(got.spilled)
        if spilled != int(want.spilled) or spilled != REPLAY_CROWDED:
            fail(f"the replay kernel spilled {spilled} guides, the plain "
                 f"version counts {int(want.spilled)}")
    kw = dict(method="and", maximum_sum=mr.maximum_sum(75.0), slice_width=8)
    ms = timed_ms(lambda: mr.mxu_replay(*dev_args, tabs, **kw), 10, dev)
    bound_ms = replay_bound_ms(hit_rows, n)
    flat = [t.to(dev) for t in replay_page(crowded=0)]
    flat_ms = timed_ms(lambda: mr.mxu_replay(*flat, tabs, **kw), 10, dev)
    flat_bound_ms = replay_bound_ms(flat[0].shape[1], n)
    del flat
    emit({"phase": "mxu_replay", "card": card, "device": str(dev),
          "queries": n, "hit_rows": hit_rows, "spilled": spilled,
          "methods": [m for m, _ in METHODS], "max_abs_err": err,
          "kernel_ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
          "plain_ms": plain_ms, "uncrowded_kernel_ms": flat_ms,
          "uncrowded_bound_ms": flat_bound_ms})
    return err, dict(ms=ms, plain_ms=plain_ms["and"], bound_ms=bound_ms,
                     **bound_label("bytes"))


def phase_mxu_small(dev):
    from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer
    from crackling_tpu_torch.ops.oracle import score_exact

    index, queries = small_world()
    for method, thr in METHODS:
        eng = MxuIsslScorer(index, max_dist=4, method=method, threshold=thr,
                            device=dev)
        for name, g, w in zip(("mit", "cfd"), eng.score(queries),
                              score_exact(index, queries, 4, thr, method)):
            if not np.array_equal(g, w):
                fail(f"MXU engine {name} scores differ from score_exact "
                     f"({method})")
    emit({"phase": "mxu_small", "methods": [m for m, _ in METHODS],
          "bit_exact": True})


def phase_flat(dev, index, queries):
    """The flat exact engine on the card: f64 and f32 on the small index,
    then an f32 sample of the 27 Mbp index."""
    import torch

    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.issl_flat import IsslScorer
    from crackling_tpu_torch.ops.oracle import score_exact
    from crackling_tpu_torch.pipeline.run import verdicts

    calc = {"mit": (True, False), "cfd": (False, True)}
    sw_index, sw_queries = small_world()
    for method, thr in METHODS:
        ref = score_exact(sw_index, sw_queries, 4, thr, method)
        for dtype in (torch.float64, torch.float32):
            got = IsslScorer(sw_index, max_dist=4, method=method,
                             threshold=thr, dtype=dtype,
                             device=dev).score(sw_queries)
            if not np.array_equal(verdicts(*got, thr, method),
                                  verdicts(*ref, thr, method)):
                fail(f"flat engine ({dtype}) verdicts differ from "
                     f"score_exact ({method})")
            if dtype == torch.float64:
                for on, g, r in zip(calc.get(method, (True, True)), got,
                                    ref):
                    if on and not np.allclose(g, r, rtol=1e-12, atol=0):
                        fail(f"flat engine f64 scores differ from "
                             f"score_exact ({method})")
    rng = np.random.default_rng(SEED + 3)
    sample = queries[rng.choice(queries.shape[0], size=SAMPLE,
                                replace=False)]
    eng = IsslScorer(index, max_dist=4, method="and", threshold=75.0,
                     dtype=torch.float32, device=dev)
    eng.score(sample[:256])                                # warm
    sync(dev)
    t = time.perf_counter()
    got = eng.score(sample)
    flat_s = time.perf_counter() - t
    want = native.exact_score_native(index, sample, 4, 75.0, "and")
    if not np.array_equal(verdicts(*got, 75.0, "and"),
                          verdicts(*want, 75.0, "and")):
        fail("flat engine f32 verdicts differ from the native exact scorer")
    rel = max(float((np.abs(g - w) / w).max()) for g, w in zip(got, want))
    # the GPU's work block against the JAX engine's 2^17, in turns, on a
    # 256-query page (the exit emulation stops at the same hit at any
    # round size)
    jax_wb = IsslScorer(index, max_dist=4, method="and", threshold=75.0,
                        dtype=torch.float32, device=dev,
                        work_block=1 << 17)
    wb_s = {jax_wb.work_block: [], eng.work_block: []}
    for e in (jax_wb, eng, eng, jax_wb):
        e.score(sample[:32])
        wb_s[e.work_block] += host_walls(
            lambda e=e: e.score(sample[:256]), dev, reps=1)
    emit({"phase": "flat", "small_methods": [m for m, _ in METHODS],
          "sample": SAMPLE, "work_block": eng.work_block, "sample_s": flat_s,
          "guides_per_s": SAMPLE / flat_s, "sample_max_rel_err": rel,
          "page256_s_by_work_block": wb_s})


def fullscan_engines(index, dev, **dense_kw):
    from crackling_tpu_torch.ops.issl_dense import DenseIsslScorer
    from crackling_tpu_torch.ops.issl_scan import ScanIsslScorer

    return (DenseIsslScorer(index, max_dist=4, device=dev, **dense_kw),
            ScanIsslScorer(index, max_dist=4, device=dev))


def dense_inputs(eng, queries, qb=None):
    """The dense scan's inputs for one page of ``queries`` (the slot plan
    the engine itself makes, or one of ``qb`` slots)."""
    from crackling_tpu_torch.ops.issl_compact import plan_query_occupancy

    if qb is None:
        qb, _ = plan_query_occupancy(queries, eng.S, eng.B, 8, eng.qb_cap)
    if qb is None:
        fail("query page overflows the dense engine's qb_cap")
    q = eng.query_tensor(queries)
    return q, eng.plan(q, qb)


def hit_count(eng, q, qsp, blen, max_dist=None):
    """Hits of the full-scan predicate on this plan: the compact finder's
    plain version tests the same predicate (w = 8); its bucket totals."""
    from crackling_tpu_torch.ops.compact_finder import (KERNEL_TILE,
                                                        compact_finder_plain)

    width = max(KERNEL_TILE, -(-int(blen.max()) // KERNEL_TILE)
                * KERNEL_TILE)
    fo = compact_finder_plain(eng.entries, eng.bucket_offsets, blen, q, qsp,
                              chunk=width, nchmax=1, superchunk=0,
                              max_dist=eng.max_dist if max_dist is None
                              else max_dist)
    return int(fo.cnt[:, :, -1].sum())


def check_sums(what, got, want):
    """Fail unless every cell of the kernel's sums lies within
    FULLSCAN_RTOL / FULLSCAN_ATOL of the plain version's; return the
    largest absolute and relative errors."""
    import torch

    errs = [0.0, 0.0]
    for name, a, b in zip(("mit", "cfd"), got, want):
        d = (a - b).abs()
        bad = d > FULLSCAN_ATOL + FULLSCAN_RTOL * b.abs()
        if bool(bad.any()):
            fail(f"{what} kernel disagrees with its plain version on {name}"
                 f" ({int(bad.sum())} cells, max abs diff {float(d.max())})")
        rel = torch.where(b != 0, d / b.abs(), d)
        errs = [max(errs[0], float(d.max())), max(errs[1], float(rel.max()))]
    return errs


def compare_dense(eng, q, qsp, blen=None, max_dist=None):
    from crackling_tpu_torch.ops.fullscan import dense_scan, dense_scan_plain

    blen = eng.bucket_lens if blen is None else blen
    max_dist = eng.max_dist if max_dist is None else max_dist
    args = (eng.entries, eng.occ, eng.bucket_offsets, blen, q, qsp)
    kw = dict(max_dist=max_dist, tabs=eng.tables)
    got = dense_scan(*args, **kw)
    want = dense_scan_plain(*args, **kw)
    sync(q.device)
    return (check_sums("dense scan", got, want),
            hit_count(eng, q, qsp, blen, max_dist))


def compare_scan(eng, q, blen=None, max_dist=None):
    from crackling_tpu_torch.ops.fullscan import (bucket_scan,
                                                  bucket_scan_plain)

    blen = eng.bucket_lens if blen is None else blen
    qoff, qsorted = eng.plan(q)
    args = (eng.entries, eng.occ, eng.bucket_offsets, blen, q, qoff, qsorted)
    kw = dict(slice_width=eng.index.slice_width,
              max_dist=eng.max_dist if max_dist is None else max_dist,
              tabs=eng.tables)
    got = bucket_scan(*args, **kw)
    want = bucket_scan_plain(*args, **kw)
    sync(q.device)
    return check_sums("bucket scan", got, want), int((want[1] > 0).sum())


def scan_at_width(index, width, dev):
    """The scan-style engine over the index's sites at slice width 4 (10
    slices) or 16 (2 slices over positions 0-15, an index of 16-position
    slices whose 40-bit signatures keep positions 16-19 for the distance):
    the bucket scan's K = 96 path."""
    from crackling_tpu_torch.index.build import IsslIndex
    from crackling_tpu_torch.ops.issl_scan import ScanIsslScorer

    other = IsslIndex(seq_length=20 if width < 16 else 16,
                      slice_width=width, seq_count=index.seq_count,
                      site_sigs=index.site_sigs,
                      occurrences=index.occurrences)
    return ScanIsslScorer(other, max_dist=4, device=dev)


def phase_fullscan_kernels_vs_plain(dev, bench_dense, bench_scan, queries):
    """Both full-scan kernels against their plain versions on the small
    index (max-distance 4, 0 and 2; a ragged qb for the dense scan; the
    bucket scan also at slice widths 4 and 16, its K = 96 path), the
    skewed index and 16 buckets of the 65,536-query page (max-distance 4,
    0 and 2; a ragged qb); returns each kernel's largest (abs, rel)
    error."""
    worst = {"dense_scan": [0.0, 0.0], "bucket_scan": [0.0, 0.0]}

    def note(kernel, err):
        worst[kernel] = [max(a, b) for a, b in zip(worst[kernel], err)]

    def both(name, dense, scan, qs, bl, max_dist=4, qb=None):
        q, qsp = dense_inputs(dense, qs, qb)
        derr, hits = compare_dense(dense, q, qsp, bl, max_dist)
        serr, scan_cells = compare_scan(scan, q, bl, max_dist)
        note("dense_scan", derr)
        note("bucket_scan", serr)
        emit({"phase": "fullscan_kernels_vs_plain", "input": name,
              "max_dist": max_dist, "qb": int(qsp.shape[2]), "hits": hits,
              "bucket_scan_cells_hit": scan_cells,
              "dense_scan_max_abs_err": derr[0],
              "dense_scan_max_rel_err": derr[1],
              "bucket_scan_max_abs_err": serr[0],
              "bucket_scan_max_rel_err": serr[1]})

    index, qs = small_world()
    dense, scan = fullscan_engines(index, dev, chunk=1024)
    for max_dist in (4, 0, 2):
        both("small", dense, scan, qs, None, max_dist)
    q, qsp = dense_inputs(dense, qs, ragged_qb(dense, qs))
    derr, hits = compare_dense(dense, q, qsp)
    note("dense_scan", derr)
    emit({"phase": "fullscan_kernels_vs_plain", "input": "small, ragged qb",
          "qb": int(qsp.shape[2]), "hits": hits,
          "dense_scan_max_abs_err": derr[0],
          "dense_scan_max_rel_err": derr[1]})
    for width in (4, 16):
        wscan = scan_at_width(index, width, dev)
        for max_dist in (4, 2):
            serr, cells = compare_scan(wscan, wscan.query_tensor(qs),
                                       max_dist=max_dist)
            if cells == 0:
                fail(f"bucket scan at width {width}: no cell hit, so the "
                     "K = 96 path was not exercised")
            note("bucket_scan", serr)
            emit({"phase": "fullscan_kernels_vs_plain",
                  "input": f"small, slice width {width}",
                  "slices": wscan.S, "max_dist": max_dist,
                  "bucket_scan_cells_hit": cells,
                  "bucket_scan_max_abs_err": serr[0],
                  "bucket_scan_max_rel_err": serr[1]})
        del wscan

    index, qs = skewed_world()
    dense, scan = fullscan_engines(index, dev, chunk=1024)
    both("skewed", dense, scan, qs, None)
    # 8 buckets each of slices 0 and 4 of the full page: other buckets
    # are given length 0, so both versions skip them
    blen = bench_dense.bucket_lens.clone()
    keep = blen.new_zeros(blen.shape, dtype=bool)
    keep[0, 40:48] = True
    keep[-1, 200:208] = True
    blen[~keep] = 0
    for max_dist in (4, 0, 2):
        both("bench page, 16 buckets", bench_dense, bench_scan, queries,
             blen, max_dist)
    q, qsp = dense_inputs(bench_dense, queries,
                          ragged_qb(bench_dense, queries))
    derr, hits = compare_dense(bench_dense, q, qsp, blen)
    note("dense_scan", derr)
    emit({"phase": "fullscan_kernels_vs_plain",
          "input": "bench page, 16 buckets, ragged qb",
          "qb": int(qsp.shape[2]), "hits": hits,
          "dense_scan_max_abs_err": derr[0],
          "dense_scan_max_rel_err": derr[1]})
    return worst


def fullscan_bound_ms(eng, k, pairs, entry_groups, hits, nbytes):
    """Least time for a full-scan kernel's work: the largest of its tensor
    operations (2 x ``k`` per live pair) over the int8 peak, its ALU
    operations (the OR fold of every live pair's sum, the one-hot rows of
    every entry for every 64-query group, the scoring of every hit) over
    the ALU peak, and its bytes (``nbytes`` and the penalty table) over
    HBM bandwidth. Returns (ms, bound by, terms in ms); the terms keep the
    scalar design's 12-op ALU term as "alu_12op"."""
    nbytes += eng.tables.pen.numel() * 4
    terms = {"tensor": pairs * 2 * k / H100_INT8_OPS_PER_S,
             "operations": (pairs * PACKED_OR_OPS_PER_PAIR
                            + entry_groups * FULLSCAN_BUILD_OPS_PER_ENTRY[k]
                            + hits * FULLSCAN_HIT_OPS)
             / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    terms["alu_12op"] = pairs * FULLSCAN_OPS_PER_PAIR / H100_ALU_OPS_PER_S
    return terms[by] * 1e3, by, {k: v * 1e3 for k, v in terms.items()}


def sample_vs_exact(eng, what, index, mit_sum, cfd_sum, sample_idx, sample):
    """Raw full-scan sums of a sample against the native exact scorer's
    (no early exit): within rtol 1e-4; returns the largest relative error
    and the largest score deviation."""
    from crackling_tpu_torch import native

    ex = native.exact_score_native(index, sample, 4, None, "and")
    if ex is None:
        fail("native exact scorer unavailable")
    ex_sums = [10000.0 / s - 100.0 for s in ex]
    rel, dev_score = 0.0, 0.0
    for name, got, want in (("mit", mit_sum[sample_idx], ex_sums[0]),
                            ("cfd", cfd_sum[sample_idx], ex_sums[1])):
        if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            bad = np.abs(got - want) / np.maximum(np.abs(want), 1e-4)
            fail(f"{what} {name} sums disagree with the exact scorer "
                 f"(max rel err {bad.max():.3e})")
        rel = max(rel, float((np.abs(got - want)
                              / np.maximum(np.abs(want), 1e-4)).max()))
        dev_score = max(dev_score, float(np.abs(
            10000.0 / (100.0 + got) - 10000.0 / (100.0 + want)).max()))
    return rel, dev_score


def phase_dense_page(dev, eng, queries, card):
    """The dense engine on the 65,536-query page, then the hybrid over
    it."""
    import torch.nn.functional as F

    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.fullscan import dense_scan, dense_scan_plain
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.pipeline.run import verdicts

    mit_sum, cfd_sum = eng.score_sums(queries)                 # warm
    walls = host_walls(lambda: eng.score_sums(queries), dev)
    page_s = float(np.median(walls))
    q, qsp = dense_inputs(eng, queries)
    args = (eng.entries, eng.occ, eng.bucket_offsets, eng.bucket_lens, q,
            qsp)
    kw = dict(max_dist=eng.max_dist, tabs=eng.tables)
    kernel_ms = timed_ms(lambda: dense_scan(*args, **kw), 3, dev)
    plan_ms = float(np.median(host_walls(
        lambda: dense_inputs(eng, queries), dev))) * 1e3
    sync(dev)
    t = time.perf_counter()
    dense_scan_plain(*args, **kw)
    sync(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    n = q.numel()
    S, B, qb = qsp.shape
    live = qsp < n
    qcount = live.sum(-1).long()
    blen = eng.bucket_lens.long()
    pairs = int((blen * qcount).sum())
    groups = F.pad(live, (0, -qb % PACKED_SLOT_GROUP)).reshape(
        S, B, -1, PACKED_SLOT_GROUP).any(-1).sum(-1).long()
    hits = hit_count(eng, q, qsp, eng.bucket_lens)
    bound_ms, bound_by, terms = fullscan_bound_ms(
        eng, PACKED_K, pairs, int((blen * groups).sum()), hits,
        int((blen * (qcount > 0)).sum()) * 8 + hits * 8 + qsp.numel() * 4
        + n * 8 + S * B * 12 + S * B * qb * 16)

    rng = np.random.default_rng(SEED + 5)
    pick = rng.choice(queries.shape[0], size=min(SAMPLE, queries.shape[0]),
                      replace=False)
    sample = queries[pick]
    rel, score_dev = sample_vs_exact(eng, "dense", eng.index, mit_sum,
                                     cfd_sum, pick, sample)
    hyb = HybridIsslScorer(eng.index, max_dist=4, method="and",
                           threshold=75.0, dense=eng)
    hm, hc = hyb.score(sample)
    em, ec = native.exact_score_native(eng.index, sample, 4, 75.0, "and")
    if not np.array_equal(verdicts(hm, hc, 75.0, "and"),
                          verdicts(em, ec, 75.0, "and")):
        fail("hybrid-dense verdicts differ from the exact scorer's "
             "(and, 75)")
    sample_rescored = hyb.last_rescored
    hyb_walls = host_walls(lambda: hyb.score(queries), dev)
    emit({"phase": "dense_page", "card": card, "device": str(dev),
          "sites": eng.index.num_sites, "queries": n, "qb": qb,
          "pairs": pairs, "page_wall_s": walls, "plan_ms": plan_ms,
          "hits": hits, "kernel_ms": kernel_ms,
          "kernel_plain_ms": plain_ms, "kernel_bound_ms": bound_ms,
          "kernel_bound_by": bound_by, "kernel_bound_terms_ms": terms,
          "dense_guides_per_s": n / page_s,
          "sample_max_rel_err": rel, "sample_max_score_dev": score_dev,
          "hybrid_band": hyb.band, "hybrid_sample_rescored": sample_rescored,
          "hybrid_page_wall_s": hyb_walls,
          "last_rescored": hyb.last_rescored,
          "hybrid_guides_per_s": n / float(np.median(hyb_walls))})
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                **bound_label(bound_by),
                bound_terms_ms=terms)


def phase_scan_page(dev, eng, queries, card):
    """The scan-style engine on the 65,536 queries in 8,192-query
    pages."""
    from crackling_tpu_torch.ops.fullscan import (bucket_scan,
                                                  bucket_scan_plain)

    mit_sum, cfd_sum = eng.score_sums(queries)                 # warm
    walls = host_walls(lambda: eng.score_sums(queries), dev)
    page = queries[:eng.query_page]
    q = eng.query_tensor(page)
    qoff, qsorted = eng.plan(q)
    args = (eng.entries, eng.occ, eng.bucket_offsets, eng.bucket_lens, q,
            qoff, qsorted)
    kw = dict(slice_width=eng.index.slice_width, max_dist=eng.max_dist,
              tabs=eng.tables)
    kernel_ms = timed_ms(lambda: bucket_scan(*args, **kw), 3, dev)
    page_ms = float(np.median(host_walls(lambda: eng.run_page(page),
                                         dev))) * 1e3
    plan_ms = float(np.median(host_walls(lambda: eng.plan(q), dev))) * 1e3
    sync(dev)
    t = time.perf_counter()
    bucket_scan_plain(*args, **kw)
    sync(dev)
    plain_ms = (time.perf_counter() - t) * 1e3
    from crackling_tpu_torch.ops.fullscan import scan_k
    from crackling_tpu_torch.ops.issl_compact import plan_slots

    counts = (qoff[:, 1:] - qoff[:, :-1]).long()
    blen = eng.bucket_lens.long()
    pairs = int((blen * counts).sum())
    S, n = qsorted.shape
    # the hits of the page: the finder's plain version over a slot plan of
    # its queries tests the same predicate (w = 8: the raw dedup is the
    # byte dedup)
    qb = int(counts.max())
    hits = hit_count(eng, q, plan_slots(q, S, eng.B, qb), eng.bucket_lens)
    bound_ms, bound_by, terms = fullscan_bound_ms(
        eng, scan_k(eng.index.slice_width), pairs,
        int((blen * (-(-counts // PACKED_SLOT_GROUP))).sum()), hits,
        int((blen * (counts > 0)).sum()) * 8 + hits * 8 + qoff.numel() * 4
        + qsorted.numel() * 4 + n * 8 + S * eng.B * 12 + S * n * 16)
    rng = np.random.default_rng(SEED + 6)
    pick = rng.choice(queries.shape[0], size=min(SAMPLE, queries.shape[0]),
                      replace=False)
    rel, score_dev = sample_vs_exact(eng, "scan-style", eng.index, mit_sum,
                                     cfd_sum, pick, queries[pick])
    page_s = float(np.median(walls))
    emit({"phase": "scan_page", "card": card, "device": str(dev),
          "queries": int(queries.shape[0]), "query_page": eng.query_page,
          "launches_per_pass": -(-queries.shape[0] // eng.query_page),
          "pairs_per_page": pairs, "pass_wall_s": walls,
          "hits_per_page": hits, "page_ms": page_ms, "plan_ms": plan_ms,
          "kernel_ms": kernel_ms, "kernel_plain_ms": plain_ms,
          "kernel_bound_ms": bound_ms, "kernel_bound_by": bound_by,
          "kernel_bound_terms_ms": terms,
          "scan_guides_per_s": queries.shape[0] / page_s,
          "sample_max_rel_err": rel, "sample_max_score_dev": score_dev})
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                **bound_label(bound_by),
                bound_terms_ms=terms)


def deep_world(seed=31, n_deep=4_300_000):
    """~4.3 M random sites share their slice-0 byte: one bucket of more
    than 2^22 entries, past the JAX engine's rank bound (the port's is
    2^30). Queries: 128 in the deep bucket (64 of its sites, 32 of
    them with a repeated one-base neighbour, and 64 one-base variants of
    other sites) and 128 elsewhere."""
    from crackling_tpu_torch.index import build_index

    rng = np.random.default_rng(seed)

    def pin(sigs):
        return (sigs & ~np.uint64(0xFF)) | np.uint64(0x55)

    deep = pin(rng.integers(0, 1 << 40, size=n_deep).astype(np.uint64))
    filler = rng.integers(0, 1 << 40, size=20_000).astype(np.uint64)
    # one-base variants of 32 of the queries, 1-60 copies each, so their
    # scores spread across the threshold
    hot_pos = rng.integers(4, 20, size=32).astype(np.uint64) * np.uint64(2)
    base = (deep[:32] >> hot_pos) & np.uint64(3)
    hot = ((deep[:32] & ~(np.uint64(3) << hot_pos))
           | (((base + np.uint64(1)) & np.uint64(3)) << hot_pos))
    index = build_index(np.concatenate([
        deep, filler, np.repeat(hot, rng.integers(1, 61, size=32))]))
    pos = rng.integers(4, 20, size=64).astype(np.uint64) * np.uint64(2)
    variants = ((deep[64:128] & ~(np.uint64(3) << pos))
                | (rng.integers(0, 4, size=64).astype(np.uint64) << pos))
    queries = np.concatenate([
        deep[:64], variants, filler[:64],
        rng.integers(0, 1 << 40, size=64).astype(np.uint64)])
    return index, queries


def write_config(out, files, engine, sites=None, tpu_extra=""):
    """A ``Crackling`` config on the bench files (``sites`` replaces the
    off-target index) with ``[tpu] engine = <engine>`` and the ``[tpu]``
    lines ``tpu_extra``."""
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
offtarget-sites = {sites or files['issl']}
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
engine = {engine}
{tpu_extra}""")
    return cfg


def phase_deep_bucket(dev, files):
    """``engine = compact``, then ``engine = sharded`` (one process), on an
    index past the JAX engine's 2^22 rank bound: the hybrid over the
    compact engine (the sharded compact engine) with no fallback logged,
    launching ``compact_finder``; then both with the compact lists made
    not to fit the device (``issl_compact.free_bytes`` patched while the
    pipeline builds its scorer): the logged fallback to the hybrid over
    the dense engine (the sharded dense engine), launching ``dense_scan``.
    Each run's verdicts on 256 queries must equal native exact, with no
    plain version run. Returns the sharded dense run's ``dense_scan``
    launches."""
    import contextlib
    import io

    from crackling_tpu_torch import native
    from crackling_tpu_torch.index import write_reference_issl
    from crackling_tpu_torch.ops import issl_compact
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
    from crackling_tpu_torch.ops.issl_dense import DenseIsslScorer
    from crackling_tpu_torch.parallel.sharded import (ShardedCompactIsslScorer,
                                                      ShardedDenseIsslScorer)
    from crackling_tpu_torch.pipeline.config import ConfigManager
    from crackling_tpu_torch.pipeline.run import Pipeline, verdicts

    t = time.perf_counter()
    index, queries = deep_world()
    deepest = int(np.diff(index.bucket_offsets, axis=1).max())
    if deepest <= 1 << 22:
        fail(f"the deep index's deepest bucket ({deepest:,}) is within the "
             "JAX engine's rank bound")
    out = CACHE / "deep_bucket"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    issl = out / "deep.issl"
    write_reference_issl(index, str(issl))
    build_s = time.perf_counter() - t
    want = verdicts(*native.exact_score_native(index, queries, 4, 75.0,
                                               "and"), 75.0, "and")
    kernels = kernel_counters()

    @contextlib.contextmanager
    def lists_do_not_fit():
        real = issl_compact.free_bytes
        issl_compact.free_bytes = lambda device: 1
        try:
            yield
        finally:
            issl_compact.free_bytes = real

    runs = (
        ("compact", False, (), CompactIsslScorer, "compact_finder"),
        ("sharded", False, (), ShardedCompactIsslScorer, "compact_finder"),
        ("compact", True, ("compact engine unavailable",
                           "using the dense engine"), DenseIsslScorer,
         "dense_scan"),
        ("sharded", True, ("sharded compact unavailable",
                           "using the sharded dense engine"),
         ShardedDenseIsslScorer, "dense_scan"))
    for engine, refused, log_lines, dense_type, kernel in runs:
        cm = ConfigManager(str(write_config(out, files, engine, issl)),
                           lambda m: None)
        if not cm.isConfigured():
            fail("the deep-bucket config did not load")
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                (lists_do_not_fit() if refused else contextlib.nullcontext()):
            scorer = Pipeline(cm, device=dev)._get_issl_scorer()
        load_s = time.perf_counter() - t
        log = buf.getvalue()
        if refused and not all(ln in log for ln in log_lines):
            fail(f"engine = {engine} on the deep index with lists that do "
                 f"not fit did not log the dense fallback: {log!r}")
        if not refused and "unavailable" in log:
            fail(f"engine = {engine} on the deep index fell back: {log!r}")
        if not isinstance(scorer, HybridIsslScorer) \
                or not isinstance(scorer.dense, dense_type):
            fail(f"the deep index's scorer is {type(scorer).__name__} over "
                 f"{type(getattr(scorer, 'dense', None)).__name__}, not the "
                 f"hybrid over {dense_type.__name__}")
        reset_counters(kernels)
        t = time.perf_counter()
        got = scorer.score(queries)
        sync(dev)
        score_s = time.perf_counter() - t
        launches, plain_calls = read_counters(kernels)
        if not np.array_equal(verdicts(*got, 75.0, "and"), want):
            fail(f"deep-bucket verdicts (engine = {engine}, lists "
                 f"{'refused' if refused else 'resident'}) differ from the "
                 "native exact scorer")
        if torch_is_cuda(dev) and (launches[kernel] <= 0
                                   or any(plain_calls.values())):
            fail(f"the deep index's engine = {engine} run (lists "
                 f"{'refused' if refused else 'resident'}) launched "
                 f"{launches} with plain calls {plain_calls}")
        emit({"phase": "deep_bucket", "engine": engine,
              "fast": dense_type.__name__, "lists_refused": refused,
              "sites": index.num_sites, "deepest_bucket": deepest,
              "queries": int(queries.shape[0]),
              "rescored": scorer.last_rescored,
              "rescorer": type(scorer._exact).__name__ if scorer._exact
              else None, "index_build_s": build_s,
              "pipeline_load_s": load_s, "score_s": score_s,
              "launches": launches, "plain_calls": plain_calls,
              "accepted": int(verdicts(*got, 75.0, "and").sum())})
        del scorer
    return launches["dense_scan"]


def phase_hybrid_methods(dev, fast):
    """The hybrid over ``fast`` (``compact``, passed in as the pipeline
    passes it, or its default, ``dense``) on the small index."""
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
    from crackling_tpu_torch.ops.mxu_finder import mxu_finder
    from crackling_tpu_torch.ops.oracle import score_exact
    from crackling_tpu_torch.pipeline.run import verdicts

    index, queries = small_world()
    res, launches, rescored = {}, {}, {}
    for method, thr in METHODS:
        want = verdicts(*score_exact(index, queries, 4, thr, method), thr,
                        method)
        for band in (None, np.inf):
            before = mxu_finder.launches
            engine = (CompactIsslScorer(index, max_dist=4, chunk=1024,
                                        device=dev)
                      if fast == "compact" else None)
            hy = HybridIsslScorer(index, max_dist=4, method=method,
                                  threshold=thr, band=band, device=dev,
                                  dense=engine,
                                  **({} if engine else dict(chunk=1024)))
            got = verdicts(*hy.score(queries), thr, method)
            if not np.array_equal(got, want):
                fail(f"hybrid-{fast} verdicts differ from score_exact "
                     f"({method}, band {band})")
            if band is None:
                own_band = hy.band
                rescored[method] = hy.last_rescored
        # the infinite band re-scored every query through the MXU engine's
        # neighbour finder on the card
        launches[method] = mxu_finder.launches - before
        if torch_is_cuda(dev) and launches[method] <= 0:
            fail("the hybrid's exact re-score did not launch the "
                 "neighbour finder")
        res[method] = int(want.sum())
    emit({"phase": "hybrid_methods", "fast": fast, "band": own_band,
          "accepted": res,
          "rescored_own_band": rescored,
          "mxu_finder_launches_band_inf": launches})


def torch_is_cuda(dev):
    import torch

    return torch.device(dev).type == "cuda"


def kernel_counters():
    """Every kernel's wrapper and its plain version, by kernel name: the
    wrapper counts its launches (``.launches``), the plain version its
    calls (``.calls``)."""
    from crackling_tpu_torch.ops import compact_decode as cd
    from crackling_tpu_torch.ops import compact_finder as cf
    from crackling_tpu_torch.ops import compact_onehot as co
    from crackling_tpu_torch.ops import compact_rescan as cr
    from crackling_tpu_torch.ops import fullscan as fs
    from crackling_tpu_torch.ops import mxu_finder as mf
    from crackling_tpu_torch.ops import mxu_replay as mr

    return {"compact_finder": (cf.compact_finder, cf.compact_finder_plain),
            "compact_finder_onehot": (co.compact_finder_onehot,
                                      co.compact_finder_onehot_plain),
            "compact_decode": (cd.compact_decode, cd.compact_decode_plain),
            "compact_rescan": (cr.compact_rescan, cr.compact_rescan_plain),
            "mxu_finder": (mf.mxu_finder, mf.mxu_finder_plain),
            "mxu_replay": (mr.mxu_replay, mr.mxu_replay_plain),
            "dense_scan": (fs.dense_scan, fs.dense_scan_plain),
            "bucket_scan": (fs.bucket_scan, fs.bucket_scan_plain)}


def reset_counters(kernels):
    for kernel, plain in kernels.values():
        kernel.launches = 0
        plain.calls = 0


def read_counters(kernels):
    """(launches, plain calls), each by kernel name."""
    return ({k: kp[0].launches for k, kp in kernels.items()},
            {k: kp[1].calls for k, kp in kernels.items()})


@contextlib.contextmanager
def offtarget_parts(dev):
    """Time the parts of one ``Crackling`` run's off-target stage on the
    host clock (each ending in a device synchronise), from here, around the
    calls that ``Pipeline._get_issl_scorer`` and the scorers make: the
    index load (``read_reference_issl``, ``load_native``), the compact
    scorer's construction (its device lists), the cap-tuning first page and
    the later pages (``CompactIsslScorer._run_pages``), the build of the
    hybrid's exact re-scorer (``HybridIsslScorer._get_exact`` on its first
    call: the MXU engine) and its re-scores (``MxuIsslScorer.score``).
    Yields the dict the seconds go into; restores every call after."""
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
    from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer
    from crackling_tpu_torch.pipeline import run

    parts = {"index_load_s": 0.0, "scorer_build_s": 0.0, "tune_page_s": 0.0,
             "tune_pages": 0, "later_pages_s": 0.0, "later_pages": 0,
             "rescore_build_s": 0.0, "rescore_s": 0.0}

    def timed(fn, key_of):
        def call(*args, **kw):
            key, count = key_of(*args)
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                sync(dev)
                parts[key] += time.perf_counter() - t
                if count:
                    parts[count] += len(args[1])

        return call

    def pages_key(scorer, _pages, *_):
        return (("tune_page_s", "tune_pages") if not scorer._tuned
                else ("later_pages_s", "later_pages"))

    def exact_key(hybrid):
        return ("rescore_build_s" if hybrid._exact is None
                else "rescore_s", None)

    hooks = [(run, "read_reference_issl", lambda *a: ("index_load_s", None)),
             (run, "load_native", lambda *a: ("index_load_s", None)),
             (CompactIsslScorer, "__init__",
              lambda *a: ("scorer_build_s", None)),
             (CompactIsslScorer, "_run_pages", pages_key),
             (HybridIsslScorer, "_get_exact", exact_key),
             (MxuIsslScorer, "score", lambda *a: ("rescore_s", None))]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in hooks]
    try:
        for owner, name, key_of in hooks:
            setattr(owner, name, timed(getattr(owner, name), key_of))
        yield parts
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_pipeline(dev, files, engine, onehot=False, fold=None,
                   split=False):
    """``Crackling -c`` with ``[tpu] engine = <engine>`` (and, with
    ``onehot``, CRACKLING_TPU_COMPACT_ONEHOT=1 for the run; with ``fold``,
    ``[tpu] rnafold-backend = <fold>``). Every kernel's
    launch count and its plain version's call count are set to 0 just
    before the run and read just after: the kernel that engine runs (the
    compact finder for ``auto`` and ``sharded``, the one-hot finder for
    ``auto`` with the variable, the neighbour finder for ``exact``,
    ``dense_scan`` for ``dense``, ``bucket_scan`` for ``pallas``) must have
    launched, the compact rescan as often as a compact finder, and no plain
    version may have run; with the variable, the packed compact finder must
    not have launched. With ``split`` the off-target stage's parts are
    timed (``offtarget_parts``) and printed beside the stage's seconds.
    Returns (launches by kernel, rows)."""
    from crackling_tpu_torch.utils import cli

    kernels = kernel_counters()
    main = {"auto": "compact_finder", "sharded": "compact_finder",
            "exact": "mxu_finder", "dense": "dense_scan",
            "pallas": "bucket_scan"}[engine]
    if onehot:
        main = "compact_finder_onehot"
    name = f"{engine}_onehot" if onehot else engine
    if fold:
        name += f"_{fold}fold"
    out = CACHE / f"pipeline_{name}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg = write_config(out, files, engine,
                       tpu_extra=f"rnafold-backend = {fold}\n" if fold
                       else "")
    on_gpu = torch_is_cuda(dev)
    if on_gpu:
        os.environ.pop("CRACKLING_PLATFORM", None)
    else:
        os.environ["CRACKLING_PLATFORM"] = "cpu"
    if onehot:
        os.environ["CRACKLING_TPU_COMPACT_ONEHOT"] = "1"
    # the main path's run: counts start at 0 just before, are read after
    with contextlib.ExitStack() as stack:
        parts = stack.enter_context(offtarget_parts(dev)) if split else None
        reset_counters(kernels)
        t = time.perf_counter()
        try:
            cli.main_crackling(["-c", str(cfg)])
            sync(dev)
        finally:
            os.environ.pop("CRACKLING_TPU_COMPACT_ONEHOT", None)
        wall = time.perf_counter() - t
    launches, plain_calls = read_counters(kernels)
    if on_gpu:
        if launches[main] <= 0:
            fail(f"Crackling (engine = {name}) ran without launching "
                 f"{main}")
        if onehot and launches["compact_finder"]:
            fail("Crackling with CRACKLING_TPU_COMPACT_ONEHOT=1 launched the "
                 "packed compact finder")
        check_page_launches(launches, f"Crackling (engine = {name})")
        if any(plain_calls.values()):
            fail(f"a plain kernel version ran on the GPU path: "
                 f"{plain_calls}")
    rows, scored = read_guides(out / "smoke-guides.txt")
    col = {c: i for i, c in enumerate(rows[0])}
    metrics = json.loads((out / "smoke-guides.txt.metrics.json").read_text())
    emit({"phase": "pipeline", "engine": name, "guides": len(rows) - 1,
          "scored": len(scored),
          "accepted": sum(r[col["passedOffTargetScore"]] == "1"
                          for r in scored),
          "kernel": main, "launches": launches,
          "plain_calls": plain_calls, "wall_s": wall,
          "stage_seconds": metrics["stage_seconds"],
          **({"offtarget_parts": dict(
              parts, rest_s=metrics["stage_seconds"]["offtarget_scoring"]
              - sum(v for k, v in parts.items() if k.endswith("_s")))}
             if split else {})})
    return launches, rows


def check_page_launches(launches, what):
    """Fail unless the compact decode and the compact rescan each launched
    once per compact finder launch (the page program runs them one after
    the other)."""
    finders = launches["compact_finder"] + launches["compact_finder_onehot"]
    for kernel in ("compact_decode", "compact_rescan"):
        if launches[kernel] != finders:
            fail(f"{what} launched the {kernel} kernel {launches[kernel]} "
                 f"times for {finders} compact finder launches")


def read_guides(path):
    """A pipeline CSV's rows and its scored rows, after the checks every
    run must pass: the 26-column header, at least one scored guide, scores
    in (0, 100]."""
    import csv

    from crackling_tpu_torch.constants import GUIDE_COLUMNS

    with open(path) as fp:
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
    return rows, scored


def fold_constructs(rows_auto, queries):
    """The unique mm10db constructs of the ``auto`` run (its ``ssL1``
    column, RNA form), topped up to FOLD_MIN_GUIDES with the constructs
    ``'G' + spacer[1:20] + scaffold`` of the dataset's guides. Returns
    (constructs, how many came from the run)."""
    from crackling_tpu_torch.codec import sigs_to_strings
    from crackling_tpu_torch.constants import SCAFFOLD_RNA

    col = rows_auto[0].index("ssL1")
    seqs = list(dict.fromkeys(r[col] for r in rows_auto[1:]
                              if r[col] not in ("", "?")))
    from_run = len(seqs)
    seen = set(seqs)
    for g in sigs_to_strings(queries, 20):
        if len(seqs) >= FOLD_MIN_GUIDES:
            break
        s = f"G{g[1:20]}{SCAFFOLD_RNA}".replace("T", "U")
        if s not in seen:
            seen.add(s)
            seqs.append(s)
    return seqs, from_run


def phase_fold(dev, seqs, from_run, card):
    """The batched MFE fold on the card against the native C++ fold (see
    the module docstring, 11a)."""
    import torch

    from crackling_tpu_torch.native import fold_batch_native
    from crackling_tpu_torch.ops import mfe

    codes = np.stack([mfe.encode_rna(s) for s in seqs])
    B, n = codes.shape
    if B < FOLD_MIN_GUIDES:
        fail(f"only {B} constructs to fold")
    on_gpu = torch_is_cuda(dev)
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    size = mfe.chunk_size(B, n, torch.device(dev))
    structures, energies, chunks = [], [], []
    t0 = t = time.perf_counter()
    for energy, tables in mfe.fold_chunks(codes, dev):
        fold_s = time.perf_counter() - t
        t = time.perf_counter()
        structures += [mfe.traceback(tables, b) for b in range(len(energy))]
        energies.append(energy)
        device_ms = tables.get("device_ms", (None, None))
        chunks.append({"guides": len(energy),
                       "precompute_ms": device_ms[0],
                       "dp_ms": device_ms[1],
                       "host_fold_s": fold_s,
                       "traceback_s": time.perf_counter() - t})
        del tables
        t = time.perf_counter()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_gpu else None
    energies = np.concatenate(energies)
    t = time.perf_counter()
    native = fold_batch_native(codes)
    native_s = time.perf_counter() - t
    if native is None:
        fail("the native fold library is unavailable")
    s_nat, e_nat = native
    err = float(np.abs(energies - e_nat).max())
    differ = sum(a != b for a, b in zip(structures, s_nat))
    if not np.isfinite(energies).all() or err > FOLD_ENERGY_ATOL or differ:
        fail(f"batched fold vs native on {B} constructs: max energy "
             f"difference {err:.3g} (bound {FOLD_ENERGY_ATOL}), {differ} "
             f"structures differ")
    traceback_s = sum(c["traceback_s"] for c in chunks)
    emit({"phase": "fold", "card": card, "guides": B, "length": n,
          "from_pipeline": from_run, "chunk": size, "chunks": len(chunks),
          "guide_bytes": mfe.guide_bytes(n), "peak_bytes": peak,
          "peak_over_chunk_guide_bytes":
              peak / (size * mfe.guide_bytes(n)) if on_gpu else None,
          "precompute_ms": [c["precompute_ms"] for c in chunks],
          "dp_ms": [c["dp_ms"] for c in chunks],
          "host_fold_s": [c["host_fold_s"] for c in chunks],
          "traceback_s": traceback_s,
          "traceback_ms_per_guide": traceback_s * 1e3 / B,
          "wall_s": wall, "guides_per_s": B / wall,
          "native_wall_s": native_s, "max_energy_err": err,
          "structures_differ": differ})
    part = codes[:FOLD_PROFILE_GUIDES]
    phase_profile(dev, lambda: list(mfe.fold_chunks(part, dev)), "mfe.")


def phase_fold_pipeline(dev, files):
    """``Crackling -c`` with ``engine = auto`` and ``[tpu] rnafold-backend
    = tpu`` after the ``auto`` run (native fold): the compact finder must
    launch with no plain version (``phase_pipeline``) and the CSV must be
    byte-equal to ``auto``'s; prints both secondary-structure stage
    times."""
    launches, _rows = phase_pipeline(dev, files, "auto", fold="tpu")
    launches = launches["compact_finder"]
    csv_auto = CACHE / "pipeline_auto" / "smoke-guides.txt"
    csv_tpu = CACHE / "pipeline_auto_tpufold" / "smoke-guides.txt"
    if csv_tpu.read_bytes() != csv_auto.read_bytes():
        fail("Crackling with rnafold-backend = tpu wrote another CSV than "
             "the auto run (native fold)")

    def ss_seconds(run):
        path = CACHE / f"pipeline_{run}" / "smoke-guides.txt.metrics.json"
        return json.loads(path.read_text())["stage_seconds"][
            "secondary_structure"]

    emit({"phase": "fold_pipeline", "csv_byte_equal": True,
          "compact_finder_launches": launches,
          "secondary_structure_s": {"native": ss_seconds("auto"),
                                    "tpu": ss_seconds("auto_tpufold")}})
    return launches


def crackling_worker(cfg):
    """One process of the two-process run: ``Crackling -c cfg`` through its
    CLI entry point, then a line of its own with its kernel launch counts,
    plain-version calls and wall seconds, and the mean ms of the sharded
    engines' merge (one gloo ``all_reduce`` of two f64 rows) at
    N_QUERIES queries, over 10 calls after a barrier."""
    import torch

    from crackling_tpu_torch.utils import cli

    kernels = kernel_counters()
    reset_counters(kernels)
    t = time.perf_counter()
    cli.main_crackling(["-c", cfg])
    wall = time.perf_counter() - t
    launches, plain_calls = read_counters(kernels)
    sums = torch.zeros((2, N_QUERIES), dtype=torch.float64)
    torch.distributed.barrier()
    t = time.perf_counter()
    for _ in range(10):
        torch.distributed.all_reduce(sums)
    merge_ms = (time.perf_counter() - t) * 1e3 / 10
    emit({"worker": os.environ.get("CRACKLING_PROCESS_ID"),
          "launches": launches, "plain_calls": plain_calls, "wall_s": wall,
          "merge_ms": merge_ms})


def phase_two_process(dev, files, rows_auto, card):
    """``Crackling -c`` in two processes on the one card: ``[tpu] engine =
    sharded``, ``process-count = 2``, a free localhost port, process ids
    0 and 1 from CRACKLING_PROCESS_ID, an output directory each, the
    bench ``.issl``. Both must exit 0 within the timeout, each having
    launched the compact finder and run no plain version; their CSVs must
    be byte-equal and their ``passedOffTargetScore`` the ``auto`` run's,
    row by row. Returns each process's compact finder launches. (Off the
    GPU, for a rehearsal, each process runs on the CPU.)"""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    base = CACHE / "two_process"
    shutil.rmtree(base, ignore_errors=True)
    procs, outs = [], []
    for pid in (0, 1):
        out = base / f"proc{pid}"
        out.mkdir(parents=True)
        outs.append(out)
        cfg = write_config(out, files, "sharded", tpu_extra=(
            f"process-count = 2\ncoordinator-address = localhost:{port}\n"
            + ("" if torch_is_cuda(dev) else "cpu-devices = 1\n")))
        env = {k: v for k, v in os.environ.items()
               if k not in ("CRACKLING_PLATFORM", "CRACKLING_PROCESS_ID")}
        env["CRACKLING_PROCESS_ID"] = str(pid)
        # output to files, not pipes: a full pipe would stall a process
        # while the other waits for it in a collective
        with open(out / "worker.out", "w") as fo, \
                open(out / "worker.err", "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.crackling_worker(sys.argv[1])", str(cfg)],
                cwd=ROOT, env=env, stdout=fo, stderr=fe))

    def stop_all():
        for q in procs:
            q.kill()
            q.wait()

    results = []
    t = time.perf_counter()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            stop_all()
            fail(f"the two-process run did not end in 600 s (process {pid})")
        lines = [ln for ln in (out / "worker.out").read_text().splitlines()
                 if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            stop_all()
            fail(f"process {pid} of the two-process run failed (exit "
                 f"{p.returncode}):\n"
                 f"{(out / 'worker.err').read_text()[-3000:]}")
        print(lines[-1], flush=True)
        results.append(json.loads(lines[-1]))
    wall = time.perf_counter() - t
    for pid, res in enumerate(results):
        if not torch_is_cuda(dev):
            break
        if res["launches"]["compact_finder"] <= 0 \
                or any(res["plain_calls"].values()):
            fail(f"process {pid} of the two-process run launched "
                 f"{res['launches']} with plain calls {res['plain_calls']}")
        check_page_launches(res["launches"],
                              f"process {pid} of the two-process run")
    csvs = [out / "smoke-guides.txt" for out in outs]
    if csvs[0].read_bytes() != csvs[1].read_bytes():
        fail("the two processes' CSVs differ")
    rows, scored = read_guides(csvs[0])
    same_verdicts(rows_auto, rows, "sharded in two processes")
    stages = [json.loads((out / "smoke-guides.txt.metrics.json")
                         .read_text())["stage_seconds"] for out in outs]
    emit({"phase": "two_process", "card": card, "guides": len(rows) - 1,
          "scored": len(scored), "both_wall_s": wall,
          "process_wall_s": [r["wall_s"] for r in results],
          "merge_ms": [r["merge_ms"] for r in results],
          "offtarget_scoring_s": [st.get("offtarget_scoring")
                                  for st in stages],
          "stage_seconds": stages,
          "launches": [r["launches"] for r in results]})
    return [r["launches"]["compact_finder"] for r in results]


def same_verdicts(rows_auto, rows, engine):
    """Fail unless the ``engine`` run's CSV lists the ``auto`` run's guides
    with the same ``passedOffTargetScore``, row by row."""
    col = rows_auto[0].index("passedOffTargetScore")
    if len(rows_auto) != len(rows):
        fail(f"the engine = {engine} run wrote another number of rows")
    diff = sum(a[0] != b[0] or a[col] != b[col]
               for a, b in zip(rows_auto[1:], rows[1:]))
    if diff:
        fail(f"engine = {engine} and engine = auto disagree on "
             f"passedOffTargetScore in {diff} rows")


def run_score_offtargets(files, qfile, platform):
    """``scoreOfftargets`` through its CLI entry point with
    CRACKLING_PLATFORM set to ``platform`` (None: unset); returns (printed
    rows, seconds)."""
    import contextlib
    import io

    from crackling_tpu_torch.utils import cli

    if platform is None:
        os.environ.pop("CRACKLING_PLATFORM", None)
    else:
        os.environ["CRACKLING_PLATFORM"] = platform
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main_score_offtargets([str(files["issl"]), str(qfile), "4",
                                       "75", "and"])
    finally:
        os.environ.pop("CRACKLING_PLATFORM", None)
    wall = time.perf_counter() - t
    rows = [ln.split("\t") for ln in buf.getvalue().splitlines()]
    if len(rows) != SAMPLE:
        fail(f"scoreOfftargets printed {len(rows)} lines for {SAMPLE} "
             "queries")
    return rows, wall


def near_rounding_boundary(v):
    """True where ``v`` lies within PRINT_TIE_RTOL (relative) of a ``%f``
    rounding boundary: there the order of an f64 sum decides the printed
    digit."""
    x = v * 1e6
    return abs(x - (np.floor(x) + 0.5)) * 1e-6 <= PRINT_TIE_RTOL * abs(v)


def phase_score_offtargets(dev, index, queries, files):
    """``scoreOfftargets`` through its CLI entry point on a 2,048-query
    file. With CRACKLING_PLATFORM unset the workload (queries x slices x
    sites per bucket) is below 5e8, so it scores in f64 on the card: every
    printed line must equal ``%f`` of the native exact scorer's scores,
    apart from values within PRINT_TIE_RTOL of a rounding boundary
    (counted and printed). With CRACKLING_PLATFORM=cuda it scores in
    TwoSum f32: verdicts identical, scores within SCORE_RTOL /
    SCORE_ATOL."""
    from crackling_tpu_torch import native
    from crackling_tpu_torch.codec import sigs_to_strings
    from crackling_tpu_torch.pipeline.run import verdicts

    rng = np.random.default_rng(SEED + 4)
    sample = queries[rng.choice(queries.shape[0], size=SAMPLE,
                                replace=False)]
    qfile = CACHE / "score_queries.txt"
    qfile.write_text("".join(s + "\n" for s in sigs_to_strings(sample, 20)))
    est = SAMPLE * index.slice_count * (index.num_sites / index.bucket_count)
    on_gpu = torch_is_cuda(dev)
    if on_gpu and est >= 5e8:
        fail(f"the scoreOfftargets sample's work estimate {est:.3g} is not "
             "below 5e8: the f64 rule is not exercised")
    want = native.exact_score_native(index, sample, 4, 75.0, "and")
    if want is None:
        fail("native exact scorer unavailable")

    # f64 on the card (CRACKLING_PLATFORM unset): the binary's lines
    rows, wall = run_score_offtargets(files, qfile,
                                      None if on_gpu else "cpu")
    ties, other = [], []
    for i, r in enumerate(rows):
        for field, w in ((1, want[0][i]), (2, want[1][i])):
            if r[field] == "%f" % w:
                continue
            (ties if near_rounding_boundary(w) else other).append(
                {"line": i, "printed": r[field], "exact": repr(float(w))})
    if other:
        fail(f"scoreOfftargets (f64) printed {len(other)} fields unlike the "
             f"native exact scorer's %f: {other[:5]}")
    got = (np.array([float(r[1]) for r in rows]),
           np.array([float(r[2]) for r in rows]))
    if not np.array_equal(verdicts(*got, 75.0, "and"),
                          verdicts(*want, 75.0, "and")):
        fail("scoreOfftargets verdicts differ from the native exact scorer")
    emit({"phase": "score_offtargets", "platform": "unset",
          "work_estimate": est, "dtype": "float64", "queries": SAMPLE,
          "wall_s": wall, "lines_equal": SAMPLE - len({t["line"]
                                                       for t in ties}),
          "rounding_ties": len(ties), "ties": ties,
          "max_abs_diff": max(float(np.abs(g - w).max())
                              for g, w in zip(got, want))})
    if not on_gpu:
        return

    # TwoSum f32 on the card (CRACKLING_PLATFORM=cuda)
    rows, wall = run_score_offtargets(files, qfile, "cuda")
    got = (np.array([float(r[1]) for r in rows]),
           np.array([float(r[2]) for r in rows]))
    if not np.array_equal(verdicts(*got, 75.0, "and"),
                          verdicts(*want, 75.0, "and")):
        fail("scoreOfftargets (f32) verdicts differ from the native exact "
             "scorer")
    for name, g, w in zip(("mit", "cfd"), got, want):
        if not np.allclose(g, w, rtol=SCORE_RTOL, atol=SCORE_ATOL):
            fail(f"scoreOfftargets {name} scores outside the f32 tier "
                 f"(max abs diff {np.abs(g - w).max():.3e})")
    emit({"phase": "score_offtargets", "platform": "cuda",
          "dtype": "float32", "queries": SAMPLE, "wall_s": wall,
          "max_abs_diff": max(float(np.abs(g - w).max())
                              for g, w in zip(got, want)),
          "rtol": SCORE_RTOL, "atol": SCORE_ATOL})


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
    from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer

    index, queries, files = bench_dataset()
    scorer = CompactIsslScorer(index, max_dist=4, device=dev)
    compact_err = phase_kernel_vs_plain(dev, scorer, queries)
    rescan_err = phase_rescan_kernel_vs_plain(dev, scorer, queries)
    decode_err = phase_decode_kernel_vs_plain(dev, scorer, queries)
    compact, rescan, decode = phase_scorer(dev, scorer, queries, card)
    phase_profile(dev, lambda: scorer.score_sums(queries), "compact.")
    del scorer
    torch.cuda.empty_cache()
    sharded_page = phase_sharded_page(dev, index, queries, card)
    torch.cuda.empty_cache()

    oh = onehot_scorer(index, dev)
    onehot_err = phase_onehot_kernel_vs_plain(dev, oh, queries)
    onehot = phase_onehot_page(dev, oh, queries, N_QUERIES, card)
    phase_onehot_page(dev, oh, queries, SMALL_PAGE, card)
    del oh
    torch.cuda.empty_cache()

    page = queries[:MXU_PAGE]
    eng = MxuIsslScorer(index, max_dist=4, method="and", threshold=75.0,
                        device=dev)
    mxu_err = phase_mxu_kernel_vs_plain(dev, eng, page)
    mxu = phase_mxu_page(dev, eng, page, card)
    phase_profile(dev, lambda: eng._run_pages(page), "mxu.")
    del eng
    torch.cuda.empty_cache()
    replay_err, replay = phase_mxu_replay(dev, card)
    torch.cuda.empty_cache()
    phase_mxu_small(dev)
    phase_flat(dev, index, queries)

    dense, scan = fullscan_engines(index, dev)
    fullscan_err = phase_fullscan_kernels_vs_plain(dev, dense, scan, queries)
    dense_stats = phase_dense_page(dev, dense, queries, card)
    phase_profile(dev, lambda: dense.score_sums(queries), "dense.")
    del dense
    torch.cuda.empty_cache()
    scan_stats = phase_scan_page(dev, scan, queries, card)
    del scan
    torch.cuda.empty_cache()
    deep_sharded = phase_deep_bucket(dev, files)
    torch.cuda.empty_cache()
    for fast in ("compact", "dense"):
        phase_hybrid_methods(dev, fast)

    launches, rows_auto = phase_pipeline(dev, files, "auto", split=True)
    compact["launches"] = launches["compact_finder"]
    rescan["launches"] = launches["compact_rescan"]
    decode["launches"] = launches["compact_decode"]
    phase_fold(dev, *fold_constructs(rows_auto, queries), card)
    torch.cuda.empty_cache()
    phase_fold_pipeline(dev, files)
    launches, rows = phase_pipeline(dev, files, "sharded")
    sharded_run = launches["compact_finder"]
    same_verdicts(rows_auto, rows, "sharded")
    two_process = phase_two_process(dev, files, rows_auto, card)
    launches, rows = phase_pipeline(dev, files, "auto", onehot=True)
    onehot["launches"] = launches["compact_finder_onehot"]
    same_verdicts(rows_auto, rows, "auto with the one-hot finder")
    launches, rows = phase_pipeline(dev, files, "exact")
    mxu["launches"] = launches["mxu_finder"]
    replay["launches"] = launches["mxu_replay"]
    same_verdicts(rows_auto, rows, "exact")
    launches, rows = phase_pipeline(dev, files, "dense")
    dense_stats["launches"] = launches["dense_scan"]
    same_verdicts(rows_auto, rows, "dense")
    launches, rows = phase_pipeline(dev, files, "pallas")
    scan_stats["launches"] = launches["bucket_scan"]
    same_verdicts(rows_auto, rows, "pallas")
    phase_score_offtargets(dev, index, queries, files)
    log(f"all phases passed in {time.time() - t0:.1f} s")

    print(card, flush=True)
    emit({"kernels": [
        {"name": "compact_finder", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/compact_finder.cu",
         "replaces": "crackling_tpu/ops/issl_compact.py:247",
         "max_abs_err": compact_err, "max_rel_err": compact_err,
         "library_ms": None, **compact,
         "sharded_launches": {"page_by_shards": sharded_page,
                              "crackling_sharded": sharded_run,
                              "two_process": two_process}},
        {"name": "compact_finder_onehot", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/compact_onehot.cu",
         "replaces": "crackling_tpu/ops/issl_compact.py:350",
         "max_abs_err": onehot_err, "max_rel_err": onehot_err,
         "library_ms": None, **onehot},
        {"name": "mxu_finder", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/mxu_finder.cu",
         "replaces": "crackling_tpu/ops/issl_mxu.py:67",
         "max_abs_err": mxu_err, "max_rel_err": mxu_err,
         "library_ms": None, **mxu},
        {"name": "dense_scan", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/fullscan.cu",
         "replaces": "crackling_tpu/ops/issl_dense.py:66",
         "max_abs_err": fullscan_err["dense_scan"][0],
         "max_rel_err": fullscan_err["dense_scan"][1],
         "library_ms": None, **dense_stats,
         "sharded_launches": {"deep_bucket_sharded": deep_sharded}},
        {"name": "bucket_scan", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/fullscan.cu",
         "replaces": "crackling_tpu/ops/issl_pallas.py:62",
         "max_abs_err": fullscan_err["bucket_scan"][0],
         "max_rel_err": fullscan_err["bucket_scan"][1],
         "library_ms": None, **scan_stats},
        {"name": "compact_rescan", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/compact_rescan.cu",
         "replaces": "crackling_tpu/ops/issl_compact.py:1016",
         "max_abs_err": rescan_err, "library_ms": None, **rescan},
        {"name": "compact_decode", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/compact_decode.cu",
         "replaces": "crackling_tpu/ops/issl_compact.py:884",
         "max_abs_err": decode_err, "library_ms": None, **decode},
        {"name": "mxu_replay", "route": "cuda",
         "source": "crackling_tpu_torch/csrc/mxu_replay.cu",
         "replaces": "crackling_tpu/ops/issl_mxu.py::_replay_page (host)",
         "max_abs_err": replay_err, "library_ms": None, **replay}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
