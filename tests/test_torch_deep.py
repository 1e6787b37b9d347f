"""The port's compact hybrid past the JAX engine's 2^22 rank bound (CPU).

The index is made with numpy from a seed, as ``chip_smoke.deep_world``
makes it: ~4.25 M random sites share their slice-0 byte, one bucket of
more than 2^22 entries (~160 of them lie within distance 4 of any 20-mer
that shares the byte, as ~200 sites do of a mouse guide), beside 20,000
random fillers and one-base neighbours of some deep sites in 1-60 copies.
Queries: 8 in the deep bucket (4 of its sites, 2 with repeated
neighbours, and 4 one-base variants of others) and 56 elsewhere.

``HybridIsslScorer`` over ``CompactIsslScorer``, on the port's plain-torch
path, is held to the benchmark's plain reference
(``gpu_bench/reference/offtarget.expected_scores``, all pairs, no index)
with the comparison that decides a run's ``correct`` (``gpu_bench/
check.compare``) at the mouse configuration's limits, and its verdicts to
the port's emulation of the binary (``ops/oracle.score_exact``). The
exact re-scorer reads the compact engine's lists and scores the deep
bucket's guides as the oracle does, bit for bit.

Marked ``cuda`` (skipped without a card): the same index with a crowd of
every 20-mer at distance 1-2 of one deep site, whose guide has ~5,600 hit
rows, past what a block of the replay kernel (``csrc/mxu_replay.cu``) sorts
in shared memory; the kernel's sums against its plain version's (max error
0) and the native exact scorer's, for all five methods.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from crackling_tpu_torch import trace
from crackling_tpu_torch.index import build_index
from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
from crackling_tpu_torch.ops import mxu_replay as mr
from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer
from crackling_tpu_torch.ops.oracle import score_exact
from crackling_tpu_torch.pipeline.run import verdicts
from gpu_bench import check
from gpu_bench.reference.offtarget import Sites, expected_scores
from gpu_bench.spec import bench_dir

ROOT = Path(__file__).resolve().parent.parent
N_DEEP = 4_250_000
# the engine's chunk here: 65 chunk cells in the deep bucket keep the plain
# finder's cells (S x B x qb x chunks) and the exact re-scorer's segment
# planes to a few hundred MB on the CPU; the card runs the default 4,096
CHUNK = 1 << 16
METHOD, THRESHOLD = "and", 75.0
METHODS = ["and", "or", "mit", "cfd", "avg"]


def crowd(center):
    """Every 20-mer at distance 1 or 2 from ``center`` (1,770 sites): a
    guide there has ~5,600 hit rows (a site is found in each slice it
    equals the guide in), past ``mxu_replay.SHARED_HITS``."""
    p = np.arange(20, dtype=np.uint64) * np.uint64(2)
    d = np.arange(1, 4, dtype=np.uint64)
    one = (center ^ (d[None, :] << p[:, None])).ravel()
    i, j = np.triu_indices(20, 1)
    two = (center ^ (d[:, None, None] << p[i][None, None, :])
           ^ (d[None, :, None] << p[j][None, None, :])).ravel()
    return np.concatenate([one, two])


def deep_world(seed=31, crowded=False):
    rng = np.random.default_rng(seed)

    def pin(sigs):
        return (sigs & ~np.uint64(0xFF)) | np.uint64(0x55)

    deep = pin(rng.integers(0, 1 << 40, size=N_DEEP).astype(np.uint64))
    filler = rng.integers(0, 1 << 40, size=20_000).astype(np.uint64)
    # one-base neighbours of 2 deep sites, 1-60 copies each
    hot_pos = rng.integers(4, 20, size=2).astype(np.uint64) * np.uint64(2)
    base = (deep[:2] >> hot_pos) & np.uint64(3)
    hot = ((deep[:2] & ~(np.uint64(3) << hot_pos))
           | (((base + np.uint64(1)) & np.uint64(3)) << hot_pos))
    # a crowd around deep[100], the last query, where asked for
    extra = [crowd(deep[100])] if crowded else []
    index = build_index(np.concatenate([
        deep, filler, np.repeat(hot, rng.integers(1, 61, size=2)), *extra]))
    pos = rng.integers(4, 20, size=4).astype(np.uint64) * np.uint64(2)
    variants = ((deep[64:68] & ~(np.uint64(3) << pos))
                | (rng.integers(0, 4, size=4).astype(np.uint64) << pos))
    queries = np.concatenate([
        deep[:4], variants, filler[:28],
        rng.integers(0, 1 << 40, size=28).astype(np.uint64),
        deep[100:101] if crowded else deep[:0]])
    return index, queries


@pytest.fixture(scope="module")
def world():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    index, queries = deep_world()
    compact = CompactIsslScorer(index, max_dist=4, chunk=CHUNK,
                                rescan_block=16, device="cpu")
    hybrid = HybridIsslScorer(index, max_dist=4, method=METHOD,
                              threshold=THRESHOLD, dense=compact,
                              device="cpu")
    yield index, queries, hybrid
    torch.set_num_threads(old)


def test_hybrid_over_compact_past_2_22(world):
    index, queries, hybrid = world
    deepest = int(np.diff(index.bucket_offsets, axis=1).max())
    assert deepest > 1 << 22
    assert isinstance(hybrid.dense, CompactIsslScorer)
    mit, cfd = hybrid.score(queries)
    assert hybrid.dense.page_stats          # the compact engine scored

    sites = Sites(torch.as_tensor(index.site_sigs.view(np.int64)),
                  index.occurrences.astype(np.float64))
    exp = expected_scores(queries, sites, max_dist=4, threshold=THRESHOLD,
                          method=METHOD, block_elems=1 << 24)
    assert exp.hits > 8 * 100               # the deep guides' ~160 each
    every = np.arange(queries.shape[0])
    got = check.compare(every, mit, cfd, every, exp, THRESHOLD, METHOD)
    limits = json.loads((bench_dir(ROOT) / "configs" / "mouse-grcm39.json")
                        .read_text())["limits"]
    assert check.correct(check.judge(got, limits)), got

    ref = score_exact(index, queries, 4, THRESHOLD, METHOD)
    assert np.array_equal(verdicts(mit, cfd, THRESHOLD, METHOD),
                          verdicts(*ref, THRESHOLD, METHOD))


def test_exact_rescorer_reads_the_compact_lists_past_2_22(world):
    index, queries, hybrid = world
    hybrid._exact = None                    # built here, under the tracer
    trace.enable()
    try:
        exact = hybrid._get_exact()
        s = trace.session()
    finally:
        trace.disable()
    assert isinstance(exact, MxuIsslScorer)
    assert exact.entries.data_ptr() == hybrid.dense.entries.data_ptr()
    assert s.spans["mxu.build"].count == 1
    deep = queries[:4]
    assert np.array_equal(np.stack(exact.score(deep)),
                          np.stack(score_exact(index, deep, 4, THRESHOLD,
                                               METHOD)))


@pytest.fixture(scope="module")
def card_page():
    """The crowded deep index on the card, its MXU engine and the hit
    table of one page of its 65 queries: (index, queries, engine, page
    positions, q_sig, hits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replay kernel has no CPU form")
    index, queries = deep_world(crowded=True)
    eng = MxuIsslScorer(index, max_dist=4, method=METHOD,
                        threshold=THRESHOLD, device="cuda")
    (pos, page, q_sig, hits), = eng._run_pages(queries)
    return index, queries, eng, pos, q_sig, hits


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_replay_kernel_equals_plain_version_on_the_card(card_page, method,
                                                        monkeypatch):
    from crackling_tpu_torch import native

    index, queries, eng, pos, q_sig, hits = card_page
    found, sid, occ = eng._self_lookup(queries[pos])
    own = torch.as_tensor(np.stack([np.where(found, sid, -1), occ]))
    args = (eng.entries.reshape(-1), eng.occ.reshape(-1),
            mr.replay_tables(20, 4, "cuda"))
    kw = dict(method=method, maximum_sum=mr.maximum_sum(THRESHOLD),
              slice_width=8)
    launches = mr.mxu_replay.launches
    got = mr.mxu_replay(hits, q_sig, own.cuda(), *args, **kw)
    want = mr.mxu_replay_plain(
        hits.cpu(), q_sig.cpu(), own,
        *(t.cpu() for t in args[:2]),
        mr.ReplayTables(*(t.cpu() for t in args[2][:3]), args[2].pam),
        **kw)
    assert mr.mxu_replay.launches == launches + 1
    assert int(got.spilled) == int(want.spilled) >= 1     # the crowd's guide
    assert torch.equal(got.sums.cpu(), want.sums)           # max error 0

    # the engine: one launch a page, no host copy of its hit table, and
    # the native exact scorer's scores bit for bit
    copied = []
    real_cpu = torch.Tensor.cpu

    def spy(t, *a, **k):
        copied.append(t.numel())
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    launches = mr.mxu_replay.launches
    trace.enable()
    try:
        mit, cfd = eng.score(queries, method=method)
        counters = trace.session().counters
    finally:
        trace.disable()
    monkeypatch.undo()
    assert mr.mxu_replay.launches == launches + 1
    assert counters["mxu.replay_hits"] == hits.shape[1] > 4 * queries.size
    assert counters["mxu.replay_spilled"] >= 1
    assert max(copied) <= 2 * queries.size          # the sums, not the hits
    ref = native.exact_score_native(index, queries, 4, THRESHOLD, method)
    assert np.array_equal(mit, ref[0]) and np.array_equal(cfd, ref[1])
