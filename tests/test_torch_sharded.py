"""The port's sharded scoring against the JAX package's, on the CPU.

One dataset, made with numpy from a seed, goes through both packages:
3,600 random sites and one-base mutants, 300 sites whose first four bases
are ``AAAA`` (one slice-0 bucket, all in the first shard) and 400 that
share their last four bases (one slice-4 bucket, spread over the shards),
and 64 queries (sites of each kind, absent sequences).
The shards are listed on the CPU, the port's counterpart of the JAX
package's virtual CPU devices. Tolerances:

* ``shard_index``, ``shard_bounds`` and ``load_index_range``: equal to
  JAX's, field for field;
* the port's three sharded engines (flat, dense, compact) at 2 and 4
  shards and at mesh-q 2: within rtol 2e-6 / atol 1e-6 (JAX's sharded
  tier, tests/test_sharded.py) of JAX's ``ShardedIsslScorer`` sums and of
  ``oracle.score_bruteforce`` (f64);
* the port's sharded compact engine against JAX's (interpret mode, run
  once): rtol 1e-5 / atol 1e-5, the tier of tests/test_distributed.py;
* a sorted batch whose query groups each re-page into strided pages:
  against ``oracle.score_bruteforce`` at rtol 2e-6 / atol 1e-6, and
  against one unsharded compact engine at rtol 1e-9 / atol 1e-9.
"""

import numpy as np
import pytest
import torch

from crackling_tpu.index import build_index as jax_build_index
from crackling_tpu.parallel import sharded as jax_sharded
from crackling_tpu.parallel.distributed import \
    load_index_range as jax_load_index_range
from crackling_tpu_torch import trace
from crackling_tpu_torch.index import build_index, write_reference_issl
from crackling_tpu_torch.ops import issl_compact
from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
from crackling_tpu_torch.ops.oracle import score_bruteforce
from crackling_tpu_torch.parallel import sharded
from crackling_tpu_torch.parallel.distributed import (host_mesh,
                                                      load_index_range)
from test_torch_compact import mutants, sorted_batch

ENGINES = {"flat": (sharded.ShardedIsslScorer,
                    dict(query_block=16, work_block=1 << 10)),
           "dense": (sharded.ShardedDenseIsslScorer,
                     dict(chunk=1024, query_page=32)),
           "compact": (sharded.ShardedCompactIsslScorer,
                       dict(chunk=1024, query_page=32))}
SHAPES = [(1, 2), (1, 4), (2, 2)]        # (mesh-q, shards)


def sites_and_queries(seed=17):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 40, size=3000).astype(np.uint64)
    pos = rng.integers(0, 20, size=600).astype(np.uint64) * np.uint64(2)
    mut = ((base[:600] & ~(np.uint64(3) << pos))
           | (rng.integers(0, 4, size=600).astype(np.uint64) << pos))
    # 300 sites in slice 0's bucket 0 (first bases AAAA: the lowest site
    # ids, so the first shard) and 400 in one bucket of slice 4, which
    # spreads over every shard
    first = rng.integers(0, 1 << 40, size=300).astype(np.uint64) \
        & ~np.uint64(0xFF)
    last = (rng.integers(0, 1 << 40, size=400).astype(np.uint64)
            & ~(np.uint64(0xFF) << np.uint64(32))) \
        | (np.uint64(0x55) << np.uint64(32))
    sites = np.concatenate([base, mut, first, last])
    queries = np.concatenate([base[:32], first[:8], last[:8],
                              rng.integers(0, 1 << 40, 16).astype(np.uint64)])
    return sites, queries


@pytest.fixture(scope="module")
def world():
    sites, queries = sites_and_queries()
    index = build_index(sites)
    jindex = jax_build_index(sites)
    assert (index.site_sigs == jindex.site_sigs).all()
    return dict(index=index, jindex=jindex, queries=queries,
                brute=score_bruteforce(queries, index.site_sigs,
                                       index.occurrences, 4))


@pytest.fixture(scope="module")
def jax_flat_sums(world):
    mesh = jax_sharded.make_mesh(n_shards=2, n_q=1)
    sc = jax_sharded.ShardedIsslScorer(world["jindex"], mesh, max_dist=4,
                                       query_block=16, work_block=1 << 10)
    return sc.score_sums(world["queries"])


def cpu_mesh(n_q, n_shards):
    return sharded.make_mesh(n_shards, n_q, ["cpu"] * (n_q * n_shards))


def assert_sums(got, want, rtol, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_shard_bounds_and_index_match_jax(world, n_shards):
    for n in (0, 1, 5, world["index"].num_sites):
        assert sharded.shard_bounds(n, n_shards) == \
            jax_sharded.shard_bounds(n, n_shards)
    got = sharded.shard_index(world["index"], n_shards)
    want = jax_sharded.shard_index(world["jindex"], n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        assert (g.seq_length, g.slice_width, g.seq_count) == \
            (w.seq_length, w.slice_width, w.seq_count)
        for f in ("site_sigs", "occurrences", "order", "bucket_offsets"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_load_index_range_matches_jax(world, tmp_path):
    path = str(tmp_path / "g.issl")
    write_reference_issl(world["index"], path)
    n = world["index"].num_sites
    cuts = [(0, n // 3), (n // 3, (2 * n) // 3), ((2 * n) // 3, n), (5, 5)]
    for lo, hi in cuts:
        got, want = load_index_range(path, lo, hi), \
            jax_load_index_range(path, lo, hi)
        assert (got.seq_length, got.slice_width, got.seq_count) == \
            (want.seq_length, want.slice_width, want.seq_count)
        for f in ("site_sigs", "occurrences", "order", "bucket_offsets"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for bad in ((0, n + 1), (3, 2)):
        with pytest.raises(ValueError, match="outside"):
            load_index_range(path, *bad)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"q{s[0]}x{s[1]}")
@pytest.mark.parametrize("engine", list(ENGINES))
def test_sharded_engine_matches_jax(world, jax_flat_sums, engine, shape):
    cls, kw = ENGINES[engine]
    n_q, n_shards = shape
    sc = cls(world["index"], cpu_mesh(n_q, n_shards), max_dist=4, **kw)
    assert sc.n_shards == n_shards and sc.n_q == n_q
    got = sc.score_sums(world["queries"])
    assert_sums(got, jax_flat_sums, 2e-6, 1e-6)
    assert_sums(got, world["brute"], 2e-6, 1e-6)


def test_sharded_compact_matches_jax_sharded_compact(world):
    kw = dict(max_dist=4, chunk=1024, query_page=128)
    jax_sc = jax_sharded.ShardedCompactIsslScorer(
        world["jindex"], jax_sharded.make_mesh(n_shards=2, n_q=1), **kw)
    sc = sharded.ShardedCompactIsslScorer(world["index"], cpu_mesh(1, 2),
                                          **kw)
    assert sc.score_band == jax_sc.score_band
    assert_sums(sc.score_sums(world["queries"]),
                jax_sc.score_sums(world["queries"]), 1e-5, 1e-5)


def deepest(index):
    return int(np.diff(index.bucket_offsets, axis=1).max())


def test_rank_bound_decision_is_the_shards(world, monkeypatch):
    """The compact engine's rank bound holds for the deepest bucket of any
    shard, not of the whole index (JAX ``sharded.py:551-554``): with the
    bound between the two, the single-device engine refuses the index
    while the sharded one takes it; at the shards' depth both refuse."""
    index = world["index"]
    shard_max = max(deepest(s) for s in sharded.shard_index(index, 2))
    assert shard_max < deepest(index)
    monkeypatch.setattr(issl_compact, "RANK_BOUND", shard_max + 1)
    with pytest.raises(ValueError, match="rank-exactness"):
        CompactIsslScorer(index, max_dist=4, device="cpu")
    sc = sharded.ShardedCompactIsslScorer(index, cpu_mesh(1, 2), max_dist=4,
                                          chunk=1024)
    assert_sums(sc.score_sums(world["queries"]), world["brute"], 2e-6, 1e-6)
    monkeypatch.setattr(issl_compact, "RANK_BOUND", shard_max)
    with pytest.raises(ValueError, match="rank-exactness"):
        sharded.ShardedCompactIsslScorer(index, cpu_mesh(1, 2), max_dist=4)


def test_sharded_compact_ignores_the_onehot_variable(world, monkeypatch):
    """CRACKLING_TPU_COMPACT_ONEHOT=1 turns the single-device engine's
    one-hot finder on; the sharded engine keeps the packed finder, as the
    JAX sharded program does."""
    monkeypatch.setenv("CRACKLING_TPU_COMPACT_ONEHOT", "1")
    assert CompactIsslScorer(world["index"], max_dist=4, chunk=1024,
                             device="cpu").onehot
    sc = sharded.ShardedCompactIsslScorer(world["index"], cpu_mesh(2, 2),
                                          max_dist=4, chunk=1024)
    engines = {id(e): e for row in sc.engines for e in row}
    assert len(engines) == 2              # one engine per (shard, device)
    assert not any(e.onehot for e in engines.values())


def test_sharded_compact_repages_sorted_groups():
    """A sorted batch as the off-target stage sends it, over 32 slice-4
    values (~128 guides each, ~32 in a strided page): each query group of
    a 2 x 2 mesh re-pages in its shard engines (strided pages, no
    halving), and the merged sums equal the brute force's, and one
    unsharded engine's within 1e-9."""
    rng = np.random.default_rng(18)
    batch = sorted_batch(rng, 4096, tops=32)
    index = build_index(np.concatenate([batch[::2], mutants(rng, batch)]))
    kw = dict(max_dist=4, chunk=1024, query_page=512, qb_cap=64)
    sc = sharded.ShardedCompactIsslScorer(index, cpu_mesh(2, 2), **kw)
    trace.enable()
    try:
        got = sc.score_sums(batch)
        s = trace.session()
    finally:
        trace.disable()
    assert s.counters["compact.repaged"] == 4     # 2 groups x 2 shards
    assert "compact.splits" not in s.counters
    assert_sums(got, score_bruteforce(batch, index.site_sigs,
                                      index.occurrences, 4), 2e-6, 1e-6)
    want = CompactIsslScorer(index, device="cpu", **kw).score_sums(batch)
    assert_sums(got, want, 1e-9, 1e-9)


def test_meshes():
    m = cpu_mesh(2, 3)
    assert m.shape == {"q": 2, "shard": 3} and list(m.local_shard_ids) == \
        [0, 1, 2]
    h = host_mesh(n_q=2, devices=["cpu"] * 4)
    assert h.shape == {"host": 1, "q": 2, "shard": 2}
    assert h.n_shards == 2 and h.devices[1][1] == torch.device("cpu")
    # mesh-q must divide the process's devices; a mesh needs its devices
    with pytest.raises(ValueError, match="does not divide"):
        host_mesh(n_q=2, devices=["cpu"])
    with pytest.raises(ValueError, match="does not divide"):
        sharded.make_mesh(n_q=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        sharded.make_mesh(2, 2, ["cpu"] * 3)
