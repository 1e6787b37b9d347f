"""The PyTorch MXU engine against the JAX engine and the oracle (CPU).

Inputs are ``tests/test_mxu.py``'s dataset (made with numpy from a
seed), handed to both packages through ``convert.index_from_arrays``. On
the CPU the port runs its plain neighbour finder; the JAX engine runs its
Pallas kernel in interpret mode, as its own tests do. Tolerances: the
finder's planes are integers and must equal the JAX kernel's f32 counts
and rank sums exactly; scores must be ``np.array_equal`` (both engines
replay the hits in f64 in the reference's order).
"""

import numpy as np
import pytest
import torch

import crackling_tpu_torch.ops.issl_mxu as port_mxu
from crackling_tpu_torch import trace
from crackling_tpu.index import build_index as jax_build_index
from crackling_tpu.ops.issl_mxu import MxuIsslScorer as JaxMxu
from crackling_tpu.ops.oracle import score_exact
from crackling_tpu_torch.index import build_index as port_build_index
from crackling_tpu_torch.ops.issl_mxu import SLOT_ALIGN, MxuIsslScorer
from crackling_tpu_torch.ops.mxu_finder import (emulate_mxu_finder,
                                                mxu_finder)
from test_mxu import data  # noqa: F401  (shared fixture)
from test_torch_compact import port_index
from test_torch_deep import crowd

METHODS = ["and", "or", "mit", "cfd", "avg"]
KW = dict(query_page=512, chunk=1024)


@pytest.fixture(scope="module")
def jax_engine(data):  # noqa: F811
    index, _ = data
    return JaxMxu(index, max_dist=4, interpret=True, **KW)


def _jax_planes(eng, page):
    """The JAX kernel's raw output for one page, split into its count and
    position-sum planes (S, B, seg, qb), with the slot plan it ran on."""
    n = page.shape[0]
    qsp, qb = eng._plan(page)
    prelude, kcall, _ = eng._get_run(qb)
    lo = (page & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (page >> np.uint64(32)).astype(np.uint32)
    packed = np.concatenate([lo, hi, qsp.reshape(-1).view(np.uint32)])
    out = np.asarray(kcall(eng.bucket_offsets, eng.bucket_lens,
                           prelude(packed, n), eng.planes))
    S, B, two_seg, _ = out.shape
    four = out.reshape(S, B, two_seg // 16, 2, 8, qb)
    seg = two_seg // 2
    return (qsp, four[:, :, :, 0].reshape(S, B, seg, qb),
            four[:, :, :, 1].reshape(S, B, seg, qb))


def _sub_l(index, queries, seq_length):
    """The same data cut to ``seq_length``-mers (w = 8)."""
    mask = np.uint64((1 << (2 * seq_length)) - 1)
    sub = jax_build_index(index.site_sigs & mask, seq_length=seq_length,
                          slice_width=8)
    return sub, queries & mask


@pytest.fixture(scope="module")
def jax_kernel_pages(data):  # noqa: F811
    """The JAX kernel's planes for the first 300 queries at seq_length 20
    and 16, each run once in interpret mode and shared by the tests that
    hold the port's finders to them: (index, page, qsp, cnt, pos)."""
    cache = {}

    def get(seq_length):
        if seq_length not in cache:
            index, queries = data
            if seq_length != 20:
                index, queries = _sub_l(index, queries, seq_length)
            jax_eng = JaxMxu(index, max_dist=4, interpret=True, **KW)
            page = queries[:300]
            cache[seq_length] = (index, page) + _jax_planes(jax_eng, page)
        return cache[seq_length]

    return get


def _port_finder(finder, index, page, qsp, seq_length):
    eng = MxuIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)
    planes = finder(
        eng.entries, eng.bucket_offsets, eng.bucket_lens,
        eng.query_tensor(page), torch.as_tensor(qsp), segw=eng.segw,
        nseg=eng.nseg, max_dist=4, seq_length=seq_length)
    return eng, planes


@pytest.mark.parametrize("seq_length", [20, 16])
def test_plain_finder_equals_jax_kernel(jax_kernel_pages, seq_length):
    index, page, qsp, cnt, pos = jax_kernel_pages(seq_length)
    eng, planes = _port_finder(mxu_finder, index, page, qsp, seq_length)
    assert eng.nseg == cnt.shape[2]
    np.testing.assert_array_equal(planes.cnt.numpy(), cnt.astype(np.int64))
    np.testing.assert_array_equal(planes.rsum.numpy(), pos.astype(np.int64))
    assert planes.cnt.sum() > 0


@pytest.mark.parametrize("seq_length", [20, 16])
def test_emulated_finder_equals_jax_kernel(jax_kernel_pages, seq_length):
    """The kernel's flow (the int8 screen, ops/mxu_finder.py's
    ``emulate_mxu_finder``) on the JAX kernel's page and plan."""
    index, page, qsp, cnt, pos = jax_kernel_pages(seq_length)
    _, planes = _port_finder(emulate_mxu_finder, index, page, qsp,
                             seq_length)
    np.testing.assert_array_equal(planes.cnt.numpy(), cnt.astype(np.int64))
    np.testing.assert_array_equal(planes.rsum.numpy(), pos.astype(np.int64))
    assert planes.cnt.sum() > 0


def test_neighbour_counts_equal_jax(data, jax_engine):  # noqa: F811
    index, queries = data
    eng = MxuIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)
    np.testing.assert_array_equal(eng.neighbour_counts(queries),
                                  jax_engine.neighbour_counts(queries))


@pytest.mark.parametrize("method", METHODS)
def test_scores_equal_jax_and_oracle(data, jax_engine, method):  # noqa: F811
    index, queries = data
    eng = MxuIsslScorer(port_index(index), max_dist=4, method=method,
                        threshold=75.0, device="cpu", **KW)
    got = eng.score(queries)
    for want in (jax_engine.score(queries, method=method, threshold=75.0),
                 score_exact(index, queries, 4, 75.0, method)):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


CASES = {
    # a smaller distance bound
    "max_dist=2": dict(max_dist=2, query_page=512),
    # three pages of 64
    "multi-page": dict(max_dist=4, query_page=64),
    # caps far below the page's populations: they grow and the page runs
    # again
    "cap-overflow": dict(max_dist=4, query_page=512, nz_cap=64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scores_equal_oracle(data, case):  # noqa: F811
    index, queries = data
    kw = CASES[case]
    queries = queries[:150]
    eng = MxuIsslScorer(port_index(index), method="and", threshold=75.0,
                        chunk=1024, device="cpu", **kw)
    mit, cfd = eng.score(queries)
    ref_mit, ref_cfd = score_exact(index, queries, kw["max_dist"], 75.0,
                                   "and")
    assert np.array_equal(mit, ref_mit)
    assert np.array_equal(cfd, ref_cfd)
    if case == "cap-overflow":
        # the first run's single-neighbour slots passed the cap of 64 it
        # started at, which grew to hold them; the page was not split
        assert len(eng.page_stats) > 1 and eng.page_stats[0][1] > 64
        assert eng.cap_single >= eng.page_stats[-1][1] > 64
        assert len(eng._run_pages(queries)) == 1


def test_page_larger_than_device_room_splits(data,  # noqa: F811
                                              monkeypatch):
    index, queries = data
    eng = MxuIsslScorer(port_index(index), method="avg", threshold=75.0,
                        device="cpu", **KW)
    # no page fits the room left after construction: each halves down to
    # one query, which runs regardless
    room = eng.page_bytes(SLOT_ALIGN, eng._caps(1)) - 1
    monkeypatch.setattr(port_mxu, "free_bytes", lambda device: room)
    queries = queries[190:202]
    mit, cfd = eng.score(queries)
    ref_mit, ref_cfd = score_exact(index, queries, 4, 75.0, "avg")
    assert np.array_equal(mit, ref_mit) and np.array_equal(cfd, ref_cfd)
    assert len(eng.page_stats) == queries.shape[0]


def test_rank_bound_guard_raises():
    """A bucket at the rank bound (2^30 entries: int32 ranks) is refused
    before any device work; 2^22, the JAX engine's f32 bound, is not the
    port's (``test_torch_hybrid.py::test_hybrid_over_compact_past_2_22``)."""
    from types import SimpleNamespace

    deep = np.zeros((5, 257), dtype=np.int64)
    deep[:, 1:] = port_mxu.RANK_BOUND
    index = SimpleNamespace(seq_length=20, max_dist=4, slice_count=5,
                            bucket_count=256, bucket_offsets=deep)
    assert port_mxu.RANK_BOUND > 1 << 22
    with pytest.raises(ValueError, match="rank-exactness bound"):
        MxuIsslScorer(index, max_dist=4, device="cpu")


def test_memory_check_raises(data, monkeypatch):  # noqa: F811
    index, _ = data
    monkeypatch.setattr(port_mxu, "free_bytes", lambda device: 1 << 20)
    with pytest.raises(ValueError, match="GB are free"):
        MxuIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)


def test_finder_off_the_cpu_never_runs_the_plain_version():
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    another device (here ``meta``) never reaches the plain version."""
    from crackling_tpu_torch.ops.mxu_finder import mxu_finder_plain

    def t(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")

    calls = mxu_finder_plain.calls
    with pytest.raises(ValueError, match="no neighbour finder"):
        mxu_finder(t((1, 8), torch.int64), t((1, 1), torch.int64),
                   t((1, 1), torch.int32), t((2,), torch.int64),
                   t((1, 1, SLOT_ALIGN), torch.int32), segw=4, nseg=2,
                   max_dist=1, seq_length=20)
    assert mxu_finder_plain.calls == calls


def test_auto_caps_grow_instead_of_splitting(data):  # noqa: F811
    """A page over its caps grows the caps it passed and runs again whole,
    however far below its populations they start, and every cap ends at
    or above its population."""
    index, queries = data
    queries = queries[:150]
    eng = MxuIsslScorer(port_index(index), method="and", threshold=75.0,
                        chunk=1024, query_page=512, device="cpu")
    eng.cap_single = eng.cap_mslot = eng.cap_mcell = 8
    eng.cap_rescan = eng.cap_rhit = eng.hit_cap = 8
    out = eng._run_pages(queries)
    assert len(out) == 1 and len(eng.page_stats) > 1     # grown, not split
    nh, n1, nm, nc, n2c, nrh = eng.page_stats[-1]
    assert all(c >= p for c, p in zip(eng._caps(150),
                                      (n1, nm, nc, n2c, nrh, nh)))
    mit, cfd = eng.score(queries)
    ref_mit, ref_cfd = score_exact(index, queries, 4, 75.0, "and")
    assert np.array_equal(mit, ref_mit) and np.array_equal(cfd, ref_cfd)


# -- the exact replay (ops/mxu_replay.py; its plain version on the CPU) ----


@pytest.fixture(scope="module")
def replay_world():
    """A small port index that holds each case of the replay, its engine
    and its queries (index, engine, queries, cases): a guide with a crowd
    of 1,770 neighbours at distance 1-2 (~5,600 hit rows, past the kernel's
    shared memory; its scan exits early), a guide whose three one-base
    neighbours (7, 30 and 1 copies) are each found in four slices, two
    neighbour-free guides (one in the index, 3 copies; one not), a guide
    off the index inside the crowd (~1,900 rows), and 40 random sites of
    the index."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 1 << 40, size=3000, dtype=np.uint64)
    center, near, lone = base[0], base[1], base[2]
    shift = np.array([5, 9, 13], dtype=np.uint64) * np.uint64(2)
    one_base = near ^ (np.uint64(1) << shift)
    index = port_build_index(np.concatenate([
        base, crowd(center), np.repeat(one_base, [7, 30, 1]),
        np.repeat(lone, 2)]))
    off_index = center ^ np.uint64(0b10101 << 20)     # 3 bases from it
    fresh = rng.integers(0, 1 << 40, size=1, dtype=np.uint64)
    queries = np.concatenate([[center, near, lone], fresh, [off_index],
                              base[3:43]])
    eng = MxuIsslScorer(index, max_dist=4, method="and", threshold=75.0,
                        chunk=1024, device="cpu")
    yield index, eng, queries
    torch.set_num_threads(old)


@pytest.mark.parametrize("method", METHODS)
def test_replay_scores_equal_native_exact_and_oracle(replay_world, method):
    """``MxuIsslScorer.score`` through the plain replay, bit for bit equal
    to ``native/exact.cpp`` and to ``oracle.score_exact``, with each case
    of the world present."""
    from crackling_tpu_torch import native
    from crackling_tpu_torch.ops.oracle import score_exact as port_exact

    index, eng, queries = replay_world
    trace.enable()
    try:
        got = eng.score(queries, method=method)
        counters = trace.session().counters
    finally:
        trace.disable()
    for want in (native.exact_score_native(index, queries, 4, 75.0, method),
                 port_exact(index, queries, 4, 75.0, method)):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert counters["mxu.replay_spilled"] == 2    # the two in the crowd
    assert counters["mxu.replay_hits"] > 5000
    counts = eng.neighbour_counts(queries[:5])
    found = eng._self_lookup(queries[:5])[0]
    assert counts[1] == 3 * 4 and found[1]         # found in four slices each
    assert counts[2] == counts[3] == 0 and list(found[2:4]) == [True, False]
    assert counts[4] > 0 and not found[4]
    # the crowd's guide exits early: without an exit its sums are larger
    full = eng.score(queries[:1], method=method, threshold=1e-9)
    assert (full[0][0], full[1][0]) != (got[0][0], got[1][0])


def test_replay_of_pages_with_no_hit_rows(replay_world):
    """An empty page, and a page whose guides have no neighbour: the
    replay scores them from their own sites alone."""
    from crackling_tpu_torch.ops.oracle import score_exact as port_exact

    index, eng, queries = replay_world
    empty = eng.score(np.empty(0, dtype=np.uint64))
    assert empty[0].shape == empty[1].shape == (0,)
    lone = queries[2:4]
    assert not eng.neighbour_counts(lone).any()
    got, want = eng.score(lone), port_exact(index, lone, 4, 75.0, "and")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1][0] == 10000.0 / 103.0 and got[0][0] == 100.0


def test_plain_replay_does_not_depend_on_row_order(replay_world):
    """The kernel scatters each query's rows in no order; the plain version
    sorts them too, so a shuffled hit table gives the same sums."""
    from crackling_tpu_torch.ops import mxu_replay as mr

    _index, eng, queries = replay_world
    (pos, page, q_sig, hits), = eng._run_pages(queries)
    found, sid, occ = eng._self_lookup(page)
    own = torch.as_tensor(np.stack([np.where(found, sid, -1), occ]))
    args = (q_sig, own, eng.entries.reshape(-1), eng.occ.reshape(-1),
            mr.replay_tables(20, 4, "cpu"))
    kw = dict(method="avg", maximum_sum=mr.maximum_sum(75.0), slice_width=8)
    calls = mr.mxu_replay_plain.calls
    a = mr.mxu_replay(hits, *args, **kw)
    perm = torch.randperm(hits.shape[1],
                          generator=torch.Generator().manual_seed(3))
    b = mr.mxu_replay(hits[:, perm].contiguous(), *args, **kw)
    assert mr.mxu_replay_plain.calls == calls + 2
    assert torch.equal(a.sums, b.sums) and int(a.spilled) == 2


def test_replay_off_the_cpu_never_runs_the_plain_version():
    """Off the CPU the wrapper launches its kernel or raises."""
    from crackling_tpu_torch.ops import mxu_replay as mr

    def t(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")

    calls = mr.mxu_replay_plain.calls
    tabs = mr.ReplayTables(t((8,), torch.int32), t((8,), torch.float64),
                           t((20, 16), torch.float64), 1.0)
    with pytest.raises(ValueError, match="no exact replay"):
        mr.mxu_replay(t((4, 3), torch.int64), t((2,), torch.int64),
                      t((2, 2), torch.int64), t((8,), torch.int64),
                      t((8,), torch.int32), tabs, method="and",
                      maximum_sum=1.0, slice_width=8)
    assert mr.mxu_replay_plain.calls == calls
