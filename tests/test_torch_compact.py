"""The PyTorch compact engine against the JAX engine and the oracles (CPU).

Inputs are ``tests/test_compact.py``'s datasets (made with numpy from a
seed), handed to both packages through ``convert.index_from_arrays``.
On the CPU the port runs its plain finder; the JAX engine runs its Pallas
kernel in interpret mode, as its own tests do. Tolerances: finder cells
exact; compaction populations (``page_stats``) exact, the six the JAX
engine's tuples open with;
sums within rtol 1e-5 / atol 1e-5 (f32 per-hit arithmetic, summed in
different orders), as in test_compact.py. The re-paging tests make a sorted
batch with numpy from a seed, as the off-target stage sends it, and hold
the port to ``score_bruteforce`` alone.
"""

import numpy as np
import pytest
import torch

from crackling_tpu.ops.issl_compact import CompactIsslScorer as JaxCompact
from crackling_tpu.ops.issl_compact import _quant_cap as jax_quant_cap
from crackling_tpu.ops.oracle import score_bruteforce
from crackling_tpu_torch import trace
from crackling_tpu_torch.convert import index_from_arrays
from crackling_tpu_torch.ops.compact_finder import (RANK_EMPTY,
                                                    compact_finder,
                                                    superchunk_cells)
from crackling_tpu_torch.index import build_index
from crackling_tpu_torch.ops.issl_compact import (ALIGN, CAP_RESCAN,
                                                  CompactIsslScorer,
                                                  _quant_cap, plan_slots)
from test_band_probe import COMPACT_MARGIN, adversarial  # noqa: F401
from test_compact import data, deep_data  # noqa: F401


def port_index(index):
    return index_from_arrays(dict(
        seq_length=index.seq_length, slice_width=index.slice_width,
        seq_count=index.seq_count, site_sigs=index.site_sigs,
        occurrences=index.occurrences, order=index.order,
        bucket_offsets=index.bucket_offsets))


def triplets(sigs, positions=(16, 17, 18)):
    """Three one-base mutants of each signature, one at each position:
    at slice 4's positions (the default) all three match their guide in
    slice 0, so the guide's slice-0 slot holds its own site and the three
    in one chunk, a rescan row; at slice 0's, in slice 1."""
    sigs = np.asarray(sigs, dtype=np.uint64)
    return np.concatenate([sigs ^ (np.uint64(1) << np.uint64(2 * p))
                           for p in positions])


def with_rows(index, queries):
    """``index``'s sites and :func:`triplets` of ``queries``: a rescan row
    for each guide."""
    return build_index(np.concatenate(
        [np.repeat(index.site_sigs, index.occurrences), triplets(queries)]))


@pytest.fixture(scope="module")
def datasets(data, deep_data):  # noqa: F811
    return {"data": data, "deep": deep_data}


def _assert_sums(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# -- the finder against a numpy brute force of its predicate ---------------


def _numpy_slot_plan(queries, S, B, qb):
    qsp = np.full((S, B, qb), len(queries), dtype=np.int64)
    fill = np.zeros((S, B), dtype=np.int64)
    for i, q in enumerate(queries):
        for s in range(S):
            b = (int(q) >> (8 * s)) & (B - 1)
            qsp[s, b, fill[s, b]] = i
            fill[s, b] += 1
    return qsp


def _numpy_finder(index, queries, qsp, chunk, nchmax, superchunk,
                  max_dist):
    S, B, qb = qsp.shape
    nsc = superchunk_cells(nchmax, superchunk)
    C = nchmax + nsc + 1
    cnt = np.zeros((S, B, C, qb), np.int64)
    rsum = np.zeros((S, B, C, qb), np.int64)
    rmin = np.full((S, B, C, qb), RANK_EMPTY, np.int64)
    rmax = np.full((S, B, C, qb), -1, np.int64)
    for s in range(S):
        for b in range(B):
            lo, hi = index.bucket_offsets[s, b], index.bucket_offsets[s, b + 1]
            ents = index.site_sigs[index.order[s, lo:hi]]
            for j in range(qb):
                qid = qsp[s, b, j]
                if qid >= len(queries) or ents.size == 0:
                    continue
                x = ents ^ queries[qid]
                pos = np.array([(x >> np.uint64(2 * p)) & np.uint64(3)
                                for p in range(20)]) != 0      # (20, L)
                hit = pos.sum(0) <= max_dist
                for sp in range(s):        # an earlier slice matches
                    hit &= pos[4 * sp:4 * sp + 4].any(0)
                for r in np.flatnonzero(hit):
                    cells = [r // chunk, C - 1]
                    if superchunk:
                        cells.append(nchmax + r // chunk // superchunk)
                    for c in cells:
                        cnt[s, b, c, j] += 1
                        rsum[s, b, c, j] += r
                        rmin[s, b, c, j] = min(rmin[s, b, c, j], r)
                        rmax[s, b, c, j] = max(rmax[s, b, c, j], r)
    return cnt, rsum, rmin, rmax


@pytest.mark.parametrize("name,superchunk", [("data", 0), ("deep", 2),
                                             ("deep", 0)])
def test_plain_finder_vs_numpy(datasets, name, superchunk):
    index, queries = datasets[name]
    pidx = port_index(index)
    chunk = 1024
    S, B = pidx.slice_count, pidx.bucket_count
    arrs = pidx.device_arrays_aligned(align=ALIGN, tail=chunk)
    nchmax = max(1, -(-int(arrs["bucket_lens"].max()) // chunk))
    qb = 64
    want_plan = _numpy_slot_plan(queries, S, B, qb)
    q_sig = torch.as_tensor(queries.view(np.int64))
    qsp = plan_slots(q_sig, S, B, qb)
    np.testing.assert_array_equal(qsp.numpy(), want_plan)
    lo = arrs["list_lo"].view(np.uint32).astype(np.uint64)
    hi = arrs["list_hi"].view(np.uint32).astype(np.uint64)
    fo = compact_finder(
        torch.as_tensor((lo | (hi << np.uint64(32))).view(np.int64)),
        torch.as_tensor(arrs["bucket_offsets"][:, :B].astype(np.int64)),
        torch.as_tensor(arrs["bucket_lens"]), q_sig, qsp, chunk=chunk,
        nchmax=nchmax, superchunk=superchunk, max_dist=4)
    want = _numpy_finder(pidx, queries, want_plan, chunk, nchmax,
                         superchunk, 4)
    for got, exp in zip(fo[:4], want):
        np.testing.assert_array_equal(got.numpy(), exp)
    assert int(fo.cnt.sum()) > 0


# -- the scorer against the JAX engine -------------------------------------

JAX_CASES = {
    "data": ("data", dict(query_page=64, chunk=1024)),
    "deep-tree": ("deep", dict(query_page=32, chunk=1024, superchunk=2)),
}


@pytest.fixture(scope="module")
def jax_runs(datasets):
    out = {}
    for case, (name, kw) in JAX_CASES.items():
        index, queries = datasets[name]
        sc = JaxCompact(index, max_dist=4, interpret=True, **kw)
        out[case] = (sc.score_sums(queries), sc.page_stats)
    return out


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_compact_matches_jax(datasets, jax_runs, case):
    name, kw = JAX_CASES[case]
    index, queries = datasets[name]
    sc = CompactIsslScorer(port_index(index), max_dist=4, device="cpu",
                           **kw)
    sums = sc.score_sums(queries)
    jax_sums, jax_stats = jax_runs[case]
    assert sc.page_stats == [p[:6] for p in jax_stats]
    _assert_sums(sums, jax_sums)
    _assert_sums(sums, score_bruteforce(queries, index.site_sigs,
                                        index.occurrences, 4))
    if case == "deep-tree":                     # every tree stage fired
        assert all(p > 0 for p in sc.page_stats[0][1:5])


# -- the scorer's paging and caps against brute force ----------------------


def _queries_page_of_sites(index):
    # distinct sites: every query self-hits, so each 8-query page has
    # more than 8 direct (1-2 hit) slots
    return np.asarray(index.site_sigs[10:42:2], dtype=np.uint64)


CAP_CASES = {
    # (dataset, scorer options, the rows cap it starts at (None: the
    # default), mode)
    # two pages (page < n) reproduce the single-page sums
    "paging": ("data", dict(query_page=16), None, ()),
    # the rows cap below the page's rows: the page grows it and runs
    # again whole
    "rows-overflow-grows": ("data", dict(query_page=64), 0, ("rows",)),
    # the same below a page whose superchunk levels fire
    "sc-rows-overflow-grows": ("deep", dict(query_page=32, superchunk=2),
                               8, ()),
    # the flat (no superchunk) decode of a multi-chunk bucket
    "flat-decode": ("deep", dict(query_page=32, superchunk=0), None, ()),
    # the first page tunes the cap to its rows (as on the card)
    "auto-tune": ("data", dict(query_page=16), None, ("tune",)),
    # a tuning page over a cap far too small overflows, grows, runs again,
    # and tunes the cap to the rows of its run
    "auto-grow": ("deep", dict(query_page=32), 8, ("tune",)),
    # two pages dispatched under the same tiny cap; the second is checked
    # against the cap it ran with, not the cap the first one grew
    "dispatch-caps": ("data", dict(query_page=8), 4, ("sites", "rows")),
}


@pytest.mark.parametrize("case", list(CAP_CASES))
def test_compact_paging_and_caps_vs_bruteforce(datasets, case):
    name, kw, cap, mode = CAP_CASES[case]
    index, queries = datasets[name]
    if "sites" in mode:
        queries = _queries_page_of_sites(index)
    index = with_rows(index, queries) if "rows" in mode else \
        port_index(index)
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                           **kw)
    assert sc._tuned                    # the CPU keeps its cap untuned
    if cap is not None:
        sc.cap_rescan = cap
    if "tune" in mode:
        sc._tuned = False               # tune on the first page
    trace.enable()
    try:
        sums = sc.score_sums(queries)
        counters = trace.session().counters
    finally:
        trace.disable()
    _assert_sums(sums, score_bruteforce(queries, index.site_sigs,
                                        index.occurrences, 4))
    stats = np.array(sc.page_stats)
    if case in ("rows-overflow-grows", "sc-rows-overflow-grows"):
        # one page, run twice whole: no split, the same populations
        assert len(sc.page_stats) == 2 == counters["compact.pages"]
        assert sc.page_stats[0] == sc.page_stats[1]
        assert counters["compact.retries"] == 1
        assert "compact.splits" not in counters
        assert sc.cap_rescan >= stats[0, 5] > cap
        if case == "sc-rows-overflow-grows":
            assert stats[0, 2] >= stats[0, 3] > 0
    elif case == "flat-decode":
        assert stats.max(0)[4] > 0 and stats.max(0)[5] > 0
    elif case == "auto-tune":
        assert sc._tuned and sc.cap_rescan < CAP_RESCAN
        assert sc.cap_rescan == _quant_cap(sc.page_stats[0][5])
    elif case == "auto-grow":
        assert len(sc.page_stats) == 2 and counters["compact.retries"] == 1
        assert sc.cap_rescan == _quant_cap(sc.page_stats[-1][5]) > 8
    elif case == "dispatch-caps":
        n_pages = -(-queries.shape[0] // 8)
        assert n_pages >= 2 and len(sc.page_stats) >= 2 * n_pages


def test_quant_cap_matches_jax():
    for pop in (0, 1, 100, 4096, 5595, 10000, 34592, 99999, 292927):
        assert _quant_cap(pop) == jax_quant_cap(pop)


def test_rank_bound_guard_raises():
    """A bucket at the rank bound (2^30 entries: int32 ranks below the
    empty-cell sentinel) is refused before any device work; 2^22, the JAX
    engine's f32 bound, is not the port's
    (``test_torch_hybrid.py::test_hybrid_over_compact_past_2_22``)."""
    from types import SimpleNamespace

    from crackling_tpu_torch.ops.issl_compact import RANK_BOUND

    deep = np.zeros((5, 257), dtype=np.int64)
    deep[:, 1:] = RANK_BOUND
    index = SimpleNamespace(slice_width=8, seq_length=20, max_dist=4,
                            slice_count=5, bucket_count=256,
                            bucket_offsets=deep)
    assert 1 << 22 < RANK_BOUND < RANK_EMPTY
    with pytest.raises(ValueError, match="rank-exactness bound"):
        CompactIsslScorer(index, max_dist=4, device="cpu")


def test_adversarial_deviation_within_band_margin(adversarial):  # noqa: F811
    index, queries, mit_f64, cfd_f64 = adversarial
    sc = CompactIsslScorer(port_index(index), max_dist=4, query_page=64,
                           chunk=1024, device="cpu")
    mit, cfd = sc.score(queries)
    dev = max(np.abs(mit - mit_f64).max(), np.abs(cfd - cfd_f64).max())
    assert dev < COMPACT_MARGIN


# -- re-paging sorted batches ----------------------------------------------

REPAGE = dict(query_page=512, qb_cap=64)
PINNED = np.uint64(0x5A) << np.uint64(32)          # slice 4's value, pinned
TOP_MASK = np.uint64(0xFF) << np.uint64(32)


@pytest.fixture
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def sorted_batch(rng, n, tops=16):
    """``n`` guides as the off-target stage hands them over (sorted,
    distinct) whose slice 4 takes ``tops`` values: a 512-guide page in
    input order crowds a bucket with ~n / tops guides, a strided one ~512 /
    tops."""
    top = rng.choice(256, tops, replace=False).astype(np.uint64)
    low = rng.integers(0, 1 << 32, size=n).astype(np.uint64)
    return np.unique((top[rng.integers(0, tops, n)] << np.uint64(32)) | low)


def mutants(rng, sigs):
    pos = rng.integers(0, 20, size=sigs.size).astype(np.uint64) * \
        np.uint64(2)
    return ((sigs & ~(np.uint64(3) << pos))
            | (rng.integers(0, 4, size=sigs.size).astype(np.uint64) << pos))


@pytest.fixture(scope="module")
def sorted_world():
    """A sorted batch of ~2,048 guides over 16 slice-4 values, 384 sorted
    guides pinned to one slice-4 value, and an index of every other guide
    of both and a one-base mutant of each, so that the sums have hits."""
    rng = np.random.default_rng(16)
    batch = sorted_batch(rng, 2048)
    crowd = np.unique((rng.integers(0, 1 << 40, size=384).astype(np.uint64)
                       & ~TOP_MASK) | PINNED)
    sites = np.concatenate([batch[::2], crowd[::2], mutants(rng, batch),
                            mutants(rng, crowd)])
    from crackling_tpu_torch.index import build_index

    return build_index(sites), batch, crowd


def traced_pages(sc, sigs, monkeypatch):
    """``sc.score_sums(sigs)`` with the tracer on: the sums, the session,
    and the host pages ``run_page`` received."""
    ran, run_page = [], CompactIsslScorer.run_page

    def spy(self, page, qb):
        ran.append(np.array(page))
        return run_page(self, page, qb)

    monkeypatch.setattr(CompactIsslScorer, "run_page", spy)
    trace.enable()
    try:
        sums = sc.score_sums(sigs)
        return sums, trace.session(), ran
    finally:
        trace.disable()


def brute(index, sigs):
    return score_bruteforce(sigs, index.site_sigs, index.occurrences, 4)


@pytest.mark.parametrize("case", ["sorted", "shuffled"])
def test_repage_engages_on_a_sorted_batch(sorted_world, one_thread,
                                          monkeypatch, case):
    """Sorted pages in input order would crowd one slice-4 bucket past
    qb_cap and halve; the batch is strided into ceil(n / query_page) pages
    instead, page k holding positions k, k + P, ..., and each answer lands
    at its guide's position. A shuffled batch, whose strided page fits
    too, is strided the same way."""
    index, batch, _crowd = sorted_world
    sigs = (batch if case == "sorted"
            else np.random.default_rng(1).permutation(batch))
    n = sigs.shape[0]
    P = -(-n // REPAGE["query_page"])
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                           **REPAGE)
    sums, s, ran = traced_pages(sc, sigs, monkeypatch)
    _assert_sums(sums, brute(index, sigs))
    assert s.counters.get("compact.repaged") == 1
    assert "compact.splits" not in s.counters
    # the decision's plan is none of the pages' plans
    assert s.counters["compact.pages"] == \
        s.counters["compact.occupancy_calls"] == len(sc.page_stats) == P
    assert s.spans["compact.repage"].count == 1
    assert s.spans["compact.repage"].parent == "compact.score"
    assert s.spans["compact.occupancy"].count == P
    assert len(ran) == P
    for k, page in enumerate(ran):
        np.testing.assert_array_equal(page, sigs[k::P])


@pytest.mark.parametrize("case", ["one-page", "crowd"])
def test_repage_declined_keeps_input_order(sorted_world, one_thread,
                                           monkeypatch, case):
    """A sorted batch of one page is not re-paged, and a batch pinned to
    one slice-4 bucket overflows qb_cap strided too: both keep input order,
    halve as before and count no re-page."""
    index, batch, crowd = sorted_world
    if case == "one-page":
        sigs, kw = batch[:REPAGE["query_page"]], REPAGE
    else:
        sigs, kw = crowd, dict(query_page=256, qb_cap=64)
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu", **kw)
    sums, s, ran = traced_pages(sc, sigs, monkeypatch)
    _assert_sums(sums, brute(index, sigs))
    assert "compact.repaged" not in s.counters
    np.testing.assert_array_equal(np.concatenate(ran), sigs)
    assert s.counters["compact.splits"] > 0
    assert all(p.shape[0] <= 64 for p in ran)
    if case == "one-page":
        assert "compact.repage" not in s.spans
    else:
        assert s.spans["compact.repage"].count == 1


def test_halving_a_strided_page_keeps_its_positions(sorted_world,
                                                     one_thread):
    """A strided page over qb_cap halves its positions with its guides:
    the answers land at every other position and nowhere else."""
    index, _batch, crowd = sorted_world
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                           qb_cap=64)
    n = crowd.shape[0]
    out = np.full((2, n), -1.0)
    sc._run_pages([(range(1, n, 2), crowd[1::2])], out[0], out[1])
    assert len(sc.page_stats) == 4          # 192 guides -> 4 pages of 48
    assert (out[:, ::2] == -1.0).all()
    _assert_sums((out[0, 1::2], out[1, 1::2]), brute(index, crowd[1::2]))


# -- the rows cap on a page shorter than the tuning page, and its growth --


@pytest.fixture(scope="module")
def rows_world():
    """4,096 shuffled distinct guides and an index of each with
    :func:`triplets` of it at slice 4's positions and at slice 0's: two
    rescan rows a guide, ~8,200 on a 4,096-guide page (past the 4,096
    grain) and ~2,050 on a 1,024-guide page."""
    rng = np.random.default_rng(17)
    batch = np.unique(rng.integers(0, 1 << 40, size=4096).astype(np.uint64))
    rng.shuffle(batch)
    return build_index(np.concatenate(
        [batch, triplets(batch), triplets(batch, (0, 1, 2))])), batch


def cap_spy(monkeypatch):
    """The rows cap of each decode the page program runs."""
    from crackling_tpu_torch.ops import issl_compact

    ran, decode = [], issl_compact.decode_score

    def spy(*args, cap_rescan, **kw):
        ran.append(cap_rescan)
        return decode(*args, cap_rescan=cap_rescan, **kw)

    monkeypatch.setattr(issl_compact, "decode_score", spy)
    return ran


def test_auto_caps_scale_to_a_shorter_page(rows_world, one_thread,
                                           monkeypatch):
    """The rows cap tuned on a 4,096-guide page: a 1,024-guide page runs
    at the cap scaled to a quarter, to the 4,096 grain, and needs no
    retry."""
    index, batch = rows_world
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                           query_page=4096)
    sc._tuned = False                   # tune on the first page, as on CUDA
    sc.score_sums(batch)
    base = sc._cap()
    assert sc._cap_rows == 4096 and base == _quant_cap(
        sc.page_stats[0][5]) > 4096
    ran = cap_spy(monkeypatch)
    trace.enable()
    try:
        sums = sc.score_sums(batch[:1024])
        s = trace.session()
    finally:
        trace.disable()
    _assert_sums(sums, brute(index, batch[:1024]))
    assert ran == [sc._cap(1024)] and ran[0] == 4096 < base
    assert "compact.retries" not in s.counters and sc._cap() == base


def test_a_scaled_page_over_its_caps_grows_their_floor(rows_world,
                                                        one_thread):
    """A page whose rows cap, scaled from a far longer tuning page, falls
    below its rows retries once at the floor it grew, and the cap of the
    longer pages stays as it was."""
    index, batch = rows_world
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                           query_page=4096)
    sc._tuned, sc._cap_rows = True, 1 << 20
    base = sc._cap()
    assert sc._cap(4096) == 4096
    trace.enable()
    try:
        sums = sc.score_sums(batch)
        s = trace.session()
    finally:
        trace.disable()
    _assert_sums(sums, brute(index, batch))
    pop = sc.page_stats[0][5]
    assert pop > 4096 and s.counters["compact.retries"] == 1
    assert sc._cap_floor == _quant_cap(pop) == sc._cap(4096)
    assert sc._cap() == base == sc._cap(1 << 20)


def test_an_overflowed_page_runs_again_whole(rows_world, one_thread,
                                             monkeypatch):
    """On the CPU as on the card, a page whose rows pass the cap it ran at
    grows the cap and runs again whole: one retry, no split."""
    index, batch = rows_world
    sc = CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                           query_page=4096)
    sc.cap_rescan = 4096
    sums, s, ran = traced_pages(sc, batch, monkeypatch)
    _assert_sums(sums, brute(index, batch))
    assert s.counters["compact.retries"] == 1
    assert "compact.splits" not in s.counters
    assert "compact.retry_halves" not in s.counters
    assert len(ran) == len(sc.page_stats) == 2
    for page in ran:
        np.testing.assert_array_equal(page, batch)
    assert sc.page_stats[0] == sc.page_stats[1]
    assert sc.page_stats[0][5] > 4096


def test_a_grown_page_past_the_room_halves(rows_world, one_thread,
                                           monkeypatch):
    """A page whose grown rows cap would not fit the room fixed at
    construction (the free memory less ``reserve`` and a sixteenth) runs
    in halves instead, each at the grown cap, and counts the halving."""
    from crackling_tpu_torch.ops import issl_compact

    index, batch = rows_world
    monkeypatch.setattr(issl_compact, "CAP_RESCAN", 4096)
    kw = dict(max_dist=4, chunk=1024, device="cpu", query_page=4096)
    qb = CompactIsslScorer(index, **kw)._plan(batch)[0]
    kw["qb_cap"] = qb
    small = CompactIsslScorer(index, **kw).page_bytes(qb, 4096)
    big = 1 << 40
    monkeypatch.setattr(issl_compact, "free_bytes", lambda d: big)
    sc = CompactIsslScorer(index, reserve=big - (-(-small * 16 // 15)),
                           **kw)
    assert (sc.qb_cap, sc.query_page) == (qb, 4096)
    sums, s, ran = traced_pages(sc, batch, monkeypatch)
    _assert_sums(sums, brute(index, batch))
    grown = small + 6 * 8 * (_quant_cap(sc.page_stats[0][5]) - 4096)
    assert small <= sc.room < grown
    assert s.counters["compact.retries"] == 1
    assert s.counters["compact.retry_halves"] == 1
    assert "compact.splits" not in s.counters
    assert len(ran) == len(sc.page_stats) == 3
    for page, want in zip(ran, (batch, batch[:2048], batch[2048:])):
        np.testing.assert_array_equal(page, want)


# -- pages sized to the device's free memory -------------------------------

@pytest.mark.parametrize("room", ["ample", "tight", "reserve", "refused",
                                  "build", "least"])
def test_pages_sized_to_free_memory(sorted_world, one_thread, monkeypatch,
                                    room):
    """Pages keep ``qb_cap`` and ``query_page`` where a page at the cap fits
    the free memory; where it does not, less ``reserve`` (by default what
    the hybrid's exact re-scorer adds beside these lists) and a sixteenth
    of slack, ``qb_cap`` is cut to the slots that fit (a multiple of 64)
    and ``query_page`` in the same ratio, with the same sums. Where the
    lists, their build's transients and the least page do not fit, or
    fewer than 64 slots do, the engine refuses the index with ValueError,
    naming the bytes needed and free."""
    from crackling_tpu_torch.ops import issl_compact
    from crackling_tpu_torch.ops.issl_compact import (SLOT_ALIGN,
                                                      aligned_layout)
    from crackling_tpu_torch.ops.issl_mxu import added_bytes

    index, batch, _ = sorted_world
    kw = dict(max_dist=4, chunk=1024, query_page=512, qb_cap=128,
              device="cpu")
    probe = CompactIsslScorer(index, **kw)
    shared = added_bytes(index, 1024, shared=True)
    assert probe.reserve == shared > 0
    need = (index.slice_count * aligned_layout(index, 1024)[1] * 12
            + index.num_sites * 36 + probe.page_bytes(SLOT_ALIGN, SLOT_ALIGN))

    def slots(k):       # the free memory that fits pages of k slots
        return -(-probe.page_bytes(k, 512) * 16 // 15)

    big = max(need, 1 << 40)
    free, kw2, refusal = {
        "ample": (None, {}, None),
        "tight": (big, dict(reserve=big - slots(96)), None),
        "reserve": (slots(96) + shared, {}, None),
        "refused": (1 << 16, {}, "needs ~.* GB are free"),
        "build": (need - 1, {}, "their build .* GB are free"),
        "least": (big, dict(reserve=big - slots(SLOT_ALIGN - 1)),
                  f"page of {SLOT_ALIGN} slots needs .* GB are free"),
    }[room]
    if room == "reserve":
        assert free >= need     # the lists fit: only the pages are cut
    if free is not None:
        monkeypatch.setattr(issl_compact, "free_bytes", lambda d: free)
    if refusal is not None:
        with pytest.raises(ValueError, match=refusal):
            CompactIsslScorer(index, **kw, **kw2)
        return
    sc = CompactIsslScorer(index, **kw, **kw2)
    sums = sc.score_sums(batch)
    want = (128, 512) if room == "ample" else (64, 256)
    assert (sc.qb_cap, sc.query_page) == want
    for got, ref in zip(sums, brute(index, batch)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tail", [0, 1024])
def test_aligned_lists_match_the_index_layout(datasets, tail):
    """The lists built on the device a slice at a time hold the index's
    aligned layout (``IsslIndex.device_arrays_aligned``) exactly."""
    from crackling_tpu_torch.ops.issl_compact import aligned_lists

    index = port_index(datasets["deep"][0])
    arrs = index.device_arrays_aligned(align=ALIGN, tail=tail)
    got = aligned_lists(index, "cpu", tail=tail)
    lo = arrs["list_lo"].view(np.uint32).astype(np.uint64)
    hi = arrs["list_hi"].view(np.uint32).astype(np.uint64)
    assert np.array_equal(got.entries.numpy(),
                          (lo | (hi << np.uint64(32))).view(np.int64))
    assert np.array_equal(got.occ.numpy(), arrs["list_occ"])
    assert np.array_equal(got.boff.numpy(),
                          arrs["bucket_offsets"][:, :index.bucket_count])
    assert np.array_equal(got.blen.numpy(), arrs["bucket_lens"])
