"""The port's tracer (``crackling_tpu_torch/trace.py``) on the compact page
path, on the CPU.

Off (no profiler, no ``trace.enable()``), a compact ``score_sums`` call
must record nothing, read no clock and open no profiler range; no module
of the port but the tracer names ``record_function``. Under
``torch.profiler.profile()`` the session's aggregates must have the page
path's counts and parents, self times that are totals less the children's,
and each span must appear among the profiler's events, as often and for
as long (within 10% or 50 us a span). The counters must be exact:
occupancy plans, pages and splits on a sorted batch whose crowded top
slice makes ``qb_cap`` halve every page, and retries of pages whose rescan
rows pass a rows cap of 0, checked against ``page_stats``. The index is
made with numpy from a seed.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import crackling_tpu_torch
from crackling_tpu_torch import trace
from crackling_tpu_torch.index import build_index
from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
from crackling_tpu_torch.pipeline.metrics import Metrics

TOP = np.uint64(0x5A) << np.uint64(32)     # slice 4's value, pinned
TOP_MASK = np.uint64(0xFF) << np.uint64(32)
QB_CAP = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def world():
    """3,000 random sites plus 384 whose slice 4 is one value: sorted, the
    384 crowd one bucket, as a sorted batch of the off-target stage does."""
    rng = np.random.default_rng(15)
    sites = rng.integers(0, 1 << 40, size=3000).astype(np.uint64)
    crowd = (rng.integers(0, 1 << 40, size=384).astype(np.uint64)
             & ~TOP_MASK) | TOP
    index = build_index(np.concatenate([sites, crowd]))
    return index, np.unique(crowd), sites[:200]


def scorer(index, **kw):
    return CompactIsslScorer(index, max_dist=4, chunk=1024, device="cpu",
                             **kw)


def plane_bytes(sc, sigs, size):
    """``compact.plane_bytes`` of pages of ``size`` consecutive guides of
    ``sigs``: each page's device bytes at the slots its plan gives."""
    pages = [sigs[i:i + size] for i in range(0, sigs.shape[0], size)]
    return sum(sc.page_bytes(sc._plan(p)[0], p.shape[0]) for p in pages)


def test_off_records_nothing(world, monkeypatch):
    index, crowd, queries = world
    sc = scorer(index, query_page=64, qb_cap=QB_CAP)

    def refused(*_a, **_k):
        raise AssertionError("entered while tracing is off")

    for mod in (trace, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", refused)
    monkeypatch.setattr(trace, "_range", refused)
    monkeypatch.setattr(trace, "perf_counter_ns", refused)
    before = trace.session()
    assert not trace.active()
    sc.score_sums(np.concatenate([queries, crowd]))
    assert trace.session() == before
    assert len(sc.page_stats) > 4


def test_only_the_tracer_names_record_function():
    pkg = Path(crackling_tpu_torch.__file__).parent
    named = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                   if "record_function" in p.read_text())
    assert named == ["trace.py"]


def test_profiler_session_matches_events(world):
    index, _crowd, queries = world
    sc = scorer(index, query_page=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.active()
        sc.score_sums(queries)
    assert not trace.active()
    s = trace.session()
    pages = -(-queries.shape[0] // 64)
    assert s.counters == {"compact.occupancy_calls": pages,
                          "compact.pages": pages,
                          "compact.plane_bytes": plane_bytes(sc, queries,
                                                             64)}
    want = {"compact.score": (1, None),
            "compact.dispatch": (pages, "compact.score"),
            "compact.occupancy": (pages, "compact.dispatch"),
            "compact.enqueue": (pages, "compact.dispatch"),
            "compact.plan": (pages, "compact.enqueue"),
            "compact.finder": (pages, "compact.enqueue"),
            "compact.decode.rescan": (pages, "compact.enqueue"),
            "compact.drain": (pages, "compact.score"),
            "compact.drain.wait": (pages, "compact.drain")}
    assert {k: (v.count, v.parent) for k, v in s.spans.items()} == want
    for name, st in s.spans.items():
        kids = sum(c.total_ns for c in s.spans.values()
                   if c.parent == name)
        assert st.self_ns == st.total_ns - kids, name
        assert 0 <= st.self_ns <= st.total_ns
    events = {}
    for e in prof.events():
        if e.name in s.spans:
            c, us = events.get(e.name, (0, 0.0))
            events[e.name] = (c + 1, us + e.time_range.end
                              - e.time_range.start)
    for name, st in s.spans.items():
        count, us = events[name]
        assert count == st.count, name
        got, mean = st.total_ns * 1e-3 / count, us / count
        assert abs(got - mean) <= max(0.1 * mean, 50.0), (name, got, mean)


def test_counters_on_a_halved_sorted_batch(world):
    index, crowd, _queries = world
    sc = scorer(index, query_page=256, qb_cap=QB_CAP)
    trace.enable()
    sc.score_sums(crowd)
    s = trace.session()
    # every page of m crowded guides halves until it holds QB_CAP: m /
    # QB_CAP pages, one plan at every node of the halving tree
    leaves = [m // QB_CAP for m in (256, crowd.shape[0] - 256)]
    assert s.counters == {"compact.occupancy_calls":
                          sum(2 * n - 1 for n in leaves),
                          "compact.splits": sum(n - 1 for n in leaves),
                          "compact.pages": sum(leaves),
                          "compact.plane_bytes": plane_bytes(sc, crowd,
                                                             QB_CAP)}
    assert len(sc.page_stats) == sum(leaves)
    assert s.spans["compact.occupancy"].count == \
        s.counters["compact.occupancy_calls"]


def test_retries_count_the_pages_run_again(world):
    index, crowd, queries = world
    sigs = np.concatenate([queries, crowd[:56]])
    # three one-base mutants of each guide in slice 4's positions: a
    # rescan row for each
    mutants = [sigs ^ (np.uint64(1) << np.uint64(2 * p))
               for p in (16, 17, 18)]
    index = build_index(np.concatenate(
        [np.repeat(index.site_sigs, index.occurrences), *mutants]))
    sc = scorer(index, query_page=64)
    sc.cap_rescan = 0
    trace.enable()
    sc.score_sums(sigs)
    s = trace.session()
    first = -(-sigs.shape[0] // 64)
    retries = s.counters["compact.retries"]
    assert retries > 0
    assert s.counters["compact.pages"] == len(sc.page_stats) \
        == first + retries
    assert "compact.splits" not in s.counters


def test_enable_starts_a_fresh_session(world):
    trace.enable()
    trace.count("compact.pages", 3)
    with trace.span("compact.score"):
        pass
    assert trace.session().counters == {"compact.pages": 3}
    trace.enable()
    assert trace.session().spans == {} and trace.session().counters == {}
    trace.disable()
    trace.count("compact.pages")
    with trace.span("compact.score"):
        pass
    assert trace.session().counters == {}
    # off, then on again under a profiler: a fresh session
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("hybrid.guides", 2)
    assert trace.session().counters == {"hybrid.guides": 2}


def test_threads_lose_no_update():
    """Spans and counts from more threads than cores, switching often:
    every one lands in the session, each thread's spans nest in its own
    stack."""
    threads, each = 16, 300
    trace.enable()

    def work():
        for _ in range(each):
            with trace.span("compact.drain"):
                with trace.span("compact.drain.wait"):
                    trace.count("compact.pages")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    s = trace.session()
    assert s.counters == {"compact.pages": threads * each}
    assert s.spans["compact.drain"].count == threads * each
    assert s.spans["compact.drain.wait"].parent == "compact.drain"
    drain, wait = s.spans["compact.drain"], s.spans["compact.drain.wait"]
    assert drain.parent is None
    assert drain.self_ns == drain.total_ns - wait.total_ns


def test_metrics_write_the_session(tmp_path):
    m = Metrics(path=str(tmp_path / "out.metrics.json"))
    with m.stage("extract_candidates"):
        pass
    assert "trace" not in m.to_dict()
    trace.enable()
    with m.stage("offtarget_scoring"):
        with m.stage("offtarget_score"):
            trace.count("compact.pages", 2)
    d = m.to_dict()
    assert set(d["stage_seconds"]) == {"extract_candidates",
                                       "offtarget_scoring", "offtarget_score"}
    spans = d["trace"]["spans"]
    assert spans["stage.offtarget_score"]["parent"] == \
        "stage.offtarget_scoring"
    assert spans["stage.offtarget_scoring"]["count"] == 1
    assert d["trace"]["counters"] == {"compact.pages": 2}
