"""The mammal cell's three readers on a recorded run: a page of a small
repeat-rich index scored on the CPU, with a made-up device trace of its
kernels and a session of the port's tracer. ``deep_finder_roofline`` and
``deep_rescan_roofline`` read what ``compact_finder_roofline`` and
``compact_rescan_roofline`` read on the same record; ``plane_mb_per_page``
reads ``compact.plane_bytes`` over ``compact.pages``; each reads None
where the run has nothing to read."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT
from crackling_tpu_torch import trace
from gpu_bench import spec
from gpu_bench.devtrace import DeviceTrace
from gpu_bench.genome import genome_bytes, make_genome
from gpu_bench.harness import RunRecord
from gpu_bench.system import Probe, build, instrument

CFG = {"seq_length": 20, "slice_width": 8, "max_distance": 4,
       "method": "and", "score_threshold": 75.0, "engine": "compact"}
TWINS = {"deep_finder_roofline": "compact_finder_roofline",
         "deep_rescan_roofline": "compact_rescan_roofline"}
KERNELS = {"compact_finder_kernel": 0.004, "compact_rescan_kernel": 0.0005}


@pytest.fixture(scope="module")
def recorded():
    """(system, trace_pages, session): the pages one call of 2,000 guides
    ran, logged by the harness's probes, and the tracer's session."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    from test_gpu_bench_reference import repeat_rich

    codes = np.concatenate([repeat_rich(seed=4, copies=60),
                            make_genome(np.random.default_rng(4), 100_000)])
    sysm = build(genome_bytes(codes), CFG, "cpu")
    queries = sysm.index.site_sigs[::7][:2000]
    probe = Probe(page_log=[])
    trace.enable()
    try:
        with instrument(sysm, probe):
            sysm.score(queries)
        session = trace.session()
    finally:
        trace.disable()
    yield sysm, probe.page_log, session
    torch.set_num_threads(old)


def record(sysm, pages, kernels=KERNELS, launches=None):
    n = len(pages) if launches is None else launches
    dtrace = DeviceTrace(1.0, 0.5, 3 * n,
                         {f"_ns::{k}(Args)": (n, s * n)
                          for k, s in kernels.items()}, {})
    return RunRecord({}, {}, dtrace, pages, sysm)


@pytest.mark.parametrize("metric", sorted(TWINS))
def test_roofline_reads_what_its_twin_reads(recorded, metric):
    sysm, pages, _ = recorded
    assert pages
    run = record(sysm, pages)
    got = spec.metric_reader(ROOT, metric)(run)
    want = spec.metric_reader(ROOT, TWINS[metric])(run)
    assert got is not None and got > 0
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(TWINS))
def test_roofline_nothing_to_read(recorded, metric):
    sysm, pages, _ = recorded
    read = spec.metric_reader(ROOT, metric)
    assert read(record(sysm, pages, kernels={})) is None    # no kernel
    assert read(record(sysm, pages, launches=len(pages) + 1)) is None
    untraced = RunRecord({}, {}, None, pages, sysm)
    assert read(untraced) is None


def test_plane_mb_per_page(recorded):
    sysm, pages, session = recorded
    read = spec.metric_reader(ROOT, "plane_mb_per_page")
    n = session.counters["compact.pages"]
    assert n == len(pages)
    c = sysm.compact
    want = sum(c.page_bytes(qb, page.shape[0]) for page, qb in pages)
    assert session.counters["compact.plane_bytes"] == want
    traced = SimpleNamespace(system=SimpleNamespace(
        compact=SimpleNamespace(trace_session=lambda: session)))
    assert read(traced) == pytest.approx(want / n / 1e6)


def test_plane_mb_per_page_nothing_to_read(recorded):
    _, _, session = recorded
    read = spec.metric_reader(ROOT, "plane_mb_per_page")

    def run(compact):
        return SimpleNamespace(system=SimpleNamespace(compact=compact))

    def tracer(s):
        return SimpleNamespace(trace_session=lambda: s)

    assert read(run(object())) is None                   # an older tree
    no_counter = type(session)(session.spans,
                               {"compact.pages": 3})
    assert read(run(tracer(no_counter))) is None
    no_pages = type(session)(session.spans,
                             {"compact.plane_bytes": 1 << 20})
    assert read(run(tracer(no_pages))) is None
