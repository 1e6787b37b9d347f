"""The readers of the program's own trace (``program_trace.py`` and the four
``metrics/*_per_page.py`` that read it) on made-up records: a session of
the port's tracer, a session with no page, and a program with no tracer
(an older tree)."""

from types import SimpleNamespace

import pytest

from conftest import ROOT
from crackling_tpu_torch.trace import Session, SpanStats
from gpu_bench import spec

PAGES = 256
SESSION = Session(
    spans={"compact.occupancy": SpanStats(510, 51_000_000, 51_000_000,
                                          "compact.score"),
           "compact.plan": SpanStats(PAGES, 179_200_000, 179_200_000,
                                     "compact.enqueue"),
           "compact.drain.wait": SpanStats(PAGES, 12_800_000, 12_800_000,
                                           "compact.drain")},
    counters={"compact.occupancy_calls": 510, "compact.pages": PAGES,
              "compact.splits": 254})
WANT = {"occupancy_calls_per_page": 510 / PAGES,
        "occupancy_ms_per_page": 51.0 / PAGES,
        "plan_ms_per_page": 179.2 / PAGES,
        "drain_wait_ms_per_page": 12.8 / PAGES}


def record(compact):
    return SimpleNamespace(system=SimpleNamespace(compact=compact))


class Traced:
    def __init__(self, session):
        self.session = session

    def trace_session(self):
        return self.session


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reads_the_session(metric):
    read = spec.metric_reader(ROOT, metric)
    assert read(record(Traced(SESSION))) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_nothing_to_read(metric):
    read = spec.metric_reader(ROOT, metric)
    assert read(record(object())) is None               # no tracer
    assert read(record(Traced(Session()))) is None      # an empty session
    no_pages = Session(SESSION.spans, {"compact.occupancy_calls": 3})
    assert read(record(Traced(no_pages))) is None
