"""The port's one in-program tracer: named spans and counters, recorded
only while tracing is on.

Tracing is on while a ``torch.profiler`` session is active
(``torch.autograd.profiler._is_profiler_enabled``; a ``[tpu] profile-dir``
run, or any caller's ``profile()``) or after :func:`enable`.

* **Off**, :func:`span` costs one flag check and returns a shared no-op
  context, and :func:`count` returns at once: nothing is recorded, no
  clock is read and no profiler range is opened.
* **On**, a span reads ``time.perf_counter_ns`` at entry and exit, keeps
  a per-thread stack of open spans and folds each closed span into the
  session's aggregates by name: count, total ns, self ns (total less its
  children's) and the name of its parent (the first one seen). It also
  opens a profiler range of that name, so that a profiler shows the span
  on the clock of the kernels it enqueues: torch's C++
  ``_RecordFunctionFast``, a quarter of the cost of
  ``torch.profiler.record_function`` under the profiler (2.9 against 11.7
  us a span on an H100's host), which stands in where torch lacks it. Its
  event is a host range and has no device-side copy.

A **session** holds what was recorded since tracing last turned on: the
first span or count that finds tracing on after one that found it off,
and :func:`enable`, start a fresh one. :func:`session` returns a copy of
it. Only aggregates are kept, so memory stays bounded over a genome.

Span names start with their layer: ``compact.``, ``mxu.``, ``dense.``,
``scan.`` and ``mfe.`` on the scoring path, ``stage.`` for the pipeline's
stages, ``index.`` and ``kernel.`` for set-up (and ``mxu.build`` for the
exact re-scorer's). Counters do too: ``compact.`` for the page program
(``compact.plane_bytes``: each enqueued page's device bytes), ``hybrid.``
for the re-score (``hybrid.exact_fallback``: each call that went to a host
re-scorer), ``mxu.`` for the exact engine (``mxu.replay_hits``: the hit
rows each page hands to its replay, under the span ``mxu.replay``;
``mxu.replay_spilled``: the guides whose rows the replay kernel sorted in
global memory, past a block's shared memory).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)


class _Stack(threading.local):
    def __init__(self):
        self.open = []      # this thread's open spans, innermost last


_enabled = False        # set by enable()
_live = False           # the session is open: no call has found tracing off
_tls = _Stack()
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


@dataclass
class SpanStats:
    count: int = 0
    total_ns: int = 0
    self_ns: int = 0
    parent: str | None = None


@dataclass
class Session:
    spans: dict[str, SpanStats] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        """Seconds and counts, for ``<output>.metrics.json``."""
        return {
            "spans": {k: {"count": v.count, "total_s": v.total_ns * 1e-9,
                          "self_s": v.self_ns * 1e-9, "parent": v.parent}
                      for k, v in self.spans.items()},
            "counters": dict(self.counters)}


_session = Session()


def _open_session() -> None:
    global _session, _live
    _session = Session()
    _live = True


def active() -> bool:
    """Whether tracing is on."""
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Turn tracing on without a profiler, in a fresh session."""
    global _enabled
    _enabled = True
    _open_session()


def disable() -> None:
    """Undo :func:`enable`; a running profiler keeps tracing on."""
    global _enabled
    _enabled = False


def session() -> Session:
    """A copy of the current (or last) session."""
    with _lock:
        return Session({k: SpanStats(v.count, v.total_ns, v.self_ns,
                                     v.parent)
                        for k, v in _session.spans.items()},
                       dict(_session.counters))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the session's counter ``name`` while tracing is on."""
    global _live
    if not (_enabled or _profiler._is_profiler_enabled):
        _live = False
        return
    with _lock:
        if not _live:
            _open_session()
        c = _session.counters
        c[name] = c.get(name, 0) + n


class _Span:
    __slots__ = ("name", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    # the profiler's range is opened first and closed last, so that the
    # span's own bookkeeping lies inside it and not in its parent's time
    def __enter__(self):
        self.rf = _range(self.name)
        self.rf.__enter__()
        if not _live:
            with _lock:
                if not _live:
                    _open_session()
        self.child_ns = 0
        _tls.open.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self.t0
        stack = _tls.open
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += dt
        with _lock:
            st = _session.spans.get(self.name)
            if st is None:
                st = _session.spans[self.name] = SpanStats(
                    parent=parent.name if parent is not None else None)
            st.count += 1
            st.total_ns += dt
            st.self_ns += dt - self.child_ns
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records ``name`` while tracing is on."""
    global _live
    if not (_enabled or _profiler._is_profiler_enabled):
        _live = False
        return _OFF
    return _Span(name)
