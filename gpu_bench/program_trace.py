"""The program's own record of the traced call: the session of the port's
tracer (``crackling_tpu_torch.trace``), which the profiler's session turns
on, reached through the compact engine's ``trace_session()``. A program
without the tracer has nothing to read, and its readers return None."""


def session(run):
    """The tracer's session, or None where the program has no tracer."""
    get = getattr(run.system.compact, "trace_session", None)
    return get() if get is not None else None


def per_page(run, value):
    """``value(session)`` over the session's ``compact.pages`` (the pages
    the traced call enqueued, re-runs included); None where there is no
    session, no page or no value."""
    s = session(run)
    pages = s.counters.get("compact.pages", 0) if s is not None else 0
    v = value(s) if pages else None
    return None if v is None else v / pages


def span_ms(name: str):
    """A ``value`` for :func:`per_page`: span ``name``'s total in ms."""
    def total(s):
        st = s.spans.get(name)
        return st.total_ns * 1e-6 if st is not None and st.count else None
    return total
