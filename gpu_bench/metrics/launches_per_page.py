"""Kernel launches in the traced window (copies and fills apart) over the
compact pages it ran."""


def read(run):
    if run.trace is None or not run.trace.launches or not run.trace_pages:
        return None
    return run.trace.launches / len(run.trace_pages)
