"""The compact rescan's share of its roofline on the mammal-depth index
(~200 hits a guide): the frozen ``rescan_bound_ms`` of every traced page's
rescan list (rebuilt by the page program at the engine's caps) over the
rescan kernel's device time in the trace, as ``compact_rescan_roofline``
reads it on the shallower cells.

A temporary alias: it reads what ``compact_rescan_roofline`` reads, under
another name for the mammal cell only, because that metric's ``workloads``
does not list the cell. Once it does, this reader and its twin test go."""

from gpu_bench import roofline

KERNEL = "compact_rescan_kernel"


def read(run):
    count, secs = run.trace.kernel_time(KERNEL) if run.trace else (0, 0.0)
    if not count or count != len(run.trace_pages):
        return None
    s = run.system
    bound_ms = 0.0
    for page, qb in run.trace_pages:
        rows = s.rescan_rows(page, qb)
        if rows.ridx.numel():
            bound_ms += roofline.rescan_bound_ms(
                rows, s.entries, s.scan_width, s.compact.max_dist,
                page.shape[0])[0]
    return 100.0 * bound_ms * 1e-3 / secs if bound_ms > 0 else None
