"""The packed compact finder's share of its roofline on the mammal-depth
index: the frozen ``finder_bound_ms`` of every traced page over the finder
kernel's device time in the trace, as ``compact_finder_roofline`` reads it
on the shallower cells.

A temporary alias: it reads what ``compact_finder_roofline`` reads, under
another name for the mammal cell only, because that metric's ``workloads``
does not list the cell. Once it does, this reader and its twin test go."""

from gpu_bench import roofline

KERNEL = "compact_finder_kernel"


def read(run):
    count, secs = run.trace.kernel_time(KERNEL) if run.trace else (0, 0.0)
    if not count or count != len(run.trace_pages):
        return None
    blen = run.system.bucket_lens
    cells = run.system.finder_cells
    bound_ms = sum(roofline.finder_bound_ms(blen, qcount, qb, n, cells)[0]
                   for _q, qcount, qb, n in run.page_counts())
    return 100.0 * bound_ms * 1e-3 / secs
