"""The packed compact finder's share of its roofline: the frozen
``finder_bound_ms`` of every traced page over the finder kernel's device
time in the trace."""

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
