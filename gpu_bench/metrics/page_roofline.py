"""The whole page's share of the device's peak: the least time of every
traced page's full scan (``page_bound_ms``: the pairs of each query and
slice with its bucket, at the int8 tensor rate, or the bytes, from the
index and the queries alone) over the device's busy time in the same
window."""

from gpu_bench import roofline


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.trace_pages:
        return None
    blen = run.system.bucket_lens
    bound_ms = sum(roofline.page_bound_ms(blen, qcount, n)[0]
                   for _q, qcount, _qb, n in run.page_counts())
    return 100.0 * bound_ms * 1e-3 / t.busy_s
