"""Host-clock ms per page inside ``CompactIsslScorer.run_page``, which
enqueues the page program without a sync on CUDA, over the window's
pages."""


def read(run):
    p = run.probe
    return 1e3 * p["enqueue_s"] / p["pages"] if p["pages"] else None
