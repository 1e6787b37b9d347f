"""Share of the window's guides that the hybrid re-scored exactly
(``HybridIsslScorer.last_rescored`` after each batch, summed)."""


def read(run):
    w = run.window
    return 100.0 * w["rescored"] / w["guides"] if w["guides"] else None
