"""Host-clock ms per batch in the exact re-scorer's ``score`` (each call
ending in a synchronise), over every batch of the window; nothing to
read where no batch re-scored a guide."""


def read(run):
    p = run.probe
    if not p["rescore_calls"]:
        return None
    return 1e3 * p["rescore_s"] / run.window["batches"]
