"""The system under test, and the benchmark's probes around it.

The only module of the benchmark that imports the port. It builds the
index as ``createIsslIndex`` does (the port's site extraction and
``build_index``) and the scorer as ``Pipeline._get_issl_scorer`` does for
its configured engine: for ``auto`` on the card,
``HybridIsslScorer(dense=CompactIsslScorer(...))``. :func:`instrument`
times and names, from here, the calls a traced run reads.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from .guard import RunRefused


@dataclass
class System:
    index: object
    hybrid: object          # HybridIsslScorer: what the window calls
    compact: object         # its fast engine, CompactIsslScorer
    device: torch.device

    def score(self, queries: np.ndarray):
        return self.hybrid.score(queries)

    def warm_exact(self, queries: np.ndarray) -> None:
        """Build the hybrid's exact re-scorer and run it once, as the first
        batch with a guide near the threshold would."""
        self.hybrid._get_exact().score(queries)

    def rescored(self) -> int:
        return int(self.hybrid.last_rescored)

    @property
    def pages_run(self) -> int:
        """Pages the compact engine has drained, retries included."""
        return len(self.compact.page_stats)

    # -- what the per-layer readers need of the compact engine -------------

    @property
    def bucket_lens(self) -> torch.Tensor:
        return self.compact.bucket_lens

    @property
    def finder_cells(self) -> int:
        """Cells per (slice, bucket, slot) of the finder's output: its
        chunks, its superchunks and the bucket total."""
        from crackling_tpu_torch.ops.compact_finder import superchunk_cells

        nch = self.compact._nchmax
        return nch + superchunk_cells(nch, self.compact.superchunk) + 1

    def query_tensor(self, page: np.ndarray) -> torch.Tensor:
        return self.compact.query_tensor(page)

    def rescan_rows(self, page: np.ndarray, qb: int):
        """The rescan list the page program builds for ``page`` at the
        engine's caps, and the flat packed list it reads."""
        from crackling_tpu_torch.ops.issl_compact import plan_slots

        c = self.compact
        q = c.query_tensor(page)
        qsp = plan_slots(q, c.S, c.B, qb)
        return c.decode_tree(q, qsp, c.finder(q, qsp)).rows

    @property
    def entries(self) -> torch.Tensor:
        return self.compact.entries.reshape(-1)

    @property
    def scan_width(self) -> int:
        return self.compact._scan_width

    def close(self) -> None:
        self.hybrid = self.compact = self.index = None


def build(genome: bytes, cfg: dict, device) -> System:
    from crackling_tpu_torch.index import build_index
    from crackling_tpu_torch.index.extract import extract_offtarget_sites_seq
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
    from crackling_tpu_torch.pipeline.run import select_auto_engine

    index = build_index(extract_offtarget_sites_seq(genome, to_upper=True),
                        seq_length=int(cfg["seq_length"]),
                        slice_width=int(cfg["slice_width"]))
    engine = cfg["engine"]
    if engine == "auto":
        engine = select_auto_engine(index, device)
    if engine != "compact":
        raise RunRefused(f"engine {cfg['engine']!r} resolves to {engine!r}; "
                         "this harness drives the hybrid over the compact "
                         "engine")
    md = int(cfg["max_distance"])
    # a bucket past the compact decoder's rank bound raises ValueError
    # here; the pipeline would fall back to the dense engine, which these
    # configurations never need
    compact = CompactIsslScorer(index, max_dist=md, device=device)
    hybrid = HybridIsslScorer(index, max_dist=md, method=cfg["method"],
                              threshold=float(cfg["score_threshold"]),
                              dense=compact, device=device)
    return System(index, hybrid, compact, torch.device(device))


@dataclass
class Probe:
    """Counts and host-clock seconds taken by :func:`instrument`."""
    pages: int = 0
    enqueue_s: float = 0.0
    rescore_calls: int = 0
    rescore_s: float = 0.0
    page_log: list | None = None    # (page, qb) of each page, when set

    def snapshot(self) -> dict:
        return {"pages": self.pages, "enqueue_s": self.enqueue_s,
                "rescore_calls": self.rescore_calls,
                "rescore_s": self.rescore_s}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def instrument(system: System, probe: Probe):
    """Wrap, for the duration, the calls a traced run reads: each page's
    enqueue (``CompactIsslScorer.run_page``, no sync on CUDA) and the exact
    re-scorer's ``score`` (ending in a synchronise) on the host clock, and
    spans ``bench.occupancy``, ``bench.pages``, ``bench.enqueue`` and
    ``bench.rescore`` for the profiler. Restores every call after."""
    from crackling_tpu_torch.ops import issl_compact

    cls = issl_compact.CompactIsslScorer
    run_page, run_pages = cls.run_page, cls._run_pages
    occupancy = issl_compact.plan_query_occupancy
    exact = system.hybrid._get_exact()
    exact_score = exact.score

    def timed_page(self, page, qb):
        t = time.perf_counter()
        with record_function("bench.enqueue"):
            out = run_page(self, page, qb)
        probe.enqueue_s += time.perf_counter() - t
        probe.pages += 1
        if probe.page_log is not None:
            probe.page_log.append((np.array(page, copy=True), qb))
        return out

    def named_pages(self, *args, **kw):
        with record_function("bench.pages"):
            return run_pages(self, *args, **kw)

    def named_occupancy(*args, **kw):
        with record_function("bench.occupancy"):
            return occupancy(*args, **kw)

    def timed_rescore(sigs):
        t = time.perf_counter()
        with record_function("bench.rescore"):
            out = exact_score(sigs)
            _sync(system.device)
        probe.rescore_s += time.perf_counter() - t
        probe.rescore_calls += 1
        return out

    cls.run_page, cls._run_pages = timed_page, named_pages
    issl_compact.plan_query_occupancy = named_occupancy
    exact.score = timed_rescore
    try:
        yield probe
    finally:
        cls.run_page, cls._run_pages = run_page, run_pages
        issl_compact.plan_query_occupancy = occupancy
        del exact.score
