"""Fast full-scan scoring with reference-exact verdicts for all 5 methods.

The port of crackling_tpu/ops/issl_dense.py::HybridIsslScorer and
``_NativeExact``. A fast full-scan engine (by default the dense engine,
``ops/issl_dense.py``, as in the JAX package; the pipeline passes the
compact engine for ``engine = compact | auto``) scores every query; the
queries whose verdict its rounding could flip are scored again exactly:
in f64, in the reference's scan order and with its early exit.

Re-score chain, as in the JAX package (``issl_dense.py:537-578``): the
bit-exact MXU engine (``ops/issl_mxu.py``) on the fast engine's device,
reading the compact engine's resident lists where the fast engine is that
one (one copy of the index's lists on the device); where it does not fit
(its rank bound or the device's free memory), the native host scanner
``native/exact.cpp`` (the binary's per-query bucket walk, OpenMP across
queries); without a host toolchain, the flat exact engine
(``ops/issl_flat.py``) in f64 on the CPU. Each re-score call that goes to
one of those two counts ``hybrid.exact_fallback`` in the tracer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..index.build import IsslIndex


class _NativeExact:
    """score() adapter over native.exact_score_native (exact.cpp)."""

    def __init__(self, index, max_dist, threshold, method):
        self.index = index
        self.max_dist = max_dist
        self.threshold = threshold
        self.method = method

    def score(self, sigs):
        from .. import native

        return native.exact_score_native(self.index, sigs, self.max_dist,
                                         self.threshold, self.method)


class HybridIsslScorer:
    """Fast-engine speed with reference-exact verdicts for all 5 methods.

    For mit/cfd/and/or, full-scan verdicts match the binary's early-exit
    verdicts in exact arithmetic: those methods exit only once rejection
    is decided (the reference's inverted naming — 'and' REJECTS iff both
    scores are below threshold, 'or' iff either is, Crackling.py:814-828
    — makes the binary's exit conditions at isslScoreOfftargets.cpp:
    467-478 exactly reject-decided), and full-scan sums are >= partial
    sums, so the full scan can only confirm the rejection. The remaining
    risk is f32 rounding flipping a comparison at the threshold, so
    every query whose method-relevant margin ``|score - threshold|`` is
    within ``band`` is re-scored exactly; re-scored queries also get the
    binary's exact early-exit score values.

    ``avg`` is different: the binary exits on the average of the SUMS
    (isslScoreOfftargets.cpp:479-484) while the pipeline thresholds the
    average of the SCORES (Crackling.py:831), and by convexity of
    ``10000/(100+x)`` an exited query's frozen score average can sit
    ABOVE the threshold. Accepts are still safe under a full scan, so for
    ``avg`` every query the fast scan does NOT accept by more than
    ``band`` is re-scored exactly.
    """

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 method: str = "and", threshold: float = 75.0,
                 band: float | None = None, dense=None, device=None,
                 **dense_kw):
        self.index = index
        self.max_dist = index.max_dist if max_dist is None else max_dist
        self.method = method
        self.threshold = float(threshold)
        # ``dense`` may be any prebuilt full-scan fast engine with the
        # same score() contract (the compact engine, say); by default the
        # dense engine, built with ``dense_kw``
        if dense is None:
            from .issl_dense import DenseIsslScorer

            dense = DenseIsslScorer(index, max_dist=max_dist, device=device,
                                    **dense_kw)
        self.dense = dense
        # band=None: the fast engine's advertised rounding band (1.0 for
        # dense, 0.05 for compact)
        if band is None:
            band = getattr(self.dense, "score_band", 1.0)
        self.band = float(band)
        self._exact = None
        self.last_rescored = 0

    def _get_exact(self):
        if self._exact is None:
            from .. import native
            from .issl_mxu import MxuIsslScorer

            lists = getattr(self.dense, "lists", None)
            kw = {} if lists is None else dict(lists=lists,
                                               chunk=self.dense.chunk)
            try:
                self._exact = MxuIsslScorer(
                    self.index, max_dist=self.max_dist, method=self.method,
                    threshold=self.threshold, device=self.dense.device,
                    **kw)
            except ValueError:
                # a bucket past the MXU engine's rank bound, or its index
                # and page buffers do not fit beside the fast engine's:
                # re-score on the host in true f64
                args = (self.index, self.max_dist, self.threshold,
                        self.method)
                if native.exact_score_native(
                        self.index, np.empty(0, np.uint64), self.max_dist,
                        self.threshold, self.method) is not None:
                    self._exact = _NativeExact(*args)
                else:
                    from .issl_flat import IsslScorer

                    self._exact = IsslScorer(
                        self.index, max_dist=self.max_dist,
                        method=self.method, threshold=self.threshold,
                        dtype=torch.float64, device="cpu")
        return self._exact

    def _near_threshold(self, mit, cfd):
        thr, band = self.threshold, self.band
        m_mit = np.abs(mit - thr) <= band
        m_cfd = np.abs(cfd - thr) <= band
        if self.method == "mit":
            return m_mit
        if self.method == "cfd":
            return m_cfd
        if self.method == "avg":
            # every non-clear-accept: the reference's avg early exit can
            # accept queries whose full-scan average is far below the
            # threshold (see class docstring)
            return (mit + cfd) / 2.0 < thr + band
        return m_mit | m_cfd          # and / or

    def score(self, query_sigs: np.ndarray):
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        mit, cfd = self.dense.score(sigs)
        near = self._near_threshold(mit, cfd)
        self.last_rescored = int(near.sum())   # diagnostics / perf studies
        trace.count("hybrid.guides", sigs.shape[0])
        trace.count("hybrid.rescored", self.last_rescored)
        if near.any():
            from .issl_mxu import MxuIsslScorer

            exact = self._get_exact()
            if not isinstance(exact, MxuIsslScorer):
                trace.count("hybrid.exact_fallback")
            with trace.span("mxu.rescore"):
                em, ec = exact.score(sigs[near])
            mit[near] = em
            cfd[near] = ec
        return mit, cfd
