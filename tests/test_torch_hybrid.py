"""The PyTorch hybrid (fast full scan + exact re-score) against exact
scoring, with either fast engine: the default, dense (band 1.0), and
compact (band 0.05), passed in as the pipeline passes it.

For all five methods the hybrid's verdicts must equal the reference's
(its early exit included), and every query it re-scores must carry the
reference's ``%f`` scores. The reference is the binary where it can be
built (``ref_bins``), and everywhere ``oracle.score_exact``, the JAX
package's bit-exact emulation of it (itself held to the binary by
tests/test_scorer.py). Inputs: tests/test_native_exact.py's dataset,
handed over through ``convert.index_from_arrays``; the port on the CPU.
"""

import subprocess

import numpy as np
import pytest
import torch

from crackling_tpu.codec import sigs_to_strings
from crackling_tpu.ops.oracle import score_exact
from crackling_tpu_torch.ops import hybrid
from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
from crackling_tpu_torch.ops.issl_dense import DenseIsslScorer
from crackling_tpu_torch.ops.issl_flat import IsslScorer
from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer
from crackling_tpu_torch.pipeline.run import verdicts
from test_native_exact import data  # noqa: F401  (shared fixture)
from test_torch_compact import port_index

METHODS = [("mit", 80.0), ("cfd", 80.0), ("and", 75.0), ("or", 75.0),
           ("avg", 90.0)]
# (MIT, CFD) channels each method calculates
CALC = {"mit": (True, False), "cfd": (False, True), "and": (True, True),
        "or": (True, True), "avg": (True, True)}


@pytest.fixture(scope="module")
def world(data):  # noqa: F811
    return data


# (re-scorer, band): the hybrid's own band re-scores only what rounding
# could flip; an infinite band sends every query through the re-scorer.
# The links of the re-score chain: the MXU engine (its first choice), the
# native host scanner, and the flat exact engine in f64 on the CPU (the
# no-toolchain link)
CHAINS = [("mxu", None), ("mxu", np.inf), ("native", None),
          ("native", np.inf), ("flat", np.inf)]
FAST = ["dense", "compact"]
KW = dict(query_page=64, chunk=1024)


def _hybrid(pidx, fast, **kw):
    """The hybrid over its default fast engine (dense) or over the compact
    engine, passed in as the pipeline passes it."""
    dense = (CompactIsslScorer(pidx, max_dist=4, device="cpu", **KW)
             if fast == "compact" else None)
    return HybridIsslScorer(pidx, max_dist=4, device="cpu", dense=dense,
                            **kw, **({} if dense else KW))


def test_default_fast_engine_is_dense(world):
    index, _ = world
    hy = HybridIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)
    assert isinstance(hy.dense, DenseIsslScorer)
    assert hy.band == DenseIsslScorer.score_band == 1.0
    assert hy.dense.query_page == 64 and hy.dense.chunk == 1024
    assert _hybrid(hy.index, "compact").band == 0.05


@pytest.mark.parametrize("fast", FAST)
@pytest.mark.parametrize("exact,band", CHAINS)
@pytest.mark.parametrize("method,thr", METHODS)
def test_hybrid_matches_exact_emulation(world, method, thr, exact, band,
                                        fast):
    index, queries = world
    hy = _hybrid(port_index(index), fast, method=method, threshold=thr,
                 band=band)
    if exact == "native":
        hy._exact = hybrid._NativeExact(hy.index, 4, thr, method)
    elif exact == "flat":
        hy._exact = IsslScorer(hy.index, max_dist=4, method=method,
                               threshold=thr, dtype=torch.float64,
                               device="cpu")
    mit, cfd = hy.score(queries)
    if exact == "mxu":               # the chain's first link on its own
        assert isinstance(hy._get_exact(), MxuIsslScorer)
    ref_mit, ref_cfd = score_exact(index, queries, 4, thr, method)
    np.testing.assert_array_equal(verdicts(mit, cfd, thr, method),
                                  verdicts(ref_mit, ref_cfd, thr, method))
    near = hy._near_threshold(*hy.dense.score(queries))
    assert hy.last_rescored == int(near.sum())
    if band == np.inf:
        assert near.all()
    # the channels the method calculates (the reference prints -1 for the
    # other, isslScoreOfftargets.cpp:514-527; the flat engine scores both)
    for on, a, b in zip(CALC[method], (mit, cfd), (ref_mit, ref_cfd)):
        if on:
            assert ["%f" % x for x in a[near]] == \
                ["%f" % x for x in b[near]]


@pytest.mark.parametrize("fast", FAST)
@pytest.mark.parametrize("method,thr", METHODS)
def test_hybrid_matches_reference_binary(world, ref_bins, tmp_path, method,
                                         thr, fast):
    from crackling_tpu_torch.index import write_reference_issl

    index, queries = world
    pidx = port_index(index)
    issl = tmp_path / "t.issl"
    write_reference_issl(pidx, str(issl))
    qfile = tmp_path / "q.txt"
    qfile.write_text("".join(s + "\n" for s in sigs_to_strings(queries, 20)))
    out = subprocess.run(
        [ref_bins["isslScoreOfftargets"], str(issl), str(qfile), "4",
         str(thr), method], capture_output=True, text=True, check=True)
    rows = [line.split("\t") for line in out.stdout.strip().split("\n")]
    ref_mit = np.array([float(r[1]) for r in rows])
    ref_cfd = np.array([float(r[2]) for r in rows])
    hy = _hybrid(pidx, fast, method=method, threshold=thr)
    mit, cfd = hy.score(queries)
    np.testing.assert_array_equal(verdicts(mit, cfd, thr, method),
                                  verdicts(ref_mit, ref_cfd, thr, method))
    near = hy._near_threshold(*hy.dense.score(queries))
    for on, a, b in zip(CALC[method], (mit, cfd), (ref_mit, ref_cfd)):
        if on:
            assert ["%f" % x for x in a[near]] == \
                ["%f" % x for x in b[near]]


@pytest.mark.parametrize("exact", ["mxu", "native", "flat"])
def test_rescorer_shares_the_compact_lists_and_counts_fallbacks(world,
                                                                exact):
    """Over the compact engine the MXU re-scorer reads the compact
    engine's lists (the same storage: one copy on the device) and no call
    counts ``hybrid.exact_fallback``; each call that goes to a host link
    of the chain counts one."""
    from crackling_tpu_torch import trace

    index, queries = world
    hy = _hybrid(port_index(index), "compact", method="and",
                 threshold=75.0, band=np.inf)
    if exact == "native":
        hy._exact = hybrid._NativeExact(hy.index, 4, 75.0, "and")
    elif exact == "flat":
        hy._exact = IsslScorer(hy.index, max_dist=4, method="and",
                               threshold=75.0, dtype=torch.float64,
                               device="cpu")
    trace.enable()
    try:
        got = [hy.score(queries), hy.score(queries[:8])]
        s = trace.session()
    finally:
        trace.disable()
    ref = score_exact(index, queries, 4, 75.0, "and")
    assert np.array_equal(np.stack(got[0]), np.stack(ref))
    assert s.counters["hybrid.rescored"] == queries.shape[0] + 8
    if exact == "mxu":
        mxu, lists = hy._exact, hy.dense.lists
        assert mxu.entries.data_ptr() == lists.entries.data_ptr()
        assert mxu.bucket_offsets.data_ptr() == lists.boff.data_ptr()
        assert mxu.bucket_lens.data_ptr() == lists.blen.data_ptr()
        assert s.spans["mxu.build"].count == 1
        assert "hybrid.exact_fallback" not in s.counters
    else:
        assert s.counters["hybrid.exact_fallback"] == 2
