"""The PyTorch scan-style engine against the JAX engine and the oracles
(CPU).

Inputs are ``tests/test_pallas.py``'s dataset (made with numpy from a
seed), the same sites at slice width 4, and an index at width 10 whose
hits match only in the slice that straddles bit 32, handed to the port
through ``convert.index_from_arrays``. On the CPU the port runs the plain
version of its scan; the JAX engine runs its Pallas kernel in interpret
mode, once per index. Tolerances: the plain per-position sums against a
numpy pair loop that forms the same f32 terms, rtol 1e-12; the port's
sums against JAX's (f32 sums) and against ``oracle.score_bruteforce``
(f64) at JAX's tier, rtol 2e-6 / atol 1e-6 (tests/test_pallas.py); a
partial page against the full one, rtol 1e-12; the kernel's flow emulated
on the CPU (``test_torch_fullscan_mma.py``: tensor-core distance screen
at K = 64 or 96, exact re-test, f32 terms of the hits, f64 sums) against
the plain version, rtol 1e-12, and, run inside the engine, against JAX's
sums at JAX's tier.
"""

import numpy as np
import pytest
import torch

from crackling_tpu.index import build_index
from crackling_tpu.ops.issl_pallas import PallasIsslScorer
from crackling_tpu.ops.oracle import score_bruteforce
from crackling_tpu_torch.ops import issl_scan
from crackling_tpu_torch.ops.fullscan import bucket_scan, bucket_scan_plain
from crackling_tpu_torch.ops.issl_scan import ScanIsslScorer
from test_pallas import data  # noqa: F401  (shared fixture)
from test_torch_compact import port_index
from test_torch_dense import bucket_entries, numpy_pair_sums
from test_torch_fullscan_mma import emulate_bucket_scan

JAX_KW = dict(query_page=32, superchunk=1024, interpret=True)


@pytest.fixture(scope="module")
def jax_sums(data):  # noqa: F811
    index, queries = data
    return PallasIsslScorer(index, max_dist=4, **JAX_KW).score_sums(queries)


def _width(data, w):  # noqa: F811
    index, queries = data
    return (index if w == 8 else build_index(index.site_sigs,
                                             slice_width=w)), queries


@pytest.mark.parametrize("width", [8, 4])
def test_plan_and_plain_bucket_scan_vs_numpy(data, width):  # noqa: F811
    index, queries = _width(data, width)
    pidx = port_index(index)
    sc = ScanIsslScorer(pidx, max_dist=4, device="cpu")
    q_sig = sc.query_tensor(queries)
    qoff, qsorted = sc.plan(q_sig)
    S, B, n = sc.S, sc.B, len(queries)
    vals = pidx.slice_values(queries).astype(np.int64)          # (S, n)
    np.testing.assert_array_equal(
        qsorted.numpy(), np.argsort(vals, axis=1, kind="stable"))
    np.testing.assert_array_equal(
        qoff.numpy()[:, 1:],
        np.cumsum([np.bincount(v, minlength=B) for v in vals], axis=1))
    mit, cfd = bucket_scan(sc.entries, sc.occ, sc.bucket_offsets,
                           sc.bucket_lens, q_sig, qoff, qsorted,
                           slice_width=width, max_dist=4, tabs=sc.tables)
    assert mit.shape == cfd.shape == (S, n)
    assert mit.dtype == cfd.dtype == torch.float64
    want = np.zeros((2, S, n))
    for s in range(S):
        for pos, qid in enumerate(qsorted[s].tolist()):
            ents, occs = bucket_entries(pidx, s, vals[s, qid])
            want[:, s, pos] = numpy_pair_sums(queries[qid], ents, occs, s,
                                              width, 4)
    np.testing.assert_allclose(mit.numpy(), want[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(cfd.numpy(), want[1], rtol=1e-12, atol=0)
    assert (want[1] > 0).sum() >= 24


@pytest.mark.parametrize("reference,width", [("jax", 8), ("bruteforce", 8),
                                             ("bruteforce", 4)])
def test_scan_sums_match(data, jax_sums, reference, width):  # noqa: F811
    index, queries = _width(data, width)
    sc = ScanIsslScorer(port_index(index), max_dist=4, query_page=32,
                        device="cpu")
    got = sc.score_sums(queries)
    want = (jax_sums if reference == "jax" else
            score_bruteforce(queries, index.site_sigs, index.occurrences, 4))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6)
    assert (got[1] > 0).sum() >= 24


def test_scan_partial_page(data):  # noqa: F811
    index, queries = data
    sc = ScanIsslScorer(port_index(index), max_dist=4, query_page=32,
                        device="cpu")
    m5, c5 = sc.score_sums(queries[:5])
    m, c = sc.score_sums(queries)
    np.testing.assert_allclose(m5, m[:5], rtol=1e-12, atol=0)
    np.testing.assert_allclose(c5, c[:5], rtol=1e-12, atol=0)


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("max_dist", [4, 2, 0])
def test_kernel_emulation_matches_plain(data, width, max_dist):  # noqa: F811
    index, queries = _width(data, width)
    sc = ScanIsslScorer(port_index(index), max_dist=4, device="cpu")
    q_sig = sc.query_tensor(queries)
    args = (sc.entries, sc.occ, sc.bucket_offsets, sc.bucket_lens, q_sig,
            *sc.plan(q_sig))
    kw = dict(slice_width=width, max_dist=max_dist, tabs=sc.tables)
    got = emulate_bucket_scan(*args, **kw)
    want = bucket_scan_plain(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)
    assert (want[1] > 0).sum() >= len(queries) // 4


def test_kernel_emulation_in_engine_matches_jax(data, jax_sums,  # noqa: F811
                                                monkeypatch):
    index, queries = data
    monkeypatch.setattr(issl_scan, "bucket_scan", emulate_bucket_scan)
    got = ScanIsslScorer(port_index(index), max_dist=4, query_page=32,
                         device="cpu").score_sums(queries)
    for g, w in zip(got, jax_sums):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6)
    assert (got[1] > 0).sum() >= 24


def _straddling_world():
    """Width 10 at l=20: slice 3 holds bits 30-39 and straddles bit 32.
    Each site differs from its query once in each of slices 0-2 (3
    positions apart), so it matches the query only in slice 3; max_dist 3
    (= S - 1) makes the slice search see every site the brute force
    sees."""
    rng = np.random.default_rng(5)
    queries = rng.integers(0, 1 << 40, size=16).astype(np.uint64)
    queries |= np.uint64(1) << np.uint64(38)   # slice-3 value >= 4
    sites = list(queries)
    for q in queries:
        for _ in range(3):
            s = int(q)
            for p in rng.integers(0, 5, 3) + np.array([0, 5, 10]):
                old = (s >> (2 * int(p))) & 3
                new = (old + 1 + int(rng.integers(0, 3))) % 4
                s = (s & ~(3 << (2 * int(p)))) | (new << (2 * int(p)))
            sites.append(s)
    sites += list(rng.integers(0, 1 << 40, size=200))
    return build_index(np.array(sites, dtype=np.uint64),
                       slice_width=10), queries


def test_straddling_width_refused():
    """The JAX engine reads a straddling slice from the low word alone,
    so it puts the queries in the wrong bucket and loses every hit that
    only that slice finds; the port refuses the width rather than give
    that answer."""
    index, queries = _straddling_world()
    want = score_bruteforce(queries, index.site_sigs, index.occurrences, 3)
    assert (want[0] > 0).all()
    got = PallasIsslScorer(index, max_dist=3, query_page=16,
                           superchunk=1024, interpret=True).score_sums(queries)
    assert not np.allclose(got[0], want[0], rtol=2e-6, atol=1e-6)
    with pytest.raises(ValueError, match="straddle"):
        ScanIsslScorer(port_index(index), max_dist=3, device="cpu")
