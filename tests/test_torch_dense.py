"""The PyTorch dense engine against the JAX engine and the oracles (CPU).

Inputs are ``tests/test_dense.py``'s dataset (self-hits, mutated
neighbours, absent queries, duplicate queries in one bucket) and
``tests/test_band_probe.py``'s adversarial index, made with numpy from a
seed and handed to the port through ``convert.index_from_arrays``. On the
CPU the port runs the plain version of its scan; the JAX engine runs its
Pallas kernel in interpret mode, once per module (each call takes tens of
seconds). Tolerances:

* the plain per-slot sums against a numpy pair loop that forms the same
  f32 terms: rtol 1e-12 (only the f64 summation order differs);
* the port's sums against JAX's (bf16-split log-matmuls, f32 sums) at
  JAX's own tier, rtol 2e-5 / atol 1e-5 (tests/test_dense.py), and
  against ``oracle.score_bruteforce`` (f64) at rtol 1e-5;
* paging and the ``qb_cap`` split against one page: rtol 1e-12;
* the kernel's flow emulated on the CPU (``test_torch_fullscan_mma.py``:
  tensor-core distance screen, exact re-test, f32 terms of the hits, f64
  sums) against the plain version: rtol 1e-12; run inside the engine,
  against JAX's sums at JAX's dense tier, rtol 2e-5 / atol 1e-5 (its
  bf16-split sums sit up to 2.7e-6 from the exact ones on this data).
"""

import numpy as np
import pytest
import torch

from crackling_tpu.ops.issl_dense import DenseIsslScorer as JaxDense
from crackling_tpu.ops.oracle import score_bruteforce
from crackling_tpu.ops.tables import (CFD_PAM_NGG_INDEX, cfd_pam_penalties,
                                      cfd_pos_penalties, mit_dense_table)
from crackling_tpu_torch.ops import issl_dense
from crackling_tpu_torch.ops.fullscan import dense_scan, dense_scan_plain
from crackling_tpu_torch.ops.issl_compact import plan_query_occupancy
from crackling_tpu_torch.ops.issl_dense import DenseIsslScorer
from test_band_probe import DENSE_MARGIN, adversarial  # noqa: F401
from test_dense import data  # noqa: F401  (shared fixture)
from test_torch_compact import port_index
from test_torch_fullscan_mma import emulate_dense_scan

KW = dict(query_page=64, chunk=1024)


def numpy_pair_sums(q, ents, occs, s, width, max_dist):
    """(MIT, CFD) sums of one query over one bucket's entries in slice
    ``s``, in a plain Python pair loop: a hit is within ``max_dist`` and
    matches no earlier slice exactly; its f32 terms are the dense MIT
    table's entry and pam x the position penalties in ascending order
    (1.0 at distance 0), summed in f64 times the occurrences."""
    tab = mit_dense_table(20, max_dist).astype(np.float32)
    pen = cfd_pos_penalties().astype(np.float32)
    pam = np.float32(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    mit = cfd = 0.0
    for e, o in zip(ents, occs):
        x = int(e) ^ int(q)
        pos = [p for p in range(20) if (x >> (2 * p)) & 3]
        if len(pos) > max_dist:
            continue
        if any(((x >> (sp * width)) & ((1 << width) - 1)) == 0
               for sp in range(s)):
            continue
        c = np.float32(1.0)
        if pos:
            c = pam
            for p in pos:
                qc, oc = (int(q) >> (2 * p)) & 3, (int(e) >> (2 * p)) & 3
                c = np.float32(c * pen[p, (qc << 2) | (oc ^ 3)])
        mit += float(tab[sum(1 << p for p in pos)]) * int(o)
        cfd += float(c) * int(o)
    return mit, cfd


def bucket_entries(index, s, b):
    ids = index.order[s, index.bucket_offsets[s, b]:
                      index.bucket_offsets[s, b + 1]]
    return index.site_sigs[ids], index.occurrences[ids]


@pytest.fixture(scope="module")
def jax_sums(data):  # noqa: F811
    index, queries = data
    return JaxDense(index, max_dist=4, interpret=True,
                    **KW).score_sums(queries)


def test_plain_dense_scan_vs_numpy(data):  # noqa: F811
    index, queries = data
    pidx = port_index(index)
    sc = DenseIsslScorer(pidx, max_dist=4, device="cpu", **KW)
    qb, _ = plan_query_occupancy(queries, sc.S, sc.B, 8, sc.qb_cap)
    q_sig = sc.query_tensor(queries)
    qsp = sc.plan(q_sig, qb)
    mit, cfd = dense_scan(sc.entries, sc.occ, sc.bucket_offsets,
                          sc.bucket_lens, q_sig, qsp, max_dist=4,
                          tabs=sc.tables)
    assert mit.shape == cfd.shape == qsp.shape
    assert mit.dtype == cfd.dtype == torch.float64
    want = np.zeros((2,) + tuple(qsp.shape))
    n = len(queries)
    for s, b, j in zip(*np.nonzero(qsp.numpy() < n)):
        ents, occs = bucket_entries(pidx, s, b)
        q = queries[int(qsp[s, b, j])]
        want[:, s, b, j] = numpy_pair_sums(q, ents, occs, s, 8, 4)
    # padding slots read 0, every occupied slot its bucket's sums
    np.testing.assert_allclose(mit.numpy(), want[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(cfd.numpy(), want[1], rtol=1e-12, atol=0)
    assert (want[1] > 0).sum() > len(queries) // 2


@pytest.mark.parametrize("reference", ["jax", "bruteforce"])
def test_dense_sums_match(data, jax_sums, reference):  # noqa: F811
    index, queries = data
    sc = DenseIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)
    got = sc.score_sums(queries)
    if reference == "jax":
        want, rtol, atol = jax_sums, 2e-5, 1e-5
    else:
        want, rtol, atol = score_bruteforce(
            queries, index.site_sigs, index.occurrences, 4), 1e-5, 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    assert (got[1] > 0).sum() > len(queries) // 2


@pytest.mark.parametrize("case", ["paging", "qb_cap_split"])
def test_dense_pages_reproduce_one_page(data, case):  # noqa: F811
    index, queries = data
    pidx = port_index(index)
    one = DenseIsslScorer(pidx, max_dist=4, device="cpu",
                          **KW).score_sums(queries)
    if case == "paging":            # two pages (page < n)
        kw = dict(query_page=16, chunk=1024)
    else:
        # four copies of one query share every bucket: a cap of 2 forces
        # the page to split in halves until each part fits
        kw = dict(KW, qb_cap=2)
        assert plan_query_occupancy(queries, 5, 256, 8, 2)[0] is None
    got = DenseIsslScorer(pidx, max_dist=4, device="cpu",
                          **kw).score_sums(queries)
    for g, w in zip(got, one):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("max_dist", [4, 2, 0])
@pytest.mark.parametrize("ragged", [False, True])
def test_kernel_emulation_matches_plain(data, max_dist, ragged):  # noqa: F811
    index, queries = data
    sc = DenseIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)
    qb, needed = plan_query_occupancy(queries, sc.S, sc.B, 8, sc.qb_cap)
    if ragged:                      # a slot count that is not a multiple of 8
        qb = needed + 1 if needed % 8 == 0 else needed
    q_sig = sc.query_tensor(queries)
    args = (sc.entries, sc.occ, sc.bucket_offsets, sc.bucket_lens, q_sig,
            sc.plan(q_sig, qb))
    kw = dict(max_dist=max_dist, tabs=sc.tables)
    got = emulate_dense_scan(*args, **kw)
    want = dense_scan_plain(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)
    assert (want[1] > 0).sum() >= len(queries) // 4


def test_kernel_emulation_in_engine_matches_jax(data, jax_sums,  # noqa: F811
                                                monkeypatch):
    index, queries = data
    monkeypatch.setattr(issl_dense, "dense_scan", emulate_dense_scan)
    got = DenseIsslScorer(port_index(index), max_dist=4, device="cpu",
                          **KW).score_sums(queries)
    for g, w in zip(got, jax_sums):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-5)
    assert (got[1] > 0).sum() > len(queries) // 2


def test_adversarial_deviation_within_band_margin(adversarial):  # noqa: F811
    index, queries, mit_f64, cfd_f64 = adversarial
    sc = DenseIsslScorer(port_index(index), max_dist=4, device="cpu", **KW)
    mit, cfd = sc.score(queries)
    dev = max(np.abs(mit - mit_f64).max(), np.abs(cfd - cfd_f64).max())
    assert dev < DENSE_MARGIN


def test_dense_engine_refuses_other_operating_points(data):  # noqa: F811
    from crackling_tpu.index import build_index

    index, _ = data
    with pytest.raises(ValueError, match="w=8"):
        DenseIsslScorer(port_index(build_index(index.site_sigs,
                                               slice_width=4)),
                        device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        DenseIsslScorer(port_index(index), chunk=1000, device="cpu")
