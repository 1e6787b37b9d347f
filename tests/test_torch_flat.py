"""The PyTorch flat exact engine (``ops/issl_flat.py``) against the JAX
package's ``IsslScorer`` and the oracles, and ``scoreOfftargets`` against
the JAX CLI (CPU).

Inputs are ``tests/test_scorer.py``'s dataset (made with numpy from a
seed), handed to both packages through ``convert.index_from_arrays``.
Tolerances are test_scorer.py's: f64 sums and scores within rtol 1e-12;
f32 sums within rtol 2e-6 of the brute-force f64 sums and f32 verdicts
identical. The CLI prints ``%f`` of f64 scores in both packages, so its
lines must be identical; its device and precision follow the JAX CLI's
rule on the estimated scan work, kept on the card (checked for every
``CRACKLING_PLATFORM`` value on both sides of the 5e8 limit).
"""

import numpy as np
import pytest
import torch

from crackling_tpu.index import build_index as jax_build_index
from crackling_tpu.ops.issl_jax import IsslScorer as JaxScorer
from crackling_tpu.ops.oracle import score_bruteforce, score_exact
from crackling_tpu_torch.device import score_offtargets_placement
from crackling_tpu_torch.ops import issl_flat
from crackling_tpu_torch.ops.issl_flat import IsslScorer, default_dtype
from crackling_tpu_torch.pipeline.run import verdicts
from test_scorer import fixture_data  # noqa: F401  (shared fixture)
from test_torch_compact import port_index

METHODS = ["and", "or", "avg", "mit", "cfd"]
KW = dict(max_dist=4, query_block=64, work_block=1 << 12)
# (MIT, CFD) channels each method calculates
CALC = {"mit": (True, False), "cfd": (False, True), "and": (True, True),
        "or": (True, True), "avg": (True, True)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sums_match_jax_and_bruteforce(fixture_data, dtype):  # noqa: F811
    import jax.numpy as jnp

    index, queries = fixture_data
    got = IsslScorer(port_index(index), dtype=getattr(torch, dtype),
                     device="cpu", **KW).score_sums(queries)
    want = JaxScorer(index, dtype=jnp.dtype(dtype), **KW).score_sums(queries)
    brute = score_bruteforce(queries, index.site_sigs, index.occurrences, 4)
    rtol = 1e-12 if dtype == "float64" else 2e-6
    for g, w, b in zip(got, want, brute):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(g, b, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("method", METHODS)
def test_early_exit_matches_jax_and_oracle(fixture_data, method):  # noqa: F811
    import jax.numpy as jnp

    index, queries = fixture_data
    got = IsslScorer(port_index(index), dtype=torch.float64, device="cpu",
                     method=method, threshold=75.0, **KW).score(queries)
    want = JaxScorer(index, dtype=jnp.float64, method=method,
                     threshold=75.0, **KW).score(queries)
    ref = score_exact(index, queries, 4, 75.0, method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    for on, g, r in zip(CALC[method], got, ref):
        if on:
            np.testing.assert_allclose(g, r, rtol=1e-12)
    np.testing.assert_array_equal(verdicts(*got, 75.0, method),
                                  verdicts(*ref, 75.0, method))


@pytest.mark.parametrize("method", ["and", "avg"])
def test_f32_verdict_parity(fixture_data, method):  # noqa: F811
    index, queries = fixture_data
    mit, cfd = IsslScorer(port_index(index), dtype=torch.float32,
                          device="cpu", method=method, threshold=75.0,
                          **KW).score(queries)
    ref = score_exact(index, queries, 4, 75.0, method)
    np.testing.assert_array_equal(verdicts(mit, cfd, 75.0, method),
                                  verdicts(*ref, 75.0, method))


@pytest.mark.parametrize("seq_length,slice_width", [(20, 4), (16, 8)])
def test_other_operating_points_match_jax(fixture_data, seq_length,  # noqa: F811
                                          slice_width):
    """Widths and lengths other than l=20 / w=8, which ``engine = auto``
    sends to this engine."""
    import jax.numpy as jnp

    index, queries = fixture_data
    mask = np.uint64((1 << (2 * seq_length)) - 1)
    index = jax_build_index(index.site_sigs & mask, seq_length=seq_length,
                            slice_width=slice_width)
    queries = queries & mask
    kw = dict(KW, max_dist=index.max_dist)
    got = IsslScorer(port_index(index), dtype=torch.float64, device="cpu",
                     method="and", threshold=75.0, **kw).score(queries)
    want = JaxScorer(index, dtype=jnp.float64, method="and",
                     threshold=75.0, **kw).score(queries)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    assert (got[1] < 100.0).any()        # the queries do find their sites


def test_scores_transform():
    from crackling_tpu_torch.codec import strings_to_sigs
    from crackling_tpu_torch.index import build_index

    sigs = strings_to_sigs(["A" * 20], 20)
    scorer = IsslScorer(build_index(sigs), query_block=8, work_block=256,
                        device="cpu")
    mit, cfd = scorer.score(sigs)
    # self-hit: MIT sum 0 (dist == 0 adds nothing), CFD sum 1 * occ
    assert mit[0] == 100.0
    np.testing.assert_allclose(cfd[0], 10000.0 / 101.0, rtol=1e-6)


def test_dtype_rule():
    assert default_dtype("cpu") == torch.float64
    assert default_dtype(torch.device("cuda")) == torch.float32


@pytest.mark.parametrize("method", METHODS)
def test_score_offtargets_cli_matches_jax(fixture_data, tmp_path,  # noqa: F811
                                          monkeypatch, capsys, method):
    from crackling_tpu.codec import sigs_to_strings
    from crackling_tpu.index import write_reference_issl
    from crackling_tpu.utils import cli as jax_cli
    from crackling_tpu_torch.utils import cli as port_cli

    index, queries = fixture_data
    issl = tmp_path / "t.issl"
    write_reference_issl(index, str(issl))
    qfile = tmp_path / "q.txt"
    qfile.write_text("".join(s + "\n" for s in sigs_to_strings(queries, 20)))
    monkeypatch.setenv("CRACKLING_PLATFORM", "cpu")
    argv = [str(issl), str(qfile), "4", "75", method]
    capsys.readouterr()
    jax_cli.main_score_offtargets(argv)
    want = capsys.readouterr().out.splitlines()
    port_cli.main_score_offtargets(argv)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(queries)
    assert got == want


@pytest.mark.parametrize("platform", [None, "auto", "cpu", "cuda", "tpu"])
@pytest.mark.parametrize("est", [2.0e8, 4.99e8, 5e8, 3.0e9])
def test_score_offtargets_precision_rule(monkeypatch, platform, est):
    """The JAX CLI scores a workload under 5e8 in f64 unless the platform
    is forced (crackling_tpu/utils/cli.py:20-37); the port keeps that
    precision and keeps the card: only ``cpu`` asks for the CPU."""
    if platform is None:
        monkeypatch.delenv("CRACKLING_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("CRACKLING_PLATFORM", platform)
    small = platform in (None, "auto") and est < 5e8
    want = (("cpu", torch.float64) if platform == "cpu"
            else ("cuda", torch.float64 if small else torch.float32))
    assert score_offtargets_placement(est) == want


def test_score_offtargets_cli_small_work_in_f64(fixture_data,  # noqa: F811
                                                tmp_path, monkeypatch,
                                                capsys):
    """With CRACKLING_PLATFORM unset, the CLI estimates the work as the JAX
    CLI does (queries x slices x sites / buckets), asks for the card in
    f64 for this small workload, and (run here on the CPU in that dtype)
    prints the JAX CLI's lines."""
    from crackling_tpu.codec import sigs_to_strings
    from crackling_tpu.index import write_reference_issl
    from crackling_tpu.utils import cli as jax_cli
    from crackling_tpu_torch.utils import cli as port_cli

    index, queries = fixture_data
    issl = tmp_path / "t.issl"
    write_reference_issl(index, str(issl))
    qfile = tmp_path / "q.txt"
    qfile.write_text("".join(s + "\n" for s in sigs_to_strings(queries, 20)))
    asked = []

    class OnTheCpu(IsslScorer):
        def __init__(self, index, *, dtype, device, **kw):
            asked.append((device, dtype))
            super().__init__(index, dtype=dtype, device="cpu", **kw)

    monkeypatch.setattr(issl_flat, "IsslScorer", OnTheCpu)
    monkeypatch.delenv("CRACKLING_PLATFORM", raising=False)
    est = len(queries) * index.slice_count * (index.num_sites
                                              / index.bucket_count)
    assert est < 5e8
    argv = [str(issl), str(qfile), "4", "75", "and"]
    capsys.readouterr()
    jax_cli.main_score_offtargets(argv)
    want = capsys.readouterr().out.splitlines()
    port_cli.main_score_offtargets(argv)
    got = capsys.readouterr().out.splitlines()
    assert asked == [("cuda", torch.float64)]
    assert got == want and len(got) == len(queries)
