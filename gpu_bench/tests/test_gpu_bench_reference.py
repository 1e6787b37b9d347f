"""The generator and the plain reference, against the port on the CPU.

The reference may import nothing of the port; these tests may, to hold
it to the port's bit-exact emulation of the reference binary
(``ops/oracle.score_exact``) and to the port's own extraction."""

import numpy as np
import pytest
import torch

from gpu_bench import check
from gpu_bench.genome import candidate_guides, genome_bytes, make_genome
from gpu_bench.harness import streams
from gpu_bench.reference import offtarget
from gpu_bench.traffic import make_traffic

CFG = {"page_length": 1000}
MIX = {"requests_per_pass": 3, "warmup_batches": 1, "trace_guides": 500,
       "check_sample": 300}


def repeat_rich(seed=5, copies=40, length=3000):
    """A genome of mutated copies of one block and a random tail, so that
    guides have many close off-targets, some early exits and scores on
    both sides of every threshold."""
    rng = np.random.default_rng(seed)
    block = make_genome(rng, length)
    parts = []
    for _ in range(copies):
        b = block.copy()
        k = int(rng.integers(0, 150))
        b[rng.integers(0, length, size=k)] = rng.integers(0, 4, size=k)
        parts.append(b)
    return np.concatenate(parts + [make_genome(rng, 20_000)])


def test_generator_repeats_by_seed():
    def draw(seed):
        g, t = streams(seed, 2)
        codes = torch.from_numpy(make_genome(g, 50_000))
        return codes, make_traffic(MIX, CFG, codes, t)

    (c1, t1), (c2, t2), (c3, t3) = draw(2**31 + 7), draw(2**31 + 7), draw(9)
    assert torch.equal(c1, c2) and not torch.equal(c1, c3)
    assert np.array_equal(t1.queries, t2.queries)
    assert np.array_equal(t1.sample, t2.sample)
    assert t1.batches == t2.batches
    assert not np.array_equal(t1.queries[:100], t3.queries[:100])
    # the off-target stage's batches: each request's candidates in genome
    # order, page_length at a time, each batch deduplicated and sorted
    cands = candidate_guides(c1).numpy().view(np.uint64)
    want = [np.unique(b) for r in np.array_split(cands, 3)
            for b in np.array_split(r, range(1000, r.shape[0], 1000))]
    assert len(t1.batches) == len(want)
    for (lo, hi), w in zip(t1.batches, want):
        assert np.array_equal(t1.queries[lo:hi], w)
    assert t1.batches[0][0] == 0
    assert t1.batches[-1][1] == t1.queries.shape[0]
    assert all(a[1] == b[0] for a, b in zip(t1.batches, t1.batches[1:]))


def test_candidate_scan_matches_the_port():
    from crackling_tpu_torch.index.extract import find_candidate_guides_seq

    codes = make_genome(np.random.default_rng(3), 40_000)
    mine = candidate_guides(torch.from_numpy(codes)).numpy().view(np.uint64)
    _, _, sig23 = find_candidate_guides_seq(genome_bytes(codes))
    assert np.array_equal(mine, sig23 & np.uint64((1 << 40) - 1))


def test_sites_match_the_port():
    from crackling_tpu_torch.index import build_index
    from crackling_tpu_torch.index.extract import extract_offtarget_sites_seq

    codes = repeat_rich()
    sites = offtarget.site_table(torch.from_numpy(codes))
    index = build_index(extract_offtarget_sites_seq(genome_bytes(codes)))
    assert np.array_equal(sites.sigs.numpy().view(np.uint64),
                          index.site_sigs)
    assert np.array_equal(sites.occ, index.occurrences)


@pytest.mark.parametrize("method,threshold", [
    ("and", 75.0), ("or", 75.0), ("mit", 60.0), ("cfd", 50.0),
    ("avg", 70.0)])
def test_reference_matches_the_binary_emulation(method, threshold):
    from crackling_tpu_torch.index import build_index
    from crackling_tpu_torch.index.extract import extract_offtarget_sites_seq
    from crackling_tpu_torch.ops.oracle import score_exact

    codes = repeat_rich()
    ct = torch.from_numpy(codes)
    sites = offtarget.site_table(ct)
    index = build_index(extract_offtarget_sites_seq(genome_bytes(codes)))
    q = torch.unique(candidate_guides(ct)).numpy().view(np.uint64)
    q = q[np.random.default_rng(1).permutation(q.shape[0])[:400]]
    exp = offtarget.expected_scores(q, sites, max_dist=4,
                                    threshold=threshold, method=method,
                                    block_elems=1 << 22)
    mit, cfd = score_exact(index, q, 4, threshold, method)
    np.testing.assert_allclose(exp.exit_mit, mit, rtol=0, atol=1e-9)
    np.testing.assert_allclose(exp.exit_cfd, cfd, rtol=0, atol=1e-9)
    assert not exp.accepted.all() or method == "cfd"
    # some guide exits early, so the two valid answers differ
    assert ((exp.exit_mit != exp.full_mit)
            | (exp.exit_cfd != exp.full_cfd)).any()


def test_control_fails_the_check():
    """The reference with bfloat16 terms in the program's place reads past
    the configurations' score limit; the f64 reference reads 0."""
    import json

    from gpu_bench.spec import bench_dir
    from conftest import ROOT

    limit = json.loads((bench_dir(ROOT) / "configs" / "fly-dm6.json")
                       .read_text())["limits"]["score_gap"]
    codes = torch.from_numpy(repeat_rich(seed=8))
    sites = offtarget.site_table(codes)
    q = torch.unique(candidate_guides(codes)).numpy().view(np.uint64)[:500]
    kw = dict(max_dist=4, threshold=75.0, method="and", block_elems=1 << 22)
    exp = offtarget.expected_scores(q, sites, **kw)
    ctl = offtarget.expected_scores(q, sites, terms_dtype=torch.bfloat16,
                                    **kw)
    pos = np.arange(q.shape[0])
    same = check.compare(pos, exp.full_mit, exp.full_cfd, pos, exp, 75.0,
                         "and")
    bad = check.compare(pos, ctl.full_mit, ctl.full_cfd, pos, exp, 75.0,
                        "and")
    assert same == {"missing": 0, "verdict_mismatches": 0, "score_gap": 0.0}
    assert bad["score_gap"] > limit
