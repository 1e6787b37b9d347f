"""The PyTorch one-hot compact finder against the JAX engine and the oracles.

The port's one-hot planes, its plain one-hot finder and its compact
scorer with ``onehot=True`` run on the CPU; the JAX package's one-hot
finder runs its Pallas kernel in interpret mode, as its own tests do.
The kernel's arithmetic (``csrc/compact_onehot.cu``: the four 16-byte
pieces of a row outside the bucket's slice times biased int8 weight
columns, K = 64, and the exact re-test of each candidate from its row) is
emulated with ``ops/compact_onehot.py``'s ``screen_rows``,
``screen_columns``, ``row_masks`` and ``emulate_compact_onehot``, held to
the packed kernel's operands, the distance and the plain finders.
Inputs are ``tests/test_compact.py``'s datasets (numpy, from a seed).
Tolerances: planes and finder cells exact (integers); compaction
populations exact, the six the JAX engine's tuples open with; sums within
rtol 1e-5 / atol 1e-5 (f32 per-hit arithmetic summed in different orders),
as in test_torch_compact.py.
"""

import numpy as np
import pytest
import torch

from crackling_tpu.ops.issl_compact import CompactIsslScorer as JaxCompact
from crackling_tpu.ops.issl_mxu import _onehot_rows
from crackling_tpu.ops.oracle import score_bruteforce
from crackling_tpu_torch.ops.bits import (SIG40, collapse_pairs,
                                          compress_even_bits, popcount)
from crackling_tpu_torch.ops.compact_finder import (compact_finder_plain,
                                                    mma_columns, mma_rows)
from crackling_tpu_torch.ops.compact_onehot import (LANES, SCREEN_K,
                                                    compact_finder_onehot,
                                                    compact_finder_onehot_plain,
                                                    emulate_compact_onehot,
                                                    onehot_planes, row_masks,
                                                    screen_columns,
                                                    screen_rows)
from crackling_tpu_torch.ops.issl_compact import ALIGN, CompactIsslScorer
from test_compact import data, deep_data  # noqa: F401
from test_torch_compact import (JAX_CASES, _assert_sums, _numpy_finder,
                                _numpy_slot_plan, port_index)
from test_torch_pipeline import _config, _rows
from test_pipeline import mini_world  # noqa: F401  (shared fixture)


@pytest.fixture(scope="module")
def datasets(data, deep_data):  # noqa: F811
    return {"data": data, "deep": deep_data}


@pytest.mark.parametrize("seq_length", [20, 16])
def test_onehot_planes_match_jax(seq_length):
    rng = np.random.default_rng(5)
    sigs = rng.integers(0, 1 << 40, size=(3, 257)).astype(np.uint64)
    sigs[:, :7] = 0                          # padding rows: base A
    got = onehot_planes(torch.as_tensor(sigs.view(np.int64)), seq_length)
    assert got.dtype == torch.int8 and got.shape == (3, 257, LANES)
    for s in range(3):
        lo = (sigs[s] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (sigs[s] >> np.uint64(32)).astype(np.uint32)
        want = np.asarray(_onehot_rows(lo, hi, seq_length=seq_length))
        np.testing.assert_array_equal(got[s].numpy(), want[:, :LANES])
        assert not want[:, LANES:].any()


def _finder_inputs(index, queries, chunk, qb=64):
    S, B = index.slice_count, index.bucket_count
    arrs = index.device_arrays_aligned(align=ALIGN, tail=chunk)
    nchmax = max(1, -(-int(arrs["bucket_lens"].max()) // chunk))
    lo = arrs["list_lo"].view(np.uint32).astype(np.uint64)
    hi = arrs["list_hi"].view(np.uint32).astype(np.uint64)
    entries = torch.as_tensor((lo | (hi << np.uint64(32))).view(np.int64))
    qsp = torch.as_tensor(_numpy_slot_plan(queries, S, B, qb)).int()
    return (entries, torch.as_tensor(arrs["bucket_offsets"][:, :B]
                                     .astype(np.int64)),
            torch.as_tensor(arrs["bucket_lens"]),
            torch.as_tensor(queries.view(np.int64)), qsp), nchmax


@pytest.mark.parametrize("name,superchunk", [("data", 0), ("deep", 0),
                                             ("deep", 2)])
def test_plain_onehot_finder_vs_numpy(datasets, name, superchunk):
    index, queries = datasets[name]
    pidx = port_index(index)
    chunk = 1024
    (entries, boff, blen, q_sig, qsp), nchmax = _finder_inputs(
        pidx, queries, chunk)
    planes = onehot_planes(entries, pidx.seq_length)
    kw = dict(chunk=chunk, nchmax=nchmax, superchunk=superchunk, max_dist=4)
    before = compact_finder_onehot_plain.calls
    fo = compact_finder_onehot(planes, boff, blen, q_sig, qsp, **kw)
    assert compact_finder_onehot_plain.calls == before + 1
    packed = compact_finder_plain(entries, boff, blen, q_sig, qsp, **kw)
    want = _numpy_finder(pidx, queries, qsp.long().numpy(), chunk, nchmax,
                         superchunk, 4)
    for got, exp, other in zip(fo[:4], want, packed[:4]):
        np.testing.assert_array_equal(got.numpy(), exp)
        assert torch.equal(got, other)
    assert (fo.nchmax, fo.nsc) == (packed.nchmax, packed.nsc)
    assert int(fo.cnt.sum()) > 0


def test_onehot_finder_refuses_bad_planes(datasets):
    index, queries = datasets["data"]
    (entries, boff, blen, q_sig, qsp), nchmax = _finder_inputs(
        port_index(index), queries, 1024)
    kw = dict(chunk=1024, nchmax=nchmax, superchunk=0, max_dist=4)
    with pytest.raises(ValueError, match="planes must be a 3-d"):
        compact_finder_onehot(entries, boff, blen, q_sig, qsp, **kw)
    wide = torch.zeros(entries.shape + (128,), dtype=torch.int8)
    with pytest.raises(ValueError, match="80 lanes"):
        compact_finder_onehot(wide, boff, blen, q_sig, qsp, **kw)


# -- the kernel's arithmetic, emulated ---------------------------------------


@pytest.mark.parametrize("seq_length,s", [(20, s) for s in range(5)]
                         + [(16, s) for s in range(4)])
def test_screen_operands_cut_from_planes(seq_length, s):
    """The four pieces of a plane row outside slice ``s`` times the screen
    columns give the packed kernel's product (the distance outside slice
    ``s`` over the planes' positions); biased, that less ``max_dist + 1``
    for a live slot; a padding slot's sum and an all-zero row's are never
    negative; and the row masks are the plain finder's 20-bit masks."""
    rng = np.random.default_rng(7 * s + seq_length)
    sig_mask = (1 << (2 * seq_length)) - 1
    b = int(rng.integers(0, 256))
    e = torch.as_tensor(rng.integers(0, 1 << 40, 200).astype(np.int64))
    q = torch.as_tensor(rng.integers(0, 1 << 40, 24).astype(np.int64))
    e[:8] = q[:8] ^ (1 << (2 * torch.as_tensor(rng.integers(0, 20, 8))))
    e, q = ((x & ~(0xFF << (8 * s))) | (b << (8 * s)) for x in (e, q))
    e = e & sig_mask
    rows = onehot_planes(e[None], seq_length)[0]
    live = torch.ones(24, dtype=torch.bool)
    live[[2, 17]] = False
    a = screen_rows(rows, s)
    assert a.dtype == torch.int8 and a.shape == (200, SCREEN_K)
    prod = a.long() @ screen_columns(q, s, live).long()
    packed = mma_rows(e, s).long() @ mma_columns(q & sig_mask, s,
                                                 live).long()
    assert torch.equal(prod[:, live], packed[:, live])
    dist = popcount(collapse_pairs((e[:, None] ^ q[None, :]) & sig_mask))
    assert torch.equal(prod[:, live], dist[:, live])
    for max_dist in (0, 2, 4):
        cols = screen_columns(q, s, live, max_dist)
        biased = a.long() @ cols.long()
        assert torch.equal(biased[:, live], dist[:, live] - max_dist - 1)
        assert bool((biased[:, ~live] > 0).all())
        zero = torch.zeros((1, SCREEN_K), dtype=torch.long)
        assert bool(((zero @ cols.long()) == 0).all())
    r = torch.arange(200).repeat_interleave(24)
    j = torch.arange(24).repeat(200)
    want = compress_even_bits(collapse_pairs((e[r] ^ q[j]) & SIG40
                                             & sig_mask))
    assert torch.equal(row_masks(rows[r], q[j]), want)


@pytest.mark.parametrize("name,superchunk,qb", [("data", 0, 64),
                                                ("data", 0, 21),
                                                ("deep", 2, 21),
                                                ("deep", 0, 64)])
@pytest.mark.parametrize("max_dist", [0, 2, 4])
def test_emulated_onehot_finder_matches_plain(datasets, name, superchunk,
                                              qb, max_dist):
    """The kernel's flow equals the plain one-hot finder and the plain
    packed finder in every cell (max-distance 0, 2, 4; a ragged qb; the
    superchunk on and off)."""
    index, queries = datasets[name]
    pidx = port_index(index)
    (entries, boff, blen, q_sig, qsp), nchmax = _finder_inputs(
        pidx, queries, 1024, qb)
    planes = onehot_planes(entries, pidx.seq_length)
    kw = dict(chunk=1024, nchmax=nchmax, superchunk=superchunk,
              max_dist=max_dist)
    got = emulate_compact_onehot(planes, boff, blen, q_sig, qsp, **kw)
    plain = compact_finder_onehot_plain(planes, boff, blen, q_sig, qsp, **kw)
    packed = compact_finder_plain(entries, boff, blen, q_sig, qsp, **kw)
    for a, b, c in zip(got[:4], plain[:4], packed[:4]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(plain.cnt[:, :, -1].sum()) > 0


# -- the scorer against the JAX engine's one-hot finder ---------------------


@pytest.fixture(scope="module")
def jax_onehot_runs(datasets):
    out = {}
    for case, (name, kw) in JAX_CASES.items():
        index, queries = datasets[name]
        sc = JaxCompact(index, max_dist=4, onehot=True, interpret=True, **kw)
        assert sc.onehot
        out[case] = (sc.score_sums(queries), sc.page_stats)
    return out


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_onehot_scorer_matches_jax(datasets, jax_onehot_runs, case):
    name, kw = JAX_CASES[case]
    index, queries = datasets[name]
    sc = CompactIsslScorer(port_index(index), max_dist=4, device="cpu",
                           onehot=True, **kw)
    assert sc.onehot and sc.planes.shape == sc.entries.shape + (LANES,)
    before = compact_finder_onehot_plain.calls
    sums = sc.score_sums(queries)
    assert compact_finder_onehot_plain.calls > before
    jax_sums, jax_stats = jax_onehot_runs[case]
    assert sc.page_stats == [p[:6] for p in jax_stats]
    _assert_sums(sums, jax_sums)
    _assert_sums(sums, score_bruteforce(queries, index.site_sigs,
                                        index.occurrences, 4))


# -- the choice of finder: the variable, the budget, the memory -------------


@pytest.mark.parametrize("case", ["unset", "variable", "over-budget",
                                  "variable-no-memory", "explicit-off"])
def test_onehot_choice(datasets, monkeypatch, capsys, case):
    import crackling_tpu_torch.ops.issl_compact as port_compact

    index, _ = datasets["data"]
    pidx = port_index(index)
    monkeypatch.delenv("CRACKLING_TPU_COMPACT_ONEHOT", raising=False)
    monkeypatch.delenv("CRACKLING_TPU_COMPACT_PLANE_BUDGET", raising=False)
    kw = {}
    if case != "unset":
        monkeypatch.setenv("CRACKLING_TPU_COMPACT_ONEHOT", "1")
    probe = CompactIsslScorer(pidx, max_dist=4, chunk=1024, device="cpu",
                              onehot=False)
    jax_bytes = probe.S * probe.entries.shape[1] * 128
    if case == "over-budget":
        monkeypatch.setenv("CRACKLING_TPU_COMPACT_PLANE_BUDGET",
                           str(jax_bytes - 1))
    elif case == "variable-no-memory":
        # room for the lists and a page, not for the port's planes
        planes = probe.S * probe.entries.shape[1] * LANES
        monkeypatch.setattr(port_compact, "free_bytes",
                            lambda device: planes - 1)
    elif case == "explicit-off":
        kw = dict(onehot=False)
    capsys.readouterr()
    sc = CompactIsslScorer(pidx, max_dist=4, chunk=1024, device="cpu", **kw)
    out = capsys.readouterr().out
    assert sc.onehot == (case == "variable")
    assert (sc.planes is not None) == sc.onehot
    logged = "using the packed compact finder" in out
    assert logged == (case in ("over-budget", "variable-no-memory"))
    if case == "over-budget":
        assert "CRACKLING_TPU_COMPACT_PLANE_BUDGET" in out
        # the same index and budget keep JAX's packed finder too
        monkeypatch.setenv("CRACKLING_TPU_COMPACT_PLANE_BUDGET",
                           str(jax_bytes - 1))
        assert not JaxCompact(index, max_dist=4, chunk=1024,
                              interpret=True).onehot
        monkeypatch.setenv("CRACKLING_TPU_COMPACT_PLANE_BUDGET",
                           str(jax_bytes))
        assert JaxCompact(index, max_dist=4, chunk=1024,
                          interpret=True).onehot
        assert CompactIsslScorer(pidx, max_dist=4, chunk=1024,
                                 device="cpu").onehot


def test_explicit_onehot_over_free_memory_raises(datasets, monkeypatch):
    import crackling_tpu_torch.ops.issl_compact as port_compact

    index, _ = datasets["data"]
    pidx = port_index(index)
    probe = CompactIsslScorer(pidx, max_dist=4, chunk=1024, device="cpu",
                              onehot=False)
    # room for the lists and a page, not for the port's planes
    planes = probe.S * probe.entries.shape[1] * LANES
    monkeypatch.setattr(port_compact, "free_bytes",
                        lambda device: planes - 1)
    with pytest.raises(ValueError, match="one-hot planes need"):
        CompactIsslScorer(pidx, max_dist=4, chunk=1024, device="cpu",
                          onehot=True)


# -- Crackling with the variable set -----------------------------------------


def _crackling(mini_world, outdir, monkeypatch, onehot):  # noqa: F811
    """``Crackling`` with ``engine = compact`` through its CLI entry point
    on the CPU; returns the CSV rows and the calls of each plain finder."""
    from crackling_tpu_torch.utils import cli

    monkeypatch.setenv("CRACKLING_PLATFORM", "cpu")
    if onehot:
        monkeypatch.setenv("CRACKLING_TPU_COMPACT_ONEHOT", "1")
    else:
        monkeypatch.delenv("CRACKLING_TPU_COMPACT_ONEHOT", raising=False)
    cfg = _config(mini_world, outdir, "compact")
    compact_finder_plain.calls = compact_finder_onehot_plain.calls = 0
    cli.main_crackling(["-c", str(cfg)])
    calls = (compact_finder_plain.calls, compact_finder_onehot_plain.calls)
    return _rows(outdir / "mini-guides.txt"), calls


def test_crackling_onehot_variable_same_csv(mini_world, tmp_path,  # noqa: F811
                                            monkeypatch):
    packed, calls = _crackling(mini_world, tmp_path / "packed", monkeypatch,
                               False)
    assert calls[0] > 0 and calls[1] == 0
    onehot, calls = _crackling(mini_world, tmp_path / "onehot", monkeypatch,
                               True)
    assert calls[0] == 0 and calls[1] > 0
    assert len(packed) > 50
    assert onehot == packed
