"""The packed compact finder kernel's arithmetic, emulated on the CPU.

``csrc/compact_finder.cu`` takes every (slot, entry) pair's distance from
an int8 tensor-core product of one-hot entry rows, built in registers from
the packed words, by the slots' weight columns, then re-tests the pairs
within ``max_dist`` from their packed words. ``ops/compact_finder.py``
builds the same operands in plain PyTorch (``mma_rows``, ``mma_columns``,
``mma_candidates``); these tests hold them to the distance of the plain
finder (``popcount(collapse_pairs(xor))``), to the one-hot planes (which
``test_torch_onehot.py`` holds to JAX's ``_onehot_rows``), and, run as the
kernel runs them, to the plain finder's cells. Inputs are made with numpy
from a seed. Everything is integer arithmetic: all checks are exact.
"""

import numpy as np
import pytest
import torch

from crackling_tpu_torch.ops.bits import (SIG40, collapse_pairs,
                                          earlier_slice_clean, popcount)
from crackling_tpu_torch.ops.compact_finder import (MMA_K, ChunkMoments,
                                                    compact_finder_plain,
                                                    mma_candidates,
                                                    mma_columns,
                                                    mma_lane_bases_positions,
                                                    mma_rows, mma_word)
from crackling_tpu_torch.ops.compact_onehot import onehot_planes
from test_compact import data, deep_data  # noqa: F401
from test_torch_compact import port_index
from test_torch_onehot import _finder_inputs


@pytest.fixture(scope="module")
def datasets(data, deep_data):  # noqa: F811
    return {"data": data, "deep": deep_data}


def _sigs(rng, n):
    return torch.as_tensor(rng.integers(0, 1 << 40, size=n).astype(np.int64))


def _in_bucket(sigs, s, b):
    """The signatures with slice ``s``'s byte set to ``b``: members of
    bucket ``b`` of slice ``s``."""
    return (sigs & ~(0xFF << (8 * s))) | (b << (8 * s))


def _distance(e, q):
    """(n,) x (m,) -> (n, m) mismatched positions of every pair: the plain
    finder's popcount of the collapsed XOR."""
    return popcount(collapse_pairs((e[:, None] ^ q[None, :]) & SIG40))


def _product(e, q, s):
    cols = mma_columns(q, s, torch.ones(q.numel(), dtype=torch.bool))
    return mma_rows(e, s).long() @ cols.long()


@pytest.mark.parametrize("s", range(5))
def test_mma_rows_match_onehot_planes(s):
    rng = np.random.default_rng(40 + s)
    sigs = _sigs(rng, 300)
    sigs[:5] = 0                                  # padding rows: base A
    rows = mma_rows(sigs, s)
    assert rows.dtype == torch.int8 and rows.shape == (300, MMA_K)
    base, pos = mma_lane_bases_positions()
    p = pos + 4 * (pos >= 4 * s)                  # skip slice s's positions
    planes = onehot_planes(sigs[None], 20)[0]
    assert torch.equal(rows, planes[:, 4 * p + base])
    # every (position outside slice s, base) lane exactly once
    assert sorted((4 * p + base).tolist()) == sorted(
        k for k in range(80) if not 16 * s <= k < 16 * s + 16)


@pytest.mark.parametrize("s", range(5))
@pytest.mark.parametrize("case", ["random", "bucket", "high-byte", "zero"])
def test_mma_product_is_distance(case, s):
    """The product counts the mismatches at the 16 positions outside slice
    ``s``: the whole distance of every pair that shares slice ``s`` (every
    pair of a bucket), never more than it for any pair (so no hit is
    lost)."""
    rng = np.random.default_rng(7 + s)
    q = _sigs(rng, 24)
    own = None                  # (entry, its query) pairs of the case
    if case == "random":
        e = _sigs(rng, 200)
    elif case == "bucket":
        b = int(rng.integers(0, 256))
        q, e = _in_bucket(q, s, b), _in_bucket(_sigs(rng, 200), s, b)
    elif case == "high-byte":   # copies of the queries that differ in bits
        e = q.repeat(8)          # 32..39 only (positions 16..19)
        e = e ^ (torch.as_tensor(rng.integers(1, 256, size=e.numel()))
                 << 32)
        own = (torch.arange(e.numel()), torch.arange(e.numel()) % q.numel())
    else:                       # the queries themselves: distance 0
        e = q.clone()
        own = (torch.arange(q.numel()), torch.arange(q.numel()))
    got = _product(e, q, s)
    full = _distance(e, q)
    slice_bits = 0xFF << (8 * s)
    assert torch.equal(got, _distance(e & ~slice_bits, q & ~slice_bits))
    assert bool((got <= full).all())
    same = ((e[:, None] ^ q[None, :]) & slice_bits) == 0
    assert torch.equal(got[same], full[same])
    if case == "bucket":
        assert bool(same.all())
    if own is not None:
        d = got[own]
        if case == "high-byte":
            assert bool((full[own] >= 1).all())
            # slice 4 is the high byte: a copy outside slice 4 is its query
            assert torch.equal(d, torch.zeros_like(d) if s == 4
                               else full[own])
        else:
            assert bool((d == 0).all())


@pytest.mark.parametrize("max_dist", [0, 4, 20])
def test_padding_slots_and_tail_rows_never_hit(max_dist):
    rng = np.random.default_rng(3)
    s, b, blen = 1, 0x3C, 40
    live_e = _in_bucket(_sigs(rng, blen), s, b)
    e = torch.cat([live_e, torch.zeros(24, dtype=torch.int64)])  # tail: 0
    q = _in_bucket(_sigs(rng, 16), s, b)
    q[0] = _in_bucket(torch.zeros(1, dtype=torch.int64), s, b)[0]  # poly-A
    q[1] = e[3]                                                 # self hit
    live = torch.ones(16, dtype=torch.bool)
    live[[5, 9, 15]] = False
    cols = mma_columns(q, s, live)
    assert bool((cols[:, ~live] == 2).all())
    prod = mma_rows(e, s).int() @ cols.int()
    assert bool((prod[:, ~live] >= 32).all())   # never within max_dist
    # the zero tail rows lie within max_dist of the poly-A slot (distance
    # 0 there when slice s's byte is cut); only the rank mask drops them
    assert int(prod[blen:, 0].max()) == 0
    # the kernel's columns start every sum at -(max_dist + 1)
    biased = mma_columns(q, s, live, max_dist)
    assert torch.equal(mma_rows(e, s).int() @ biased.int(),
                       prod - max_dist - 1)
    cand = mma_candidates(mma_rows(e, s), biased, torch.arange(e.numel()),
                          blen)
    assert not bool(cand[blen:].any()) and not bool(cand[:, ~live].any())
    # and every pair within max_dist of a live slot and a live row is one
    within = _distance(live_e, q) <= max_dist
    assert torch.equal(cand[:blen][:, live], within[:, live])
    assert bool(cand[3, 1])


def _kernel_emulation(entries, boff, blen, q_sig, qsp, *, chunk, nchmax,
                      superchunk, max_dist):
    """The kernel's algorithm in plain PyTorch: per (slice, bucket) with a
    live slot, the bucket's rows (in whole 64-entry batches, 0 past its
    end, as the kernel loads them) times every slot's column, screened by
    the epilogue, then the exact test of the candidates from their packed
    words, folded into chunk quads."""
    S, B, qb = qsp.shape
    n = q_sig.numel()
    acc = ChunkMoments(qsp.shape, chunk, nchmax, entries.device)
    for s in range(S):
        for b in range(B):
            ids = qsp[s, b].long()
            live = (ids >= 0) & (ids < n)
            length, o = int(blen[s, b]), int(boff[s, b])
            if length == 0 or not bool(live.any()):
                continue
            e = torch.zeros(-(-length // 64) * 64, dtype=torch.int64)
            e[:length] = entries[s, o:o + length]
            q = q_sig[ids.clamp(0, n - 1)]
            cand = mma_candidates(mma_rows(e, s),
                                  mma_columns(q, s, live, max_dist),
                                  torch.arange(e.numel()), length)
            r, j = torch.nonzero(cand, as_tuple=True)
            c40 = collapse_pairs((e[r] ^ q[j]) & SIG40)
            hit = (popcount(c40) <= max_dist) & ~earlier_slice_clean(c40, s)
            acc.add((s * B + b) * qb + j[hit], r[hit])
    return acc.finder_out(superchunk)


@pytest.mark.parametrize("name,superchunk,qb", [("data", 0, 64),
                                                ("data", 0, 21),
                                                ("deep", 2, 21),
                                                ("deep", 0, 64)])
@pytest.mark.parametrize("max_dist", [0, 2, 4])
def test_kernel_emulation_matches_plain_finder(datasets, name, superchunk,
                                               qb, max_dist):
    index, queries = datasets[name]
    chunk = 1024
    args, nchmax = _finder_inputs(port_index(index), queries, chunk, qb)
    kw = dict(chunk=chunk, nchmax=nchmax, superchunk=superchunk,
              max_dist=max_dist)
    got = _kernel_emulation(*args, **kw)
    want = compact_finder_plain(*args, **kw)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert int(want.cnt[:, :, -1].sum()) > 0


def test_mma_word_cuts_the_slice_byte():
    sig = torch.tensor([0xAB_1234_5678], dtype=torch.int64)
    assert [int(mma_word(sig, s)) for s in range(5)] == [
        0xAB123456, 0xAB123478, 0xAB125678, 0xAB345678, 0x12345678]
