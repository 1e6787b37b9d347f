"""The full-scan kernels' arithmetic, emulated on the CPU.

``csrc/fullscan.cu`` screens every (query, entry) pair by an int8
tensor-core product of one-hot entry rows, built in registers from the
packed words, by the queries' weight columns: K = 64 (the 16 positions
outside the bucket's slice) at slice width 8, K = 96 (all 20 positions) at
the bucket scan's other widths. Candidates (products below 0 after the
bias) are re-tested from their packed words, and only hits are scored.
``ops/fullscan.py`` builds the same operands in plain PyTorch
(``scan_rows``, ``scan_columns``); these tests hold them to the plain
versions' distance (``popcount(collapse_pairs(xor))``) at every slice and
width, and to the one-hot planes, and check that padding columns and the
zero rows past a bucket never pass the screen. :func:`emulate_dense_scan`
and :func:`emulate_bucket_scan` run the kernels' flow (screen, exact
re-test, ``pair_scores`` terms, f64 sums) in plain PyTorch, with the
wrappers' signatures; ``test_torch_dense.py`` and ``test_torch_scan.py``
hold them to the plain versions (rtol 1e-12: only the order of the f64
sums differs) and, run inside the engines, to the JAX engines. Inputs are
made with numpy from a seed; everything here is integer arithmetic, so
every check in this file is exact.
"""

import numpy as np
import pytest
import torch

from crackling_tpu_torch.ops.bits import (SIG40, collapse_pairs,
                                          earlier_slice_clean,
                                          earlier_slice_clean_raw, popcount)
from crackling_tpu_torch.ops.compact_finder import (MMA_K, mma_candidates,
                                                    mma_lane_bases_positions)
from crackling_tpu_torch.ops.compact_onehot import onehot_planes
from crackling_tpu_torch.ops.fullscan import (ALL_K, scan_columns, scan_k,
                                              scan_rows)
from crackling_tpu_torch.ops.compact_rescan import pair_scores

# (width, slice) of every slice the bucket scan takes at 40-bit signatures
# (S * width <= 40; at w = 16 the two slices cover positions 0-15)
WIDTH_SLICES = [(w, s) for w in (2, 4, 8, 16) for s in range(40 // w)]


def _sigs(rng, n):
    return torch.as_tensor(rng.integers(0, 1 << 40, size=n).astype(np.int64))


def _in_bucket(sigs, s, b, width):
    """The signatures with slice ``s``'s bits set to ``b``: members of
    bucket ``b`` of slice ``s`` at slice width ``width``."""
    mask = ((1 << width) - 1) << (width * s)
    return (sigs & ~mask) | (b << (width * s))


def _distance(e, q):
    """(n,) x (m,) -> (n, m) mismatched positions of every pair."""
    return popcount(collapse_pairs((e[:, None] ^ q[None, :]) & SIG40))


def test_all_position_rows_match_onehot_planes():
    rng = np.random.default_rng(50)
    sigs = _sigs(rng, 300)
    sigs[:5] = 0                                  # rows past a bucket
    rows = scan_rows(sigs, 1, 4)
    assert rows.dtype == torch.int8 and rows.shape == (300, ALL_K)
    planes = onehot_planes(sigs[None], 20)[0]     # lane 4p + base
    base, pos = mma_lane_bases_positions()        # the low word's 16
    assert torch.equal(rows[:, :MMA_K], planes[:, 4 * pos + base])
    assert torch.equal(rows[:, MMA_K:80], planes[:, 64:80])
    assert not bool(rows[:, 80:].any())
    assert bool((rows.sum(1) == 20).all())       # one base per position


@pytest.mark.parametrize("width,s", WIDTH_SLICES)
def test_scan_product_is_distance(width, s):
    """Within a bucket the product is the whole distance at every width
    (K = 96: every pair; K = 64: the slice's own positions always match),
    and never more than it for any pair, so no hit is lost."""
    rng = np.random.default_rng(100 * width + s)
    b = int(rng.integers(0, 1 << width))
    q = _in_bucket(_sigs(rng, 24), s, b, width)
    near = q[8:16] ^ (torch.as_tensor(rng.integers(1, 256, 8)) << 32)
    e = torch.cat([_in_bucket(_sigs(rng, 150), s, b, width),
                   q[:8],                                     # distance 0
                   _in_bucket(near, s, b, width)])            # 16..19 only
    live = torch.ones(q.numel(), dtype=torch.bool)
    rows, cols = scan_rows(e, s, width), scan_columns(q, s, width, live)
    assert rows.shape[1] == cols.shape[0] == scan_k(width)
    got = rows.long() @ cols.long()
    assert torch.equal(got, _distance(e, q))
    # any pair, bucket or not: never more than the distance
    other = _sigs(rng, 64)
    assert bool((scan_rows(other, s, width).long() @ cols.long()
                 <= _distance(other, q)).all())


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("max_dist", [0, 4, 20])
def test_padding_columns_and_tail_rows_never_pass(width, max_dist):
    rng = np.random.default_rng(3 + width)
    s, blen = 1, 40
    b = 0x3C & ((1 << width) - 1)
    live_e = _in_bucket(_sigs(rng, blen), s, b, width)
    e = torch.cat([live_e, torch.zeros(24, dtype=torch.int64)])  # tail: 0
    q = _in_bucket(_sigs(rng, 16), s, b, width)
    q[0] = _in_bucket(torch.zeros(1, dtype=torch.int64), s, b, width)[0]
    q[1] = e[3]                                                 # self hit
    live = torch.ones(16, dtype=torch.bool)
    live[[5, 9, 15]] = False
    rows = scan_rows(e, s, width)
    cols = scan_columns(q, s, width, live)
    assert bool((cols[:80, ~live] == 2).all())
    prod = rows.int() @ cols.int()
    assert bool((prod[:, ~live] >= 32).all())   # never within max_dist
    # the zero tail rows lie near the query whose other positions are all
    # A (distance 0 outside slice 1 at w = 8; at w = 4 the one C of the
    # bucket value 0xC): only the rank test drops them
    assert bool((prod[blen:, 0] == (0 if width == 8 else 1)).all())
    biased = scan_columns(q, s, width, live, max_dist)
    assert torch.equal(rows.int() @ biased.int(), prod - max_dist - 1)
    cand = mma_candidates(rows, biased, torch.arange(e.numel()), blen)
    assert not bool(cand[blen:].any()) and not bool(cand[:, ~live].any())
    within = _distance(live_e, q) <= max_dist
    assert torch.equal(cand[:blen][:, live], within[:, live])
    assert bool(cand[3, 1])


# -- the kernels' flow, emulated ------------------------------------------


def _bucket_sums(entries, occ, boff, blen, s, b, q, live, *, width,
                 slices, max_dist, tabs):
    """One (slice, bucket) against query columns ``q`` (m,) of liveness
    ``live``, as the kernel runs it: the bucket's rows (in whole 64-entry
    batches, 0 past its end) times the columns, screened by the epilogue
    (negative biased sum, rank below the length, a live column), the exact
    test of the candidates from their packed words (w = 8 and ``slices``
    None: the dense scan's byte dedup; else the raw dedup at ``width``),
    then ``occ x`` the f32 terms of each hit into f64 sums. Returns (mit,
    cfd), (m,) f64."""
    mit = torch.zeros(q.numel(), dtype=torch.float64)
    cfd = torch.zeros(q.numel(), dtype=torch.float64)
    length, o = int(blen[s, b]), int(boff[s, b])
    if length == 0 or not bool(live.any()):
        return mit, cfd
    e = torch.zeros(-(-length // 64) * 64, dtype=torch.int64)
    e[:length] = entries[s, o:o + length]
    cand = mma_candidates(scan_rows(e, s, width),
                          scan_columns(q, s, width, live, max_dist),
                          torch.arange(e.numel()), length) & live[None, :]
    r, j = torch.nonzero(cand, as_tuple=True)
    x = (e[r] ^ q[j]) & SIG40
    c40 = collapse_pairs(x)
    seen = (earlier_slice_clean(c40, s) if slices is None
            else earlier_slice_clean_raw(x, s, width, slices))
    hit = (popcount(c40) <= max_dist) & ~seen
    r, j = r[hit], j[hit]
    _, tm, tc = pair_scores(q[j], e[r][:, None], tabs)
    w = occ[s, o + r].double()
    mit.index_add_(0, j, tm[:, 0].double() * w)
    cfd.index_add_(0, j, tc[:, 0].double() * w)
    return mit, cfd


def emulate_dense_scan(entries, occ, boff, blen, q_sig, qsp, *, max_dist,
                       tabs):
    """``fullscan.dense_scan``'s kernel flow in plain PyTorch (same
    arguments and result)."""
    S, B, qb = qsp.shape
    n = q_sig.numel()
    mit = torch.zeros((S, B, qb), dtype=torch.float64)
    cfd = torch.zeros((S, B, qb), dtype=torch.float64)
    for s, b in torch.nonzero(((qsp >= 0) & (qsp < n)).any(-1)).tolist():
        ids = qsp[s, b].long()
        live = (ids >= 0) & (ids < n)
        mit[s, b], cfd[s, b] = _bucket_sums(
            entries, occ, boff, blen, s, b, q_sig[ids.clamp(0, n - 1)],
            live, width=8, slices=None, max_dist=max_dist, tabs=tabs)
    return mit, cfd


def emulate_bucket_scan(entries, occ, boff, blen, q_sig, qoff, qsorted, *,
                        slice_width, max_dist, tabs):
    """``fullscan.bucket_scan``'s kernel flow in plain PyTorch (same
    arguments and result)."""
    S, n = qsorted.shape
    mit = torch.zeros((S, n), dtype=torch.float64)
    cfd = torch.zeros((S, n), dtype=torch.float64)
    for s, b in torch.nonzero(qoff[:, 1:] > qoff[:, :-1]).tolist():
        q0, q1 = int(qoff[s, b]), int(qoff[s, b + 1])
        q = q_sig[qsorted[s, q0:q1].long()]
        mit[s, q0:q1], cfd[s, q0:q1] = _bucket_sums(
            entries, occ, boff, blen, s, b, q,
            torch.ones(q.numel(), dtype=torch.bool), width=slice_width,
            slices=S, max_dist=max_dist, tabs=tabs)
    return mit, cfd
