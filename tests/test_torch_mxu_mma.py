"""The neighbour finder kernel's arithmetic, emulated on the CPU.

``csrc/mxu_finder.cu`` screens every (slot, entry) pair by the full-scan
kernels' int8 tensor-core product of one-hot entry rows, built in
registers from the packed words, by the slots' weight columns, after
cutting both signatures to their 2L bits: K = 64 (the 16 positions
outside the bucket's slice) at slice width 8, K = 96 (all 20 positions)
at the others. A negative sum is a candidate, kept iff its distance from
the packed words lies in 1..max_dist. ``ops/fullscan.py`` builds the same
operands in plain PyTorch (``scan_rows``, ``scan_columns``);
``ops/mxu_finder.emulate_mxu_finder`` runs the kernel's flow with them.
These tests hold the biased product to the distance less ``max_dist + 1``
at widths 8 and 4 and at seq_length 20 and 16, and the emulated finder to
the plain one (``test_torch_mxu.py`` holds it to the JAX kernel). Inputs
are made with numpy from a seed; everything is integer arithmetic, so
every check is exact.
"""

import numpy as np
import pytest
import torch

from crackling_tpu_torch.index.build import IsslIndex
from crackling_tpu_torch.ops.bits import collapse_pairs, popcount
from crackling_tpu_torch.ops.fullscan import scan_columns, scan_k, scan_rows
from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer
from crackling_tpu_torch.ops.mxu_finder import (emulate_mxu_finder,
                                                mxu_finder_plain,
                                                screen_width,
                                                signature_mask)
from test_mxu import data  # noqa: F401  (shared fixture)
from test_torch_compact import port_index


def _sigs(rng, n):
    return torch.as_tensor(rng.integers(0, 1 << 40, size=n).astype(np.int64))


def _in_bucket(sigs, s, b, width):
    mask = ((1 << width) - 1) << (width * s)
    return (sigs & ~mask) | (b << (width * s))


@pytest.mark.parametrize("width,seq_length", [(8, 20), (8, 16), (4, 20),
                                              (4, 16)])
def test_biased_product_is_distance_less_bound(width, seq_length):
    """In every slice's bucket the rows times the biased columns are the
    distance over the 2L bits less ``max_dist + 1`` for a live slot, and
    a padding slot's sum is never negative."""
    rng = np.random.default_rng(10 * width + seq_length)
    mask = signature_mask(seq_length)
    assert screen_width(1 << width) == width
    for s in range(2 * seq_length // width):
        b = int(rng.integers(0, 1 << width))
        q = _in_bucket(_sigs(rng, 16), s, b, width) & mask
        e = _in_bucket(torch.cat([
            _sigs(rng, 100),
            q[:6] ^ (1 << (2 * int(rng.integers(0, 20)))),  # near
            q[6:10]]), s, b, width) & mask                  # self
        live = torch.ones(16, dtype=torch.bool)
        live[[3, 11]] = False
        for max_dist in (0, 2, 4):
            rows = scan_rows(e, s, width)
            cols = scan_columns(q, s, width, live, max_dist)
            assert rows.shape[1] == cols.shape[0] == scan_k(width)
            prod = rows.long() @ cols.long()
            dist = popcount(collapse_pairs(e[:, None] ^ q[None, :]))
            assert torch.equal(prod[:, live], dist[:, live] - max_dist - 1)
            assert bool((prod[:, ~live] > 0).all())


def _engine(index, segw, width=8, seq_length=20):
    """The MXU engine's lists over ``index`` cut to ``seq_length`` and
    sliced at ``width`` (segments of ``segw`` entries)."""
    mask = np.uint64(signature_mask(seq_length))
    other = IsslIndex(seq_length=seq_length, slice_width=width,
                      seq_count=index.seq_count,
                      site_sigs=index.site_sigs & mask,
                      occurrences=index.occurrences)
    return MxuIsslScorer(other, max_dist=4, chunk=8 * segw, device="cpu")


def _ragged_inputs(eng, queries):
    """The engine's own slot plan cut to a slot count that still holds
    every bucket's queries and is not a multiple of 8."""
    qsp, _ = eng._plan(queries)
    n = queries.shape[0]
    need = int((qsp < n).sum(-1).max())
    qb = need + 1 if need % 8 == 0 else need
    assert qb % 8 and qb < qsp.shape[2]
    return eng.query_tensor(queries), torch.as_tensor(qsp[:, :, :qb].copy())


CASES = [(max_dist, segw, "w8") for max_dist in (0, 1, 2, 4)
         for segw in (128, 512)] + [(2, 128, "w4"), (4, 512, "w4"),
                                    (3, 128, "l16")]


@pytest.mark.parametrize("max_dist,segw,variant", CASES)
def test_emulated_finder_equals_plain(data, max_dist, segw,  # noqa: F811
                                      variant):
    index, queries = data
    width = 4 if variant == "w4" else 8
    seq_length = 16 if variant == "l16" else 20
    eng = _engine(port_index(index), segw, width, seq_length)
    q, qsp = _ragged_inputs(eng, queries)
    kw = dict(segw=eng.segw, nseg=eng.nseg, max_dist=max_dist,
              seq_length=seq_length)
    args = (eng.entries, eng.bucket_offsets, eng.bucket_lens, q, qsp)
    got = emulate_mxu_finder(*args, **kw)
    want = mxu_finder_plain(*args, **kw)
    assert torch.equal(got.cnt, want.cnt)
    assert torch.equal(got.rsum, want.rsum)
    assert (int(want.cnt.sum()) > 0) == (max_dist > 0)
