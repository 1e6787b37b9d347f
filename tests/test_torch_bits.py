"""The port's int64 bit helpers against the JAX package's host codecs."""

import numpy as np
import pytest
import torch

from crackling_tpu.codec import popcount64
from crackling_tpu.ops.oracle import collapse_mismatches
from crackling_tpu.ops.tables import mask40_to_mask20
from crackling_tpu_torch.ops import bits


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(5)
    sigs = rng.integers(0, 1 << 40, size=4000, dtype=np.uint64)
    wide = rng.integers(0, 1 << 63, size=4000, dtype=np.uint64)
    edge = np.array([0, 1, 2, 3, (1 << 40) - 1, (1 << 62), (1 << 63) - 1],
                    dtype=np.uint64)
    return np.concatenate([sigs, sigs ^ sigs[::-1], wide, edge])


def _t(a):
    return torch.as_tensor(a.view(np.int64))


def _bitlen(a):
    return np.array([int(x).bit_length() for x in a], dtype=np.int64)


def _ctz(a):
    return np.array([(int(x) & -int(x)).bit_length() - 1 if x else 64
                     for x in a], dtype=np.int64)


@pytest.mark.parametrize("name", ["popcount", "ctz", "clz", "bit_length"])
def test_counts_match_host(words, name):
    got = getattr(bits, name)(_t(words)).numpy()
    want = {"popcount": lambda a: popcount64(a),
            "ctz": _ctz,
            "clz": lambda a: 64 - _bitlen(a),
            "bit_length": _bitlen}[name](words)
    np.testing.assert_array_equal(got, want)


def test_collapse_and_compress_match_host(words):
    x = words & np.uint64((1 << 40) - 1)
    c40 = bits.collapse_pairs(_t(x))
    np.testing.assert_array_equal(c40.numpy().view(np.uint64),
                                  collapse_mismatches(x))
    np.testing.assert_array_equal(
        bits.compress_even_bits(c40).numpy().view(np.uint64),
        mask40_to_mask20(collapse_mismatches(x)))


@pytest.mark.parametrize("s", range(5))
def test_earlier_slice_clean(words, s):
    c40 = collapse_mismatches(words & np.uint64((1 << 40) - 1))
    # slice s' holds positions 4s'..4s'+3 (byte s' of the collapsed mask)
    want = np.zeros(c40.shape, bool)
    for sp in range(s):
        want |= ((c40 >> np.uint64(8 * sp)) & np.uint64(0xFF)) == 0
    got = bits.earlier_slice_clean(_t(c40), s).numpy()
    np.testing.assert_array_equal(got, want)
