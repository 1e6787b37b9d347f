"""The port's native index path against its numpy twins.

``extract_offtargets_native``, ``sort_u64_native``,
``unique_counts_native`` and ``bucket_order_native`` split their work over
OpenMP threads; each must give exactly what the serial numpy path gives,
in the same order, on inputs that cross the threads' range boundaries.
"""

from __future__ import annotations

import numpy as np
import pytest

from crackling_tpu_torch import native
from crackling_tpu_torch.index import build as index_build
from crackling_tpu_torch.index import extract

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="the native library did not build")

_ALPHABET = np.frombuffer(b"ACGTacgtNn", np.uint8)
_WEIGHTS = [0.23, 0.23, 0.23, 0.23, 0.02, 0.02, 0.01, 0.01, 0.01, 0.01]


@pytest.mark.parametrize("to_upper", [True, False])
@pytest.mark.parametrize("n", [0, 22, 23, 24, 1_000, 400_000])
def test_extract_matches_numpy(n, to_upper):
    rng = np.random.default_rng(n)
    raw = rng.choice(_ALPHABET, size=n, p=_WEIGHTS).tobytes()
    got = native.extract_offtargets_native(raw, to_upper)
    want = extract.extract_offtarget_sites(
        extract.encode_seq(np.frombuffer(raw, np.uint8), to_upper=to_upper))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [40, 64])
@pytest.mark.parametrize("n", [1, 2, 1_000, 300_001])
def test_sort_and_unique_match_numpy(n, bits):
    rng = np.random.default_rng(n + bits)
    keys = rng.integers(0, 1 << (bits - 1), n, dtype=np.uint64) << np.uint64(
        bits == 64)
    keys[: n // 3] = keys[n - n // 3:]          # runs that cross threads
    got = native.sort_u64_native(keys.copy())
    np.testing.assert_array_equal(got, np.sort(keys))
    vals, counts = native.unique_counts_native(got)
    want_vals, want_counts = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("slice_width", [2, 8, 10])
def test_bucket_order_is_a_stable_argsort(slice_width):
    rng = np.random.default_rng(slice_width)
    sigs = rng.integers(0, 1 << 40, 200_003, dtype=np.uint64)
    nb = 1 << slice_width
    for shift in (0, slice_width, 40 - slice_width):
        order = np.empty(sigs.shape[0], np.int32)
        offsets = np.empty(nb + 1, np.int64)
        assert native.bucket_order_native(sigs, shift, nb, order, offsets)
        v = ((sigs >> np.uint64(shift)) & np.uint64(nb - 1)).astype(np.int64)
        np.testing.assert_array_equal(order, np.argsort(v, kind="stable"))
        np.testing.assert_array_equal(
            offsets, np.concatenate([[0], np.cumsum(np.bincount(v, minlength=nb))]))


def test_index_slices_match_the_numpy_build(monkeypatch):
    rng = np.random.default_rng(3)
    sites = rng.integers(0, 1 << 40, 50_000, dtype=np.uint64)
    sites[:5_000] = sites[-5_000:]
    index = index_build.build_index(sites)
    monkeypatch.setattr(native, "bucket_order_native", lambda *a: False)
    plain = index_build.IsslIndex(20, 8, index.seq_count, index.site_sigs,
                                  index.occurrences)
    np.testing.assert_array_equal(index.order, plain.order)
    np.testing.assert_array_equal(index.bucket_offsets, plain.bucket_offsets)
    want, counts = np.unique(sites, return_counts=True)
    np.testing.assert_array_equal(np.sort(index.site_sigs), want)
    assert int(index.occurrences.sum()) == int(counts.sum()) == 50_000
