"""The PyTorch package's batched MFE fold against the JAX package's, on the
CPU.

The same code batches, made from a seed with numpy, go through the JAX
package's ``_precompute`` / ``fold_batch`` (x64, as tests/conftest.py
sets it) and the port's, which runs its torch DP with ``device="cpu"``:

* the precomputed tables are equal (``array_equal``: each value is a
  table lookup or the same f64 sum in the same order);
* the DP tables V, fML, fM1 and f5 lie within atol 1e-9 of JAX's, and
  the traced-back structures are equal;
* against the port's own native C++ engine (``fold_batch_native``),
  energies lie within atol 1e-6 and structures are equal (the cases of
  tests/test_mfe.py's cross-engine test);
* folding in chunks of 3 gives the bits of one chunk;
* the ``tpu`` backend of the port's secondary-structure gate gives the
  JAX gate's ``tpu`` columns and the port's ``native`` columns.

The JAX fold compiles once per (B, n) shape, so the cases reuse three.
"""

import numpy as np
import pytest
import torch

from crackling_tpu.ops import mfe as jmfe
from crackling_tpu_torch.constants import SCAFFOLD_RNA
from crackling_tpu_torch.native import fold_batch_native
from crackling_tpu_torch.ops import mfe

CASES = [(30, 32, 10), (60, 16, 11), (100, 16, 12)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fold is thousands of small torch ops per batch: on a loaded
    host their intra-op thread pools only contend, so run on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_seqs(n, count, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGU"), n)) for _ in range(count)]


def _constructs(count, seed):
    """The pipeline's 100-nt construct: 'G' + spacer[1:20] + scaffold."""
    rng = np.random.default_rng(seed)
    return [f"G{''.join(rng.choice(list('ACGU'), 19))}{SCAFFOLD_RNA}"
            for _ in range(count)]


def _codes(seqs):
    return np.stack([mfe.encode_rna(s) for s in seqs])


@pytest.mark.parametrize("seqs", [_rand_seqs(30, 8, 3), _constructs(8, 4)],
                         ids=["n30", "construct"])
def test_precompute_equals_jax(seqs):
    codes = _codes(seqs)
    want = jmfe._precompute(codes)
    got = mfe._precompute(codes, "cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value)), key


@pytest.mark.parametrize("n,count,seed", CASES)
def test_fold_batch_matches_jax(n, count, seed):
    codes = _codes(_rand_seqs(n, count, seed))
    e_jax, t_jax = jmfe.fold_batch(codes)
    e_pt, t_pt = mfe.fold_batch(codes, device="cpu")
    for key in ("V", "fML", "fM1", "f5"):
        np.testing.assert_allclose(t_pt[key], t_jax[key], rtol=0, atol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(e_pt, e_jax, rtol=0, atol=1e-9)
    s_jax = [jmfe.traceback(t_jax, b) for b in range(count)]
    s_pt = [mfe.traceback(t_pt, b) for b in range(count)]
    assert s_pt == s_jax


@pytest.mark.parametrize("n,count,seed", CASES)
def test_fold_matches_native(n, count, seed):
    seqs = _rand_seqs(n, count, seed)
    s_nat, e_nat = fold_batch_native(_codes(seqs))
    s_pt, e_pt = mfe.fold_sequences(seqs, device="cpu")
    np.testing.assert_allclose(e_pt, e_nat, rtol=0, atol=1e-6)
    assert s_pt == s_nat


def test_chunks_give_the_same_bits():
    codes = _codes(_rand_seqs(40, 10, 5))
    e_one, t_one = mfe.fold_batch(codes, device="cpu")
    e_ch, t_ch = mfe.fold_batch(codes, device="cpu", chunk=3)
    assert [len(e) for e, _ in mfe.fold_chunks(codes, "cpu", chunk=3)] == \
        [3, 3, 3, 1]
    assert np.array_equal(e_one, e_ch)
    for key in ("V", "fML", "fM1", "f5"):
        assert np.array_equal(t_one[key], t_ch[key]), key
    for key, value in t_one["pre"].items():
        assert np.array_equal(t_ch["pre"][key], value), key
    # sized from free memory, the chunk holds the whole small batch
    assert mfe.chunk_size(10, 100, torch.device("cpu")) == 10
    assert mfe.chunk_size(10, 100, torch.device("cpu"), chunk=0) == 1


def test_fold_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = _codes(_rand_seqs(30, 2, 6))
    with pytest.raises(RuntimeError, match="CUDA"):
        mfe.fold_batch(codes)
    with pytest.raises(RuntimeError, match="CUDA"):
        mfe.fold_sequences(_rand_seqs(30, 2, 6))


def test_gate_tpu_backend_matches_jax_and_native():
    """16 distinct constructs (the JAX fold's (16, 100) shape again), one
    duplicated 19-mer key and one target starting with T (CODE_ERROR)."""
    from crackling_tpu.pipeline.secondary_structure import (
        SecondaryStructureGate as JaxGate)
    from crackling_tpu_torch.pipeline.secondary_structure import (
        SecondaryStructureGate)

    rng = np.random.default_rng(13)
    targets = ["".join(rng.choice(list("ACG"), 1))
               + "".join(rng.choice(list("ACGT"), 22)) for _ in range(15)]
    targets.append("T" + targets[0][1:])      # same construct, CODE_ERROR
    targets.append("T" + "".join(rng.choice(list("ACGT"), 22)))
    targets.append(targets[3])
    assert len({f"G{t[1:20]}" for t in targets}) == 16
    want = JaxGate(backend="tpu").assess(targets)
    got = SecondaryStructureGate(backend="tpu", device="cpu").assess(targets)
    native = SecondaryStructureGate(backend="native").assess(targets)
    assert native["verdict"][15] == "!" and native["verdict"][16] == "!"
    for key in ("verdict", "ssL1", "ssStructure", "ssEnergy"):
        assert list(got[key]) == list(want[key]), key
        assert list(got[key]) == list(native[key]), key
