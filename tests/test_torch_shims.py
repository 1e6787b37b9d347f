"""The PyTorch package's drop-in RNAfold / bowtie2 shims against the JAX
package's, on the CPU.

* ``rnafold_main`` writes the JAX shim's ``RNAfold_output.fold`` byte for
  byte, folding with the port's native engine and, with the native
  library made unavailable, with its batched DP on the CLIs' device
  (``CRACKLING_PLATFORM=cpu``). The JAX shim's native fold is made to
  raise, so it folds with its own DP and never builds
  ``crackling_tpu.native``.
* ``bowtie2_main`` writes the JAX shim's SAM file byte for byte on reads
  with exact (one and two genome copies, both strands), 1-2 mismatch and
  unplaced alignments.
* ``write_shim_scripts`` writes executable scripts that import
  ``crackling_tpu_torch``, and the bowtie2 script run in a subprocess
  writes what ``bowtie2_main`` writes.
* The port's pipeline ``vienna`` backend, with its binary set to the port's
  RNAfold shim, gives the ``native`` backend's columns.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from crackling_tpu.utils import shims as jshims
from crackling_tpu_torch.utils import shims


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fold is thousands of small torch ops per batch: on a loaded
    host their intra-op thread pools only contend, so run on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rc(seq):
    return seq[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")
def bowtie_world(tmp_path_factory):
    """A two-record FASTA and 23-mer reads that end in a GG PAM: exact
    forward and reverse-strand copies, one present twice, 1- and
    2-mismatch variants, random reads."""
    td = tmp_path_factory.mktemp("bowtie")
    rng = np.random.default_rng(7)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), n))

    def guide():
        return rand(21) + "GG"

    chr1, chr2 = list(rand(3000)), list(rand(2000))
    twice = guide()
    placed = [(chr1, 100, guide()), (chr2, 700, _rc(guide())),
              (chr1, 500, twice), (chr1, 2500, twice),
              (chr2, 1500, guide()), (chr1, 1200, guide()),
              (chr2, 300, guide()), (chr1, 2000, _rc(guide()))]
    windows = []
    for chrom, at, seq in placed:
        chrom[at:at + 23] = seq
        windows.append(seq)
    chr1, chr2 = "".join(chr1), "".join(chr2)
    fasta = td / "genome.fa"
    fasta.write_text(">chr1 a\n" + "\n".join(
        chr1[i:i + 60] for i in range(0, len(chr1), 60))
        + "\n>chr2\n" + chr2 + "\n")

    def mutate(s, k):
        s = list(s)
        for p in rng.choice(np.arange(2, 20), k, replace=False):
            s[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[p]]
        return "".join(s)

    reads = [windows[0], _rc(windows[1]), twice, windows[4],
             mutate(windows[5], 1), mutate(windows[6], 2),
             mutate(_rc(windows[7]), 1), rand(21) + "GG", rand(21) + "GG"]
    rfile = td / "reads.txt"
    rfile.write_text("".join(r + "\n" for r in reads))
    return {"fasta": str(fasta), "reads": str(rfile)}


def _bowtie_args(world, sam):
    return ["-x", world["fasta"], "-p", "1", "--reorder", "--no-hd", "-t",
            "-r", "-U", world["reads"], "-S", str(sam)]


@pytest.mark.parametrize("engine", ["native", "tpu"])
def test_rnafold_shim_matches_jax(engine, tmp_path, monkeypatch):
    from crackling_tpu.pipeline import secondary_structure as jss
    from crackling_tpu_torch.pipeline import secondary_structure as pss

    def unavailable(*args, **kwargs):
        raise RuntimeError("native fold library unavailable")

    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list("GGCCAT"), 40)) for _ in range(8)]
    seqs[3] = seqs[3].lower()
    inp = tmp_path / "in.txt"
    inp.write_text("".join(s + "\n" for s in seqs))
    argv = ["--noPS", "-j1", "-i", str(inp), "-o"]
    monkeypatch.setattr(jss, "fold_constructs_native", unavailable)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert jshims.rnafold_main(argv) == 0
    want = (tmp_path / "jax" / "RNAfold_output.fold").read_bytes()

    if engine == "tpu":
        monkeypatch.setattr(pss, "fold_constructs_native", unavailable)
        monkeypatch.setenv("CRACKLING_PLATFORM", "cpu")
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "torch")
    assert shims.rnafold_main(argv) == 0
    got = (tmp_path / "torch" / "RNAfold_output.fold").read_bytes()
    assert got == want
    assert got.count(b"\n") == 16 and b"(" in got


def test_bowtie2_shim_matches_jax(bowtie_world, tmp_path, monkeypatch):
    import crackling_tpu.native as jnative

    # the JAX package's numpy window scan, never its native library
    monkeypatch.setattr(jnative, "pam_windows_native", lambda codes: None)
    assert jshims.bowtie2_main(
        _bowtie_args(bowtie_world, tmp_path / "jax.sam")) == 0
    assert shims.bowtie2_main(
        _bowtie_args(bowtie_world, tmp_path / "torch.sam")) == 0
    got = (tmp_path / "torch.sam").read_text()
    assert got == (tmp_path / "jax.sam").read_text()
    lines = [line.split("\t") for line in got.splitlines()]
    assert len(lines) == 9
    assert "XS:i:0" in lines[2]                       # two genome copies
    assert lines[1][1] == "0" and "XM:i:0" in lines[1]  # reverse strand
    assert "XM:i:2" in lines[5]
    assert lines[7][1] == "4" and lines[8][1] == "4"  # unplaced


def test_shim_scripts_import_the_port(bowtie_world, tmp_path):
    paths = shims.write_shim_scripts(str(tmp_path))
    assert set(paths) == {"rnafold", "bowtie2"}
    for name, path in paths.items():
        text = open(path).read()
        assert "from crackling_tpu_torch.utils.shims import" in text
        assert os.access(path, os.X_OK)
    assert shims.bowtie2_main(
        _bowtie_args(bowtie_world, tmp_path / "in_process.sam")) == 0
    env = dict(os.environ, CRACKLING_PLATFORM="cpu")
    res = subprocess.run(
        [paths["bowtie2"]] + _bowtie_args(bowtie_world, tmp_path / "sub.sam"),
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert (tmp_path / "sub.sam").read_bytes() == \
        (tmp_path / "in_process.sam").read_bytes()


def test_vienna_backend_through_the_shim(tmp_path, monkeypatch):
    from crackling_tpu_torch.pipeline.secondary_structure import (
        SecondaryStructureGate)

    monkeypatch.setenv("CRACKLING_PLATFORM", "cpu")
    shim = shims.write_shim_scripts(str(tmp_path))["rnafold"]
    rng = np.random.default_rng(19)
    targets = ["".join(rng.choice(list("ACGT"), 23)) for _ in range(12)]
    got = SecondaryStructureGate(backend="vienna", binary=shim,
                                 threads=1).assess(targets)
    want = SecondaryStructureGate(backend="native").assess(targets)
    for key in ("verdict", "ssL1", "ssStructure", "ssEnergy"):
        assert list(got[key]) == list(want[key]), key
    assert all(s for s in got["ssStructure"])
