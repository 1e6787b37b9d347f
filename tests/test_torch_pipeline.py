"""The PyTorch package's ``Crackling`` against the JAX package's, on the CPU.

Both pipelines run ``tests/test_pipeline.py``'s mini-world config; the
JAX CPU path scores off-targets with its f64 exact engine. The port runs
through its CLI entry point with ``CRACKLING_PLATFORM=cpu``, once per
``[tpu] engine``:

* ``auto`` picks the general exact engine on the CPU, as the JAX package
  does, in f64: the whole CSV, both score columns included, must be the
  JAX package's. (Both engines sum in the same order, so the printed
  ``%f`` scores are identical, not merely close.)
* ``exact`` is the MXU engine (plain neighbour finder on the CPU, f64
  host replay): every column but the two scores identical, verdicts
  included; scores within 1e-9 (it sums each query's hits in the
  reference's order, the flat engine per round, so the last f64 bits may
  differ before ``%f`` rounds them).
* ``auto+tpufold`` is ``auto`` with ``[tpu] rnafold-backend = tpu``: the
  secondary-structure gate folds with the port's batched DP (on the CPU
  here) in place of the native engine, and the whole CSV must still be
  the JAX package's.
* ``compact`` and ``dense`` are the hybrid over the compact and the
  dense engine, ``sharded`` the hybrid over the compact engine on two
  site-range shards (``[tpu] cpu-devices = 2``), ``pallas`` the
  scan-style engine alone: every column but the two scores identical,
  verdicts included; scores within 1e-3 (f32 per-hit terms of a full
  scan vs f64).
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_pipeline import mini_world  # noqa: F401  (shared fixture)

SCORE_COLS = ("mitOfftargetscore", "cfdOfftargetscore")
ENGINES = ["auto", "auto+tpufold", "exact", "compact", "dense", "pallas",
           "sharded"]
SCORE_TOL = {"auto": 0.0, "auto+tpufold": 0.0, "exact": 1e-9,
             "compact": 1e-3, "dense": 1e-3, "pallas": 1e-3,
             "sharded": 1e-3}
# the JAX package's virtual CPU devices: two shards on the CPU; the
# batched fold in place of the native one
TPU_EXTRA = {"sharded": "cpu-devices = 2\n",
             "auto+tpufold": "rnafold-backend = tpu\n"}
# the batched fold is thousands of small torch ops: on a loaded host
# their intra-op thread pools only contend
ENV_EXTRA = {"auto+tpufold": {"OMP_NUM_THREADS": "1"}}


def _config(mini_world, outdir, engine=None):  # noqa: F811
    outdir.mkdir()
    text = mini_world["config"].read_text().replace(
        str(mini_world["outdir"]), str(outdir))
    if engine is not None:
        text += (f"\n[tpu]\nengine = {engine.split('+')[0]}\n"
                 f"{TPU_EXTRA.get(engine, '')}")
    cfg = outdir.parent / f"{outdir.name}.ini"
    cfg.write_text(text)
    return cfg


def _rows(path):
    with open(path) as fp:
        return list(csv.reader(fp))


@pytest.fixture(scope="module")
def jax_rows(mini_world, tmp_path_factory):  # noqa: F811
    from crackling_tpu.pipeline.config import ConfigManager
    from crackling_tpu.pipeline.run import Crackling

    td = tmp_path_factory.mktemp("jax")
    cm = ConfigManager(str(_config(mini_world, td / "out")), lambda m: None)
    assert cm.isConfigured()
    Crackling(cm)
    return _rows(td / "out" / "mini-guides.txt")


@pytest.fixture(scope="module", params=ENGINES)
def torch_run(request, mini_world, tmp_path_factory):  # noqa: F811
    engine = request.param
    td = tmp_path_factory.mktemp(f"torch-{engine}")
    cfg = _config(mini_world, td / "out", engine)
    env = dict(os.environ, CRACKLING_PLATFORM="cpu",
               **ENV_EXTRA.get(engine, {}))
    res = subprocess.run(
        [sys.executable, "-m", "crackling_tpu_torch.utils.run_cli",
         "Crackling", "-c", str(cfg)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return engine, _rows(td / "out" / "mini-guides.txt")


def test_csv_identical_except_scores(jax_rows, torch_run):
    _engine, rows_torch = torch_run
    assert rows_torch[0] == jax_rows[0]
    assert len(rows_torch) == len(jax_rows) > 50
    col = {c: i for i, c in enumerate(jax_rows[0])}
    others = [i for c, i in col.items() if c not in SCORE_COLS]
    for rj, rt in zip(jax_rows[1:], rows_torch[1:]):
        assert [rt[i] for i in others] == [rj[i] for i in others]


def test_scores_within_tolerance(jax_rows, torch_run):
    engine, rows_torch = torch_run
    col = {c: i for i, c in enumerate(jax_rows[0])}
    scored = 0
    for rj, rt in zip(jax_rows[1:], rows_torch[1:]):
        for name in SCORE_COLS:
            a, b = rj[col[name]], rt[col[name]]
            if a in ("?", ""):
                assert b == a
                continue
            assert abs(float(a) - float(b)) <= SCORE_TOL[engine], \
                (name, a, b)
            scored += 1
    assert scored > 0, "no guide reached off-target scoring"
    if engine.startswith("auto"):
        assert rows_torch == jax_rows


def test_auto_engine_rule():
    """The JAX rule with its TPU mapped to CUDA: compact on CUDA at
    l=20 / w=8, the general exact engine everywhere else."""
    from types import SimpleNamespace

    from crackling_tpu_torch.pipeline.run import select_auto_engine

    def index(seq_length=20, slice_width=8):
        return SimpleNamespace(seq_length=seq_length,
                               slice_width=slice_width)

    assert select_auto_engine(index(), "cuda") == "compact"
    assert select_auto_engine(index(), "cpu") == "xla"
    assert select_auto_engine(index(seq_length=16), "cuda") == "xla"
    assert select_auto_engine(index(slice_width=4), "cuda") == "xla"


def test_mxu_falls_back_to_xla(mini_world, tmp_path, monkeypatch,  # noqa: F811
                               capsys):
    """``engine = mxu`` on an index the MXU engine cannot hold (here: no
    free memory) logs the fallback and builds the general exact engine
    in the device's dtype, as the JAX pipeline does."""
    import crackling_tpu_torch.ops.issl_mxu as port_mxu
    from crackling_tpu_torch.ops.issl_flat import IsslScorer
    from crackling_tpu_torch.pipeline.config import ConfigManager
    from crackling_tpu_torch.pipeline.run import Pipeline

    cm = ConfigManager(str(_config(mini_world, tmp_path / "out", "mxu")),
                       lambda m: None)
    assert cm.isConfigured()
    monkeypatch.setattr(port_mxu, "free_bytes", lambda device: 0)
    scorer = Pipeline(cm, device="cpu")._get_issl_scorer()
    assert isinstance(scorer, IsslScorer)
    assert scorer.dtype == torch.float64 and scorer.method == "and"
    assert "MXU engine unavailable" in capsys.readouterr().out


def test_compact_falls_back_to_dense(mini_world, tmp_path,  # noqa: F811
                                     monkeypatch, capsys):
    """``engine = compact`` on an index past the compact engine's rank
    bound (here: the bound lowered below the mini world's buckets) logs
    the JAX package's line and builds the hybrid over the dense engine."""
    import crackling_tpu_torch.ops.issl_compact as port_compact
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.ops.issl_dense import DenseIsslScorer
    from crackling_tpu_torch.pipeline.config import ConfigManager
    from crackling_tpu_torch.pipeline.run import Pipeline

    cm = ConfigManager(str(_config(mini_world, tmp_path / "out",
                                   "compact")), lambda m: None)
    assert cm.isConfigured()
    monkeypatch.setattr(port_compact, "RANK_BOUND", 1)
    scorer = Pipeline(cm, device="cpu")._get_issl_scorer()
    assert isinstance(scorer, HybridIsslScorer)
    assert isinstance(scorer.dense, DenseIsslScorer)
    assert scorer.band == 1.0 and scorer.dense.device.type == "cpu"
    out = capsys.readouterr().out
    assert "compact engine unavailable" in out
    assert "using the dense engine" in out


def test_sharded_falls_back_to_sharded_dense(mini_world, tmp_path,  # noqa: F811
                                             monkeypatch, capsys):
    """``engine = sharded`` past the compact rank bound logs the JAX
    package's line and builds the hybrid over the sharded dense engine."""
    import crackling_tpu_torch.ops.issl_compact as port_compact
    from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
    from crackling_tpu_torch.parallel.sharded import ShardedDenseIsslScorer
    from crackling_tpu_torch.pipeline.config import ConfigManager
    from crackling_tpu_torch.pipeline.run import Pipeline

    cm = ConfigManager(str(_config(mini_world, tmp_path / "out",
                                   "sharded")), lambda m: None)
    assert cm.isConfigured()
    monkeypatch.setattr(port_compact, "RANK_BOUND", 1)
    # [tpu] cpu-devices puts the run on the CPU, whatever the caller asked
    scorer = Pipeline(cm, device="cuda")._get_issl_scorer()
    assert isinstance(scorer, HybridIsslScorer)
    assert isinstance(scorer.dense, ShardedDenseIsslScorer)
    assert scorer.dense.n_shards == 2 and scorer.band == 1.0
    assert scorer.dense.device.type == "cpu"
    out = capsys.readouterr().out
    assert "sharded compact unavailable" in out
    assert "using the sharded dense engine" in out


@pytest.mark.parametrize("engine", ["auto", "exact", "mxu", "compact",
                                    "dense", "sharded", "pallas", "xla"])
def test_every_jax_engine_is_accepted(mini_world, tmp_path,  # noqa: F811
                                      engine):
    """Every ``[tpu] engine`` of the JAX package builds a scorer in the
    port; an unknown name is refused."""
    from crackling_tpu_torch.pipeline.config import ConfigManager
    from crackling_tpu_torch.pipeline.run import Pipeline

    cm = ConfigManager(str(_config(mini_world, tmp_path / "out", engine)),
                       lambda m: None)
    assert cm.isConfigured()
    scorer = Pipeline(cm, device="cpu")._get_issl_scorer()
    mit, cfd = scorer.score(np.zeros(1, dtype=np.uint64))
    assert mit.shape == cfd.shape == (1,)


def test_unknown_engine_is_refused(mini_world, tmp_path):  # noqa: F811
    from crackling_tpu_torch.pipeline.config import ConfigManager
    from crackling_tpu_torch.pipeline.run import Pipeline

    cm = ConfigManager(str(_config(mini_world, tmp_path / "out", "nope")),
                       lambda m: None)
    assert cm.isConfigured()
    with pytest.raises(ValueError, match="unknown"):
        Pipeline(cm, device="cpu")._get_issl_scorer()
