"""The PyTorch package's ``Crackling`` against the JAX package's, on the CPU.

Both pipelines run ``tests/test_pipeline.py``'s mini-world config. The
JAX CPU path scores off-targets with its f64 exact engine; the port runs
its compact engine (plain finder on the CPU) plus the hybrid's exact
re-score of near-threshold queries, through its CLI entry point with
``CRACKLING_PLATFORM=cpu``. Every CSV column must be identical except the
two off-target scores, which agree within 1e-3 (f32 full scan vs f64),
and the verdicts derived from them, which must be identical.
"""

import csv
import os
import subprocess
import sys

import pytest

from test_pipeline import mini_world  # noqa: F401  (shared fixture)

SCORE_COLS = ("mitOfftargetscore", "cfdOfftargetscore")


def _config(mini_world, outdir):  # noqa: F811
    outdir.mkdir()
    text = mini_world["config"].read_text().replace(
        str(mini_world["outdir"]), str(outdir))
    cfg = outdir.parent / f"{outdir.name}.ini"
    cfg.write_text(text)
    return cfg


def _rows(path):
    with open(path) as fp:
        return list(csv.reader(fp))


@pytest.fixture(scope="module")
def both_runs(mini_world, tmp_path_factory):  # noqa: F811
    from crackling_tpu.pipeline.config import ConfigManager
    from crackling_tpu.pipeline.run import Crackling

    td = tmp_path_factory.mktemp("torch-vs-jax")
    cfg_jax = _config(mini_world, td / "jax")
    cm = ConfigManager(str(cfg_jax), lambda m: None)
    assert cm.isConfigured()
    Crackling(cm)

    cfg_torch = _config(mini_world, td / "torch")
    env = dict(os.environ, CRACKLING_PLATFORM="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "crackling_tpu_torch.utils.run_cli",
         "Crackling", "-c", str(cfg_torch)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return (_rows(td / "jax" / "mini-guides.txt"),
            _rows(td / "torch" / "mini-guides.txt"))


def test_csv_identical_except_scores(both_runs):
    rows_jax, rows_torch = both_runs
    assert rows_torch[0] == rows_jax[0]
    assert len(rows_torch) == len(rows_jax) > 50
    header = rows_jax[0]
    col = {c: i for i, c in enumerate(header)}
    others = [i for c, i in col.items() if c not in SCORE_COLS]
    for rj, rt in zip(rows_jax[1:], rows_torch[1:]):
        assert [rt[i] for i in others] == [rj[i] for i in others]


def test_scores_within_tolerance(both_runs):
    rows_jax, rows_torch = both_runs
    col = {c: i for i, c in enumerate(rows_jax[0])}
    scored = 0
    for rj, rt in zip(rows_jax[1:], rows_torch[1:]):
        for name in SCORE_COLS:
            a, b = rj[col[name]], rt[col[name]]
            if a in ("?", ""):
                assert b == a
                continue
            assert abs(float(a) - float(b)) <= 1e-3, (name, a, b)
            scored += 1
    assert scored > 0, "no guide reached off-target scoring"
