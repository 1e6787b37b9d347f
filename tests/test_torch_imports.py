"""The PyTorch package, chip_smoke.py, finder_variants.py and
fullscan_variants.py stand alone: no JAX, nothing of ``crackling_tpu``.

Checked in a subprocess, because this test process already imported jax
(tests/conftest.py). The same subprocess checks that the entry points
default to the GPU and raise without one, rather than running on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
import crackling_tpu_torch as pkg

mods = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    mods.append(m.name)
import chip_smoke  # noqa: F401  (the GPU smoke script, same rule)
import finder_variants  # noqa: F401  (the kernel variants, same rule)
import fullscan_variants  # noqa: F401  (full-scan variants, same rule)
leaked = sorted(k for k in sys.modules
                if k == "jax" or k.startswith("jax.") or k == "jaxlib"
                or k == "crackling_tpu" or k.startswith("crackling_tpu."))

import numpy as np
from crackling_tpu_torch.index import build_index
from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer
from crackling_tpu_torch.ops.issl_dense import DenseIsslScorer
from crackling_tpu_torch.ops.issl_scan import ScanIsslScorer
from crackling_tpu_torch.ops.issl_flat import IsslScorer
from crackling_tpu_torch.ops.issl_mxu import MxuIsslScorer
from crackling_tpu_torch.ops.hybrid import HybridIsslScorer
from crackling_tpu_torch.parallel.distributed import (host_mesh,
                                                      local_devices)
from crackling_tpu_torch.parallel.sharded import (ShardedCompactIsslScorer,
                                                  ShardedDenseIsslScorer,
                                                  ShardedIsslScorer,
                                                  make_mesh)
from crackling_tpu_torch.pipeline.run import Pipeline

index = build_index(np.arange(1, 300, dtype=np.uint64) * 7919)
raised = {}
if not torch.cuda.is_available():
    class _CM:
        # a config with a [tpu] section and nothing else
        _parser = None

        def __init__(self, **tpu):
            self.tpu = tpu

        def __getitem__(self, section):
            return self.tpu

    def sharded(cls):
        return lambda: cls(index, make_mesh(1))

    for name, make in (("compact", lambda: CompactIsslScorer(index)),
                       ("dense", lambda: DenseIsslScorer(index)),
                       ("scan", lambda: ScanIsslScorer(index)),
                       ("mxu", lambda: MxuIsslScorer(index)),
                       ("flat", lambda: IsslScorer(index)),
                       ("hybrid", lambda: HybridIsslScorer(index)),
                       ("pipeline", lambda: Pipeline(_CM())),
                       ("sharded_flat", sharded(ShardedIsslScorer)),
                       ("sharded_dense", sharded(ShardedDenseIsslScorer)),
                       ("sharded_compact", sharded(ShardedCompactIsslScorer)),
                       ("host_mesh", host_mesh),
                       ("local_devices", local_devices),
                       ("pipeline_sharded",
                        lambda: Pipeline(_CM(engine="sharded")))):
        try:
            make()
            raised[name] = False
        except RuntimeError as e:
            raised[name] = "CUDA" in str(e)
print(json.dumps({"mods": mods, "leaked": leaked, "raised": raised}))
"""


def _probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package():
    res = _probe()
    # every module of the port was imported ...
    for mod in ("issl_compact", "compact_finder", "compact_onehot",
                "compact_rescan", "compact_decode", "issl_mxu", "mxu_finder",
                "issl_flat", "kernel_build", "fullscan", "issl_dense",
                "issl_scan", "mfe"):
        assert f"crackling_tpu_torch.ops.{mod}" in res["mods"]
    for mod in ("sharded", "distributed"):
        assert f"crackling_tpu_torch.parallel.{mod}" in res["mods"]
    assert "crackling_tpu_torch.utils.cli" in res["mods"]
    assert "crackling_tpu_torch.utils.shims" in res["mods"]
    # ... and none of them brought in JAX or the JAX package
    assert res["leaked"] == []
    # without a GPU, entry points not asked for the CPU refuse to run
    import torch

    if not torch.cuda.is_available():
        assert res["raised"] == {"compact": True, "dense": True,
                                 "scan": True, "mxu": True,
                                 "flat": True, "hybrid": True,
                                 "pipeline": True, "sharded_flat": True,
                                 "sharded_dense": True,
                                 "sharded_compact": True,
                                 "host_mesh": True, "local_devices": True,
                                 "pipeline_sharded": True}
