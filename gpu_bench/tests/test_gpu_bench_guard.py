"""The no-JAX check compares whole top-level module names."""

import pytest

from gpu_bench import guard


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["crackling_tpu"], ["crackling_tpu"]),
    (["crackling_tpu.ops.issl_compact"], ["crackling_tpu"]),
    (["crackling_tpu_torch", "crackling_tpu_torch.ops.hybrid"], []),
    (["jaxtyping", "flaxen", "crackling_tpu_tools"], []),
])
def test_forbidden_modules(names, found):
    assert guard.forbidden_modules(names) == found
    if found:
        with pytest.raises(guard.RunRefused):
            guard.check_no_jax("test", names)
    else:
        guard.check_no_jax("test", names)


def test_this_process_has_no_jax_after_a_run(tiny_root):
    """The harness and the port load neither, here where the tests' own
    process may hold them: compare what a run adds."""
    import subprocess
    import sys

    code = ("import sys; from pathlib import Path; "
            "from gpu_bench.harness import main; "
            "from gpu_bench.guard import forbidden_modules; "
            f"rc = main(['--workload', 'tiny.small', '--seed', '3', "
            f"'--seconds', '0.2'], root=Path({str(tiny_root)!r}), "
            "device='cpu'); "
            "sys.exit(rc or len(forbidden_modules()))")
    from conftest import ROOT

    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_no_card_refuses(monkeypatch, tiny_root):
    import torch

    from gpu_bench.harness import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", "tiny.small", "--seed", "1", "--seconds",
                 "1"], root=tiny_root) == 2
