"""What a run refuses: a missing card, and JAX or the JAX package loaded."""

from __future__ import annotations

import subprocess
import sys

# top-level module names, compared whole: the port's name begins with the
# JAX package's and is allowed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "crackling_tpu"})


class RunRefused(RuntimeError):
    """The run cannot give a result; the message says why."""


def forbidden_modules(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)


def check_no_jax(when: str, names=None) -> None:
    found = forbidden_modules(names)
    if found:
        raise RunRefused(f"{when}: loaded {', '.join(found)}; nothing the "
                         "benchmark runs may import JAX or the JAX package")


def check_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunRefused("no CUDA device: this benchmark runs on the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise RunRefused(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` prints it."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if res.returncode == 0 and lines else None
