"""Device selection for the port's entry points.

Every entry point takes a ``device``. ``None`` means the GPU: the port
runs on ``cuda`` unless the caller asks for the CPU, and a caller that did
not ask for the CPU and has no GPU gets an error, never a silent CPU run.
Engines that size their device buffers check them against
:func:`free_bytes` before they allocate.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for (or
    defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or set "
            "CRACKLING_PLATFORM=cpu for the CLIs) to run on the CPU")
    return dev


def free_bytes(device: torch.device) -> int:
    """Memory an engine may still take on ``device``: the card's free
    memory plus what PyTorch's allocator holds unused, or the host's
    available memory for the CPU."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free + torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def cli_device() -> str:
    """The CLIs' device: ``cpu`` when CRACKLING_PLATFORM=cpu, else
    ``cuda`` (the same override the JAX package's CLIs honour)."""
    return "cpu" if os.environ.get("CRACKLING_PLATFORM", "") == "cpu" \
        else "cuda"


# scoreOfftargets' estimated scan work below which it scores in f64
SMALL_SCORE_WORK = 5e8


def score_offtargets_placement(est_items: float):
    """``scoreOfftargets``' device and compute dtype by the JAX CLI's
    precision rule (crackling_tpu/utils/cli.py:20-37, :153), kept on the
    card: ``CRACKLING_PLATFORM=cpu`` -> the CPU in f64; unset or ``auto``
    with an estimated scan work ``est_items`` (queries x slices x sites
    per bucket) below 5e8 -> ``cuda`` in f64, whose printed scores are the
    binary's; anything else -> ``cuda`` in TwoSum-compensated f32 (the
    JAX CLI's accelerator f32). Returns (device, dtype)."""
    want = os.environ.get("CRACKLING_PLATFORM", "") or "auto"
    if want == "cpu":
        return "cpu", torch.float64
    if want == "auto" and est_items < SMALL_SCORE_WORK:
        return "cuda", torch.float64
    return "cuda", torch.float32
