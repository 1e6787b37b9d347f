"""Build and load the package's hand-written CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exposes a plain C entry point. At
first use nvcc compiles it for sm_90a into ``_build/`` (one shared
library per source version, named by the hash of the source and of the
headers ``csrc/*.cuh`` beside it, so an edited source or header is rebuilt
and a stale library is never loaded), with the
compiler's ``-Xptxas -v`` report beside it as ``.log``; ctypes loads it.
Nothing is built when a module is imported: the CPU never needs nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

from .. import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found: the CUDA kernels under {CSRC} are "
                       "built at first use")


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>`` for sm_90a into ``_build/`` (once per
    source version) and return the library's path."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    out = BUILD / f"lib{src.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: processes that build at once
    # never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    trace.count("kernel.builds")
    with trace.span("kernel.build"):
        res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


class KernelLibrary:
    """One kernel source's library, built and loaded on the first
    :meth:`get`; ``bind`` declares its entry points' ctypes signatures."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library(self.source)))
                self._bind(lib)
                self._lib = lib
        return self._lib
