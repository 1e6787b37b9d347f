"""crackling_tpu_torch — the CRISPR guide-design engine on PyTorch and CUDA.

The PyTorch port of ``crackling_tpu``: the same pipeline, index formats,
CLIs and scoring semantics, with the off-target scan running on an NVIDIA
GPU through kernels written by hand for Hopper (``csrc/``). It imports
neither JAX nor ``crackling_tpu``; the host layer (codecs, index builder,
efficiency scorers, native C++ helpers, pipeline plumbing) is its own copy.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` in the library, ``CRACKLING_PLATFORM=cpu`` for the
CLIs), where every kernel is replaced by its plain PyTorch version.
"""

from .constants import *  # noqa: F401,F403
from .codec import rc, trans_to_dna, at_percentage  # noqa: F401

__version__ = "0.1.0"
