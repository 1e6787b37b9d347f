"""The compact finder over one-hot planes: the mismatch mask as a product.

The same function as :mod:`.compact_finder` (per-(chunk, query slot) hit
count, rank sum, min rank and max rank, plus superchunk and bucket cells;
the same :class:`~.compact_finder.FinderOut`), from another input: the
index's **one-hot planes**. Row ``e`` of slice ``s`` holds, at lane
``4p + b``, 1 iff the entry's base at position ``p`` is ``b``. With a
weight column per query slot that holds ``2^p`` at lane ``4p + b`` where
the query's base at ``p`` is not ``b``, the product (row . column) is the
pair's 20-bit mismatch mask; its popcount is the distance and its zero
nibbles are the earlier slices that match (first-clean-slice dedup).

The planes keep **80 lanes** per entry (4 bases x 20 positions), not the
JAX package's 128: 80 B per entry is 37.5% fewer plane bytes, and the
extra JAX lanes (80..127) are always 0. The kernel pads them to K = 96
(three k32 steps of int8 ``mma``) in shared memory.

Two implementations of the same function:

* :func:`compact_finder_onehot` — the wrapper. On a CUDA tensor it
  launches the hand-written Hopper kernel ``csrc/compact_onehot.cu``
  (nvcc at first use, ctypes), which takes every pair's distance from an
  int8 tensor-core product with weight 1 at the mismatched lanes, and the
  masks of the rare tiles that hold a candidate from three int8 products
  of 7-bit column groups; on a CPU tensor it runs the plain version. No
  fallback from one to the other.
* :func:`compact_finder_onehot_plain` — plain PyTorch: per (slice,
  bucket) with live slots, one f32 ``torch.matmul`` of the bucket's plane
  rows by the slots' weight columns, then the hit predicate on that mask
  and the plain compact finder's scatter.

Replaces crackling_tpu/ops/issl_compact.py::_finder_kernel_onehot.
"""

from __future__ import annotations

import ctypes

import torch

from .bits import earlier_slice_clean_mask, popcount
from .compact_finder import (PLAIN_PAIR_BLOCK, ChunkMoments, FinderOut,
                             alloc_out, check_inputs, superchunk_cells)
from .kernel_build import KernelLibrary

LANES = 80                  # one-hot lanes per entry: 4 bases x 20 positions
PLANE_BUILD_ROWS = 1 << 20  # entries per step of the plane build


def onehot_planes(entries: torch.Tensor, seq_length: int) -> torch.Tensor:
    """(S, Epad) int64 packed signatures -> (S, Epad, LANES) int8 one-hot
    planes on the same device: lane ``4p + b`` is ``base(p) == b``, and
    lanes at or past ``4 * seq_length`` are 0 (the port's copy of
    crackling_tpu/ops/issl_mxu.py::_onehot_rows, 80 lanes wide). Padding
    entries (signature 0) are real rows of base A; the finder's bucket
    bound keeps them out. Built in steps of PLANE_BUILD_ROWS entries."""
    dev = entries.device
    S, epad = entries.shape
    p = torch.arange(LANES // 4, device=dev)
    b = torch.arange(4, device=dev)
    keep = (p < seq_length)[:, None]                            # (20, 1)
    out = torch.empty((S, epad, LANES), dtype=torch.int8, device=dev)
    for s in range(S):
        for r0 in range(0, epad, PLANE_BUILD_ROWS):
            e = entries[s, r0:r0 + PLANE_BUILD_ROWS]
            code = (e[:, None] >> (2 * p)) & 3                  # (rows, 20)
            out[s, r0:r0 + e.numel()] = (
                (code[:, :, None] == b) & keep).reshape(-1, LANES)
    return out


def mask_weights(q: torch.Tensor) -> torch.Tensor:
    """(m,) int64 query signatures -> (LANES, m) f32 weight columns:
    ``2^p`` at lane ``4p + b`` where the query's base at ``p`` is not
    ``b`` (the JAX engine's ``prelude``, issl_compact.py:767-784)."""
    dev = q.device
    p = torch.arange(LANES // 4, device=dev)
    code = (q[:, None] >> (2 * p)) & 3                              # (m, 20)
    miss = code[:, :, None] != torch.arange(4, device=dev)          # (m, 20, 4)
    pw = torch.pow(2.0, p.float())[None, :, None]
    return (miss * pw).reshape(-1, LANES).t().contiguous()


# -- the kernel -----------------------------------------------------------


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crackling_compact_finder_onehot.restype = i
    lib.crackling_compact_finder_onehot.argtypes = [
        p, ll, p, p, p, p,    # planes, epad, boff, blen, qsig, qsp
        i, i, i, i,           # S, B, qb, n
        i, i, i, i, i,        # chunk, nchmax, superchunk, nsc, max_dist
        p, p, p, p,           # cnt, rsum, rmin, rmax
        i, p]                 # device, stream


KERNEL = KernelLibrary("compact_onehot.cu", _bind)


def compact_finder_onehot(planes: torch.Tensor, boff: torch.Tensor,
                          blen: torch.Tensor, q_sig: torch.Tensor,
                          qsp: torch.Tensor, *, chunk: int, nchmax: int,
                          superchunk: int, max_dist: int) -> FinderOut:
    """The finder (module docstring) on ``planes.device``.

    planes (S, Epad, LANES) int8 one-hot planes of the bucket-aligned
    lists (:func:`onehot_planes`); the other arguments as for
    :func:`~.compact_finder.compact_finder`. A CUDA tensor launches the
    kernel (counted in ``compact_finder_onehot.launches``); a CPU tensor
    runs :func:`compact_finder_onehot_plain`."""
    check_inputs(planes, boff, blen, q_sig, qsp, chunk, nchmax, max_dist,
                 lists_name="planes", lists_dtype=torch.int8, lists_dim=3)
    if planes.shape[2] != LANES:
        raise ValueError(f"planes must have {LANES} lanes, got "
                         f"{planes.shape[2]}")
    if planes.device.type == "cpu":
        return compact_finder_onehot_plain(planes, boff, blen, q_sig, qsp,
                                           chunk=chunk, nchmax=nchmax,
                                           superchunk=superchunk,
                                           max_dist=max_dist)
    if planes.device.type != "cuda":
        raise ValueError(f"no one-hot finder for device {planes.device}")
    lib = KERNEL.get()
    S, B, qb = qsp.shape
    nsc = superchunk_cells(nchmax, superchunk)
    out = alloc_out(S, B, qb, nchmax, nsc, planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = lib.crackling_compact_finder_onehot(
        planes.data_ptr(), planes.shape[1], boff.data_ptr(),
        blen.data_ptr(), q_sig.data_ptr(), qsp.data_ptr(),
        S, B, qb, q_sig.numel(), chunk, nchmax, superchunk, nsc, max_dist,
        out.cnt.data_ptr(), out.rsum.data_ptr(), out.rmin.data_ptr(),
        out.rmax.data_ptr(), planes.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"one-hot finder kernel launch failed: CUDA "
                           f"error {rc}")
    compact_finder_onehot.launches += 1
    return out


compact_finder_onehot.launches = 0


# -- the plain version ----------------------------------------------------


def compact_finder_onehot_plain(planes: torch.Tensor, boff: torch.Tensor,
                                blen: torch.Tensor, q_sig: torch.Tensor,
                                qsp: torch.Tensor, *, chunk: int,
                                nchmax: int, superchunk: int,
                                max_dist: int) -> FinderOut:
    """The same function in plain PyTorch, with the mask taken from the
    planes: per (slice, bucket) with live slots, f32 matmuls of the
    bucket's plane rows (in blocks of rows) by the live slots' weight
    columns, the hit predicate on the mask, and the plain compact
    finder's scatter into chunk cells.

    TF32 is switched off for the products. Operands of 0/1 and powers of
    two are exact in TF32 too, and every partial sum is an integer below
    2^20, so the mask would be exact either way; the flag only keeps the
    product in the same arithmetic on every device."""
    compact_finder_onehot_plain.calls += 1
    dev = planes.device
    S, B, qb = qsp.shape
    n = q_sig.numel()
    acc = ChunkMoments(qsp.shape, chunk, nchmax, dev)
    qid = qsp.long()
    live = (qid >= 0) & (qid < n)
    todo = torch.nonzero(live.any(2) & (blen > 0)).tolist()
    boff_h, blen_h = boff.tolist(), blen.tolist()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s, b in todo:
            js = torch.nonzero(live[s, b]).flatten()
            w = mask_weights(q_sig[qid[s, b, js]])                 # (80, m)
            o, length = boff_h[s][b], blen_h[s][b]
            rows = max(1, PLAIN_PAIR_BLOCK // js.numel())
            for r0 in range(0, length, rows):
                e = planes[s, o + r0:o + min(length, r0 + rows)].float()
                mask = torch.matmul(e, w).long()                   # (rows, m)
                hit = ((popcount(mask) <= max_dist)
                       & ~earlier_slice_clean_mask(mask, s))
                r, k = torch.nonzero(hit, as_tuple=True)
                acc.add((s * B + b) * qb + js[k], r + r0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return acc.finder_out(superchunk)


compact_finder_onehot_plain.calls = 0
