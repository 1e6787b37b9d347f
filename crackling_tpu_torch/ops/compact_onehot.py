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
extra JAX lanes (80..127) are always 0.

Two implementations of the same function:

* :func:`compact_finder_onehot` — the wrapper. On a CUDA tensor it
  launches the hand-written Hopper kernel ``csrc/compact_onehot.cu``
  (nvcc at first use, ctypes); on a CPU tensor it runs the plain version.
  No fallback from one to the other.
* :func:`compact_finder_onehot_plain` — plain PyTorch: per (slice,
  bucket) with live slots, one f32 ``torch.matmul`` of the bucket's plane
  rows by the slots' weight columns, then the hit predicate on that mask
  and the plain compact finder's scatter.

The kernel screens every pair by an int8 tensor-core product with K = 64:
a row's 16-byte piece ``s`` is slice ``s``'s four positions, which every
entry and query of a bucket of slice ``s`` share, so it multiplies the
other four pieces (:func:`screen_rows`) by weight columns of 1 at the
lanes of the bases the query does not have (:func:`screen_columns`,
lowered by ``max_dist + 1`` at the first of those positions). A negative
sum is a candidate, re-tested from its whole row (:func:`row_masks`:
distance and first-clean-slice dedup). :func:`emulate_compact_onehot`
runs that flow in plain PyTorch, for the tests.

Replaces crackling_tpu/ops/issl_compact.py::_finder_kernel_onehot.
"""

from __future__ import annotations

import ctypes

import torch

from .bits import earlier_slice_clean_mask, popcount
from .compact_finder import (PLAIN_PAIR_BLOCK, ChunkMoments, FinderOut,
                             alloc_out, check_inputs, mma_candidates,
                             signed_columns, superchunk_cells)
from .kernel_build import KernelLibrary

LANES = 80                  # one-hot lanes per entry: 4 bases x 20 positions
SCREEN_K = 64               # the kernel's product lanes: 4 of 5 pieces
KERNEL_TILE_ROWS = 256      # the kernel's entry tile (kTileRows)
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


def blocks_per_sm(qb: int, device: torch.device) -> int:
    """Blocks of the kernel one SM of ``device`` holds at a time for a
    plan of ``qb`` slots (CUDA's occupancy calculator)."""
    query = KERNEL.get().crackling_compact_onehot_blocks_per_sm
    query.restype = ctypes.c_int
    query.argtypes = [ctypes.c_int, ctypes.c_int]
    n = query(qb, device.index or 0)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


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


# -- the kernel's operands and flow, in plain PyTorch ---------------------


def screen_pieces(s: int) -> list[int]:
    """The 16-byte pieces (four positions each) of a row the kernel
    multiplies in a bucket of slice ``s``: every piece but ``s``, in
    order."""
    return [p for p in range(LANES // 16) if p != s]


def screen_rows(rows: torch.Tensor, s: int) -> torch.Tensor:
    """(n, LANES) int8 plane rows -> (n, SCREEN_K) int8: the A operand the
    kernel multiplies (pieces :func:`screen_pieces`)."""
    return rows.view(-1, LANES // 16, 16)[:, screen_pieces(s)] \
        .reshape(-1, SCREEN_K)


def screen_columns(q: torch.Tensor, s: int, live: torch.Tensor,
                   max_dist: int | None = None) -> torch.Tensor:
    """(m,) int64 query signatures of slots of slice ``s`` and their
    liveness -> (SCREEN_K, m) int8 weight columns for :func:`screen_rows`:
    lane ``16 i + 4 j + b`` is position ``4 p + j`` (``p`` the i-th piece
    of :func:`screen_pieces`), base ``b``; 1 where a live slot's query does
    not have base ``b`` there, 2 at every lane of a padding slot. With
    ``max_dist``, the first of those positions' four weights are lowered
    by ``max_dist + 1``, so a row with one base there sums to its distance
    outside slice ``s`` less ``max_dist + 1``."""
    k = torch.arange(SCREEN_K)
    pos = 4 * torch.tensor(screen_pieces(s))[k // 16] + (k % 16) // 4
    code = (q[:, None] >> (2 * pos)) & 3                    # (m, K)
    w = (code != k % 4).long()
    if max_dist is not None:
        w[:, :4] -= max_dist + 1
    w = torch.where(live[:, None], w, 2)
    return signed_columns(w & 0xFF)


def row_masks(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, LANES) int8 plane rows and (n,) int64 query signatures -> (n,)
    int64 20-bit mismatch masks, the kernel's re-test of a candidate: bit
    ``p`` set iff the row holds a base at ``p`` that the query does not
    have (the product of the row by the query's 2^p weight column)."""
    p = torch.arange(LANES // 4)
    code = (q[:, None] >> (2 * p)) & 3                      # (n, 20)
    miss = code[:, :, None] != torch.arange(4)              # (n, 20, 4)
    bit = (rows.view(-1, LANES // 4, 4).bool() & miss).any(-1)
    return (bit.long() << p).sum(-1)


def emulate_compact_onehot(planes: torch.Tensor, boff: torch.Tensor,
                           blen: torch.Tensor, q_sig: torch.Tensor,
                           qsp: torch.Tensor, *, chunk: int, nchmax: int,
                           superchunk: int, max_dist: int) -> FinderOut:
    """The kernel's flow in plain PyTorch (same arguments and result): per
    (slice, bucket) with a live slot, the bucket's plane rows in whole
    tiles of KERNEL_TILE_ROWS (here 0 past its end; the kernel's rows there
    hold whatever the stage held, and its rank test drops them) as the
    kernel's K = 64 rows, times every slot's biased column; a negative
    product of a live column and a row within the bucket is a candidate,
    re-tested from its whole row (:func:`row_masks`: distance within
    ``max_dist``, no earlier slice clean) and folded into the chunk
    quads."""
    S, B, qb = qsp.shape
    n = q_sig.numel()
    acc = ChunkMoments(qsp.shape, chunk, nchmax, planes.device)
    ids = qsp.long()
    live = (ids >= 0) & (ids < n)
    for s, b in torch.nonzero(live.any(-1) & (blen > 0)).tolist():
        length, o = int(blen[s, b]), int(boff[s, b])
        rows = torch.zeros((-(-length // KERNEL_TILE_ROWS)
                            * KERNEL_TILE_ROWS, LANES), dtype=torch.int8)
        rows[:length] = planes[s, o:o + length]
        q = q_sig[ids[s, b].clamp(0, n - 1)]
        cand = mma_candidates(
            screen_rows(rows, s), screen_columns(q, s, live[s, b], max_dist),
            torch.arange(rows.shape[0]), length) & live[s, b][None, :]
        r, j = torch.nonzero(cand, as_tuple=True)
        m = row_masks(rows[r], q[j])
        hit = (popcount(m) <= max_dist) & ~earlier_slice_clean_mask(m, s)
        acc.add((s * B + b) * qb + j[hit], r[hit])
    return acc.finder_out(superchunk)
