"""The exact (MXU) engine's neighbour finder: per-(segment, query slot)
neighbour moments.

For every (slice ``s``, bucket ``b``) of the ISSL index, every entry of
the bucket (in-bucket rank ``r < blen``) and every query slot ``j`` of
the page's slot plan, the pair is a **neighbour** iff the Hamming
distance over the ``seq_length`` positions is in ``1..max_dist``: the
query's own site (distance 0) is not one, and there is no dedup across
slices. A slot whose id lies outside ``[0, n)`` is padding and has no
neighbours.

Per segment of ``segw`` consecutive entries (``chunk // 8`` in the
engine: 512 at chunk 4096) and slot the finder emits the neighbour count
(int32) and the sum of their in-bucket ranks (int64), as two planes of
shape (S, B, nseg, qb); segments past a bucket's end read 0. A segment
with one neighbour pins its rank exactly.

Two implementations of the same function:

* :func:`mxu_finder` — the wrapper. On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/mxu_finder.cu`` (built with nvcc at
  first use, bound with ctypes); on a CPU tensor it runs the plain
  version. Nothing else: no fallback from one to the other.
* :func:`mxu_finder_plain` — plain PyTorch over the list of (slot,
  entry) pairs, in bounded blocks; the CPU engine and the reference the
  kernel is held to on the card.

The kernel screens every pair by the full-scan kernels' int8 tensor-core
product (``fullscan.scan_rows`` by ``fullscan.scan_columns``, of the
signatures cut to their 2L bits): K = 64 at slice width 8 (the bucket
count 256), K = 96 at the others. A negative sum (distance within
``max_dist``) is a candidate, re-tested from its packed words and kept
iff its distance lies in ``1..max_dist``. :func:`emulate_mxu_finder` runs
that flow in plain PyTorch, for the tests.

Replaces crackling_tpu/ops/issl_mxu.py::_kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .bits import collapse_pairs, popcount
from .compact_finder import slot_entry_pairs
from .fullscan import scan_columns, scan_k, scan_rows
from .kernel_build import KernelLibrary


class NeighbourPlanes(NamedTuple):
    cnt: torch.Tensor     # (S, B, nseg, qb) int32 neighbour counts
    rsum: torch.Tensor    # (S, B, nseg, qb) int64 sums of in-bucket ranks


def signature_mask(seq_length: int) -> int:
    """The 2L signature bits of an L-mer (int64 mask)."""
    return (1 << (2 * seq_length)) - 1


def _bind(lib):
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint
    lib.crackling_mxu_finder.restype = i
    lib.crackling_mxu_finder.argtypes = [
        p, ll, p, p, p, p,    # entries, epad, boff, blen, qsig, qsp
        i, i, i, i,           # S, B, qb, n
        i, i, i, u, u,        # segw, nseg, max_dist, mask_lo, mask_hi
        p, p,                 # cnt, rsum
        i, p]                 # device, stream


KERNEL = KernelLibrary("mxu_finder.cu", _bind)


def _check(entries, boff, blen, q_sig, qsp, segw, nseg, max_dist,
           seq_length):
    dev = entries.device
    for name, t, dt, nd in (("entries", entries, torch.int64, 2),
                            ("boff", boff, torch.int64, 2),
                            ("blen", blen, torch.int32, 2),
                            ("q_sig", q_sig, torch.int64, 1),
                            ("qsp", qsp, torch.int32, 3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, entries on {dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d {dt} tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S, B, qb = qsp.shape
    if entries.shape[0] != S or boff.shape != (S, B) \
            or blen.shape != (S, B):
        raise ValueError("entries/boff/blen/qsp disagree on (S, B)")
    if segw < 1 or nseg < 1 or qb < 1:
        raise ValueError("segw, nseg and qb must be >= 1")
    if not 1 <= seq_length <= 20:
        raise ValueError("the finder takes seq_length 1..20 (40-bit "
                         "signatures)")
    if not 0 <= max_dist <= seq_length:
        raise ValueError("max_dist must lie in [0, seq_length]")
    if q_sig.numel() >= (1 << 31) or S * B * qb * nseg >= (1 << 62):
        raise ValueError("page too large for the finder's indices")


def mxu_finder(entries: torch.Tensor, boff: torch.Tensor,
               blen: torch.Tensor, q_sig: torch.Tensor, qsp: torch.Tensor,
               *, segw: int, nseg: int, max_dist: int,
               seq_length: int) -> NeighbourPlanes:
    """The finder (module docstring) on ``entries.device``.

    entries (S, Epad) int64 bucket-aligned packed site signatures (one
    slice per row); boff (S, B) int64 bucket starts within a row; blen
    (S, B) int32 bucket lengths; q_sig (n,) int64 query signatures; qsp
    (S, B, qb) int32 slot plan (query id per slot; ids outside ``[0, n)``
    are padding). Buckets must fit ``nseg`` segments of ``segw``. A CUDA
    tensor launches the kernel (counted in ``mxu_finder.launches``); a
    CPU tensor runs :func:`mxu_finder_plain`."""
    _check(entries, boff, blen, q_sig, qsp, segw, nseg, max_dist,
           seq_length)
    kw = dict(segw=segw, nseg=nseg, max_dist=max_dist,
              seq_length=seq_length)
    if entries.device.type == "cpu":
        return mxu_finder_plain(entries, boff, blen, q_sig, qsp, **kw)
    if entries.device.type != "cuda":
        raise ValueError(f"no neighbour finder for device {entries.device}")
    lib = KERNEL.get()
    S, B, qb = qsp.shape
    dev = entries.device
    out = NeighbourPlanes(
        torch.empty((S, B, nseg, qb), dtype=torch.int32, device=dev),
        torch.empty((S, B, nseg, qb), dtype=torch.int64, device=dev))
    mask = signature_mask(seq_length)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.crackling_mxu_finder(
        entries.data_ptr(), entries.shape[1], boff.data_ptr(),
        blen.data_ptr(), q_sig.data_ptr(), qsp.data_ptr(),
        S, B, qb, q_sig.numel(), segw, nseg, max_dist,
        mask & 0xFFFFFFFF, mask >> 32, out.cnt.data_ptr(),
        out.rsum.data_ptr(), dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"neighbour finder kernel launch failed: CUDA "
                           f"error {rc}")
    mxu_finder.launches += 1
    return out


mxu_finder.launches = 0


def mxu_finder_plain(entries: torch.Tensor, boff: torch.Tensor,
                     blen: torch.Tensor, q_sig: torch.Tensor,
                     qsp: torch.Tensor, *, segw: int, nseg: int,
                     max_dist: int, seq_length: int) -> NeighbourPlanes:
    """The same function in plain PyTorch: test every (slot, entry) pair
    (``compact_finder.slot_entry_pairs``) and scatter the neighbours'
    counts and ranks into their segment cells."""
    mxu_finder_plain.calls += 1
    dev = entries.device
    S, B, qb = qsp.shape
    mask = signature_mask(seq_length)
    # cells in the planes' (S, B, nseg, qb) order
    cnt = torch.zeros(S * B * nseg * qb, dtype=torch.int64, device=dev)
    rsum = torch.zeros(S * B * nseg * qb, dtype=torch.int64, device=dev)
    for pb in slot_entry_pairs(entries, boff, blen, q_sig, qsp):
        d = popcount(collapse_pairs((pb.e ^ pb.q) & mask))
        seg = pb.r // segw
        h = torch.nonzero((d >= 1) & (d <= max_dist)
                          & (seg < nseg)).flatten()
        rh = pb.r[h]
        slot = pb.slot[h]
        cell = ((slot // qb) * nseg + seg[h]) * qb + slot % qb
        cnt.index_add_(0, cell, torch.ones_like(rh))
        rsum.index_add_(0, cell, rh)
    return NeighbourPlanes(cnt.view(S, B, nseg, qb).int(),
                           rsum.view(S, B, nseg, qb))


mxu_finder_plain.calls = 0


# -- the kernel's flow, in plain PyTorch ----------------------------------


def screen_width(bucket_count: int) -> int:
    """The slice width the kernel's screen assumes from the bucket count
    (``2^width``): width 8 takes K = 64, any other K = 96."""
    return bucket_count.bit_length() - 1


def emulate_mxu_finder(entries: torch.Tensor, boff: torch.Tensor,
                       blen: torch.Tensor, q_sig: torch.Tensor,
                       qsp: torch.Tensor, *, segw: int, nseg: int,
                       max_dist: int, seq_length: int) -> NeighbourPlanes:
    """The kernel's flow in plain PyTorch (same arguments and result): per
    (slice, bucket) with a live slot, the bucket's first ``nseg * segw``
    entries (in whole 64-entry batches, 0 past its end) and the slots'
    queries, both cut to their 2L bits, as the kernel's rows and biased
    columns (``scan_rows``, ``scan_columns``); a negative product of a
    live column and a row within the bucket is a candidate (the epilogue
    screen of ``compact_finder.mma_candidates``), kept iff its distance
    from the packed words lies in ``1..max_dist``, and added to its
    segment cell. The buckets of a slice go through one batched product,
    padded to the longest."""
    S, B, qb = qsp.shape
    n = q_sig.numel()
    mask = signature_mask(seq_length)
    width = screen_width(B)
    K = scan_k(width)
    cnt = torch.zeros(S * B * nseg * qb, dtype=torch.int64)
    rsum = torch.zeros(S * B * nseg * qb, dtype=torch.int64)
    ids = qsp.long()
    live = (ids >= 0) & (ids < n)
    flat = entries.reshape(-1)
    for s in range(S):
        bs = torch.nonzero(live[s].any(-1) & (blen[s] > 0)).flatten()
        if bs.numel() == 0:
            continue
        lens = blen[s, bs].long().clamp(max=nseg * segw)
        rank = torch.arange(-(-int(lens.max()) // 64) * 64)
        inb = rank < lens[:, None]                         # (nb, rows)
        at = s * entries.shape[1] + boff[s, bs][:, None] + rank
        e = torch.where(inb, flat[at.clamp(max=flat.numel() - 1)], 0) & mask
        q = q_sig[ids[s, bs].clamp(0, n - 1)] & mask       # (nb, qb)
        rows = scan_rows(e.flatten(), s, width).view(bs.numel(), -1, K)
        cols = scan_columns(q.flatten(), s, width, live[s, bs].flatten(),
                            max_dist).view(K, bs.numel(), qb)
        d = rows.int() @ cols.permute(1, 0, 2).int()       # (nb, rows, qb)
        cand = (d < 0) & inb[:, :, None] & live[s, bs][:, None, :]
        i, r, j = torch.nonzero(cand, as_tuple=True)
        dist = popcount(collapse_pairs(e[i, r] ^ q[i, j]))
        keep = (dist >= 1) & (dist <= max_dist)
        i, r, j = i[keep], r[keep], j[keep]
        cell = ((s * B + bs[i]) * nseg + r // segw) * qb + j
        cnt.index_add_(0, cell, torch.ones_like(r))
        rsum.index_add_(0, cell, r)
    return NeighbourPlanes(cnt.view(S, B, nseg, qb).int(),
                           rsum.view(S, B, nseg, qb))
