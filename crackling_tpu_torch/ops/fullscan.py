"""The full-scan engines' scorers: per-(slice, query) MIT and CFD sums.

For every (slice ``s``, bucket ``b``) of the ISSL index, every entry of
the bucket (in-bucket rank ``r < blen``) and every query of that bucket,
the pair is a **hit** iff

* the Hamming distance (mismatched positions) is ``<= max_dist``;
* no earlier slice ``s' < s`` matches the query exactly (first-clean-
  slice dedup: the hit was counted there).

Each hit adds ``occ x MIT local score`` and ``occ x CFD score`` to the
query's sums for slice ``s``: the f32 terms of the port's
``compact_rescan.pair_scores`` (MIT from the dense table by the 20-bit
mismatch mask, 0 at distance 0; CFD the PAM penalty times the position
penalties in ascending order, exactly 1.0 at distance 0), summed in f64.
Two query layouts, one function:

* :func:`dense_scan` — the dense engine's (S, B, qb) slot plan (id ``n``
  = padding) at w = 8, dedup on the collapsed low word's bytes; out
  (S, B, qb) f64 per slot. Replaces
  crackling_tpu/ops/issl_dense.py::_kernel.
* :func:`bucket_scan` — the scan-style engine's CSR of sorted queries,
  ``qoff`` (S, B+1) and ``qsorted`` (S, n), at any slice width that
  divides 32, dedup on each earlier slice's raw XOR bits; out (S, n) f64
  per (slice, CSR position). Replaces
  crackling_tpu/ops/issl_pallas.py::_kernel.

Each wrapper launches the hand-written Hopper kernel in
``csrc/fullscan.cu`` (built with nvcc at first use, bound with ctypes) on
a CUDA tensor and runs its plain PyTorch version on a CPU tensor; nothing
else, no fallback from one to the other. The plain versions enumerate the
pairs with ``compact_finder.bucket_entry_pairs``; kernel and plain
version differ only in the order of their f64 sums.

The kernels screen every pair by an int8 tensor-core product of one-hot
entry rows, built in registers from the packed words, by the queries'
weight columns, and score only the pairs the screen passes, after the
exact test. :func:`scan_rows` and :func:`scan_columns` build the same
operands in plain PyTorch, lane for lane: K = 64 (the 16 positions
outside the bucket's slice, ``compact_finder.mma_rows``) at w = 8, and
K = 96 (all 20 positions) at the bucket scan's other widths.
"""

from __future__ import annotations

import ctypes

import torch

from .bits import (SIG40, collapse_pairs, earlier_slice_clean,
                   earlier_slice_clean_raw, popcount)
from .compact_finder import (MMA_K, bucket_entry_pairs, mma_columns,
                             mma_rows, onehot_lanes, signed_columns,
                             slot_entry_pairs, weight_lanes)
from .compact_rescan import ScoreTables, check_tensors, pair_scores
from .kernel_build import KernelLibrary


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.crackling_dense_scan.restype = i
    lib.crackling_dense_scan.argtypes = [
        p, p, ll, p, p, p, p,   # entries, occ, epad, boff, blen, qsig, qsp
        i, i, i, i, i,          # S, B, qb, n, max_dist
        p, p, f,                # mit table, penalties, pam
        p, p,                   # out_mit, out_cfd
        i, p]                   # device, stream
    lib.crackling_bucket_scan.restype = i
    lib.crackling_bucket_scan.argtypes = [
        p, p, ll, p, p, p,      # entries, occ, epad, boff, blen, qsig
        p, p,                   # qoff, qsorted
        i, i, i, i, i,          # S, B, n, width, max_dist
        p, p, f,                # mit table, penalties, pam
        p, p,                   # out_mit, out_cfd
        i, p]                   # device, stream


KERNEL = KernelLibrary("fullscan.cu", _bind)


def _index_shapes(entries, occ, boff, blen):
    S, B = boff.shape
    if entries.shape[0] != S or occ.shape != entries.shape \
            or blen.shape != (S, B):
        raise ValueError("entries/occ/boff/blen disagree on (S, B)")
    return S, B


def _empty_sums(shape, device):
    return (torch.zeros(shape, dtype=torch.float64, device=device),
            torch.zeros(shape, dtype=torch.float64, device=device))


def _launch_args(entries, occ, boff, blen, q_sig):
    return (entries.data_ptr(), occ.data_ptr(), entries.shape[1],
            boff.data_ptr(), blen.data_ptr(), q_sig.data_ptr())


def _table_args(tabs):
    return (tabs.mit.data_ptr(), tabs.pen.data_ptr(), tabs.pam)


# -- the dense engine's scan ----------------------------------------------


def dense_scan(entries: torch.Tensor, occ: torch.Tensor, boff: torch.Tensor,
               blen: torch.Tensor, q_sig: torch.Tensor, qsp: torch.Tensor,
               *, max_dist: int, tabs: ScoreTables):
    """Per-slot full-scan sums (module docstring) on ``entries.device``.

    entries (S, Epad) int64 bucket-aligned packed site signatures and occ
    (S, Epad) int32 their occurrences (one slice per row); boff (S, B)
    int64 bucket starts within a row; blen (S, B) int32 bucket lengths;
    q_sig (n,) int64 query signatures; qsp (S, B, qb) int32 slot plan
    (query id per slot, ``n`` = padding); w = 8, so S <= 5. Returns
    (mit, cfd), each (S, B, qb) f64, 0 at padding slots. A CUDA tensor
    launches the kernel (counted in ``dense_scan.launches``); a CPU tensor
    runs :func:`dense_scan_plain`."""
    check_tensors((("entries", entries, torch.int64, 2),
            ("occ", occ, torch.int32, 2), ("boff", boff, torch.int64, 2),
            ("blen", blen, torch.int32, 2), ("q_sig", q_sig, torch.int64, 1),
            ("qsp", qsp, torch.int32, 3)), max_dist, tabs)
    S, B = _index_shapes(entries, occ, boff, blen)
    if qsp.shape[:2] != (S, B) or qsp.shape[2] < 1:
        raise ValueError("qsp must be (S, B, qb) with qb >= 1")
    if not 1 <= S <= 5:
        raise ValueError("the dense scan takes 1..5 slices (l=20, w=8)")
    if q_sig.numel() >= (1 << 31):
        raise ValueError("query page too large for int32 slot ids")
    if entries.device.type == "cpu":
        return dense_scan_plain(entries, occ, boff, blen, q_sig, qsp,
                                max_dist=max_dist, tabs=tabs)
    if entries.device.type != "cuda":
        raise ValueError(f"no dense scan for device {entries.device}")
    lib = KERNEL.get()
    qb = qsp.shape[2]
    dev = entries.device
    mit, cfd = _empty_sums((S, B, qb), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.crackling_dense_scan(
        *_launch_args(entries, occ, boff, blen, q_sig), qsp.data_ptr(),
        S, B, qb, q_sig.numel(), max_dist, *_table_args(tabs),
        mit.data_ptr(), cfd.data_ptr(), dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"dense scan kernel launch failed: CUDA error "
                           f"{rc}")
    dense_scan.launches += 1
    return mit, cfd


dense_scan.launches = 0


def _hit_sums(pairs, out_mit, out_cfd, occ, max_dist, tabs, clean):
    """Score every hit of the pair blocks and add occ x term into the
    flat f64 sums at the pair's slot; ``clean(pb, x)`` is the dedup test
    (True where an earlier slice matches exactly)."""
    occ_f = occ.reshape(-1)
    for pb in pairs:
        x = (pb.e ^ pb.q) & SIG40
        hit = (popcount(collapse_pairs(x)) <= max_dist) & ~clean(pb, x)
        h = torch.nonzero(hit).flatten()
        if not h.numel():
            continue
        _, mit, cfd = pair_scores(pb.q[h], pb.e[h][:, None], tabs)
        w = occ_f[pb.at[h]].double()
        out_mit.index_add_(0, pb.slot[h], mit[:, 0].double() * w)
        out_cfd.index_add_(0, pb.slot[h], cfd[:, 0].double() * w)


def dense_scan_plain(entries: torch.Tensor, occ: torch.Tensor,
                     boff: torch.Tensor, blen: torch.Tensor,
                     q_sig: torch.Tensor, qsp: torch.Tensor, *,
                     max_dist: int, tabs: ScoreTables):
    """The same function in plain PyTorch: the hit predicate and the
    per-pair terms on every (slot, entry) pair
    (``compact_finder.slot_entry_pairs``), dedup on the collapsed low
    word's bytes (``bits.earlier_slice_clean``)."""
    dense_scan_plain.calls += 1
    mit, cfd = _empty_sums(qsp.numel(), entries.device)
    _hit_sums(slot_entry_pairs(entries, boff, blen, q_sig, qsp), mit, cfd,
              occ, max_dist, tabs,
              lambda pb, x: earlier_slice_clean(collapse_pairs(x), pb.sl))
    return mit.view(qsp.shape), cfd.view(qsp.shape)


dense_scan_plain.calls = 0


# -- the scan-style engine's scan -----------------------------------------


def bucket_scan(entries: torch.Tensor, occ: torch.Tensor,
                boff: torch.Tensor, blen: torch.Tensor, q_sig: torch.Tensor,
                qoff: torch.Tensor, qsorted: torch.Tensor, *,
                slice_width: int, max_dist: int, tabs: ScoreTables):
    """Per-(slice, CSR position) full-scan sums (module docstring) on
    ``entries.device``.

    entries / occ / boff / blen as for :func:`dense_scan`; qoff (S, B+1)
    int32 the start of each bucket's range in ``qsorted`` (S, n) int32,
    the page's query ids sorted by their slice-``s`` value; slice_width
    even and dividing 32 (no slice straddles the two 32-bit words).
    Returns (mit, cfd), each (S, n) f64. A CUDA tensor launches the
    kernel (counted in ``bucket_scan.launches``); a CPU tensor runs
    :func:`bucket_scan_plain`."""
    check_tensors((("entries", entries, torch.int64, 2),
            ("occ", occ, torch.int32, 2), ("boff", boff, torch.int64, 2),
            ("blen", blen, torch.int32, 2), ("q_sig", q_sig, torch.int64, 1),
            ("qoff", qoff, torch.int32, 2),
            ("qsorted", qsorted, torch.int32, 2)), max_dist, tabs)
    S, B = _index_shapes(entries, occ, boff, blen)
    n = q_sig.numel()
    if qoff.shape != (S, B + 1) or qsorted.shape != (S, n):
        raise ValueError("qoff must be (S, B+1) and qsorted (S, n)")
    if slice_width % 2 or 32 % slice_width or B != 1 << slice_width \
            or S * slice_width > 40:
        raise ValueError(f"slice width {slice_width} must be even, divide "
                         "32 and match the index")
    if S * n >= (1 << 62) or n >= (1 << 31):
        raise ValueError("query page too large for int32 query ids")
    if entries.device.type == "cpu":
        return bucket_scan_plain(entries, occ, boff, blen, q_sig, qoff,
                                 qsorted, slice_width=slice_width,
                                 max_dist=max_dist, tabs=tabs)
    if entries.device.type != "cuda":
        raise ValueError(f"no bucket scan for device {entries.device}")
    lib = KERNEL.get()
    dev = entries.device
    mit, cfd = _empty_sums((S, n), dev)
    if n == 0:
        return mit, cfd
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.crackling_bucket_scan(
        *_launch_args(entries, occ, boff, blen, q_sig), qoff.data_ptr(),
        qsorted.data_ptr(), S, B, n, slice_width, max_dist,
        *_table_args(tabs), mit.data_ptr(), cfd.data_ptr(), dev.index or 0,
        stream)
    if rc != 0:
        raise RuntimeError(f"bucket scan kernel launch failed: CUDA error "
                           f"{rc}")
    bucket_scan.launches += 1
    return mit, cfd


bucket_scan.launches = 0


def bucket_scan_plain(entries: torch.Tensor, occ: torch.Tensor,
                      boff: torch.Tensor, blen: torch.Tensor,
                      q_sig: torch.Tensor, qoff: torch.Tensor,
                      qsorted: torch.Tensor, *, slice_width: int,
                      max_dist: int, tabs: ScoreTables):
    """The same function in plain PyTorch: every CSR position is a slot
    of its bucket (``compact_finder.bucket_entry_pairs``), dedup on the
    earlier slices' raw XOR bits (``bits.earlier_slice_clean_raw``)."""
    bucket_scan_plain.calls += 1
    S, B = boff.shape
    n = q_sig.numel()
    mit, cfd = _empty_sums(S * n, entries.device)
    counts = (qoff[:, 1:] - qoff[:, :-1]).reshape(-1).long()
    sb = torch.repeat_interleave(
        torch.arange(S * B, device=entries.device), counts)
    pairs = bucket_entry_pairs(entries, boff, blen, q_sig,
                               qsorted.reshape(-1).long(), sb)
    _hit_sums(pairs, mit, cfd, occ, max_dist, tabs,
              lambda pb, x: earlier_slice_clean_raw(x, pb.sl, slice_width,
                                                    S))
    return mit.view(S, n), cfd.view(S, n)


bucket_scan_plain.calls = 0


# -- the kernels' operands, in plain PyTorch ------------------------------

ALL_K = 96            # product lanes at widths other than 8: 20 x 4 + 16
_ONES = 0x01010101


def _register_bytes(regs: torch.Tensor) -> torch.Tensor:
    """(n, 4) 32-bit registers of threads t = 0..3 -> (n, 16) lanes
    ``4 t + m`` (byte ``m`` of thread ``t``'s register)."""
    m = torch.arange(4, device=regs.device)
    return ((regs[:, :, None] >> (8 * m)) & 0xFF).reshape(-1, 16)


def _high_codes(sig: torch.Tensor) -> torch.Tensor:
    """(n,) int64 signatures -> (n, 4) the codes of positions 16..19."""
    t = torch.arange(4, device=sig.device)
    return (sig[:, None] >> (32 + 2 * t)) & 3


def scan_rows(sig: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """(n,) int64 entry signatures of a bucket of slice ``s`` of an index
    of slice width ``width`` -> the A rows the full-scan kernels build
    from packed words, int8: at w = 8 (n, MMA_K), the 16 positions outside
    slice ``s`` (``compact_finder.mma_rows``); else (n, ALL_K), all 20
    positions: lanes 0-63 positions 0-15 (the low word) in ``mma_rows``'
    layout, lane ``64 + 4 t + m`` 1 iff position ``16 + t`` has base
    ``m`` (byte ``m`` of the register ``1 << 8 code``), lanes 80-95 0."""
    if width == 8:
        return mma_rows(sig, s)
    high = _register_bytes(1 << (8 * _high_codes(sig)))
    return torch.cat([onehot_lanes(sig & 0xFFFFFFFF), high,
                      torch.zeros_like(high)], 1).to(torch.int8)


def scan_columns(q: torch.Tensor, s: int, width: int, live: torch.Tensor,
                 max_dist: int | None = None) -> torch.Tensor:
    """(m,) int64 query signatures of slice ``s`` and their liveness ->
    the kernels' (K, m) int8 weight columns for :func:`scan_rows`: 1 at
    the lanes of the bases a live query does not have, 2 at every lane of
    a padding column (lanes 80-95: 0); with ``max_dist``, position 0's
    four weights lowered by ``max_dist + 1``, so a row's product is its
    distance less ``max_dist + 1`` (at w = 8 the distance outside slice
    ``s``, which is the whole distance within a bucket)."""
    if width == 8:
        return mma_columns(q, s, live, max_dist)
    regs = torch.where(live[:, None], (1 << (8 * _high_codes(q))) ^ _ONES,
                       2 * _ONES)
    high = _register_bytes(regs)
    return signed_columns(torch.cat([
        weight_lanes(q & 0xFFFFFFFF, live, max_dist), high,
        torch.zeros_like(high)], 1))


def scan_k(width: int) -> int:
    """The kernels' product depth at slice width ``width``."""
    return MMA_K if width == 8 else ALL_K
