"""The general exact ISSL engine: flat work expansion over (query, slice)
segments.

The PyTorch port of crackling_tpu/ops/issl_jax.py (``IsslScorer`` and
``score_page_core``), named after what it does. It serves ``engine =
xla`` (the CPU's pick and the path for operating points other than
l=20 / w=8), the MXU engine's fallback, the hybrid's last re-scorer and
``scoreOfftargets``. It has no kernel of its own: every step is torch ops
on the scorer's device.

* The reference's per-query pointer walk over inverted lists
  (isslScoreOfftargets.cpp:308-511) becomes a **flat work expansion**:
  every (query, slice) pair contributes the contiguous span of its
  bucket; the spans are concatenated into one flat work axis, processed
  ``work_block`` items per round, and each item finds its segment with
  ``torch.searchsorted``.
* The per-query seen-set becomes the **first-clean-slice dedup**: slice
  ``s`` counts a hit iff no slice ``s' < s`` of the XOR is all zero.
* MIT local scores are computed in **closed form** (``single_score``,
  isslCreateIndex.cpp:93-118); CFD is the reference's per-position
  penalty **product** (isslScoreOfftargets.cpp:399-461).
* Sums are TwoSum-compensated in the compute dtype: f32 on the GPU, f64
  on the CPU (where the compensation term stays ~0).
* With a method and threshold the engine emulates the reference's
  **early exit** (isslScoreOfftargets.cpp:467-496) to the exact hit, and
  a page stops once every query in it has exited.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import IsslIndex
from .bits import bit_length, collapse_pairs, compress_even_bits, ctz, \
    popcount
from .tables import (CFD_PAM_NGG_INDEX, MIT_WEIGHTS, cfd_pam_penalties,
                     cfd_pos_penalties)

# Score methods (reference isslScoreOfftargets.cpp:44,121-143).
METHODS = ("mit", "cfd", "and", "or", "avg")
# flat work items per round: the JAX engine's 2^17 on the CPU; on the GPU
# a round is hundreds of small kernel launches and a host sync, so rounds
# 16x larger amortise them (a 256-query f32 page of the 27 Mbp index ran
# 7.5x faster on an H100, PERF.md)
WORK_BLOCK = {"cpu": 1 << 17, "cuda": 1 << 21}


def default_dtype(device) -> torch.dtype:
    """The engine's compute dtype by the JAX package's rule: f64 on the
    CPU, TwoSum-compensated f32 on the GPU."""
    return (torch.float64 if torch.device(device).type == "cpu"
            else torch.float32)


def _mit_closed_form(mm20, dist, keep_w, dtype):
    """Closed-form MIT local score from the 20-bit mismatch mask, op for
    op as the JAX engine: T1 = prod(1-M[p]) over mismatched p
    (ascending; ``keep_w`` holds 1-M in the compute dtype),
    d = (last-first)/(m-1) (19 when m == 1), T2 = 1/(((19-d)/19)*4+1),
    T3 = 1/m^2; zero when dist == 0."""
    t1 = torch.ones(mm20.shape, dtype=dtype, device=mm20.device)
    for p in range(20):
        is_mm = ((mm20 >> p) & 1) != 0
        t1 = torch.where(is_mm, t1 * keep_w[p], t1)
    m = dist.to(dtype)
    span = (bit_length(mm20) - 1 - ctz(mm20)).to(dtype)
    d = torch.where(dist == 1, 19.0, span / torch.clamp(m - 1.0, min=1.0))
    t2 = 1.0 / ((19.0 - d) / 19.0 * 4.0 + 1.0)
    t3 = 1.0 / torch.clamp(m * m, min=1.0)
    return torch.where(dist > 0, t1 * t2 * t3 * 100.0, 0.0)


def _cfd_product(q, o, dist, pos_pen_flat, pam_ngg, dtype):
    """Per-hit CFD score: product over mismatched positions of
    cfdPosPenalties[pos<<4 | q<<2 | (ot^3)], times the NGG PAM penalty;
    1.0 when dist == 0."""
    cfd = torch.full(q.shape, pam_ngg, dtype=dtype, device=q.device)
    for p in range(20):
        qb = (q >> (2 * p)) & 3
        ob = (o >> (2 * p)) & 3
        pen = pos_pen_flat[p * 16 + (qb << 2) + (ob ^ 3)]
        cfd = torch.where(qb != ob, cfd * pen, cfd)
    return torch.where(dist == 0, 1.0, cfd)


def _two_sum(hi, lo, x):
    """Compensated accumulation: (hi, lo) += x with TwoSum error tracking."""
    s = hi + x
    bb = s - hi
    err = (hi - (s - bb)) + (x - bb)
    return s, lo + err


class ScorerConfig(NamedTuple):
    """Static parameters of the scoring program."""

    slice_count: int
    slice_width: int
    work_block: int
    max_dist: int
    npad: int
    pam_ngg: float
    dtype: str
    method: str | None
    maximum_sum: float | None


def score_page_core(cfg: ScorerConfig, q_sig, q_valid, list_sig, list_occ,
                    bucket_offsets, pos_pen_flat):
    """Score one padded page of queries against one index (shard).

    A pure function of its tensors and the static ``cfg``, all on one
    device: q_sig (Q,) int64 query signatures, q_valid (Q,) bool, list_sig
    (S*npad,) int64 and list_occ (S*npad,) int32 per-slice bucket-sorted
    entries, bucket_offsets (S, B+1) int64 CSR offsets, pos_pen_flat
    (320,) CFD penalties in the compute dtype. Returns raw (mit_sum,
    cfd_sum) of shape (Q,)."""
    dtype = getattr(torch, cfg.dtype)
    dev = q_sig.device
    Q = q_sig.shape[0]
    S = cfg.slice_count
    W = cfg.work_block
    w_bits = cfg.slice_width
    bmask = (1 << w_bits) - 1

    # --- work plan: one segment per (query, slice) ---------------------
    s_idx = torch.arange(S, device=dev)
    vals = (q_sig[:, None] >> (s_idx * w_bits)[None, :]) & bmask   # (Q, S)
    starts = bucket_offsets[s_idx[None, :], vals]
    lens = bucket_offsets[s_idx[None, :], vals + 1] - starts
    lens = torch.where(q_valid[:, None], lens, 0)   # padding does no work
    seg_bucket_start = starts.reshape(-1)           # (Q*S,)
    seg_lens = lens.reshape(-1)
    seg_cum = torch.cumsum(seg_lens, 0)             # inclusive
    seg_work_start = seg_cum - seg_lens
    total = int(seg_cum[-1])
    nrounds = -(-total // W)
    ar_w = torch.arange(W, device=dev)
    bases_per_slice = w_bits // 2
    smask = (1 << bases_per_slice) - 1
    ms = cfg.maximum_sum
    keep_w = torch.as_tensor(1.0 - MIT_WEIGHTS, dtype=dtype, device=dev)

    def exit_cond(mit_tot, cfd_tot):
        """Reference early-exit predicate on the running sums
        (isslScoreOfftargets.cpp:467-496)."""
        m = cfg.method
        if m == "and":
            return (mit_tot > ms) & (cfd_tot > ms)
        if m == "or":
            return (mit_tot > ms) | (cfd_tot > ms)
        if m == "avg":
            return (mit_tot + cfd_tot) / 2.0 > ms
        if m == "mit":
            return mit_tot > ms
        return cfd_tot > ms

    def segment_sum(x, q):
        return torch.zeros(Q, dtype=dtype, device=dev).index_add_(0, q, x)

    def round_body(r, acc):
        mit_hi, mit_lo, cfd_hi, cfd_lo, crossed = acc
        w = r * W + ar_w
        inb = w < total
        seg = torch.searchsorted(seg_cum, w, right=True).clamp(max=Q * S - 1)
        q = seg // S
        s = seg - q * S
        entry = seg_bucket_start[seg] + (w - seg_work_start[seg])
        flat = torch.where(inb, s * cfg.npad + entry, 0)
        o = list_sig[flat]
        occ = list_occ[flat].to(dtype)
        ql = q_sig[q]
        c40 = collapse_pairs(ql ^ o)
        mm20 = compress_even_bits(c40)
        dist = popcount(c40)

        # first-clean-slice dedup: slice s' clean iff its XOR bits are 0
        clean = torch.zeros_like(mm20)
        for sp in range(S):
            c = ((mm20 >> (sp * bases_per_slice)) & smask) == 0
            clean = clean | (c.long() << sp)
        seen_earlier = (clean & ((torch.ones_like(s) << s) - 1)) != 0
        valid = inb & (dist <= cfg.max_dist) & ~seen_earlier

        mit_local = _mit_closed_form(mm20, dist, keep_w, dtype)
        cfd_local = _cfd_product(ql, o, dist, pos_pen_flat, cfg.pam_ngg,
                                 dtype)
        vf = valid.to(dtype) * occ
        mit_c = mit_local * vf          # dist==0 contributes 0 (closed form)
        cfd_c = cfd_local * vf

        if ms is not None:
            # Exact exit emulation. Work items of one query arrive in
            # reference scan order (slice-major, bucket order), so the
            # first item whose *previous* running sums satisfy the exit
            # predicate — and everything after it — is dropped, freezing
            # the totals exactly where the reference breaks.
            all_mit_q = segment_sum(mit_c, q)
            all_cfd_q = segment_sum(cfd_c, q)
            base_mit = (torch.cumsum(all_mit_q, 0) - all_mit_q)[q]
            base_cfd = (torch.cumsum(all_cfd_q, 0) - all_cfd_q)[q]
            prev_mit = (mit_hi + mit_lo)[q] + (torch.cumsum(mit_c, 0)
                                               - mit_c - base_mit)
            prev_cfd = (cfd_hi + cfd_lo)[q] + (torch.cumsum(cfd_c, 0)
                                               - cfd_c - base_cfd)
            drop = crossed[q] | exit_cond(prev_mit, prev_cfd)
            mit_c = torch.where(drop, 0.0, mit_c)
            cfd_c = torch.where(drop, 0.0, cfd_c)

        mit_hi, mit_lo = _two_sum(mit_hi, mit_lo, segment_sum(mit_c, q))
        cfd_hi, cfd_lo = _two_sum(cfd_hi, cfd_lo, segment_sum(cfd_c, q))
        if ms is not None:
            crossed = crossed | exit_cond(mit_hi + mit_lo, cfd_hi + cfd_lo)
        return mit_hi, mit_lo, cfd_hi, cfd_lo, crossed

    zeros = torch.zeros(Q, dtype=dtype, device=dev)
    acc = (zeros, zeros, zeros, zeros,
           torch.zeros(Q, dtype=torch.bool, device=dev))
    for r in range(nrounds):
        # with the exit emulation the page stops as soon as every live
        # query has exited (the vectorized analogue of the reference's
        # break): one host sync per round
        if ms is not None and bool(torch.all(acc[4] | ~q_valid)):
            break
        acc = round_body(r, acc)
    mit_hi, mit_lo, cfd_hi, cfd_lo, _ = acc
    return mit_hi + mit_lo, cfd_hi + cfd_lo


class IsslScorer:
    """Batched exact ISSL scorer resident on one device.

    Parameters
    ----------
    index: the host-side :class:`IsslIndex`.
    max_dist: maximum Hamming distance scored (default ``slice_count -
        1``, which guarantees full recall by pigeonhole).
    query_block: queries per page (padded).
    work_block: flat work items per round (default ``WORK_BLOCK`` of the
        device's type).
    dtype: compute dtype — float32 on the GPU (with compensated
        accumulation), float64 on the CPU for the reference's sums.
    device: ``cuda`` unless the caller asks for the CPU.
    method, threshold: turn on the early-exit emulation.
    """

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 query_block: int = 256, work_block: int | None = None,
                 dtype=torch.float32, device=None,
                 method: str | None = None, threshold: float | None = None):
        if index.slice_width not in (2, 4, 8, 16):
            raise ValueError("slice width must divide 32 bits")
        if method is not None and method not in METHODS:
            raise ValueError(f"unknown score method: {method}")
        self.device = resolve_device(device)
        self.method = method
        self.threshold = threshold
        if method is not None and threshold is not None and threshold > 0:
            self.maximum_sum = (10000.0 - threshold * 100.0) / threshold
        else:
            self.maximum_sum = None
        self.slice_count = index.slice_count
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.query_block = int(query_block)
        self.work_block = int(WORK_BLOCK[self.device.type]
                              if work_block is None else work_block)
        self.dtype = dtype if isinstance(dtype, torch.dtype) \
            else getattr(torch, str(dtype))

        arrs = index.device_arrays()
        dev = self.device
        lo = arrs["list_lo"].reshape(-1).view(np.uint32).astype(np.uint64)
        hi = arrs["list_hi"].reshape(-1).view(np.uint32).astype(np.uint64)
        self.list_sig = torch.as_tensor(
            (lo | (hi << np.uint64(32))).view(np.int64), device=dev)
        self.list_occ = torch.as_tensor(arrs["list_occ"].reshape(-1),
                                        device=dev)
        self.bucket_offsets = torch.as_tensor(
            arrs["bucket_offsets"].astype(np.int64), device=dev)
        self.pos_pen_flat = torch.as_tensor(
            cfd_pos_penalties().reshape(-1), dtype=self.dtype, device=dev)
        self.cfg = ScorerConfig(
            slice_count=self.slice_count,
            slice_width=index.slice_width,
            work_block=self.work_block,
            max_dist=self.max_dist,
            npad=arrs["list_lo"].shape[1],
            pam_ngg=float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX]),
            dtype=str(self.dtype).removeprefix("torch."),
            method=self.method,
            maximum_sum=self.maximum_sum,
        )
        self._score_page = partial(score_page_core, self.cfg)

    def score_sums(self, query_sigs: np.ndarray):
        """Raw per-query (MIT sum, CFD sum) accumulations, f64 on host."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        qb = self.query_block
        mit = np.zeros(n, dtype=np.float64)
        cfd = np.zeros(n, dtype=np.float64)
        for i in range(0, n, qb):
            page = sigs[i:i + qb]
            k = page.shape[0]
            padded = np.zeros(qb, dtype=np.uint64)
            padded[:k] = page
            m, c = self._score_page(
                torch.as_tensor(padded.view(np.int64), device=self.device),
                torch.as_tensor(np.arange(qb) < k, device=self.device),
                self.list_sig, self.list_occ, self.bucket_offsets,
                self.pos_pen_flat)
            mit[i:i + k] = m[:k].cpu().double().numpy()
            cfd[i:i + k] = c[:k].cpu().double().numpy()
        return mit, cfd

    def score(self, query_sigs: np.ndarray):
        """Global per-query scores 10000/(100+sum)
        (isslScoreOfftargets.cpp:505-506)."""
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)
