"""Scan-style full-scan ISSL engine: bucket-major, queries sorted by bucket.

The PyTorch port of crackling_tpu/ops/issl_pallas.py::PallasIsslScorer
(``[tpu] engine = pallas``). It computes what the dense engine computes,
the per-query full-scan MIT and CFD sums, at any slice width that divides
32, from another query layout: per slice, the page's queries sorted by
their slice value, as a CSR (``qoff`` (S, B+1) bucket starts into
``qsorted`` (S, n) query ids). One page runs three steps on the scorer's
device:

1. **Plan** (:meth:`ScanIsslScorer.plan`): a stable argsort of each
   slice's bucket values and the bucket counts' running sum. The CSR
   covers the page's real queries only (the JAX page pads to
   ``query_page`` with never-matching queries; nothing here needs that).
2. **Scan** (:func:`~crackling_tpu_torch.ops.fullscan.bucket_scan`, the
   hand-written Hopper kernel on CUDA): per (slice, CSR position) the
   occurrence-weighted sums of every hit in that bucket, f32 per-hit
   terms summed in f64; the dedup tests each earlier slice's raw XOR bits.
3. **Scatter**: ``index_add_`` of the position sums into per-query f64
   sums by ``qsorted``.

The JAX engine's ``superchunk`` and ``interpret`` options shaped its TPU
DMA and its interpret mode; the pipeline never passes them and they are
gone. Full-scan semantics: verdicts exact for mit/cfd/and/or; the
pipeline runs this engine without the hybrid re-score, as the JAX
package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..index.build import IsslIndex
from .fullscan import bucket_scan
from .issl_compact import aligned_lists, score_tables


class ScanIsslScorer:
    """Single-GPU bucket-major full-scan ISSL scorer."""

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 query_page: int = 8192, device=None):
        self.device = resolve_device(device)
        w = index.slice_width
        if w > 16 or w % 2:
            raise ValueError("unsupported slice width")
        if 32 % w:
            # a slice straddling bit 32 (w = 10 at l = 20): the JAX engine
            # reads such a slice from the low word alone and mis-buckets
            # its queries and mis-tests its dedup (ROADMAP queue 3)
            raise ValueError(f"slice width {w} lets a slice straddle the "
                             "32-bit word boundary; use 2, 4, 8 or 16")
        self.index = index
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.query_page = int(query_page)
        self.S = index.slice_count
        self.B = index.bucket_count

        (self.entries, self.occ, self.bucket_offsets,
         self.bucket_lens) = aligned_lists(index, self.device)
        self.tables = score_tables(self.max_dist, self.device)

    def query_tensor(self, page: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(page, dtype=np.uint64).view(np.int64),
            device=self.device)

    def plan(self, q_sig: torch.Tensor):
        """Sort the page's queries by bucket, per slice: qoff (S, B+1)
        int32 and qsorted (S, n) int32 (the JAX ``_plan``)."""
        with trace.span("scan.plan"):
            dev = q_sig.device
            S, B, n = self.S, self.B, q_sig.numel()
            shifts = torch.arange(S, device=dev)[:, None] \
                * self.index.slice_width
            vals = (q_sig[None, :] >> shifts) & (B - 1)          # (S, n)
            qsorted = torch.argsort(vals, dim=1, stable=True).int()
            counts = torch.zeros((S, B), dtype=torch.int64, device=dev)
            counts.scatter_add_(1, vals, torch.ones_like(vals))
            qoff = torch.zeros((S, B + 1), dtype=torch.int32, device=dev)
            qoff[:, 1:] = torch.cumsum(counts, 1)
            return qoff, qsorted

    def run_page(self, page: np.ndarray):
        """The page program, enqueued: (mit, cfd) f64 device tensors."""
        q_sig = self.query_tensor(page)
        qoff, qsorted = self.plan(q_sig)
        mit_pos, cfd_pos = bucket_scan(
            self.entries, self.occ, self.bucket_offsets, self.bucket_lens,
            q_sig, qoff, qsorted, slice_width=self.index.slice_width,
            max_dist=self.max_dist, tabs=self.tables)
        with trace.span("scan.scatter"):
            ids = qsorted.reshape(-1).long()
            n = q_sig.numel()
            mit = torch.zeros(n, dtype=torch.float64, device=self.device)
            cfd = torch.zeros(n, dtype=torch.float64, device=self.device)
            mit.index_add_(0, ids, mit_pos.reshape(-1))
            cfd.index_add_(0, ids, cfd_pos.reshape(-1))
        return mit, cfd

    # -- public API --------------------------------------------------------

    def score_sums(self, query_sigs: np.ndarray):
        """Per-query full-scan MIT and CFD sums (f64 numpy)."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        out_mit = np.zeros(n, dtype=np.float64)
        out_cfd = np.zeros(n, dtype=np.float64)
        # enqueue every page, then drain
        pending = [(i, self.run_page(sigs[i:i + self.query_page]))
                   for i in range(0, n, self.query_page)]
        for lo_idx, (m, c) in pending:
            out_mit[lo_idx:lo_idx + m.numel()] = m.cpu().numpy()
            out_cfd[lo_idx:lo_idx + c.numel()] = c.cpu().numpy()
        return out_mit, out_cfd

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)
