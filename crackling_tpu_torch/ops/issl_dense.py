"""Dense full-scan ISSL engine: every (query, bucket entry) pair scored.

The PyTorch port of crackling_tpu/ops/issl_dense.py::DenseIsslScorer.
One query page runs three steps on the scorer's device, with no host sync
inside the page:

1. **Slot plan** (``issl_compact.plan_slots``): each (slice, bucket) of
   the index gets ``qb`` query slots holding the page's queries whose
   slice value selects that bucket; spare slots hold the padding id
   ``n``. ``qb`` (``issl_compact.plan_query_occupancy``) is the page's
   only data-dependent shape.
2. **Scan** (:func:`~crackling_tpu_torch.ops.fullscan.dense_scan`, the
   hand-written Hopper kernel on CUDA): per slot, the occurrence-weighted
   MIT and CFD sums of every hit (distance <= max_dist, first-clean-slice
   dedup) in its bucket, f32 per-hit terms summed in f64.
3. **Scatter** (:func:`dense_page`): ``index_add_`` of the slot sums into
   per-query f64 sums by the slot plan (duplicate queries hold separate
   slots, padding slots land in a dropped row ``n``).

The JAX engine's weight prelude (``build_weight_consts`` and ``prelude``:
five bf16 weight planes per slot, the mask and the MIT and CFD log-weights
split hi/lo) existed only to feed the TPU's matrix unit; the Hopper
kernel computes the mask and the terms directly, so it is gone.

Full-scan semantics: verdicts exact for mit/cfd/and/or; wrap in
:class:`~crackling_tpu_torch.ops.hybrid.HybridIsslScorer` (whose default
fast engine this is) for reference-exact verdicts on all five methods.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..index.build import IsslIndex
from .fullscan import dense_scan
from .issl_compact import (ALIGN, ScoreTables, aligned_lists,
                           plan_query_occupancy, plan_slots, score_tables)


def dense_page(entries: torch.Tensor, occ: torch.Tensor, boff: torch.Tensor,
               blen: torch.Tensor, q_sig: torch.Tensor, qsp: torch.Tensor,
               *, max_dist: int, tabs: ScoreTables):
    """One device's page: the scan over the slot plan ``qsp`` and the
    scatter of its slot sums into per-query sums; (mit, cfd), each (n,)
    f64 on the index's device. The counterpart of the JAX ``build_run``'s
    ``run``, pure so a sharded engine can wrap it."""
    n = q_sig.numel()
    mit_slots, cfd_slots = dense_scan(entries, occ, boff, blen, q_sig, qsp,
                                      max_dist=max_dist, tabs=tabs)
    with trace.span("dense.scatter"):
        ids = qsp.reshape(-1).long()
        mit = torch.zeros(n + 1, dtype=torch.float64, device=q_sig.device)
        cfd = torch.zeros(n + 1, dtype=torch.float64, device=q_sig.device)
        mit.index_add_(0, ids, mit_slots.reshape(-1))
        cfd.index_add_(0, ids, cfd_slots.reshape(-1))
    return mit[:n], cfd[:n]


class DenseIsslScorer:
    """Single-GPU dense full-scan ISSL scorer (f32 per-hit terms, f64
    sums)."""

    # Near-threshold re-score band advertised to HybridIsslScorer. Kept at
    # the JAX engine's 1.0 (its bf16-split log-matmuls deviate from the
    # binary by up to ~0.05 at mammal bucket depth) although the port's
    # plain-f32 terms are far closer: the band decides which queries the
    # hybrid re-scores, and so which printed scores are early-exit values,
    # and those must be the JAX package's.
    score_band = 1.0

    def __init__(self, index: IsslIndex, max_dist: int | None = None,
                 query_page: int = 65536, chunk: int = 4096,
                 qb_cap: int = 512, device=None):
        self.device = resolve_device(device)
        if index.slice_width != 8 or index.seq_length != 20:
            raise ValueError("dense engine supports l=20, w=8")
        if chunk % ALIGN:
            raise ValueError(f"chunk must be a multiple of {ALIGN}")
        self.index = index
        self.max_dist = index.max_dist if max_dist is None else int(max_dist)
        self.query_page = int(query_page)
        # the JAX kernel's DMA chunk, checked and kept for drop-in callers:
        # the Hopper kernel stages its own tiles and never reads past a
        # bucket, so the lists need no dead tail
        self.chunk = int(chunk)
        self.qb_cap = int(qb_cap)
        self.S = index.slice_count
        self.B = index.bucket_count

        (self.entries, self.occ, self.bucket_offsets,
         self.bucket_lens) = aligned_lists(index, self.device)
        self.tables = score_tables(self.max_dist, self.device)

    def query_tensor(self, page: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(page, dtype=np.uint64).view(np.int64),
            device=self.device)

    def plan(self, q_sig: torch.Tensor, qb: int) -> torch.Tensor:
        with trace.span("dense.plan"):
            return plan_slots(q_sig, self.S, self.B, qb)

    def run_page(self, page: np.ndarray, qb: int):
        """The page program, enqueued: (mit, cfd) f64 device tensors."""
        q_sig = self.query_tensor(page)
        return dense_page(self.entries, self.occ, self.bucket_offsets,
                          self.bucket_lens, q_sig, self.plan(q_sig, qb),
                          max_dist=self.max_dist, tabs=self.tables)

    # -- public API --------------------------------------------------------

    def score_sums(self, query_sigs: np.ndarray):
        """Per-query full-scan MIT and CFD sums (f64 numpy)."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        out_mit = np.zeros(n, dtype=np.float64)
        out_cfd = np.zeros(n, dtype=np.float64)
        pending = []        # (lo_idx, length, device (mit, cfd))

        def run_page(lo_idx, page):
            qb, _needed = plan_query_occupancy(
                page, self.S, self.B, self.index.slice_width, self.qb_cap)
            if qb is None:
                half = page.shape[0] // 2
                if half == 0:
                    raise RuntimeError("query bucket overflow; raise qb_cap")
                run_page(lo_idx, page[:half])
                run_page(lo_idx + half, page[half:])
                return
            pending.append((lo_idx, page.shape[0], self.run_page(page, qb)))

        # enqueue every page (the host plan of page i+1 overlaps the
        # device scan of page i), then drain
        for i in range(0, n, self.query_page):
            run_page(i, sigs[i:i + self.query_page])
        for lo_idx, ln, (m, c) in pending:
            out_mit[lo_idx:lo_idx + ln] = m.cpu().numpy()
            out_cfd[lo_idx:lo_idx + ln] = c.cpu().numpy()
        return out_mit, out_cfd

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)
