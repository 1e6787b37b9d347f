"""The one traffic generator: reads a mix from ``traffic/<name>.json``.

A pass sends the genome's candidate guides as Crackling's off-target
stage hands them to the scorer (``Pipeline.process_batch``): the
candidates of the harness's own scan (forward hits, then reverse, in
genome order, duplicates kept) are cut into requests of consecutive
candidates, as consecutive regions of the genome would give; each request
into batches of the configuration's ``page_length`` candidates; and each
batch is deduplicated and sorted by signature, as ``np.unique`` leaves it.

Keys of a mix:

- ``requests_per_pass``: requests a pass cuts the candidates into, of
  equal size (1: one request of the whole genome);
- ``warmup_batches``: batches sent once, from the first, before the
  window;
- ``trace_guides``: a traced run also scores the first this many guides
  of the first batch under the profiler;
- ``check_sample``: guides, drawn from the seed, whose every answer the
  reference checks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .genome import candidate_guides


@dataclass
class Traffic:
    queries: np.ndarray                 # (n,) uint64, in the order sent
    batches: list[tuple[int, int]]      # [lo, hi) of each call, in turn
    sample: np.ndarray                  # sorted positions that are checked
    warmup_batches: int
    trace_guides: int

    def sampled(self, lo: int, hi: int) -> np.ndarray:
        """The checked positions inside ``[lo, hi)``."""
        a, b = np.searchsorted(self.sample, [lo, hi])
        return self.sample[a:b]


def make_traffic(mix: dict, cfg: dict, codes: torch.Tensor,
                 rng: np.random.Generator) -> Traffic:
    cands = candidate_guides(codes)
    if cands.numel() == 0:
        raise ValueError("the genome has no candidate guides")
    page = int(cfg["page_length"])
    parts, batches, lo = [], [], 0
    for request in torch.tensor_split(cands, int(mix["requests_per_pass"])):
        for i in range(0, request.numel(), page):
            # signatures are 40-bit, so int64 sorts them as np.unique sorts
            # the stage's uint64; on the device, the host's sort is slow
            batch = torch.unique(request[i:i + page])
            parts.append(batch)
            batches.append((lo, lo + batch.numel()))
            lo += batch.numel()
    queries = torch.cat(parts).cpu().numpy().view(np.uint64)
    k = min(int(mix["check_sample"]), queries.shape[0])
    sample = np.sort(rng.choice(queries.shape[0], k, replace=False))
    return Traffic(queries, batches, sample, int(mix["warmup_batches"]),
                   int(mix["trace_guides"]))
