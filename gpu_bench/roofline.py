"""The yardstick's peaks and the least time of each measured piece of work.

The H100's published peaks (NVIDIA's data sheet, SXM, dense, at its 700 W
limit), and frozen copies of ``chip_smoke.py``'s bound arithmetic for the
compact finder and the compact rescan (its ``finder_bound_ms`` and
``rescan_bound_ms``, with the bit helpers of the port's ``ops/bits.py``
they use), so that a later change to either file leaves the yardstick as
it is. ``page_bound_ms`` counts a page's full-scan work from the index and
the queries alone, whatever kernels implement it.
"""

from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
# the published float32 rate outside the tensor cores: the peak table's
# only rate for scalar 32-bit work
H100_ALU_OPS_PER_S = 67e12

# the packed compact finder: per live pair 2 x 64 int8 operations on the
# tensor cores (16 positions outside the bucket's slice x 4 bases) and
# half an epilogue operation; per entry and 64-slot group with a live
# slot, 24 operations to build its one-hot row; the scalar design's 12
# operations per pair kept as the "alu_12op" term
PACKED_K = 64
PACKED_OR_OPS_PER_PAIR = 0.5
PACKED_BUILD_OPS_PER_ENTRY = 24
PACKED_SLOT_GROUP = 64
FINDER_OPS_PER_PAIR = 12
# the compact rescan: ~20 32-bit operations per (row, column) pair of a
# live row and ~64 per hit; six 8-B descriptors per row
RESCAN_OPS_PER_PAIR = 20
RESCAN_HIT_OPS = 64
RESCAN_DESCRIPTOR_BYTES = 6 * 8
# a page's full scan: each (query, slice) pair with every entry of the
# query's bucket in that slice, at the finder's tensor-core count; each
# entry of a touched bucket (8-B signature, 4-B occurrence) read once, each
# query's signature read and its two f64 sums written once
PAGE_ENTRY_BYTES = 12
PAGE_QUERY_BYTES = 8 + 16

SIG40 = (1 << 40) - 1
_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def popcount(x):
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def collapse_pairs(x):
    return (x | (x >> 1)) & _M1


def compress_even_bits(c):
    c = c & _M1
    c = (c | (c >> 1)) & _M2
    c = (c | (c >> 2)) & _M4
    c = (c | (c >> 4)) & _M8
    c = (c | (c >> 8)) & _M16
    return (c | (c >> 16)) & _M32


def earlier_slice_clean(c40, s):
    """True where a slice before ``s`` matches the query exactly."""
    earlier = (torch.ones_like(s) << (8 * s)) - 1
    xb = (c40 & _M32) | (earlier ^ _M32)
    return ((xb - 0x01010101) & ~xb & 0x80808080) != 0


def slice_counts(queries: torch.Tensor, S: int, B: int) -> torch.Tensor:
    """(S, B) int64: the page's queries in each (slice, bucket)."""
    shifts = torch.arange(S, device=queries.device)[:, None] * 8
    vals = (queries[None, :] >> shifts) & (B - 1)
    counts = torch.zeros((S, B), dtype=torch.int64, device=queries.device)
    return counts.scatter_add_(1, vals, torch.ones_like(vals))


def finder_bound_ms(blen, qcount, qb: int, n: int, C: int):
    """Least time of the packed finder on one page: the largest of its
    tensor operations, its ALU operations and its bytes (the lists of
    buckets with a live slot, the plan, the queries, the offsets and the
    output cells, each once). ``blen`` and ``qcount`` are (S, B): bucket
    lengths and the page's live slots. Returns (ms, bound by, live pairs,
    terms in ms)."""
    S, B = blen.shape
    blen = blen.long()
    pairs = int((blen * qcount).sum())
    groups = -(-qcount // PACKED_SLOT_GROUP)
    entry_groups = int((blen * groups).sum())
    nbytes = (int((blen * (qcount > 0)).sum()) * 8 + S * B * qb * 4
              + n * 8 + S * B * 12 + S * B * C * qb * 20)
    terms = {"tensor": pairs * 2 * PACKED_K / H100_INT8_OPS_PER_S,
             "operations": (pairs * PACKED_OR_OPS_PER_PAIR
                            + entry_groups * PACKED_BUILD_OPS_PER_ENTRY)
             / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    terms["alu_12op"] = pairs * FINDER_OPS_PER_PAIR / H100_ALU_OPS_PER_S
    return terms[by] * 1e3, by, pairs, {k: v * 1e3 for k, v in terms.items()}


def rescan_bound_ms(rows, entries, width: int, max_dist: int, n: int):
    """Least time of the rescan on these rows (fields ``ridx``, ``hq``,
    ``start``, ``live``, ``s``, ``q``): the larger of its 32-bit operations
    and its bytes (the distinct chunks' entries, the distinct hits'
    occurrences and table entries, the descriptors, two f64 sums per query
    it adds to), each read once. ``entries`` is the flat packed list.
    Returns (ms, bound by, pairs, hits, terms in ms, entries read)."""
    live_row = (rows.ridx >= 0) & (rows.hq < n)
    cols = torch.arange(width, device=rows.q.device)
    pairs = hits = 0
    hit_pos, hit_mask = [], []
    for k in range(0, rows.ridx.numel(), 4096):
        sl = slice(k, k + 4096)
        inrow = (cols[None, :] < rows.live[sl, None]) & live_row[sl, None]
        pos = rows.start[sl, None] + cols[None, :]
        c40 = collapse_pairs((entries[pos] ^ rows.q[sl, None]) & SIG40)
        hit = (inrow & (popcount(c40) <= max_dist)
               & ~earlier_slice_clean(c40, rows.s[sl, None]))
        pairs += int(inrow.sum())
        hits += int(hit.sum())
        hit_pos.append(pos[hit])
        hit_mask.append(compress_even_bits(c40[hit]))
    starts, inv = torch.unique(rows.start[live_row], return_inverse=True)
    span = torch.zeros_like(starts).scatter_(
        0, inv, rows.live[live_row].clamp(min=0, max=width))
    entries_read = int(span.sum())
    queries = int(torch.unique(rows.hq[live_row]).numel())
    nbytes = (entries_read * 8
              + 4 * int(torch.unique(torch.cat(hit_pos)).numel())
              + 4 * int(torch.unique(torch.cat(hit_mask)).numel())
              + rows.ridx.numel() * RESCAN_DESCRIPTOR_BYTES + queries * 16)
    terms = {"operations": (pairs * RESCAN_OPS_PER_PAIR
                            + hits * RESCAN_HIT_OPS) / H100_ALU_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return (terms[by] * 1e3, by, pairs, hits,
            {k: v * 1e3 for k, v in terms.items()}, entries_read)


def page_bound_ms(blen, qcount, n: int):
    """Least time of one page's full scan, from the index's bucket lengths
    and the page's queries: (ms, bound by, pairs)."""
    blen = blen.long()
    pairs = int((blen * qcount).sum())
    nbytes = (int((blen * (qcount > 0)).sum()) * PAGE_ENTRY_BYTES
              + n * PAGE_QUERY_BYTES)
    terms = {"tensor": pairs * 2 * PACKED_K / H100_INT8_OPS_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by, pairs
