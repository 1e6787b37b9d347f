"""The MXU engine's exact replay: each query's hits summed in f64 in the
reference's scan order, frozen at the reference's early exit
(isslScoreOfftargets.cpp:308-511).

Step 4 of the MXU engine's page (``issl_mxu.MxuIsslScorer.score``). Its
input is the page's hit table as the decode leaves it, rows (query, slice,
site id, flat entry position in the aligned lists) in any order, and per
query its own site (id, -1 where the index lacks it, and occurrences). For
each query:

1. **Order.** Its rows, and its own site once as (slice 0, id), sorted by
   the key (slice, site id). A query's hits in one slice lie in one bucket,
   whose list is in id order, so this is the reference's scan order. The
   own site lies in every slice's bucket and is kept in the first.
2. **Dedup.** The finder reports a site in exactly the slices where it
   equals the query (discovery parity), so a hit in slice ``s`` repeats an
   earlier one iff query and site agree in some slice ``s' < s``: the
   reference's first occurrence, with one test a hit.
3. **Terms in f64.** MIT: the local score of the 20-bit mismatch mask in
   the reference's map (0 at distance 0, and for a mask the map lacks)
   times the occurrences. CFD: the PAM penalty times
   ``pen[p, q_p << 2 | (o_p ^ 3)]`` over the mismatched positions in
   ascending order (exactly 1.0 at distance 0) times the occurrences.
4. **Sums.** The kept terms added in key order, one query at a time, with
   the method's exit test against ``maximum_sum`` (``native/replay.cpp``).

A query with no hit and no own site sums to (0, 0); one with its own site
alone to (0, occurrences).

Two implementations of the same function, equal bit for bit:

* :func:`mxu_replay` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/mxu_replay.cu`` (built with nvcc at first use,
  bound with ctypes): a histogram of the rows by query, a scan, a scatter
  into each query's segment, and a block a query that sorts its keys in
  shared memory (in its global segment past ``SHARED_HITS`` rows, counted
  as spilled) and walks its terms in one thread. On a CPU tensor it runs
  the plain version. Nothing else: no fallback from one to the other.
* :func:`mxu_replay_plain` — plain PyTorch on CPU tensors: a stable sort
  by (query, key), the same dedup test and terms, and the walk in
  ``native/replay.cpp`` (a Python loop without a host toolchain).

Replaces crackling_tpu/ops/issl_mxu.py::_replay_page (host numpy; the JAX
package has no kernel for this step).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .bits import collapse_pairs, compress_even_bits, \
    earlier_slice_clean_raw
from .kernel_build import KernelLibrary

# keys a kernel block sorts in shared memory (csrc/mxu_replay.cu kShared);
# a query with more rows sorts them in its global segment
SHARED_HITS = 1024
METHODS = {"mit": 0, "cfd": 1, "and": 2, "or": 3, "avg": 4}


class ReplayTables(NamedTuple):
    """A few KB a device holds for the replay (the kernel searches the MIT
    map, so no block of the allocator's large pool is pinned by it)."""
    mit_masks: torch.Tensor   # (K,) int32 the MIT map's 20-bit masks, sorted
    mit: torch.Tensor         # (K,) f64 their local MIT scores
    pen: torch.Tensor         # (20, 16) f64 CFD position penalties
    pam: float                # CFD PAM (NGG) penalty


class Replay(NamedTuple):
    sums: torch.Tensor     # (n, 2) f64 MIT and CFD sums
    spilled: torch.Tensor  # (1,) int64 queries past SHARED_HITS rows


@lru_cache(maxsize=4)
def _mit_map(seq_length: int, max_dist: int):
    """The local MIT scores (``precalculated_mit_scores``, the map the
    reference's index stores) as sorted 20-bit position masks and their
    scores, closed by the mask 2^20 (no 20-bit mask's) with score 0."""
    from .tables import precalculated_mit_scores

    pre = precalculated_mit_scores(seq_length, max_dist)
    masks = compress_even_bits(torch.as_tensor(np.fromiter(
        pre.keys(), dtype=np.int64, count=len(pre))))
    order = torch.argsort(masks)
    scores = torch.as_tensor(np.fromiter(pre.values(), dtype=np.float64,
                                         count=len(pre)))
    return (torch.cat([masks[order], torch.tensor([1 << 20])]).int(),
            torch.cat([scores[order], torch.zeros(1, dtype=torch.float64)]))


def replay_tables(seq_length: int, max_dist: int, device) -> ReplayTables:
    from .tables import (CFD_PAM_NGG_INDEX, cfd_pam_penalties,
                         cfd_pos_penalties)

    masks, scores = _mit_map(seq_length, max_dist)
    return ReplayTables(
        masks.to(device), scores.to(device),
        torch.as_tensor(cfd_pos_penalties(), device=device),
        float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX]))


def maximum_sum(threshold: float) -> float:
    """The sum past which the reference stops a query's scan."""
    return (10000.0 - threshold * 100.0) / threshold


def check_inputs(hits, q_sig, own, entries, occ, tabs, method,
                 slice_width):
    dev = entries.device
    for name, t, dt, nd in (("hits", hits, torch.int64, 2),
                            ("q_sig", q_sig, torch.int64, 1),
                            ("own", own, torch.int64, 2),
                            ("entries", entries, torch.int64, 1),
                            ("occ", occ, torch.int32, 1),
                            ("tabs.mit_masks", tabs.mit_masks, torch.int32,
                             1),
                            ("tabs.mit", tabs.mit, torch.float64, 1),
                            ("tabs.pen", tabs.pen, torch.float64, 2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, entries on {dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d {dt} tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if t is not hits and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hits.shape[0] != 4 or hits.stride(1) != 1:
        raise ValueError("hits must be (4, H) rows (query, slice, site id, "
                         "entry position), each contiguous")
    n = q_sig.numel()
    if own.shape != (2, n):
        raise ValueError("own must be a (2, n) tensor (site id, "
                         "occurrences) beside q_sig's n queries")
    if occ.numel() != entries.numel():
        raise ValueError("entries and occ differ in length")
    if tabs.mit.shape != tabs.mit_masks.shape or tabs.mit.numel() < 1 \
            or tabs.pen.shape != (20, 16):
        raise ValueError("tables must be the MIT map's masks and scores "
                         "(replay_tables), and the (20, 16) CFD penalties")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if n >= 1 << 31 or not 1 <= slice_width <= 32:
        raise ValueError("the replay takes fewer than 2^31 queries and "
                         "slices 1-32 bits wide")


# -- the kernel -----------------------------------------------------------


def _bind(lib):
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    lib.crackling_mxu_replay.restype = i
    lib.crackling_mxu_replay.argtypes = [
        p, p, p, p, ll,       # hq, hs, hid, hpos, rows
        p, p, p, i,           # qsig, own id, own occurrences, n
        p, p, p, p, i, p, d,  # entries, occ, MIT masks, scores, count,
                              # penalties, pam
        i, d, i,              # method, maximum_sum, slice width
        p, p, p, p,           # counts, offsets, keys, positions
        p, p,                 # sums, spilled
        i, p]                 # device, stream


KERNEL = KernelLibrary("mxu_replay.cu", _bind)


def mxu_replay(hits: torch.Tensor, q_sig: torch.Tensor, own: torch.Tensor,
               entries: torch.Tensor, occ: torch.Tensor, tabs: ReplayTables,
               *, method: str, maximum_sum: float,
               slice_width: int) -> Replay:
    """The replay (module docstring) on ``entries.device``.

    hits (4, H) int64 rows (query, slice, site id, flat entry position),
    each row contiguous; q_sig (n,) int64 query signatures; own (2, n)
    int64 each query's site id (-1: not in the index) and occurrences;
    entries (E,) int64 and occ (E,) int32 the flat aligned lists the
    positions index; tabs: :func:`replay_tables`. A CUDA tensor launches
    the kernel once (counted in ``mxu_replay.launches``); a CPU tensor runs
    :func:`mxu_replay_plain`."""
    check_inputs(hits, q_sig, own, entries, occ, tabs, method, slice_width)
    kw = dict(method=method, maximum_sum=maximum_sum,
              slice_width=slice_width)
    dev = entries.device
    if dev.type == "cpu":
        return mxu_replay_plain(hits, q_sig, own, entries, occ, tabs, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no exact replay for device {dev}")
    n, H = q_sig.numel(), hits.shape[1]
    sums = torch.empty((n, 2), dtype=torch.float64, device=dev)
    spilled = torch.empty(1, dtype=torch.int64, device=dev)
    if n == 0:
        return Replay(sums, spilled.zero_())
    lib = KERNEL.get()
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int64, device=dev)
    keys = torch.empty(H + n, dtype=torch.int64, device=dev)
    pos = torch.empty(H + n, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.crackling_mxu_replay(
        *(hits[k].data_ptr() for k in range(4)), H, q_sig.data_ptr(),
        own[0].data_ptr(), own[1].data_ptr(), n, entries.data_ptr(),
        occ.data_ptr(), tabs.mit_masks.data_ptr(), tabs.mit.data_ptr(),
        tabs.mit.numel(), tabs.pen.data_ptr(), tabs.pam,
        METHODS[method], maximum_sum, slice_width, cnt.data_ptr(),
        offsets.data_ptr(), keys.data_ptr(), pos.data_ptr(),
        sums.data_ptr(), spilled.data_ptr(), dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"exact replay kernel launch failed: CUDA error "
                           f"{rc}")
    mxu_replay.launches += 1
    return Replay(sums, spilled)


mxu_replay.launches = 0


def scratch_bytes(hit_rows: int, queries: int) -> int:
    """Device bytes :func:`mxu_replay` allocates for a page: each row's key
    and position (16 B), and per query the same for its own site, its
    count, offset and sums (44 B)."""
    return 16 * hit_rows + 44 * queries + 16


# -- the plain version ----------------------------------------------------


def mxu_replay_plain(hits: torch.Tensor, q_sig: torch.Tensor,
                     own: torch.Tensor, entries: torch.Tensor,
                     occ: torch.Tensor, tabs: ReplayTables, *, method: str,
                     maximum_sum: float, slice_width: int) -> Replay:
    """The same function in plain PyTorch on CPU tensors: every row and own
    site sorted by (query, key), the dedup test and the terms elementwise,
    and each query's walk in ``native/replay.cpp``."""
    from .. import native

    mxu_replay_plain.calls += 1
    n = q_sig.numel()
    hq, hs, hid, hpos = hits
    sid, socc = own
    with_own = torch.nonzero(sid >= 0).flatten()
    q = torch.cat([hq, with_own])
    key = torch.cat([(hs << 32) | hid, sid[with_own]])
    pos = torch.cat([hpos, torch.full_like(with_own, -1)])
    o = torch.sort(key, stable=True).indices
    o = o[torch.sort(q[o], stable=True).indices]
    q, key, pos = q[o], key[o], pos[o]
    counts = torch.bincount(q, minlength=n)
    starts = torch.zeros(n + 1, dtype=torch.int64)
    torch.cumsum(counts, 0, out=starts[1:])

    is_own = pos < 0
    at = pos.clamp(min=0)
    qs = q_sig[q]
    x = torch.where(is_own, 0, entries[at] ^ qs)
    s = key >> 32
    slices = int(s.max()) + 1 if s.numel() else 1
    keep = ~earlier_slice_clean_raw(x, s, slice_width, slices)
    o_f = torch.where(is_own, socc[q], occ[at].long()).double()
    m20 = compress_even_bits(collapse_pairs(x))
    dist0 = m20 == 0
    zero = torch.zeros(q.numel(), dtype=torch.float64)
    if method != "cfd":
        # the map's masks end in 2^20, so every search lands in it
        at_map = torch.searchsorted(tabs.mit_masks, m20.int())
        score = torch.where(tabs.mit_masks[at_map] == m20, tabs.mit[at_map],
                            0.0)
        mit_c = torch.where(dist0, 0.0, score) * o_f
    else:
        mit_c = zero
    if method != "mit":
        # position by position in ascending order, as the reference's loop
        # (a factor of exactly 1.0 where the bases agree)
        c = torch.full((q.numel(),), tabs.pam, dtype=torch.float64)
        e = qs ^ x
        for p in range(20):
            qc, ec = (qs >> (2 * p)) & 3, (e >> (2 * p)) & 3
            c = c * torch.where(qc != ec, tabs.pen[p, (qc << 2) | (ec ^ 3)],
                                1.0)
        cfd_c = torch.where(dist0, 1.0, c) * o_f
    else:
        cfd_c = zero

    acc = native.replay_accumulate_native(
        starts.numpy(), mit_c.numpy(), cfd_c.numpy(), keep.numpy(), method,
        maximum_sum)
    if acc is None:
        acc = _walk(starts.tolist(), mit_c.tolist(), cfd_c.tolist(),
                    keep.tolist(), method, maximum_sum)
    sums = torch.stack([torch.as_tensor(a) for a in acc], 1)
    spilled = (counts > SHARED_HITS).sum().reshape(1)
    return Replay(sums, spilled)


mxu_replay_plain.calls = 0


def _walk(starts, mit_c, cfd_c, keep, method, maximum_sum):
    """``native/replay.cpp`` in Python: each group's kept terms added in
    order until the method's exit test holds."""
    ms, ccs = [], []
    for g in range(len(starts) - 1):
        m = cc = 0.0
        for i in range(starts[g], starts[g + 1]):
            if not keep[i]:
                continue
            m += mit_c[i]
            cc += cfd_c[i]
            if method == "and":
                stop = m > maximum_sum and cc > maximum_sum
            elif method == "or":
                stop = m > maximum_sum or cc > maximum_sum
            elif method == "avg":
                stop = (m + cc) / 2.0 > maximum_sum
            elif method == "mit":
                stop = m > maximum_sum
            else:
                stop = cc > maximum_sum
            if stop:
                break
        ms.append(m)
        ccs.append(cc)
    return np.array(ms, dtype=np.float64), np.array(ccs, dtype=np.float64)
