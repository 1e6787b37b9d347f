"""Multi-device ISSL scoring: site-range index shards, one merge of the sums.

The PyTorch port of crackling_tpu/parallel/sharded.py. The index is split
by **site-id range** (every site keeps all of its slice-bucket entries on
one shard, so the first-clean-slice dedup stays shard-local and exact)
and every shard scores the queries against its own sub-index; the
per-query MIT/CFD partial sums add up to the whole index's. The
10000/(100+sum) transform and thresholding happen after the merge.

Where the JAX package stacks the shards into one SPMD program
(``shard_map`` over a device mesh, ``psum`` inside each page's program),
each shard here holds the port's **single-device engine** over its
sub-index, on its own device, and a process runs its local shards one
after another. Each shard engine runs ``score_sums`` to completion, with
its own paging, retries and overflow splits, so the merge cannot sit
inside a page loop: a process adds its shards' partial sums in f64, and a
mesh that spans processes merges them with **one** ``all_reduce`` (SUM)
per ``score_sums`` call, over gloo on host f64 arrays, the same bits on
every rank (``_all_reduce``). The engines' sums are on the host already; the
merge moves 16 bytes per query.

Early-exit emulation is not applied across shards (the reference's exit
point depends on a global scan order that sharding interleaves); sharded
scoring always computes full sums, which preserves verdicts for the
mit/cfd/and/or methods and the scores of accepted guides everywhere.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import IsslIndex
from ..ops import issl_compact
from ..ops.issl_dense import DenseIsslScorer
from ..ops.issl_flat import IsslScorer


def _site_range(index: IsslIndex, lo: int, hi: int) -> IsslIndex:
    return IsslIndex(
        seq_length=index.seq_length,
        slice_width=index.slice_width,
        seq_count=int(index.occurrences[lo:hi].sum()),
        site_sigs=index.site_sigs[lo:hi].copy(),
        occurrences=index.occurrences[lo:hi].copy(),
    )


def shard_index(index: IsslIndex, n_shards: int) -> list[IsslIndex]:
    """Split an index into ``n_shards`` site-id-contiguous sub-indexes."""
    return [_site_range(index, lo, hi)
            for lo, hi in shard_bounds(index.num_sites, n_shards)]


def shard_bounds(num_sites: int, n_shards: int) -> list[tuple[int, int]]:
    """Deterministic site-range split: every process computes the same
    bounds from the global site count."""
    b = [(num_sites * k) // n_shards for k in range(n_shards + 1)]
    return [(b[k], b[k + 1]) for k in range(n_shards)]


@dataclass(frozen=True)
class Mesh:
    """A process's place in a ``('q', 'shard')`` or ``('host', 'q',
    'shard')`` layout: ``devices[i][k]`` scores query group ``i`` against
    local shard ``k``. The index is split into ``hosts x shards_per_host``
    site ranges; this process holds ranges ``host * shards_per_host + k``.
    A device may be listed more than once (several shards on one card, or
    JAX's virtual CPU devices)."""

    devices: tuple[tuple[torch.device, ...], ...]
    host: int = 0
    hosts: int = 1
    axis_names: tuple[str, ...] = ("q", "shard")

    @property
    def n_q(self) -> int:
        return len(self.devices)

    @property
    def shards_per_host(self) -> int:
        return len(self.devices[0])

    @property
    def n_shards(self) -> int:
        return self.hosts * self.shards_per_host

    @property
    def shape(self) -> dict[str, int]:
        size = {"host": self.hosts, "q": self.n_q,
                "shard": self.shards_per_host}
        return {a: size[a] for a in self.axis_names}

    @property
    def local_shard_ids(self) -> range:
        k = self.shards_per_host
        return range(self.host * k, (self.host + 1) * k)


def device_grid(devices, n_q: int, n_shards: int | None):
    """``devices`` laid out as ``n_q`` rows of ``n_shards`` (default: all
    of them, which ``n_q`` must divide)."""
    devices = [resolve_device(d) for d in devices]
    if n_shards is None:
        if n_q < 1 or len(devices) % n_q:
            raise ValueError(f"mesh-q = {n_q} does not divide the "
                             f"{len(devices)} local devices")
        n_shards = len(devices) // n_q
    if n_q < 1 or n_shards < 1 or n_q * n_shards > len(devices):
        raise ValueError(f"a {n_q} x {n_shards} mesh needs {n_q * n_shards} "
                         f"devices; {len(devices)} are local")
    return tuple(tuple(devices[i * n_shards:(i + 1) * n_shards])
                 for i in range(n_q))


def make_mesh(n_shards: int | None = None, n_q: int = 1,
              devices=None) -> Mesh:
    """A single-process ``('q', 'shard')`` mesh over ``devices`` (default:
    every CUDA card)."""
    if devices is None:
        resolve_device(None)                    # raises without a GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(device_grid(devices, n_q, n_shards))


def _on(device: torch.device):
    """The context that makes ``device`` current: the kernels launch on
    the current CUDA device."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _all_reduce(values: np.ndarray, op) -> None:
    """In-place ``all_reduce`` of a host array over the process group."""
    torch.distributed.all_reduce(torch.from_numpy(values), op=op)


def _max_bucket(shards: list[IsslIndex], mesh: Mesh) -> int:
    """The largest bucket of any shard of the mesh: one ``all_reduce``
    (MAX) when the mesh spans processes, so every process takes the same
    compact-or-dense decision."""
    deepest = np.array([max(int(np.diff(s.bucket_offsets, axis=1).max())
                            for s in shards)], dtype=np.int64)
    if mesh.hosts > 1:
        _all_reduce(deepest, torch.distributed.ReduceOp.MAX)
    return int(deepest[0])


class _ShardedScorer:
    """One single-device engine per (query group, local shard) of a mesh,
    and the merge of their sums. ``make(shard, device)`` builds an
    engine; query groups whose devices coincide share it."""

    def __init__(self, mesh: Mesh, local_shards: list[IsslIndex], make):
        if len(local_shards) != mesh.shards_per_host:
            raise ValueError(f"{len(local_shards)} local shards for a mesh "
                             f"with {mesh.shards_per_host} per process")
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.n_q = mesh.n_q
        self.device = mesh.devices[0][0]
        built = {}
        for row in mesh.devices:
            for k, dev in enumerate(row):
                if (k, dev) not in built:
                    built[k, dev] = make(local_shards[k], dev)
        self.engines = [[built[k, dev] for k, dev in enumerate(row)]
                        for row in mesh.devices]

    @staticmethod
    def _local_shards(index, mesh, local_shards):
        if local_shards is not None:
            return local_shards
        bounds = shard_bounds(index.num_sites, mesh.n_shards)
        return [_site_range(index, *bounds[k]) for k in mesh.local_shard_ids]

    def score_sums(self, query_sigs: np.ndarray):
        """Per-query full-scan MIT and CFD sums over the whole index (f64
        numpy). Query group ``i`` (a contiguous part of the queries) runs
        on row ``i`` of the mesh; each shard engine adds its partial sums,
        and processes merge theirs in one ``all_reduce``."""
        sigs = np.asarray(query_sigs, dtype=np.uint64)
        n = sigs.shape[0]
        sums = np.zeros((2, n), dtype=np.float64)
        for (lo, hi), row in zip(shard_bounds(n, self.n_q), self.engines):
            if hi == lo:
                continue
            for eng in row:
                with _on(eng.device):
                    m, c = eng.score_sums(sigs[lo:hi])
                sums[0, lo:hi] += m
                sums[1, lo:hi] += c
        if self.mesh.hosts > 1 and n:
            _all_reduce(sums, torch.distributed.ReduceOp.SUM)
        return sums[0], sums[1]

    def score(self, query_sigs: np.ndarray):
        mit_sum, cfd_sum = self.score_sums(query_sigs)
        return 10000.0 / (100.0 + mit_sum), 10000.0 / (100.0 + cfd_sum)

    @classmethod
    def from_local_shards(cls, local_shards: list[IsslIndex], mesh: Mesh,
                          **kwargs):
        """Multi-process construction: this process supplies only its own
        site-range shards, in global shard order (``mesh.local_shard_ids``);
        no process materialises the whole index."""
        return cls(None, mesh, local_shards=local_shards, **kwargs)


class ShardedIsslScorer(_ShardedScorer):
    """The order-exact flat engine (``ops/issl_flat.score_page_core``, no
    early exit) per shard: the counterpart of the JAX ``ShardedIsslScorer``,
    f32 with TwoSum-compensated sums by default, as there."""

    def __init__(self, index: IsslIndex | None, mesh: Mesh,
                 max_dist: int | None = None, query_block: int = 256,
                 work_block: int | None = None, dtype=torch.float32, *,
                 local_shards: list[IsslIndex] | None = None):
        super().__init__(
            mesh, self._local_shards(index, mesh, local_shards),
            lambda shard, dev: IsslScorer(
                shard, max_dist=max_dist, query_block=query_block,
                work_block=work_block, dtype=dtype, device=dev))


class ShardedDenseIsslScorer(_ShardedScorer):
    """The dense full-scan engine (``ops/issl_dense.DenseIsslScorer``, the
    ``dense_scan`` kernel on CUDA) per shard. Full-scan semantics: wrap it
    in the hybrid re-score for reference-exact verdicts."""

    # the single-device dense engine's band; the merge adds one f64 sum
    score_band = 1.0

    def __init__(self, index: IsslIndex | None, mesh: Mesh,
                 max_dist: int | None = None, query_page: int = 65536,
                 chunk: int = 4096, qb_cap: int = 512, *,
                 local_shards: list[IsslIndex] | None = None):
        super().__init__(
            mesh, self._local_shards(index, mesh, local_shards),
            lambda shard, dev: DenseIsslScorer(
                shard, max_dist=max_dist, query_page=query_page, chunk=chunk,
                qb_cap=qb_cap, device=dev))


class ShardedCompactIsslScorer(_ShardedScorer):
    """The compact two-phase engine (``ops/issl_compact.CompactIsslScorer``,
    the packed ``compact_finder`` kernel on CUDA) per shard.

    The rank-bound verdict is the mesh's: the largest bucket of any shard
    (of any process, :func:`_max_bucket`) must lie below the moment
    decoder's bound (``issl_compact.RANK_BOUND``, 2^30; the JAX engine's
    is 2^22), as in the JAX engine, so every process builds
    the same engine and advertises the same band. Each shard engine then
    sizes its own moment planes and superchunks from its own buckets, and
    always runs the packed finder (``onehot=False``): the JAX sharded
    program never selects the one-hot finder. Its pages reserve no room
    for the hybrid's exact re-scorer, which over a sharded engine builds
    lists of its own."""

    # the single-device compact engine's band; the merge adds one f64 sum
    score_band = 0.05

    def __init__(self, index: IsslIndex | None, mesh: Mesh,
                 max_dist: int | None = None, query_page: int = 65536,
                 chunk: int = 4096, qb_cap: int = 512,
                 superchunk: int | None = None, *,
                 local_shards: list[IsslIndex] | None = None):
        local_shards = self._local_shards(index, mesh, local_shards)
        deepest = _max_bucket(local_shards, mesh)
        if deepest >= issl_compact.RANK_BOUND:
            raise ValueError(
                f"bucket with {deepest:,} entries exceeds the moment "
                "decoder's rank-exactness bound "
                f"({issl_compact.RANK_BOUND:,} entries)")
        super().__init__(
            mesh, local_shards,
            lambda shard, dev: issl_compact.CompactIsslScorer(
                shard, max_dist=max_dist, query_page=query_page, chunk=chunk,
                qb_cap=qb_cap, superchunk=superchunk, onehot=False,
                reserve=0, device=dev))
