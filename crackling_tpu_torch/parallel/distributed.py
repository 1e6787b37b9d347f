"""Multi-process ISSL scoring: torch.distributed entry points.

The PyTorch port of crackling_tpu/parallel/distributed.py. A
``('host', 'q', 'shard')`` mesh puts the processes on the host axis and
splits each process's local devices into q x shard; the index is sharded
over (host, shard) site ranges, and the per-query partial sums merge in
one ``all_reduce`` per scoring call (``parallel/sharded.py``).

Each process materialises only its own site ranges: :func:`load_index_range`
reads a site-id slice straight out of a reference-format ``.issl`` file
(signatures by seek, occurrences by one streamed pass over the slice-0
entry list), and the engines' ``from_local_shards`` build on them.

The process group is gloo, over TCP, on every platform: the merge is of
host f64 arrays, and gloo can put two ranks on one card, which NCCL
cannot. Start every process with the coordinator address of process 0
and its own process id; ``[tpu] process-count`` in the pipeline does so.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import IsslIndex
from .sharded import (Mesh, ShardedCompactIsslScorer, ShardedDenseIsslScorer,
                      ShardedIsslScorer, device_grid, shard_bounds)

_HEADER_FIELDS = 6
# a rank that dies leaves the others waiting in a collective: they give up
# after this long
TIMEOUT = timedelta(minutes=5)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int):
    """Join the gloo process group whose rank 0 listens at
    ``coordinator_address`` (``host:port``)."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=TIMEOUT)


def process_count() -> int:
    return (torch.distributed.get_world_size()
            if torch.distributed.is_initialized() else 1)


def process_index() -> int:
    return (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)


def local_devices(device=None, cpu_devices: int = 0) -> list[torch.device]:
    """This process's devices: ``cpu_devices`` CPU devices when asked for
    (the JAX package's virtual CPU devices); the CPU when ``device`` is the
    CPU; on CUDA, every card for a single process, and card ``process id
    % cards`` for each process of a multi-process run."""
    if cpu_devices:
        return [torch.device("cpu")] * int(cpu_devices)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    cards = torch.cuda.device_count()
    if process_count() > 1:
        return [torch.device("cuda", process_index() % cards)]
    return [torch.device("cuda", i) for i in range(cards)]


def host_mesh(n_q: int = 1, shards_per_host: int | None = None,
              devices=None) -> Mesh:
    """``('host', 'q', 'shard')`` mesh: the processes on the host axis,
    this process's ``devices`` (default :func:`local_devices`) split
    ``n_q`` x ``shards_per_host``."""
    grid = device_grid(local_devices() if devices is None else devices,
                       n_q, shards_per_host)
    return Mesh(grid, host=process_index(), hosts=process_count(),
                axis_names=("host", "q", "shard"))


def load_index_range(path: str, lo: int, hi: int) -> IsslIndex:
    """Load sites [lo, hi) of a reference-format .issl file.

    Reads only the signature range (seek) plus one streamed pass over the
    slice-0 entry list for the occurrence counts — never the full index.
    The shard rebuilds its slice CSR locally, which keeps the first-clean-
    slice dedup shard-exact (see parallel/sharded.py docstring).
    """
    with open(path, "rb") as fp:
        header = np.fromfile(fp, dtype=np.uint64, count=_HEADER_FIELDS)
        n, seq_length, _seq_count, slice_width, slice_count, scores_count = (
            int(x) for x in header)
        if not (0 <= lo <= hi <= n):
            raise ValueError(f"site range [{lo}, {hi}) outside 0..{n}")
        sigs_off = 8 * (_HEADER_FIELDS + 2 * scores_count)
        fp.seek(sigs_off + 8 * lo)
        site_sigs = np.fromfile(fp, dtype=np.uint64, count=hi - lo)
    entries_off = (sigs_off + 8 * n
                   + 8 * slice_count * (1 << slice_width))
    slice0 = np.memmap(path, dtype=np.uint64, mode="r",
                       offset=entries_off, shape=(n,))
    ids = (slice0 & np.uint64(0xFFFFFFFF)).astype(np.int64)
    occ_by_id = np.zeros(hi - lo, dtype=np.uint32)
    m = (ids >= lo) & (ids < hi)
    occ_by_id[ids[m] - lo] = (slice0[m] >> np.uint64(32)).astype(np.uint32)
    del slice0
    return IsslIndex(
        seq_length=seq_length,
        slice_width=slice_width,
        seq_count=int(occ_by_id.sum()),
        site_sigs=site_sigs,
        occurrences=occ_by_id,
    )


def _local_shards_of(issl_path: str, mesh: Mesh) -> list[IsslIndex]:
    with open(issl_path, "rb") as fp:
        n = int(np.fromfile(fp, dtype=np.uint64, count=1)[0])
    bounds = shard_bounds(n, mesh.n_shards)
    return [load_index_range(issl_path, *bounds[k])
            for k in mesh.local_shard_ids]


def multihost_scorer(issl_path: str, mesh: Mesh,
                     **kwargs) -> ShardedIsslScorer:
    """The sharded order-exact flat scorer for this process from an .issl
    file, loading only the site ranges this process's shards own."""
    return ShardedIsslScorer.from_local_shards(
        _local_shards_of(issl_path, mesh), mesh, **kwargs)


def multihost_fast_scorer(issl_path: str, mesh: Mesh, **kwargs):
    """The fast multi-process scorer: the compact engine per shard, or the
    dense engine past the compact decoder's bucket-depth bound (a verdict
    every process shares). Same loading contract as
    :func:`multihost_scorer`."""
    local = _local_shards_of(issl_path, mesh)
    try:
        return ShardedCompactIsslScorer.from_local_shards(local, mesh,
                                                          **kwargs)
    except ValueError:
        return ShardedDenseIsslScorer.from_local_shards(local, mesh, **kwargs)
