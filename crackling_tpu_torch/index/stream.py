"""Memory-bounded off-target extraction and index construction.

Genome-scale equivalent of the reference's external-sort pipeline
(/root/reference/src/crackling/utils/extractOfftargets.py:130-253): the
reference fans out per-FASTA-record regex workers, sorts each temp file,
and k-way heap-merges them. Here the same bound is achieved with:

* a **streaming FASTA scanner** — records are read in large binary
  blocks (newlines stripped with C-level ``bytes.translate``, never a
  per-line Python loop) and scanned in fixed-size chunks (22-byte
  overlap covers windows spanning a boundary), so peak memory is
  independent of genome and record size;
* a **thread pool over scan chunks** — the native scanner, signature
  conversion and run sorting all release the GIL, so chunks fan out
  across cores (the reference's multiprocessing.Pool role,
  extractOfftargets.py:193-253), each worker spilling to its own runs;
* **sorted spill runs** — lexicographic site signatures accumulate in a
  bounded buffer per worker, are sorted (numpy's SIMD sort) and spilled
  as raw uint64 runs;
* a **chunked 2-way merge cascade** — runs are merged pairwise on disk
  (native linear merge, ct_merge_u64), log2(runs) passes, block-buffered,
  independent pairs merged concurrently;
* **streaming consumers** — the sorted-with-duplicates stream is either
  written as the reference's text site list (native OpenMP byte
  assembly; no per-site Python strings) or run-length collapsed directly
  into an :class:`IsslIndex` without ever materialising the raw
  occurrence array.

Within-chunk hit order differs from the reference's (fwd-then-rev per
record vs per chunk) and chunk completion order is nondeterministic
across workers, but the output is sorted, so the site list and the index
are identical.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from .extract import extract_offtarget_sites_seq

# scan chunk (bases) and window overlap; merge/text IO block (signatures)
SCAN_CHUNK = 32 * 1024 * 1024
OVERLAP = 22
IO_BLOCK = 8 * 1024 * 1024
READ_BLOCK = 16 * 1024 * 1024


def _default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def iter_fasta_chunks(path: str | Path,
                      chunk_size: int = SCAN_CHUNK) -> Iterator[bytes]:
    """Yield sequence chunks (headers stripped, newlines removed) with
    OVERLAP bytes of carry between consecutive yields of one record.

    A header line resets the carry, so windows never span two records —
    matching the reference's per-record scan (extractOfftargets.py:64-109).
    Reads in READ_BLOCK binary blocks; sequence lines are concatenated
    with ``bytes.translate`` (a 3.1 Gbp genome has ~31M lines — a
    per-line Python loop costs more than the scan itself).
    """
    carry = b""
    buf = bytearray()
    partial = b""

    with open(path, "rb") as fp:
        at_eof = False
        while not at_eof:
            block = fp.read(READ_BLOCK)
            if block:
                block = partial + block
                cut = block.rfind(b"\n")
                if cut < 0:
                    partial = block
                    continue
                partial, block = block[cut + 1:], block[:cut + 1]
            else:
                at_eof = True
                block = partial  # final line without a trailing newline
                partial = b""
            # `block` is whole lines; split into header / sequence segments
            pos = 0
            end = len(block)
            while pos < end:
                if block[pos] == 0x3E:  # '>' at a line start: header
                    nl = block.find(b"\n", pos)
                    pos = end if nl < 0 else nl + 1
                    if buf:
                        yield carry + bytes(buf)
                        buf = bytearray()
                    carry = b""
                    continue
                nh = block.find(b"\n>", pos)
                seg_end = end if nh < 0 else nh + 1
                buf += block[pos:seg_end].translate(None, b"\n\r ")
                pos = seg_end
                while len(buf) >= chunk_size:
                    chunk = bytes(buf[:chunk_size])
                    yield carry + chunk
                    carry = chunk[-OVERLAP:]
                    del buf[:chunk_size]
        if buf:
            yield carry + bytes(buf)


def _sort_keys(arr: np.ndarray) -> np.ndarray:
    """In-place sort. numpy's SIMD introsort beats the old native LSD
    radix ~6x on this host (0.32s vs 1.96s for 26M u64)."""
    arr.sort()
    return arr


class SpillSorter:
    """Bounded-memory external sorter for uint64 keys.

    ``prefix`` namespaces run files so several sorters (one per scan
    worker) can share one temp directory and merge in a single cascade.
    """

    def __init__(self, tmp_dir: str | Path | None = None,
                 run_size: int = 64 * 1024 * 1024, prefix: str = ""):
        self._dir = Path(tmp_dir) if tmp_dir else Path(
            tempfile.mkdtemp(prefix="crackling_sort_"))
        self._dir.mkdir(parents=True, exist_ok=True)
        self.run_size = int(run_size)
        self.prefix = prefix
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._runs: list[Path] = []
        self.total = 0

    def add(self, keys: np.ndarray) -> None:
        if keys.size == 0:
            return
        self._buf.append(np.ascontiguousarray(keys, dtype=np.uint64))
        self._buffered += keys.size
        self.total += keys.size
        if self._buffered >= self.run_size:
            self._spill()

    def _spill(self) -> None:
        arr = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
        self._buf, self._buffered = [], 0
        arr = _sort_keys(arr)
        path = self._dir / f"{self.prefix}run{len(self._runs):05d}.u64"
        arr.tofile(path)
        self._runs.append(path)
        del arr

    def sorted_blocks(self, block: int = IO_BLOCK,
                      threads: int = 1) -> Iterator[np.ndarray]:
        """Merge all runs; yield ascending sorted blocks (with duplicates).
        Consumes the sorter (temp runs are deleted as they merge)."""
        return merged_blocks([self], block=block, threads=threads)


def merged_blocks(sorters: list[SpillSorter], block: int = IO_BLOCK,
                  threads: int = 1) -> Iterator[np.ndarray]:
    """Merge several sorters' runs+buffers into one ascending block
    stream. Consumes the sorters (runs are deleted as they merge)."""
    spilled = [s for s in sorters if s._runs]
    if not spilled:
        # everything fits in the buffers: sort in RAM, no disk round trip
        arrs = [a for s in sorters for a in s._buf]
        for s in sorters:
            s._buf, s._buffered = [], 0
        arr = (np.concatenate(arrs) if arrs else np.zeros(0, dtype=np.uint64))
        del arrs
        arr = _sort_keys(arr)
        for i in range(0, arr.size, block):
            yield arr[i:i + block]
        return
    runs = []
    for s in sorters:
        if s._buf:
            s._spill()
        runs.extend(s._runs)
    tmp_dir = spilled[0]._dir
    # pairwise cascade until two (or one) runs remain, then stream;
    # independent pairs of one generation merge concurrently (each merge
    # is native linear-merge + file IO, both GIL-free)
    gen = 0
    while len(runs) > 2:
        pairs = [(runs[i], runs[i + 1],
                  tmp_dir / f"merge{gen:03d}_{i // 2:05d}.u64")
                 for i in range(0, len(runs) - 1, 2)]
        if threads > 1 and len(pairs) > 1:
            with ThreadPoolExecutor(min(threads, len(pairs))) as ex:
                list(ex.map(lambda p: _merge_files(p[0], p[1], p[2], block),
                            pairs))
        else:
            for a, b, out in pairs:
                _merge_files(a, b, out, block)
        for a, b, _ in pairs:
            os.unlink(a)
            os.unlink(b)
        nxt = [out for _, _, out in pairs]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
        gen += 1
    if len(runs) == 1:
        yield from _stream_file(runs[0], block)
    else:
        yield from _merge_streams(_stream_file(runs[0], block),
                                  _stream_file(runs[1], block))
    for r in runs:
        try:
            os.unlink(r)
        except OSError:
            pass


def _stream_file(path: Path, block: int) -> Iterator[np.ndarray]:
    with open(path, "rb") as fp:
        while True:
            arr = np.fromfile(fp, dtype=np.uint64, count=block)
            if arr.size == 0:
                return
            yield arr


def _merge_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    from .. import native

    out = native.merge_u64_native(a, b)
    if out is None:
        out = np.concatenate([a, b])
        out.sort(kind="stable")
    return out


def _merge_streams(sa: Iterator[np.ndarray],
                   sb: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
    """Merge two sorted block streams into one sorted block stream."""
    a = next(sa, None)
    b = next(sb, None)
    while a is not None and b is not None:
        lim = min(a[-1], b[-1])
        ia = int(np.searchsorted(a, lim, side="right"))
        ib = int(np.searchsorted(b, lim, side="right"))
        yield _merge_arrays(a[:ia], b[:ib])
        a = a[ia:] if ia < a.size else next(sa, None)
        b = b[ib:] if ib < b.size else next(sb, None)
    while a is not None:
        yield a
        a = next(sa, None)
    while b is not None:
        yield b
        b = next(sb, None)


def _merge_files(pa: Path, pb: Path, out: Path, block: int) -> None:
    with open(out, "wb") as fo:
        for blk in _merge_streams(_stream_file(pa, block),
                                  _stream_file(pb, block)):
            blk.tofile(fo)


_STOP = object()


def _sorted_stream_parallel(items: Iterator, transform,
                            tmp_dir: str | Path | None,
                            run_size: int, threads: int,
                            block: int = IO_BLOCK):
    """Run ``transform(item) -> sorted-key array`` over ``items`` in a
    thread pool (the scan/pack/sort natives all release the GIL — the
    reference's multiprocessing fan-out, extractOfftargets.py:193-253,
    without the process-boundary copies); each worker spills to its own
    runs in a shared directory; returns ``(total, block_iterator)``.
    """
    threads = max(1, int(threads))
    shared = Path(tmp_dir) if tmp_dir else Path(
        tempfile.mkdtemp(prefix="crackling_sort_"))
    if threads == 1:
        sorter = SpillSorter(tmp_dir=shared, run_size=run_size)
        for item in items:
            sorter.add(transform(item))
        return sorter.total, sorter.sorted_blocks(block=block)

    sorters = [SpillSorter(tmp_dir=shared,
                           run_size=max(run_size // threads, 1 << 20),
                           prefix=f"w{i:02d}.")
               for i in range(threads)]
    q: queue.Queue = queue.Queue(maxsize=2 * threads)

    def worker(wid: int):
        s = sorters[wid]
        while True:
            item = q.get()
            if item is _STOP:
                return
            s.add(transform(item))

    with ThreadPoolExecutor(threads) as ex:
        futs = [ex.submit(worker, i) for i in range(threads)]
        for item in items:
            q.put(item)
        for _ in range(threads):
            q.put(_STOP)
        for f in futs:
            f.result()
    total = sum(s.total for s in sorters)
    return total, merged_blocks(sorters, block=block, threads=threads)


def stream_sorted_sites(inputs: Iterable[str | Path],
                        tmp_dir: str | Path | None = None,
                        run_size: int = 64 * 1024 * 1024,
                        progress=None, threads: int | None = None):
    """Extract all off-target sites from FASTA inputs; return
    ``(total, block_iterator)`` over the lexicographically sorted
    site stream (duplicates preserved, like the reference's sorted file)."""
    from ..index.build import _lofirst_to_lex
    from .. import native

    threads = _default_threads() if threads is None else threads
    lock = threading.Lock()
    state = {"sites": 0}

    def transform(chunk: bytes) -> np.ndarray:
        sigs = extract_offtarget_sites_seq(chunk, to_upper=True)
        if sigs.size:
            lex = native.lex_convert_native(sigs, 20)
            if lex is None:
                lex = _lofirst_to_lex(sigs, 20)
        else:
            lex = sigs
        if progress is not None:
            with lock:
                state["sites"] += sigs.size
                progress(len(chunk), state["sites"])
        return lex

    items = (chunk for path in inputs for chunk in iter_fasta_chunks(path))
    return _sorted_stream_parallel(items, transform, tmp_dir, run_size,
                                   threads)


def stream_sorted_sites_from_text(path: str | Path,
                                  seq_length: int = 20,
                                  tmp_dir: str | Path | None = None,
                                  run_size: int = 64 * 1024 * 1024,
                                  chunk_lines: int = 4 * 1024 * 1024,
                                  threads: int | None = None):
    """A site *text* file (one sequence per line, any order) ->
    ``(total, block_iterator)`` over the lexicographically sorted site
    stream — memory bounded by the spill-run size, never the file size
    (the reference binary loads the whole file, isslCreateIndex.cpp:160-171).
    """
    from ..index.build import _lofirst_to_lex
    from .. import native

    threads = _default_threads() if threads is None else threads

    def read_buffers() -> Iterator[np.ndarray]:
        with open(path, "rb") as fp:
            width = None
            while True:
                buf = fp.read((seq_length + 1) * chunk_lines)
                if not buf:
                    break
                if width is None:
                    nl = buf.find(b"\n")
                    width = (nl + 1) if nl >= 0 else len(buf)
                # fixed-width lines: vectorized decode without str.split
                rem = len(buf) % width
                if rem:
                    buf += fp.read(width - rem)
                rem = len(buf) % width
                if rem:
                    # final line without a trailing newline: pad to width
                    if rem >= seq_length:
                        buf += b"\n" * (width - rem)
                    else:
                        raise ValueError(
                            f"{path}: trailing {rem}-byte partial site line")
                yield np.frombuffer(buf, dtype=np.uint8).reshape(-1, width)

    def transform(arr: np.ndarray) -> np.ndarray:
        sigs = _pack_lines(arr, seq_length)
        lex = native.lex_convert_native(sigs, seq_length)
        if lex is None:
            lex = _lofirst_to_lex(sigs, seq_length)
        return lex

    return _sorted_stream_parallel(read_buffers(), transform, tmp_dir,
                                   run_size, threads)


def _pack_lines(arr: np.ndarray, seq_length: int) -> np.ndarray:
    """(n, width) ASCII rows (sequence + newline) -> low-first signatures."""
    from .. import native

    out = native.pack_lines_native(arr, seq_length)
    if out is not None:
        return out
    table = np.full(256, 255, dtype=np.uint8)
    for ch, c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
        table[ch] = c
    codes = table[arr[:, :seq_length]]
    if (codes == 255).any():
        bad = np.flatnonzero((codes == 255).any(axis=1))[0]
        raise ValueError(
            f"non-ACGT site line: {bytes(arr[bad, :seq_length])!r}")
    sig = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(seq_length):
        sig |= codes[:, j].astype(np.uint64) << np.uint64(2 * j)
    return sig


def build_index_from_sites_text(path: str | Path, seq_length: int = 20,
                                slice_width: int = 8,
                                tmp_dir: str | Path | None = None,
                                run_size: int = 64 * 1024 * 1024,
                                threads: int | None = None):
    """Site text file -> IsslIndex, memory bounded by the distinct-site
    count (the createIsslIndex CLI's scale path)."""
    from .build import IsslIndex, lex_to_lofirst_checked

    total, blocks = stream_sorted_sites_from_text(
        path, seq_length=seq_length, tmp_dir=tmp_dir, run_size=run_size,
        threads=threads)
    val_parts, cnt_parts = [], []
    for vals, counts in run_length(blocks):
        val_parts.append(vals)
        cnt_parts.append(counts)
    if val_parts:
        uniq_lex = np.concatenate(val_parts)
        counts = np.concatenate(cnt_parts)
    else:
        uniq_lex = np.zeros(0, dtype=np.uint64)
        counts = np.zeros(0, dtype=np.int64)
    del val_parts, cnt_parts
    uniq = lex_to_lofirst_checked(uniq_lex, seq_length)
    return IsslIndex(
        seq_length=seq_length,
        slice_width=slice_width,
        seq_count=int(total),
        site_sigs=uniq,
        occurrences=counts.astype(np.uint32),
    )


_LEX_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def lex_block_to_text(block: np.ndarray, length: int = 20) -> np.ndarray:
    """(n,) lex signatures -> (n, length+1) ASCII bytes with trailing
    newline — native OpenMP formatter (the numpy path costs ~1 us/site,
    which dominated the extraction CLI at genome scale); vectorized
    numpy fallback without per-site Python strings."""
    from .. import native

    out = native.lex_to_text_native(block, length)
    if out is not None:
        return out
    n = block.shape[0]
    out = np.empty((n, length + 1), dtype=np.uint8)
    for j in range(length):
        code = (block >> np.uint64(2 * (length - 1 - j))) & np.uint64(3)
        out[:, j] = _LEX_LETTERS[code.astype(np.int64)]
    out[:, length] = ord("\n")
    return out


def write_sites_text(blocks: Iterator[np.ndarray], path: str | Path,
                     length: int = 20) -> int:
    """Stream sorted site text to ``path``; returns sites written."""
    total = 0
    with open(path, "wb") as fp:
        for blk in blocks:
            lex_block_to_text(blk, length).tofile(fp)
            total += blk.size
    return total


def run_length(blocks: Iterator[np.ndarray]):
    """Sorted block stream -> (values, counts) block stream with
    cross-block carry (reference occurrence counting semantics,
    isslCreateIndex.cpp:184-207)."""
    carry_val = None
    carry_cnt = 0
    for blk in blocks:
        if blk.size == 0:
            continue
        vals, counts = np.unique(blk, return_counts=True)
        # np.unique on a sorted block is a run-length pass; merge the carry
        if carry_val is not None:
            if vals[0] == carry_val:
                counts[0] += carry_cnt
            else:
                yield (np.array([carry_val], dtype=np.uint64),
                       np.array([carry_cnt], dtype=np.int64))
        carry_val = vals[-1]
        carry_cnt = int(counts[-1])
        if vals.size > 1:
            yield vals[:-1], counts[:-1].astype(np.int64)
    if carry_val is not None:
        yield (np.array([carry_val], dtype=np.uint64),
               np.array([carry_cnt], dtype=np.int64))


def build_index_streamed(inputs: Iterable[str | Path], seq_length: int = 20,
                         slice_width: int = 8,
                         tmp_dir: str | Path | None = None,
                         run_size: int = 64 * 1024 * 1024,
                         progress=None, threads: int | None = None):
    """FASTA inputs -> IsslIndex with memory bounded by the *distinct* site
    count (raw occurrences stream through the external sort; the reference
    loads the full occurrence list, isslCreateIndex.cpp:160-171)."""
    from .build import IsslIndex, lex_to_lofirst_checked

    total, blocks = stream_sorted_sites(inputs, tmp_dir=tmp_dir,
                                        run_size=run_size, progress=progress,
                                        threads=threads)
    val_parts, cnt_parts = [], []
    for vals, counts in run_length(blocks):
        val_parts.append(vals)
        cnt_parts.append(counts)
    if val_parts:
        uniq_lex = np.concatenate(val_parts)
        counts = np.concatenate(cnt_parts)
    else:
        uniq_lex = np.zeros(0, dtype=np.uint64)
        counts = np.zeros(0, dtype=np.int64)
    del val_parts, cnt_parts
    uniq = lex_to_lofirst_checked(uniq_lex, seq_length)
    return IsslIndex(
        seq_length=seq_length,
        slice_width=slice_width,
        seq_count=int(total),
        site_sigs=uniq,
        occurrences=counts.astype(np.uint32),
    )
