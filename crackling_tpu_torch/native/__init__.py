"""ctypes bindings for the native host data path (extract.cpp).

The shared library is compiled on first use with the host g++ into the
package's ``_build/`` directory (rebuilt when a source changes). Every
entry point has a pure-numpy fallback in index/extract.py, so the package
works without a toolchain; the native path is ~10x faster on long genomes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "extract.cpp", _HERE / "fold.cpp", _HERE / "replay.cpp",
         _HERE / "exact.cpp"]
_LIB = _HERE.parent / "_build" / "_libcrackling_native.so"
_lock = threading.Lock()
_lib = None
_disabled = os.environ.get("CRACKLING_NO_NATIVE", "") == "1"


def _build() -> bool:
    # build to a private name, then rename: concurrent processes that
    # import the package at once never load a half-written library
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fopenmp",
             "-shared", "-fPIC", "-o", str(tmp)] + [str(s) for s in _SRCS],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """The loaded library, or None when unavailable."""
    global _lib, _disabled
    if _disabled:
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _disabled:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < max(
                s.stat().st_mtime for s in _SRCS):
            if not _build():
                _disabled = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            _disabled = True
            return None
        i64, u64p, i64p, u8p, u32p, charp = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_char_p,
        )
        lib.ct_extract_offtargets.restype = i64
        lib.ct_extract_offtargets.argtypes = [charp, i64, ctypes.c_int, u64p, i64]
        lib.ct_extract_candidates.restype = i64
        lib.ct_extract_candidates.argtypes = [charp, i64, u64p, i64p, u8p, i64]
        lib.ct_sort_u64.restype = None
        lib.ct_sort_u64.argtypes = [u64p, i64]
        lib.ct_unique_counts.restype = i64
        lib.ct_unique_counts.argtypes = [u64p, i64, u64p, u32p]
        lib.ct_bucket_order.restype = None
        lib.ct_bucket_order.argtypes = [
            u64p, i64, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS,WRITEABLE"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS,WRITEABLE")]
        lib.ct_lex_convert.restype = None
        lib.ct_lex_convert.argtypes = [u64p, u64p, i64, ctypes.c_int]
        lib.ct_merge_u64.restype = None
        lib.ct_merge_u64.argtypes = [u64p, i64, u64p, i64, u64p]
        lib.ct_pam_windows.restype = i64
        lib.ct_pam_windows.argtypes = [u8p, i64, u64p, i64p, i64]
        lib.ct_lex_to_text.restype = None
        lib.ct_lex_to_text.argtypes = [u64p, i64, ctypes.c_int, u8p]
        lib.ct_pack_lines.restype = i64
        lib.ct_pack_lines.argtypes = [u8p, i64, ctypes.c_int, ctypes.c_int,
                                      u64p]
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f64wp = np.ctypeslib.ndpointer(np.float64,
                                       flags="C_CONTIGUOUS,WRITEABLE")
        lib.ct_replay_accumulate.restype = None
        lib.ct_replay_accumulate.argtypes = [
            i64p, i64, f64p, f64p, u8p, ctypes.c_int, ctypes.c_double,
            f64wp, f64wp]
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ct_exact_score.restype = None
        lib.ct_exact_score.argtypes = [
            u64p, u32p, i64, i32p, i64p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u64p, i64, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            f64p, f64p, ctypes.c_double, f64wp, f64wp]
        lib.ct_fold_batch.restype = ctypes.c_int
        lib.ct_fold_batch.argtypes = [
            u8p, i64, i64, f64p, i64, f64p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS,WRITEABLE"),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def pam_windows_native(codes: np.ndarray):
    """(sig23, pos) of PAM-candidate windows over an encoded genome, or
    None when the native lib is missing. Positions ascend."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    cap = max(16, n)
    sig = np.empty(cap, dtype=np.uint64)
    pos = np.empty(cap, dtype=np.int64)
    count = lib.ct_pam_windows(codes, n, sig, pos, cap)
    return sig[:count].copy(), pos[:count].copy()


def fold_batch_native(codes: np.ndarray, nthreads: int = 0):
    """MFE-fold a (B, n) uint8 code batch with the C++ Zuker engine.

    Returns (structures list[str], energies (B,) float64) or None when the
    native library is unavailable. Energy model: ops/rna_params.py.
    """
    lib = get_lib()
    if lib is None:
        return None
    from ..ops.rna_params import param_blob

    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    B, n = codes.shape
    energies = np.empty(B, dtype=np.float64)
    structures = np.empty((B, n), dtype=np.uint8)
    blob = param_blob()
    rc = lib.ct_fold_batch(codes, B, n, blob, blob.shape[0], energies,
                           structures, int(nthreads))
    if rc != 0:
        raise RuntimeError(
            "native fold library parameter-layout mismatch; rebuild "
            f"{_LIB} (delete it and retry)")
    return ([bytes(row).decode() for row in structures], energies)


_REPLAY_METHODS = {"mit": 0, "cfd": 1, "and": 2, "or": 3, "avg": 4}


def replay_accumulate_native(starts: np.ndarray, mit_c: np.ndarray,
                             cfd_c: np.ndarray, keep: np.ndarray,
                             method: str, maximum_sum: float):
    """Per-group sequential f64 hit accumulation with the reference's
    score-visible early exit (replay.cpp), parallel across groups.
    Returns (m, cc) per group, or None when the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n_groups = starts.shape[0] - 1
    out_m = np.empty(n_groups, dtype=np.float64)
    out_cc = np.empty(n_groups, dtype=np.float64)
    lib.ct_replay_accumulate(
        starts, n_groups,
        np.ascontiguousarray(mit_c, dtype=np.float64),
        np.ascontiguousarray(cfd_c, dtype=np.float64),
        np.ascontiguousarray(keep, dtype=np.uint8),
        _REPLAY_METHODS[method], float(maximum_sum), out_m, out_cc)
    return out_m, out_cc


def exact_score_native(index, query_sigs: np.ndarray, max_dist: int,
                       threshold: float | None, method: str):
    """Reference-exact f64 MIT/CFD scores on the host (exact.cpp),
    parallel across queries — the hybrid engine's near-threshold
    re-score path at depths where the MXU engine no longer fits HBM.
    Returns (mit_scores, cfd_scores) already 10000/(100+sum)-mapped, or
    None when the native lib is missing or the layout is unsupported
    (the collapsed-mask dedup bytes require w == 8, l == 20)."""
    lib = get_lib()
    if lib is None or index.slice_width != 8 or index.seq_length != 20:
        return None
    from ..ops.tables import (CFD_PAM_NGG_INDEX, cfd_pam_penalties,
                              cfd_pos_penalties, mit_dense_table)

    queries = np.ascontiguousarray(query_sigs, dtype=np.uint64)
    sites = np.ascontiguousarray(index.site_sigs, dtype=np.uint64)
    occ = np.ascontiguousarray(index.occurrences, dtype=np.uint32)
    order = np.ascontiguousarray(index.order, dtype=np.int32)
    boff = np.ascontiguousarray(index.bucket_offsets, dtype=np.int64)
    mit_tab = np.ascontiguousarray(
        mit_dense_table(index.seq_length, max_dist), dtype=np.float64)
    pos_pen = np.ascontiguousarray(cfd_pos_penalties(), dtype=np.float64)
    pam = float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    maximum_sum = (float("inf") if threshold is None or threshold <= 0
                   else (10000.0 - threshold * 100.0) / threshold)
    n_q = queries.shape[0]
    mit = np.empty(n_q, dtype=np.float64)
    cfd = np.empty(n_q, dtype=np.float64)
    lib.ct_exact_score(
        sites, occ, sites.shape[0], order, boff,
        int(index.slice_count), int(index.bucket_count),
        int(index.slice_width), queries, n_q, int(max_dist),
        maximum_sum, _REPLAY_METHODS[method], mit_tab.reshape(-1),
        pos_pen.reshape(-1), pam, mit, cfd)
    return 10000.0 / (100.0 + mit), 10000.0 / (100.0 + cfd)


def extract_offtargets_native(seq_bytes: bytes, to_upper: bool) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    n = len(seq_bytes)
    cap = max(16, 2 * n)
    out = np.empty(cap, dtype=np.uint64)
    count = lib.ct_extract_offtargets(seq_bytes, n, int(to_upper), out, cap)
    return out[:count].copy()


def extract_candidates_native(seq_bytes: bytes):
    lib = get_lib()
    if lib is None:
        return None
    n = len(seq_bytes)
    cap = max(16, 2 * n)
    sig = np.empty(cap, dtype=np.uint64)
    pos = np.empty(cap, dtype=np.int64)
    strand = np.empty(cap, dtype=np.uint8)
    count = lib.ct_extract_candidates(seq_bytes, n, sig, pos, strand, cap)
    return sig[:count].copy(), pos[:count].copy(), strand[:count].copy()


def sort_u64_native(arr: np.ndarray) -> np.ndarray | None:
    """Radix sort; returns the sorted array (in place when contiguous) or
    None if the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    if not arr.flags["C_CONTIGUOUS"]:
        arr = arr.copy()
    lib.ct_sort_u64(arr, arr.shape[0])
    return arr


def unique_counts_native(sorted_arr: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    n = sorted_arr.shape[0]
    vals = np.empty(n, dtype=np.uint64)
    counts = np.empty(n, dtype=np.uint32)
    m = lib.ct_unique_counts(np.ascontiguousarray(sorted_arr), n, vals, counts)
    return vals[:m].copy(), counts[:m].copy()


def bucket_order_native(sigs: np.ndarray, shift: int, nbuckets: int,
                        order: np.ndarray, offsets: np.ndarray) -> bool:
    """Fill ``order`` (int32, ids in stable bucket order) and ``offsets``
    (int64, bucket starts and the end) for buckets ``(sigs >> shift) &
    (nbuckets - 1)``; False when the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return False
    sigs = np.ascontiguousarray(sigs, dtype=np.uint64)
    lib.ct_bucket_order(sigs, sigs.shape[0], int(shift), int(nbuckets),
                        order, offsets)
    return True


def merge_u64_native(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """Stable linear merge of two sorted uint64 arrays (None w/o the lib)."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty(a.shape[0] + b.shape[0], dtype=np.uint64)
    lib.ct_merge_u64(a, a.shape[0], b, b.shape[0], out)
    return out


def lex_to_text_native(lex: np.ndarray, length: int) -> np.ndarray | None:
    """(n,) lexicographic signatures -> (n, length+1) ASCII rows with
    trailing newlines, or None when the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    lex = np.ascontiguousarray(lex, dtype=np.uint64)
    out = np.empty((lex.shape[0], length + 1), dtype=np.uint8)
    lib.ct_lex_to_text(lex, lex.shape[0], int(length), out.reshape(-1))
    return out


def pack_lines_native(rows: np.ndarray, seq_length: int) -> np.ndarray | None:
    """(n, width) ASCII site rows -> (n,) low-first signatures, or None
    when the native lib is missing. Raises on a non-ACGT base."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    out = np.empty(rows.shape[0], dtype=np.uint64)
    bad = lib.ct_pack_lines(rows.reshape(-1), rows.shape[0], rows.shape[1],
                            int(seq_length), out)
    if bad >= 0:
        raise ValueError(
            f"non-ACGT site line: {bytes(rows[bad, :seq_length])!r}")
    return out


def lex_convert_native(arr: np.ndarray, length: int) -> np.ndarray | None:
    """Bit-reverse-pairs conversion (low-first <-> lexicographic packing);
    the transform is an involution so one entry point serves both ways."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    out = np.empty_like(arr)
    lib.ct_lex_convert(arr, out, arr.shape[0], int(length))
    return out
