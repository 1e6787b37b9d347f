"""The compact rescan (``ops/compact_rescan.py``, ``csrc/compact_rescan.cu``).

Step 3 of the compact engine's decode: per row of the compacted rescan
list (one >=3-hit chunk of one query slot), the screened, occurrence-
weighted MIT/CFD sums over the chunk's entries, added into the row's
query's f64 sums. ``compact_rescan_plain`` is held to a numpy brute force
per row, built from the port's own oracle (``ops/oracle.py``: the
reference's mismatch collapse and CFD product; MIT from
``tables.precalculated_mit_scores``, the map an ``.issl`` file stores),
at rtol 1e-12: both form the same f32 terms and sum them in f64 in
another order.
The rows are made with numpy from a seed and hold every case the decode
can give: padding rows (ridx -1), rows whose query is ``n``, columns past
the live length, distance-0 pairs, pairs clean in an earlier slice, and a
list longer than the plain version's row block. A list in the decode's
order (the rows of one chunk consecutive) gives the plain version the
same sums as a shuffled copy of it. The wrapper on CPU tensors runs the
plain version; on the card it launches the kernel, whose blocks of one
run of rows sharing a chunk (cut at every 8th row) split the chunk among
them and screen each part against all the run's queries, held to the
plain version on both lists (tests marked ``cuda``, skipped without a
card).
``test_torch_compact.py::test_compact_matches_jax`` holds the decode that
builds the rows, and so the rescan inside it, to the JAX engine.
"""

import numpy as np
import pytest
import torch

from crackling_tpu_torch.ops import compact_rescan as cr
from crackling_tpu_torch.ops.issl_compact import score_tables
from crackling_tpu_torch.ops.oracle import _cfd_one, collapse_mismatches
from crackling_tpu_torch.ops.tables import (CFD_PAM_NGG_INDEX,
                                            cfd_pam_penalties,
                                            cfd_pos_penalties,
                                            precalculated_mit_scores)

N = 6               # queries; a row with hq = N adds nothing
SCAN_WIDTH = 128
ENTRIES = 4096
ROWS = 40
BLOCK = 16          # the plain version's row block: the list is longer
SIG40 = (1 << 40) - 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mutate(rng, sig, positions):
    """``sig`` with another base at each of ``positions``."""
    for p in positions:
        code = (sig >> (2 * p)) & 3
        new = (code + int(rng.integers(1, 4))) % 4
        sig = (sig & ~(3 << (2 * p))) | (new << (2 * p))
    return sig


def _world(seed=7):
    """Queries, flat entries (half of them near copies of a query: 0-5
    mutated positions, half of them outside slice 0, so slice 0 stays
    clean), occurrences and the row descriptors, all numpy. Four rows of
    slice 0 hold their query itself at the last live column and at the
    first one past it."""
    rng = np.random.default_rng(seed)
    queries = rng.integers(0, 1 << 40, N)
    ents = rng.integers(0, 1 << 40, ENTRIES)
    for i in np.flatnonzero(rng.random(ENTRIES) < 0.5):
        lo = 4 if rng.random() < 0.5 else 0
        pos = rng.choice(np.arange(lo, 20), int(rng.integers(0, 6)),
                         replace=False)
        ents[i] = _mutate(rng, int(queries[rng.integers(N)]), pos)
    occ = rng.integers(1, 1000, ENTRIES).astype(np.int32)
    ridx = np.arange(ROWS)
    ridx[rng.random(ROWS) < 0.15] = -1
    hq = rng.integers(0, N, ROWS)
    hq[rng.random(ROWS) < 0.1] = N
    rows = dict(ridx=ridx, q=queries[np.minimum(hq, N - 1)], hq=hq,
                start=rng.integers(0, ENTRIES - SCAN_WIDTH, ROWS),
                live=rng.integers(-3, SCAN_WIDTH + 50, ROWS),
                s=rng.integers(0, 5, ROWS))
    for r in np.flatnonzero((ridx >= 0) & (hq < N))[:4]:
        live = int(rng.integers(1, SCAN_WIDTH))
        rows["live"][r], rows["s"][r] = live, 0
        ents[rows["start"][r] + live - 1:rows["start"][r] + live + 1] = \
            rows["q"][r]
    return ents, occ, rows


def _tensors(ents, occ, rows, device="cpu"):
    return (cr.RescanRows(*(torch.as_tensor(rows[f], dtype=torch.int64,
                                            device=device)
                            for f in cr.RescanRows._fields)),
            torch.as_tensor(ents, device=device),
            torch.as_tensor(occ, device=device))


def _sums(device="cpu"):
    return (torch.zeros(N + 1, dtype=torch.float64, device=device),
            torch.zeros(N + 1, dtype=torch.float64, device=device))


def _brute(ents, occ, rows, max_dist):
    """Per-row pair loop in numpy: (mit, cfd) (N + 1,) f64 sums and the
    cases met (hits, distance-0 hits, pairs dropped as clean in an earlier
    slice, would-be hits past the live length and just past it, padding
    rows, rows of query N)."""
    precalc = precalculated_mit_scores(20, max_dist)
    pen = cfd_pos_penalties().astype(np.float32)
    pam = np.float32(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    mit = np.zeros(N + 1)
    cfd = np.zeros(N + 1)
    seen = dict(hits=0, dist0=0, earlier_clean=0, past_live=0, at_live=0,
                padding=0, query_n=0)
    for r in range(len(rows["ridx"])):
        if rows["ridx"][r] < 0:
            seen["padding"] += 1
            continue
        h = int(rows["hq"][r])
        if h >= N:
            seen["query_n"] += 1
            continue
        q, s = int(rows["q"][r]), int(rows["s"][r])
        st = int(rows["start"][r])
        row_m = row_c = 0.0
        for col in range(SCAN_WIDTH):
            e = int(ents[st + col])
            c = int(collapse_mismatches(np.uint64((e ^ q) & SIG40)))
            dist = bin(c).count("1")
            if dist > max_dist:
                continue
            if any((c >> (8 * sp)) & 0xFF == 0 for sp in range(s)):
                seen["earlier_clean"] += 1
                continue
            if col >= rows["live"][r]:
                seen["past_live"] += 1
                seen["at_live"] += col == rows["live"][r]
                continue
            seen["hits"] += 1
            seen["dist0"] += dist == 0
            w = np.float32(occ[st + col])
            t_mit = np.float32(precalc.get(c, 0.0))
            t_cfd = (np.float32(1.0) if dist == 0
                     else _cfd_one(q, e, pen, pam))
            row_m += float(np.float32(t_mit * w))
            row_c += float(np.float32(t_cfd * w))
        mit[h] += row_m
        cfd[h] += row_c
    return mit, cfd, seen


@pytest.mark.parametrize("max_dist", [0, 2, 4])
def test_plain_rescan_matches_numpy_bruteforce(max_dist):
    ents, occ, rows = _world()
    want_mit, want_cfd, seen = _brute(ents, occ, rows, max_dist)
    # the rows hold every case the decode can give
    assert seen["hits"] > 0 and seen["dist0"] > 0
    assert seen["padding"] > 0 and seen["query_n"] > 0
    assert seen["past_live"] > 0 and seen["at_live"] > 0
    if max_dist:
        assert seen["earlier_clean"] > 0
    assert ROWS > BLOCK
    t_rows, t_ents, t_occ = _tensors(ents, occ, rows)
    mit, cfd = _sums()
    cr.compact_rescan_plain(t_rows, t_ents, t_occ,
                            score_tables(max_dist, "cpu"), mit, cfd, n=N,
                            scan_width=SCAN_WIDTH, max_dist=max_dist,
                            rescan_block=BLOCK)
    np.testing.assert_allclose(mit.numpy(), want_mit, rtol=1e-12, atol=0)
    np.testing.assert_allclose(cfd.numpy(), want_cfd, rtol=1e-12, atol=0)
    assert mit[N] == 0 and cfd[N] == 0


def test_wrapper_runs_plain_version_on_cpu():
    ents, occ, rows = _world(seed=8)
    t_rows, t_ents, t_occ = _tensors(ents, occ, rows)
    tabs = score_tables(4, "cpu")
    kw = dict(n=N, scan_width=SCAN_WIDTH, max_dist=4)
    want = _sums()
    cr.compact_rescan_plain(t_rows, t_ents, t_occ, tabs, *want,
                            rescan_block=BLOCK, **kw)
    calls, launches = cr.compact_rescan_plain.calls, cr.compact_rescan.launches
    got = _sums()
    cr.compact_rescan(t_rows, t_ents, t_occ, tabs, *got, rescan_block=BLOCK,
                      **kw)
    assert cr.compact_rescan_plain.calls == calls + 1
    assert cr.compact_rescan.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fault", ["int32 rows", "ragged rows", "short sums"])
def test_wrapper_refuses_bad_inputs(fault):
    ents, occ, rows = _world()
    t_rows, t_ents, t_occ = _tensors(ents, occ, rows)
    mit, cfd = _sums()
    if fault == "int32 rows":
        t_rows = t_rows._replace(hq=t_rows.hq.int())
    elif fault == "ragged rows":
        t_rows = t_rows._replace(live=t_rows.live[:-1])
    else:
        mit = mit[:N]
    with pytest.raises(ValueError):
        cr.compact_rescan(t_rows, t_ents, t_occ, score_tables(4, "cpu"), mit,
                          cfd, n=N, scan_width=SCAN_WIDTH, max_dist=4)


def _grouped_world(seed=9):
    """The entries of :func:`_world` and a rescan list in the decode's
    order: each of 7 chunks (start, live length, slice 0) read by a run of
    consecutive rows, one query each (1 to 11 rows: one run longer than
    the kernel's segments of at most 8 rows), with a padding row and a
    row of query N inside runs (they break them), and padding at the end.
    Each row's chunk holds its query itself and near copies (1-4 mutated
    positions) below the live length."""
    ents, occ, _ = _world()
    rng = np.random.default_rng(seed)
    queries = rng.integers(0, 1 << 40, N)
    fields = {f: [] for f in cr.RescanRows._fields}
    for k, size in enumerate([1, 3, 2, 11, 4, 5, 3]):
        start = int(rng.integers(0, ENTRIES - SCAN_WIDTH))
        live = int(rng.integers(SCAN_WIDTH // 2, SCAN_WIDTH + 50))
        for i in range(size):
            hq = int(rng.integers(0, N))
            ridx = len(fields["ridx"])
            if (k, i) == (4, 2):
                ridx = -1
            elif (k, i) == (5, 1):
                hq = N
            else:
                at = start + rng.choice(min(live, SCAN_WIDTH), 4,
                                        replace=False)
                for a, m in zip(at, range(4)):
                    ents[a] = _mutate(rng, int(queries[hq]),
                                      rng.choice(20, m, replace=False))
            for f, v in zip(cr.RescanRows._fields,
                            (ridx, int(queries[min(hq, N - 1)]), hq, start,
                             live, 0)):
                fields[f].append(v)
    for _ in range(3):
        for f, v in zip(cr.RescanRows._fields, (-1, 0, N, 0, 0, 0)):
            fields[f].append(v)
    return ents, occ, {f: np.array(v, dtype=np.int64)
                       for f, v in fields.items()}


def _shuffled(rows, seed=4):
    perm = np.random.default_rng(seed).permutation(len(rows["ridx"]))
    return {f: v[perm] for f, v in rows.items()}


@pytest.mark.parametrize("max_dist", [0, 2, 4])
def test_plain_rescan_sums_do_not_depend_on_row_order(max_dist):
    ents, occ, rows = _grouped_world()
    tabs = score_tables(max_dist, "cpu")
    kw = dict(n=N, scan_width=SCAN_WIDTH, max_dist=max_dist,
              rescan_block=BLOCK)
    want_mit, want_cfd, seen = _brute(ents, occ, rows, max_dist)
    assert seen["hits"] > 0 and seen["padding"] > 0 and seen["query_n"] > 0
    grouped, shuffled = _sums(), _sums()
    for order, sums in ((rows, grouped), (_shuffled(rows), shuffled)):
        cr.compact_rescan_plain(*_tensors(ents, occ, order), tabs, *sums,
                                **kw)
    for g, w, want in zip(grouped, shuffled, (want_mit, want_cfd)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_dist", [0, 2, 4])
def test_kernel_matches_plain_version_on_the_card(max_dist):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    ents, occ, rows = _world()
    t_rows, t_ents, t_occ = _tensors(ents, occ, rows, "cuda")
    tabs = score_tables(max_dist, "cuda")
    kw = dict(n=N, scan_width=SCAN_WIDTH, max_dist=max_dist)
    want = _sums("cuda")
    cr.compact_rescan_plain(t_rows, t_ents, t_occ, tabs, *want, **kw)
    launches = cr.compact_rescan.launches
    got = _sums("cuda")
    cr.compact_rescan(t_rows, t_ents, t_occ, tabs, *got, **kw)
    torch.cuda.synchronize()
    assert cr.compact_rescan.launches == launches + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["grouped", "shuffled"])
@pytest.mark.parametrize("max_dist", [0, 4])
def test_kernel_matches_plain_version_on_chunk_runs_on_the_card(max_dist,
                                                                order):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    ents, occ, rows = _grouped_world()
    if order == "shuffled":
        rows = _shuffled(rows)
    t_rows, t_ents, t_occ = _tensors(ents, occ, rows, "cuda")
    tabs = score_tables(max_dist, "cuda")
    kw = dict(n=N, scan_width=SCAN_WIDTH, max_dist=max_dist)
    want = _sums("cuda")
    cr.compact_rescan_plain(t_rows, t_ents, t_occ, tabs, *want, **kw)
    got = _sums("cuda")
    cr.compact_rescan(t_rows, t_ents, t_occ, tabs, *got, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)
