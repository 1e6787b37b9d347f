"""The compact decode's steps 1-2 (``ops/compact_decode.py``,
``csrc/compact_decode.cu``).

From one page's finder cells, the decode scores every 1-2-hit cell of the
moment tree (slot total, superchunk, chunk) pointwise into f64 sums and
lists the >=3-hit chunks as rescan rows. ``compact_decode_plain`` is held
to a numpy walk of the same tree over the plain finder's cells, with the
terms of each hit from the port's own oracle (``ops/oracle.py``: the
reference's mismatch collapse and CFD product; MIT from
``tables.precalculated_mit_scores``): populations exact, rows equal as a
set sorted by (hq, start), sums within rtol 1e-12 (the same f32 terms,
summed in f64 in another order). The index is made with numpy from a seed:
a bucket of ~3,000 sites (3 chunks of 1,024, so with ``superchunk`` 2 the
last superchunk overhangs) whose clusters give 1-2-hit and >=3-hit cells at
every level, single hits elsewhere, absent queries and padding slots. A
rows cap below the page's rows (none of them, one, a quarter, a half, all
but two, all but one) must cut the list there to rows of the uncapped
list, flag the page, and leave every level's population as it was. The
plain version's
rows, sorted so that each chunk's are consecutive (the kernel's order),
give the same steps 1-3 sums as its own order. The wrapper on CPU
tensors runs the plain version; on the card it launches the kernel, held
to the plain version, its rows of each chunk consecutive (tests marked
``cuda``, skipped without a card).
``test_torch_compact.py::test_compact_matches_jax`` holds the decode, inside
the scorer, to the JAX engine.
"""

import numpy as np
import pytest
import torch

from crackling_tpu_torch.index import build_index
from crackling_tpu_torch.ops import compact_decode as cd
from crackling_tpu_torch.ops.compact_finder import RANK_EMPTY, FinderOut
from crackling_tpu_torch.ops.compact_rescan import (RescanRows,
                                                    compact_rescan_plain)
from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer, plan_slots
from crackling_tpu_torch.ops.oracle import _cfd_one, collapse_mismatches
from crackling_tpu_torch.ops.tables import (CFD_PAM_NGG_INDEX,
                                            cfd_pam_penalties,
                                            cfd_pos_penalties,
                                            precalculated_mit_scores)

CHUNK = 1024
WIDE = 1 << 17                  # a rows cap no page reaches
SIG40 = (1 << 40) - 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _world(seed=23):
    """Sites and queries: 66 cluster bases sharing slice 0's value, 48 with
    64 variants each, 6 with 4 and 12 with 3 (1-2 positions mutated
    outside slice 0); 6 pairs of a random site and one such variant; 300
    random fillers. Queries: 12 large and the 18 small clusters' bases,
    the pairs' sites, 6 fillers and 6 random signatures."""
    rng = np.random.default_rng(seed)

    def pin(sigs):
        return (sigs & ~np.uint64(0xFF)) | np.uint64(0x55)

    def variant(sig):
        v = int(sig)
        for pos in rng.integers(4, 20, size=int(rng.integers(1, 3))):
            v = (v & ~(3 << (2 * int(pos)))) \
                | (int(rng.integers(0, 4)) << (2 * int(pos)))
        return v

    base = pin(rng.integers(0, 1 << 40, size=66).astype(np.uint64))
    sizes = [64] * 48 + [4] * 6 + [3] * 12
    pairs = rng.integers(0, 1 << 40, size=6).astype(np.uint64)
    variants = [variant(sig) for sig, k in zip(base, sizes)
                for _ in range(k)] + [variant(sig) for sig in pairs]
    filler = rng.integers(0, 1 << 40, size=300).astype(np.uint64)
    sites = np.concatenate([base, pairs, np.array(variants, np.uint64),
                            filler])
    queries = np.concatenate([base[:12], base[48:], pairs, filler[:6],
                              rng.integers(0, 1 << 40, 6).astype(np.uint64)])
    return build_index(sites), queries


@pytest.fixture(scope="module")
def world():
    return _world()


def _page(world, max_dist, superchunk, device="cpu"):
    """The scorer's decode inputs for the page: (scorer, q_sig, qsp, cells),
    the cells from the plain finder; qb one slot group above the fullest
    bucket, so every bucket has padding slots."""
    index, queries = world
    sc = CompactIsslScorer(index, max_dist=max_dist, chunk=CHUNK,
                           superchunk=superchunk, device="cpu")
    S, B = sc.S, sc.B
    vals = (queries[None, :].astype(np.int64)
            >> (8 * np.arange(S)[:, None])) & (B - 1)
    fullest = max(np.bincount(v, minlength=B).max() for v in vals)
    q = sc.query_tensor(queries)
    qsp = plan_slots(q, S, B, -(-(fullest + 1) // 8) * 8)
    fo = sc.finder(q, qsp)
    if device != "cpu":
        sc.entries, sc.occ = sc.entries.to(device), sc.occ.to(device)
        sc.bucket_offsets = sc.bucket_offsets.to(device)
        sc.bucket_lens = sc.bucket_lens.to(device)
        sc.tables = sc.tables._replace(mit=sc.tables.mit.to(device),
                                       pen=sc.tables.pen.to(device))
        q, qsp = q.to(device), qsp.to(device)
        fo = fo._replace(**{f: getattr(fo, f).to(device)
                            for f in ("cnt", "rsum", "rmin", "rmax")})
    return sc, q, qsp, fo


def _decode(fn, sc, q, qsp, fo, cap=WIDE):
    return fn(q, qsp, fo, sc.bucket_offsets, sc.bucket_lens, sc.entries,
              sc.occ, chunk=sc.chunk, superchunk=sc.superchunk,
              cap_rescan=cap, tabs=sc.tables, trim=q.device.type == "cpu")


def _brute(sc, queries, qsp, fo):
    """The moment tree walked in numpy over the cells: (pops, mit, cfd,
    rows), the sums (n + 1,) f64, the rows sorted (hq, start, live, s, q)
    tuples."""
    cnt, rmin, rmax = (t.numpy() for t in (fo.cnt, fo.rmin, fo.rmax))
    qsp = qsp.numpy()
    ents, occ = sc.entries.numpy(), sc.occ.numpy()
    boff, blen = sc.bucket_offsets.numpy(), sc.bucket_lens.numpy()
    S, B, C, qb = cnt.shape
    n, epad, nchmax = len(queries), ents.shape[1], fo.nchmax
    precalc = precalculated_mit_scores(20, sc.max_dist)
    pen = cfd_pos_penalties().astype(np.float32)
    pam = np.float32(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    mit, cfd = np.zeros(n + 1), np.zeros(n + 1)
    pops, rows = [0] * 6, []
    for s, b, j in zip(*np.nonzero(cnt[:, :, C - 1, :])):
        hq = min(int(qsp[s, b, j]), n)
        first = int(boff[s, b])

        def score(cell):
            c = cnt[s, b, cell, j]
            if hq >= n:
                return
            ranks = [rmin[s, b, cell, j], rmax[s, b, cell, j]][:int(c)]
            for r in ranks:
                e, qs = int(ents[s, first + r]), int(queries[hq])
                cm = int(collapse_mismatches(np.uint64((e ^ qs) & SIG40)))
                t_mit = np.float32(precalc.get(cm, 0.0))
                t_cfd = (np.float32(1.0) if cm == 0
                         else _cfd_one(qs, e, pen, pam))
                w = np.float32(occ[s, first + r])
                mit[hq] += float(np.float32(t_mit * w))
                cfd[hq] += float(np.float32(t_cfd * w))

        def chunk_cell(ch):
            c = cnt[s, b, ch, j]
            if c == 0:
                return
            pops[4] += 1
            if c <= 2:
                score(ch)
                return
            pops[5] += 1
            rows.append((hq, s * epad + first + ch * CHUNK,
                         int(blen[s, b]) - ch * CHUNK, s,
                         int(queries[min(hq, n - 1)])))

        if cnt[s, b, C - 1, j] <= 2:
            pops[0] += 1
            score(C - 1)
            continue
        pops[1] += 1
        if not sc.superchunk:
            for ch in range(nchmax):
                chunk_cell(ch)
            continue
        for k in range(fo.nsc):
            c = cnt[s, b, nchmax + k, j]
            if c == 0:
                continue
            pops[2] += 1
            if c <= 2:
                score(nchmax + k)
                continue
            pops[3] += 1
            for ch in range(k * sc.superchunk,
                            min((k + 1) * sc.superchunk, nchmax)):
                chunk_cell(ch)
    return pops, mit, cfd, sorted(rows)


def _rows(d):
    """The live rows of a Decoded as sorted (hq, start, live, s, q)."""
    r = d.rows
    live = (r.ridx >= 0).cpu()
    cols = [t.cpu()[live].tolist() for t in (r.hq, r.start, r.live, r.s,
                                             r.q)]
    return sorted(zip(*cols))


@pytest.mark.parametrize("superchunk", [0, 2])
@pytest.mark.parametrize("max_dist", [0, 2, 4])
def test_plain_decode_matches_numpy_walk(world, max_dist, superchunk):
    sc, q, qsp, fo = _page(world, max_dist, superchunk)
    pops, mit, cfd, rows = _brute(sc, world[1], qsp, fo)
    d = _decode(cd.compact_decode_plain, sc, q, qsp, fo)
    assert d.pops.tolist() == pops
    assert _rows(d) == rows
    np.testing.assert_allclose(d.mit_sums.numpy(), mit, rtol=1e-12, atol=0)
    np.testing.assert_allclose(d.cfd_sums.numpy(), cfd, rtol=1e-12, atol=0)
    # the page exercises every level the walk has
    assert pops[0] > 0
    if max_dist == 4:
        assert pops[1] > 0 and pops[4] > pops[5] > 0
        assert fo.nchmax == 3
        if superchunk:
            assert pops[2] > pops[3] > 0


def _runs(rows):
    """(runs, distinct): the runs of equal start among a list's live rows,
    in list order, and their distinct starts; equal when the rows of each
    chunk are consecutive."""
    starts = rows.start[rows.ridx >= 0].tolist()
    runs = sum(1 for i, st in enumerate(starts) if i == 0
               or st != starts[i - 1])
    return runs, len(set(starts))


def _steps_1_3(sc, q, d, rows):
    """The page's sums after steps 1-3: the decode's, and the plain rescan
    of ``rows`` added to them."""
    mit, cfd = d.mit_sums.clone(), d.cfd_sums.clone()
    compact_rescan_plain(rows, sc.entries.reshape(-1), sc.occ.reshape(-1),
                         sc.tables, mit, cfd, n=q.numel(),
                         scan_width=sc._scan_width, max_dist=sc.max_dist)
    return mit, cfd


@pytest.mark.parametrize("superchunk", [0, 2])
@pytest.mark.parametrize("max_dist", [2, 4])
def test_rows_grouped_by_chunk_give_the_same_sums(world, max_dist,
                                                  superchunk):
    sc, q, qsp, fo = _page(world, max_dist, superchunk)
    d = _decode(cd.compact_decode_plain, sc, q, qsp, fo)
    runs, distinct = _runs(d.rows)
    # the plain version lists a slot's chunks together, so a chunk's rows
    # are apart; the kernel lists them together
    assert runs > distinct > 0
    order = torch.sort(d.rows.start, stable=True).indices
    grouped = RescanRows(*(t[order] for t in d.rows))
    assert _runs(grouped) == (distinct, distinct)
    for g, w in zip(_steps_1_3(sc, q, d, grouped),
                    _steps_1_3(sc, q, d, d.rows)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)


# where the rows cap cuts the page's rows: none listed, one, a quarter, a
# half, all but two, all but one
CUTS = (lambda r: 0, lambda r: 1, lambda r: r // 4, lambda r: r // 2,
        lambda r: r - 2, lambda r: r - 1)


def _capped(fn, world, cut):
    """The page's walk (the numpy count over the cells), its uncapped
    decode and its decode at the rows cap ``CUTS[cut]`` of its rows."""
    sc, q, qsp, fo = _page(world, 4, 2)
    walk = _brute(sc, world[1], qsp, fo)[0]
    if fn is cd.compact_decode:
        sc, q, qsp, fo = _page(world, 4, 2, "cuda")
    true = _decode(cd.compact_decode_plain, sc, q, qsp, fo)
    cap = CUTS[cut](int(true.pops[5]))
    return walk, true, cap, _decode(fn, sc, q, qsp, fo, cap)


def _check_capped(walk, true, cap, got):
    """Every population is the uncapped run's and the walk's, n_rescan
    passes the cap, and the list holds ``cap`` of the uncapped rows."""
    pops = true.pops.tolist()
    assert min(pops) > 0 and pops == walk and pops[5] > cap
    assert got.pops.tolist() == pops
    rows = _rows(got)
    assert len(rows) == cap and set(rows) <= set(_rows(true))


@pytest.mark.parametrize("cut", range(len(CUTS)))
def test_a_cap_below_its_population_flags_the_page(world, cut):
    _check_capped(*_capped(cd.compact_decode_plain, world, cut))


def test_wrapper_runs_plain_version_on_cpu(world):
    sc, q, qsp, fo = _page(world, 4, 2)
    want = _decode(cd.compact_decode_plain, sc, q, qsp, fo)
    calls, launches = cd.compact_decode_plain.calls, cd.compact_decode.launches
    got = _decode(cd.compact_decode, sc, q, qsp, fo)
    assert cd.compact_decode_plain.calls == calls + 1
    assert cd.compact_decode.launches == launches
    assert torch.equal(got.pops, want.pops)
    assert torch.equal(got.mit_sums, want.mit_sums)
    assert torch.equal(got.cfd_sums, want.cfd_sums)
    for g, w in zip(got.rows, want.rows):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fault", ["int64 qsp", "ragged cells",
                                   "superchunk of other cells"])
def test_wrapper_refuses_bad_inputs(world, fault):
    sc, q, qsp, fo = _page(world, 4, 2)
    if fault == "int64 qsp":
        qsp = qsp.long()
    elif fault == "ragged cells":
        fo = fo._replace(rmax=fo.rmax[..., :-1].contiguous())
    else:
        sc.superchunk = 0
    with pytest.raises(ValueError):
        _decode(cd.compact_decode, sc, q, qsp, fo)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("max_dist,superchunk", [(4, 0), (4, 2), (2, 2),
                                                 (0, 0)])
def test_kernel_matches_plain_version_on_the_card(world, max_dist,
                                                  superchunk):
    _on_card()
    sc, q, qsp, fo = _page(world, max_dist, superchunk, "cuda")
    want = _decode(cd.compact_decode_plain, sc, q, qsp, fo)
    launches = cd.compact_decode.launches
    got = _decode(cd.compact_decode, sc, q, qsp, fo)
    torch.cuda.synchronize()
    assert cd.compact_decode.launches == launches + 1
    assert torch.equal(got.pops, want.pops)
    assert _rows(got) == _rows(want)
    for g, w in ((got.mit_sums, want.mit_sums),
                 (got.cfd_sums, want.cfd_sums)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("max_dist,superchunk", [(4, 0), (4, 2), (2, 2)])
def test_kernel_lists_the_rows_of_a_chunk_together_on_the_card(
        world, max_dist, superchunk):
    _on_card()
    sc, q, qsp, fo = _page(world, max_dist, superchunk, "cuda")
    got = _decode(cd.compact_decode, sc, q, qsp, fo)
    torch.cuda.synchronize()
    runs, distinct = _runs(got.rows)
    assert runs == distinct > 0
    live = int(min(got.pops[5], WIDE))
    assert torch.equal(got.rows.ridx[:live].cpu(), torch.arange(live))
    pad = got.rows.ridx[live:]
    assert bool((pad == -1).all()) and bool((got.rows.hq[live:]
                                             == q.numel()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cut", range(len(CUTS)))
def test_kernel_flags_each_overflowing_level_on_the_card(world, cut):
    _on_card()
    capped = _capped(cd.compact_decode, world, cut)
    torch.cuda.synchronize()
    _check_capped(*capped)


# -- ranks past 2^22, near 2^31: the 64-bit offset path --------------------

FAR_CHUNK = 1 << 24
FAR_BOFF = 1 << 20                       # bucket 1's start in its row
FAR_LEN = (1 << 31) - FAR_BOFF - 1024    # bucket 1: ranks near 2^31
FAR_WIDTH = 4096                         # the rescan's scan width here
FAR_ROW = 100                            # the >=3-hit chunk, ranks ~2^30


def _far_page(superchunk, device):
    """Hand-made cells of one slice and two buckets for two queries in
    bucket 1 (bucket 0 holds padding), whose rows reach 2^31 entries:
    query 0's bucket total of 6 hits descends to a 1-hit chunk at rank
    2^22 + 3, a 2-hit chunk at ranks near 2^31 and a 3-hit chunk at
    ranks ~2^30 (a rescan row); query 1's total of 1 hit, near 2^31, is
    scored from the slot. The entries (16 GiB) and occurrences (8 GiB) are
    allocated uninitialised, so the CPU pages in only the few windows
    written: the hits, and the rescan row's window of non-hits.
    Returns (q_sig, qsp, cells, boff, blen, entries, occ, hits), ``hits``
    the (query, rank, signature, occurrence) of every hit."""
    rng = np.random.default_rng(7)
    nchmax = -(-FAR_LEN // FAR_CHUNK)
    nsc = -(-nchmax // superchunk) if superchunk else 0
    C = nchmax + nsc + 1
    q = (rng.integers(0, 1 << 40, size=2).astype(np.int64) & ~0xFF) | 0x01

    def near(sig, k):                      # k changed positions past slice 0
        for p in rng.choice(np.arange(4, 20), size=k, replace=False):
            sig ^= 1 << (2 * int(p))
        return sig

    ranks = {0: [(1 << 22) + 3, FAR_LEN - 7, FAR_LEN - 2,
                 FAR_ROW * FAR_CHUNK + 5, FAR_ROW * FAR_CHUNK + 900,
                 FAR_ROW * FAR_CHUNK + 4000],
             1: [FAR_LEN - 100]}
    hits = [(j, r, near(int(q[j]), 1 + (r % 3)), 1 + r % 5)
            for j in (0, 1) for r in ranks[j]]
    epad = FAR_BOFF + FAR_LEN + 1024
    entries = torch.empty((1, epad), dtype=torch.int64)
    occ = torch.empty((1, epad), dtype=torch.int32)
    lo = FAR_BOFF + FAR_ROW * FAR_CHUNK
    entries[0, lo:lo + FAR_WIDTH] = int(q[0]) ^ 0x5555555555  # distance 20
    occ[0, lo:lo + FAR_WIDTH] = 1
    for _j, r, sig, w in hits:
        entries[0, FAR_BOFF + r] = sig
        occ[0, FAR_BOFF + r] = w

    shape = (1, 2, C, 2)
    cnt = np.zeros(shape, np.int64)
    rmin = np.full(shape, RANK_EMPTY, np.int64)
    rmax = np.full(shape, -1, np.int64)
    for j, r, _sig, _w in hits:
        ch = r // FAR_CHUNK
        cells = [ch, C - 1] + ([nchmax + ch // superchunk] if superchunk
                               else [])
        for c in cells:
            cnt[0, 1, c, j] += 1
            rmin[0, 1, c, j] = min(rmin[0, 1, c, j], r)
            rmax[0, 1, c, j] = max(rmax[0, 1, c, j], r)
    rsum = np.zeros(shape, np.int64)
    fo = FinderOut(*(torch.as_tensor(x).to(t) for x, t in
                     ((cnt, torch.int32), (rsum, torch.int64),
                      (rmin, torch.int32), (rmax, torch.int32))),
                   nchmax, nsc)
    qsp = torch.tensor([[[2, 2], [0, 1]]], dtype=torch.int32)
    boff = torch.tensor([[0, FAR_BOFF]], dtype=torch.int64)
    blen = torch.tensor([[0, FAR_LEN]], dtype=torch.int32)
    args = [torch.as_tensor(q), qsp, fo, boff, blen, entries, occ]
    if device != "cpu":
        args = [a.to(device) if isinstance(a, torch.Tensor) else
                a._replace(**{f: getattr(a, f).to(device)
                              for f in ("cnt", "rsum", "rmin", "rmax")})
                for a in args]
    return (*args, hits)


def _far_sums(q_sig, hits):
    """The hits' f32 terms times their occurrences, summed in f64 per
    query, from the port's oracle."""
    precalc = precalculated_mit_scores(20, 4)
    pen = cfd_pos_penalties().astype(np.float32)
    pam = np.float32(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    mit, cfd = np.zeros(3), np.zeros(3)
    for j, _r, e, w in hits:
        qs = int(q_sig[j])
        cm = int(collapse_mismatches(np.uint64((e ^ qs) & SIG40)))
        mit[j] += float(np.float32(np.float32(precalc.get(cm, 0.0)) * w))
        cfd[j] += float(np.float32(_cfd_one(qs, e, pen, pam) * w))
    return mit, cfd


def _far_decode(superchunk, device):
    from crackling_tpu_torch.ops.issl_compact import decode_score, \
        score_tables

    *args, hits = _far_page(superchunk, device)
    header, mit, cfd = decode_score(
        *args, chunk=FAR_CHUNK, superchunk=superchunk, max_dist=4,
        cap_rescan=WIDE, tabs=score_tables(4, device), scan_width=FAR_WIDTH,
        trim=device == "cpu", rescan_block=4)
    d = cd.compact_decode(*args, chunk=FAR_CHUNK, superchunk=superchunk,
                          cap_rescan=WIDE, tabs=score_tables(4, device),
                          trim=device == "cpu")
    return args[0].cpu().numpy(), hits, header.cpu(), mit.cpu(), \
        cfd.cpu(), d


@pytest.mark.parametrize("superchunk", [0, 16])
def test_decode_and_rescan_at_ranks_near_2_31(superchunk):
    q, hits, header, mit, cfd, d = _far_decode(superchunk, "cpu")
    want_mit, want_cfd = _far_sums(q, hits)
    np.testing.assert_allclose(mit.numpy(), want_mit[:2], rtol=1e-12)
    np.testing.assert_allclose(cfd.numpy(), want_cfd[:2], rtol=1e-12)
    # 2 slots scored or walked, the 3-hit chunk one rescan row whose start
    # and live length are past 2^31 and 2^30 exactly
    assert header[0] == 1 and header[1] == 1 and header[5] == 1
    live = d.rows.ridx >= 0
    assert d.rows.start[live].tolist() == [FAR_BOFF + FAR_ROW * FAR_CHUNK]
    assert d.rows.live[live].tolist() == [FAR_LEN - FAR_ROW * FAR_CHUNK]


@pytest.mark.cuda
@pytest.mark.parametrize("superchunk", [0, 16])
def test_kernels_at_ranks_near_2_31_on_the_card(superchunk):
    _on_card()
    want = _far_decode(superchunk, "cpu")
    got = _far_decode(superchunk, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[3:5], want[3:5]):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)
    assert _rows(got[5]) == _rows(want[5])
