"""Host-side scoring oracles used for parity testing.

``score_exact`` is a bit-exact emulation of the reference scorer's main loop
(/root/reference/src/ISSL/isslScoreOfftargets.cpp:308-511): slice-ordered
scanning, the per-query seen-set, f64 accumulation in exact reference order
and — crucially — the reference's score-visible early exit
(isslScoreOfftargets.cpp:326,467-496), which freezes the reported score at
the partial sum reached when the exit fires.

``score_bruteforce`` is an index-free all-pairs check: for the default
``max_dist == slice_count - 1`` every in-range site shares at least one exact
slice with the query (pigeonhole over ceil(max_dist+1) slices), so a full
ISSL scan finds exactly the same hit set as brute force.
"""

from __future__ import annotations

import numpy as np

from ..codec import popcount64
from ..index.build import IsslIndex
from .tables import cfd_pam_penalties, cfd_pos_penalties, CFD_PAM_NGG_INDEX

_EVEN = np.uint64(0xAAAAAAAAAAAAAAAA)
_ODD = np.uint64(0x5555555555555555)


def collapse_mismatches(xored: np.ndarray) -> np.ndarray:
    """Reference collapse (isslScoreOfftargets.cpp:376-379): ``01`` in every
    mismatched 2-bit slot."""
    return ((xored & _EVEN) >> np.uint64(1)) | (xored & _ODD)


def _cfd_one(q: int, ot: int, pos_pen: np.ndarray, pam: float) -> float:
    """Per-hit CFD product, exact reference op order
    (isslScoreOfftargets.cpp:410-458)."""
    cfd = pam
    for pos in range(20):
        qb = (q >> (2 * pos)) & 3
        ob = (ot >> (2 * pos)) & 3
        if qb != ob:
            cfd = cfd * pos_pen[pos, (qb << 2) | (ob ^ 3)]
    return cfd


def score_exact(
    index: IsslIndex,
    query_sigs: np.ndarray,
    max_dist: int,
    threshold: float,
    method: str,
    precalc: dict[int, float] | None = None,
):
    """Bit-exact emulation of ``isslScoreOfftargets`` for a query array.

    Returns (mit_scores, cfd_scores) f64 arrays, already transformed to
    10000/(100+sum). ``precalc`` overrides the MIT local-score map (e.g. the
    one read from a reference-built .issl file); missing masks contribute
    0.0 exactly like ``phmap``'s ``operator[]`` default-insert.
    """
    from .tables import precalculated_mit_scores

    if precalc is None:
        precalc = precalculated_mit_scores(index.seq_length, index.max_dist)

    calc_mit = method in ("mit", "and", "or", "avg")
    calc_cfd = method in ("cfd", "and", "or", "avg")
    pos_pen = cfd_pos_penalties()
    pam = float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    maximum_sum = (10000.0 - threshold * 100.0) / threshold

    sites = index.site_sigs
    occ = index.occurrences
    S = index.slice_count
    w = index.slice_width
    bmask = (1 << w) - 1

    n_q = len(query_sigs)
    mit_out = np.empty(n_q, dtype=np.float64)
    cfd_out = np.empty(n_q, dtype=np.float64)

    for qi, qsig in enumerate(np.asarray(query_sigs, dtype=np.uint64)):
        q = int(qsig)
        tot_mit = 0.0
        tot_cfd = 0.0
        seen: set[int] = set()
        check_next = True
        for s in range(S):
            sv = (q >> (w * s)) & bmask
            lo = index.bucket_offsets[s, sv]
            hi = index.bucket_offsets[s, sv + 1]
            ids = index.order[s, lo:hi]
            # vectorized distance pre-pass (value-identical: ints are exact);
            # entries beyond max_dist have no side effects in the reference
            # loop (the `continue` at isslScoreOfftargets.cpp:382 touches
            # neither the seen-set nor the sums), so restricting the Python
            # replay to in-range hits preserves exact semantics
            xored = qsig ^ sites[ids]
            mismatches = collapse_mismatches(xored)
            dists = popcount64(mismatches)
            for k in np.flatnonzero(dists <= max_dist):
                dist = int(dists[k])
                site_id = int(ids[k])
                if site_id in seen:
                    continue
                occurrences = float(occ[site_id])
                if calc_mit and dist > 0:
                    tot_mit += precalc.get(int(mismatches[k]), 0.0) * occurrences
                if calc_cfd:
                    if dist == 0:
                        cfd = 1.0
                    else:
                        cfd = _cfd_one(q, int(sites[site_id]), pos_pen, pam)
                    tot_cfd += cfd * occurrences
                seen.add(site_id)
                # reference early exit (isslScoreOfftargets.cpp:467-496)
                if method == "and":
                    if tot_mit > maximum_sum and tot_cfd > maximum_sum:
                        check_next = False
                        break
                elif method == "or":
                    if tot_mit > maximum_sum or tot_cfd > maximum_sum:
                        check_next = False
                        break
                elif method == "avg":
                    if (tot_mit + tot_cfd) / 2.0 > maximum_sum:
                        check_next = False
                        break
                elif method == "mit":
                    if tot_mit > maximum_sum:
                        check_next = False
                        break
                elif method == "cfd":
                    if tot_cfd > maximum_sum:
                        check_next = False
                        break
            if not check_next:
                break
        mit_out[qi] = 10000.0 / (100.0 + tot_mit)
        cfd_out[qi] = 10000.0 / (100.0 + tot_cfd)
    return mit_out, cfd_out


def score_bruteforce(
    query_sigs: np.ndarray,
    site_sigs: np.ndarray,
    occurrences: np.ndarray,
    max_dist: int = 4,
    seq_length: int = 20,
):
    """All-pairs f64 MIT/CFD sums with no index (validation only).

    Accumulates in ascending site-id order; equals the full-scan ISSL result
    up to f64 reassociation (the hit sets are identical for
    ``max_dist <= slice_count - 1``). Returns raw (mit_sum, cfd_sum).
    """
    from .tables import mit_dense_table, mask40_to_mask20

    table = mit_dense_table(seq_length, max_dist)
    pos_pen = cfd_pos_penalties()
    pam = float(cfd_pam_penalties()[CFD_PAM_NGG_INDEX])
    sites = np.asarray(site_sigs, dtype=np.uint64)
    occ = np.asarray(occurrences, dtype=np.float64)

    n_q = len(query_sigs)
    mit_sums = np.zeros(n_q, dtype=np.float64)
    cfd_sums = np.zeros(n_q, dtype=np.float64)
    for qi, qsig in enumerate(np.asarray(query_sigs, dtype=np.uint64)):
        xored = qsig ^ sites
        mm40 = collapse_mismatches(xored)
        dists = popcount64(mm40)
        hit = dists <= max_dist
        ids = np.flatnonzero(hit)
        mm20 = mask40_to_mask20(mm40[ids])
        mit_sums[qi] = float(np.add.reduce(table[mm20.astype(np.int64)] * occ[ids]))
        cfd = np.empty(ids.shape[0], dtype=np.float64)
        for k, sid in enumerate(ids):
            d = int(dists[sid])
            cfd[k] = 1.0 if d == 0 else _cfd_one(int(qsig), int(sites[sid]), pos_pen, pam)
        cfd_sums[qi] = float(np.add.reduce(cfd * occ[ids]))
    return mit_sums, cfd_sums
