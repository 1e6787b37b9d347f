"""Plain reference of Crackling's off-target scoring.

It works everything out again from the genome: the off-target sites and
their occurrences (Crackling's ``extractOfftargets.py`` patterns), every
site within Hamming distance ``max_dist`` of each query (all pairs, no
index: a one-hot product counts matching positions), and per hit the MIT
local score (Hsu et al. 2013) and the CFD product (Doench et al. 2016,
``cfd_penalties.json`` beside this file), in f64. Scores are
``10000 / (100 + sum)`` as ``isslScoreOfftargets`` prints them.

Two answers per query are valid for a verdict-exact scorer: the full scan
over every hit, and the reference binary's early exit, which stops at the
first hit (in the binary's scan order: slice by slice, sites in
lexicographic order within a bucket, each site once) after which the
method's rejection is decided and reports the partial sums. The verdict
is the binary's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..genome import A, C, G, T, pack, window_starts

# Hsu et al. 2013 per-position mismatch weights, PAM-distal position first
MIT_WEIGHTS = np.array(
    [0.0, 0.0, 0.014, 0.0, 0.0, 0.395, 0.317, 0.0, 0.389, 0.079,
     0.445, 0.508, 0.613, 0.851, 0.732, 0.828, 0.615, 0.804, 0.685, 0.583])
L = 20
SLICES = 5              # the binary's index: 5 slices of 4 positions
PAM_NGG = 0b1010        # the PAM table's row for NGG
METHODS = ("mit", "cfd", "and", "or", "avg")


def cfd_tables():
    """(20, 16) position penalties [pos, guide << 2 | comp(site)] and the
    NGG PAM penalty."""
    data = json.loads((Path(__file__).with_name("cfd_penalties.json"))
                      .read_text())
    pos = np.asarray(data["position_penalties"], dtype=np.float64)
    return pos.reshape(L, 16), float(data["pam_penalties"][PAM_NGG])


def offtarget_sites(codes: torch.Tensor) -> torch.Tensor:
    """Every off-target site of the genome (duplicates kept): forward
    ``[ACG][ACGT]{19}[ACGT][AG]G`` keeps the first 20 bases; reverse
    ``C[CT][ACGT]{20}[CGT]`` keeps the reverse complement of its first 20
    bases (Crackling's rule, PAM bases included)."""
    if codes.numel() < 23:
        return codes.new_zeros(0, dtype=torch.int64)
    n = codes.numel() - 22
    ok = window_starts(codes, 23)
    c0, c1 = codes[0:n], codes[1:1 + n]
    c21, c22 = codes[21:21 + n], codes[22:22 + n]
    fwd = ok & (c0 != T) & ((c21 == A) | (c21 == G)) & (c22 == G)
    rev = ok & (c0 == C) & ((c1 == C) | (c1 == T)) & (c22 != A)
    return torch.cat([pack(codes, torch.nonzero(fwd).flatten(), L),
                      pack(codes, torch.nonzero(rev).flatten(), L,
                           reverse=True)])


def lex_key(sigs: torch.Tensor) -> torch.Tensor:
    """The first base in the high bits: numeric order is the order of the
    20-mers as text."""
    out = torch.zeros_like(sigs)
    for j in range(L):
        out |= ((sigs >> (2 * j)) & 3) << (2 * (L - 1 - j))
    return out


@dataclass
class Sites:
    sigs: torch.Tensor      # (N,) int64 distinct sites, in text order
    occ: np.ndarray         # (N,) f64 occurrences


def site_table(codes: torch.Tensor) -> Sites:
    lex, occ = torch.unique(lex_key(offtarget_sites(codes)),
                            return_counts=True)
    # lex_key reverses the positions, so it is its own inverse
    return Sites(lex_key(lex), occ.cpu().numpy().astype(np.float64))


def onehot(sigs: torch.Tensor, dtype) -> torch.Tensor:
    """(n, 80): column 4j + b is 1 where position j holds base b."""
    pos = torch.arange(L, device=sigs.device)
    base = (sigs[:, None] >> (2 * pos)) & 3
    out = torch.zeros(sigs.numel(), L, 4, dtype=dtype, device=sigs.device)
    out.scatter_(2, base[..., None], 1)
    return out.reshape(-1, 4 * L)


def find_hits(queries: torch.Tensor, sites: torch.Tensor, max_dist: int,
              block_elems: int):
    """Every (query, site) pair within ``max_dist``: (query index, site
    index) int64 arrays. The product of one-hot rows counts the positions
    that match; its terms are 0 or 1 and its sums at most 20, so f16 and
    f32 hold them exactly."""
    dtype = torch.float16 if queries.is_cuda else torch.float32
    qblock = min(4096, max(1, queries.numel()))
    sblock = max(1024, block_elems // qblock)
    need = L - max_dist
    q_out, s_out = [], []
    for q0 in range(0, queries.numel(), qblock):
        qh = onehot(queries[q0:q0 + qblock], dtype)
        for s0 in range(0, sites.numel(), sblock):
            match = onehot(sites[s0:s0 + sblock], dtype) @ qh.T
            si, qi = torch.nonzero(match >= need, as_tuple=True)
            q_out.append((qi + q0).cpu())
            s_out.append((si + s0).cpu())
    if not q_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (torch.cat(q_out).numpy().astype(np.int64),
            torch.cat(s_out).numpy().astype(np.int64))


def hit_terms(q: np.ndarray, s: np.ndarray, pos_pen: np.ndarray,
              pam: float):
    """Per hit of query signature ``q`` on site ``s`` (uint64 arrays): the
    mismatch count, the MIT local score (0 at distance 0) and the CFD
    product (1 at distance 0), in f64, each product in ascending position
    order as the reference binary takes it."""
    j = np.arange(L, dtype=np.uint64)
    qb = ((q[:, None] >> (2 * j)) & np.uint64(3)).astype(np.int64)
    sb = ((s[:, None] >> (2 * j)) & np.uint64(3)).astype(np.int64)
    mm = qb != sb
    m = mm.sum(1)
    t1 = np.ones(q.shape[0])
    cfd = np.full(q.shape[0], pam)
    for p in range(L):
        t1 = t1 * np.where(mm[:, p], 1.0 - MIT_WEIGHTS[p], 1.0)
        pen = pos_pen[p, (qb[:, p] << 2) | (sb[:, p] ^ 3)]
        cfd = np.where(mm[:, p], cfd * pen, cfd)
    first = np.argmax(mm, 1)
    last = L - 1 - np.argmax(mm[:, ::-1], 1)
    d = np.where(m == 1, 19.0, (last - first) / np.maximum(m - 1, 1))
    t2 = 1.0 / ((19.0 - d) / 19.0 * 4.0 + 1.0)
    t3 = 1.0 / np.maximum(m * m, 1)
    mit = np.where(m == 0, 0.0, t1 * t2 * t3 * 100.0)
    return m, mit, np.where(m == 0, 1.0, cfd)


def decided(method: str, mit_sum, cfd_sum, max_sum: float):
    """The binary's early-exit test: the method's rejection is decided."""
    return {"mit": lambda: mit_sum > max_sum,
            "cfd": lambda: cfd_sum > max_sum,
            "and": lambda: (mit_sum > max_sum) & (cfd_sum > max_sum),
            "or": lambda: (mit_sum > max_sum) | (cfd_sum > max_sum),
            "avg": lambda: (mit_sum + cfd_sum) / 2.0 > max_sum}[method]()


def accepted(mit, cfd, threshold: float, method: str):
    """Crackling's verdict: True where the guide passes."""
    rejected = {"mit": lambda: mit < threshold,
                "cfd": lambda: cfd < threshold,
                "and": lambda: (mit < threshold) & (cfd < threshold),
                "or": lambda: (mit < threshold) | (cfd < threshold),
                "avg": lambda: (mit + cfd) / 2.0 < threshold}[method]()
    return ~np.asarray(rejected)


def score(x: float | np.ndarray):
    return 10000.0 / (100.0 + x)


@dataclass
class Expected:
    full_mit: np.ndarray    # full-scan scores, (K,) f64
    full_cfd: np.ndarray
    exit_mit: np.ndarray    # the reference binary's scores
    exit_cfd: np.ndarray
    accepted: np.ndarray    # the binary's verdicts
    hits: int


def expected_scores(queries: np.ndarray, sites: Sites, *, max_dist: int,
                    threshold: float, method: str, block_elems: int,
                    terms_dtype=None) -> Expected:
    """The reference's answers for ``queries`` (uint64 signatures).
    ``terms_dtype`` (a torch dtype) rounds every per-hit term to it before
    the f64 sums: the control's lower precision."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    pos_pen, pam = cfd_tables()
    qdev = torch.as_tensor(queries.view(np.int64), device=sites.sigs.device)
    qi, si = find_hits(qdev, sites.sigs, max_dist, block_elems)
    site_sigs = sites.sigs[torch.as_tensor(si, device=sites.sigs.device)]
    s_u = site_sigs.cpu().numpy().view(np.uint64)
    q_u = queries[qi]
    m, mit, cfd = hit_terms(q_u, s_u, pos_pen, pam)
    if terms_dtype is not None:
        mit = torch.as_tensor(mit).to(terms_dtype).double().numpy()
        cfd = torch.as_tensor(cfd).to(terms_dtype).double().numpy()
    occ = sites.occ[si]
    k = queries.shape[0]
    mit_sum = np.bincount(qi, weights=mit * occ, minlength=k)
    cfd_sum = np.bincount(qi, weights=cfd * occ, minlength=k)
    calc_mit = method in ("mit", "and", "or", "avg")
    calc_cfd = method in ("cfd", "and", "or", "avg")
    max_sum = (10000.0 - threshold * 100.0) / threshold
    exit_mit = np.where(calc_mit, mit_sum, 0.0)
    exit_cfd = np.where(calc_cfd, cfd_sum, 0.0)
    # only a query whose whole sums decide its rejection can exit early;
    # replay those in the binary's order: first slice that matches
    # exactly (each site is counted there once), then text order
    xor = q_u ^ s_u
    first = np.full(qi.shape[0], SLICES, dtype=np.int64)
    for sl in reversed(range(SLICES)):
        clean = ((xor >> np.uint64(8 * sl)) & np.uint64(0xFF)) == 0
        first = np.where(clean, sl, first)
    for q in np.flatnonzero(decided(method, exit_mit, exit_cfd, max_sum)):
        mine = np.flatnonzero(qi == q)
        mine = mine[np.lexsort((si[mine], first[mine]))]
        tm = tc = 0.0
        for h in mine:
            if calc_mit and m[h] > 0:
                tm += mit[h] * occ[h]
            if calc_cfd:
                tc += cfd[h] * occ[h]
            if decided(method, tm, tc, max_sum):
                break
        exit_mit[q], exit_cfd[q] = tm, tc
    em, ec = score(exit_mit), score(exit_cfd)
    return Expected(score(mit_sum), score(cfd_sum), em, ec,
                    accepted(em, ec, threshold, method), int(qi.shape[0]))
