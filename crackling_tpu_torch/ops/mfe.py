"""Batched RNA minimum-free-energy folding (Zuker-style DP) on the GPU.

The ``tpu`` fold backend of pipeline/secondary_structure.py: the port of
the JAX package's batched fold, which replaces the reference's RNAfold
subprocess call (Crackling.py:426-433). The pipeline folds the fixed-length
100-nt construct ``'G' + spacer[1:20] + scaffold``, so a page of guides is
one batch of equal-length sequences.

Energy model: ops/rna_params.py (shared with the native C++ engine,
native/fold.cpp): Turner-2004-style stacking, loop initiations with Ninio
asymmetry, terminal mismatches, d2-style dangles on multiloop/exterior
stems, special tri/tetra/hexaloop energies. The engines agree on the model
bit for bit.

Structure: everything that depends only on the sequence (pair codes,
hairpin energies, mismatch and stem weights) is built as dense (B, n, n)
f64 tables by torch gathers on the device (:func:`_precompute`); the DP
(:func:`_fold_run`) is a loop over columns of torch ops over (batch, i),
with a (29, 29) window per row for the generic interior loop. Every
table and every DP value is f64, so the tables equal the JAX package's
numpy ones exactly and the DP equals its x64 program. The batch is folded
in chunks sized to the device's free memory; each DP guide is independent
of every other, so chunking changes no result.

Traceback (dot-bracket) runs on the host from each chunk's tables: it is
O(n) sequential per guide and data-dependent.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import trace
from . import rna_params as rp

INF = rp.INF
MAXLOOP = rp.MAXLOOP

# The generic interior minimum is taken over this many interior sizes
# ``a`` at a time, so its window temporary is (B, n, A_SLICE, L - 1)
# rather than (B, n, L - 1, L - 1); a minimum is exact in any order.
A_SLICE = 8

# Device bytes one guide of length n holds at the DP's peak, in f64
# (n, n) planes (8 n^2 bytes each):
#   17  precompute: 14 energy tables, au_out, pc (int64), can_pair and
#       the transient pc_rev / pin / index planes of _precompute
#    5  DP state: V, W, Vau, fML, fM1
#    2  the shifted fML buffers of the multiloop minima
#    4  temporaries: each column's (B, n, n) min-plus sums, Vext, and
#       the allocator's slack
# (a 4,096-guide chunk peaked at 0.99-1.00 of this on the H100, within
# the FOLD_MEMORY_SHARE margin)
FOLD_PLANES = 28
# plus the interior window of one a-slice: the gathered (n, A_SLICE, 29)
# f64 block, updated in place (+ grid, masked), and its minimum
WINDOW_BLOCKS = 2
# share of the free device memory a chunk may take
FOLD_MEMORY_SHARE = 0.5
# at most this many guides per chunk: a chunk's tables come back to the
# host through page-locked memory (~1.3 MB per guide at n = 100), whose
# blocks PyTorch's host allocator keeps and hands to the next chunk, so
# the cap bounds what the process pins; the DP takes no longer per guide
# at this size than at four times it
MAX_CHUNK = 4096


def encode_rna(seq: str) -> np.ndarray:
    """RNA/DNA string -> codes (A=0, C=1, G=2, U/T=3)."""
    table = np.full(256, 255, dtype=np.uint8)
    for ch, c in zip("ACGUacgu", [0, 1, 2, 3, 0, 1, 2, 3]):
        table[ord(ch)] = c
    table[ord("T")] = 3
    table[ord("t")] = 3
    codes = table[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError(f"non-ACGU character in RNA sequence: {seq!r}")
    return codes


def guide_bytes(n: int) -> int:
    """Device bytes one guide of length ``n`` holds at the fold's peak."""
    return 8 * n * (FOLD_PLANES * n + WINDOW_BLOCKS * A_SLICE * (MAXLOOP - 1))


def _device_tables(device):
    """The energy tables (rna_params.tables, read at call time so a
    parameter file installed by the gate applies) as f64 device tensors."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in rp.tables(512).items()}


def _precompute(codes, device, t=None):
    """Sequence-dependent dense (B, n, n) tables for the DP, f64, built by
    torch gathers on ``device`` in the JAX package's order of operations
    (each value a table lookup or the same f64 sum), so every table equals
    the numpy one exactly.

    Returns a dict of device tensors: ``pc`` (pair code, 6 = no pair),
    ``can_pair``, ``hp`` (full hairpin energy of the closing pair (i, j)),
    ``mi_out`` / ``mi_in`` (outer / inner interior-loop mismatch) and their
    1xn and 2x3 families, ``e11`` / ``e12`` / ``e21`` / ``e22`` (complete
    small interior loop energies), ``mlw`` / ``extw`` (multiloop and
    exterior stem weights, excluding V), ``mlclose`` (multiloop closing
    pair), and the ``stack`` / ``bulge`` / ``internal`` tables.
    """
    if t is None:
        t = _device_tables(device)
    codes = torch.as_tensor(np.asarray(codes), device=device).long()
    B, n = codes.shape
    pair_code = torch.as_tensor(rp.PAIR_CODE, device=device).long()
    pair_rev = torch.as_tensor(rp.PAIR_REV, device=device).long()
    pair_is_au = torch.as_tensor(rp.PAIR_IS_AU, device=device,
                                 dtype=torch.float64)
    pc = pair_code[codes[:, :, None], codes[:, None, :]]
    pc = torch.where(pc < 0, 6, pc)                         # (B, n, n)
    can_pair = pc != 6

    i_idx = torch.arange(n, device=device)
    au = pair_is_au[pc] * rp.TERMINAL_AU                    # (B, n, n)

    # neighbours clipped to stay in range; boundary handling below
    nxt = torch.clamp(i_idx + 1, max=n - 1)
    prv = torch.clamp(i_idx - 1, min=0)
    s_ip1 = codes[:, nxt]          # s[i+1]
    s_im1 = codes[:, prv]          # s[i-1]

    # hairpin: init + (triloop: AU | >3: mismatch); a special tri/tetra/
    # hexaloop entry is a TOTAL energy replacing the generic formula
    # (ViennaRNA E_Hairpin semantics; INF in the table means no entry)
    ls = i_idx[None, :] - i_idx[:, None] - 1                # (n, n) j - i - 1
    ls_b = ls.expand(B, n, n)
    hp = t["hairpin"][torch.clamp(ls_b, 0, 512)]
    mm_h = t["mismatch_h"][pc, s_ip1[:, :, None], s_im1[:, None, :]]
    hp = hp + torch.where(ls_b == 3, au, mm_h)
    # special loops: packed subsequence codes
    for L, key in ((3, "tri"), (4, "tetra"), (6, "hexa")):
        if not (rp.tables(512)[key] < INF / 2).any():
            continue
        W = L + 2
        if n < W:
            continue
        packs = torch.zeros((B, n - W + 1), dtype=torch.long, device=device)
        for m in range(W):
            packs = packs * 4 + codes[:, m:n - W + 1 + m]
        total = t[key][packs]                               # (B, n-W+1)
        ii = torch.arange(n - W + 1, device=device)
        sub = hp[:, ii, ii + W - 1]
        hp[:, ii, ii + W - 1] = torch.where(total < INF / 2, total, sub)
    hp = torch.where((ls_b >= 3) & can_pair, hp, INF)

    # interior-loop mismatches (generic, 1xn, and 2x3 families)
    pc_rev = pair_rev[pc]

    def mi_pair(key):
        out = t[key][pc, s_ip1[:, :, None], s_im1[:, None, :]]
        # inner pair (k, l): tbl[rev(pc[k,l]), s[l+1], s[k-1]]
        inn = t[key][pc_rev, s_ip1[:, None, :], s_im1[:, :, None]]
        return out, inn

    mi_out, mi_in = mi_pair("mismatch_i")
    mi1n_out, mi1n_in = mi_pair("mismatch_1n")
    mi23_out, mi23_in = mi_pair("mismatch_23")

    # special small interior loops: complete transition energies (i,j) ->
    # implied inner pair, ViennaRNA int11/int21/int22 conventions; INF
    # where the inner pair is off-grid or unpairable
    def shift(k):
        return codes[:, torch.clamp(i_idx + k, 0, n - 1)]

    s1, s2 = shift(1), shift(2)
    sm1, sm2 = shift(-1), shift(-2)
    pin = {(dk, dl): torch.where(
        (i_idx[:, None] + dk < n) & (i_idx[None, :] - dl >= 0),
        pc_rev[:, torch.clamp(i_idx + dk, 0, n - 1)[:, None],
               torch.clamp(i_idx - dl, 0, n - 1)[None, :]], 6)
        for dk, dl in ((2, 2), (2, 3), (3, 2), (3, 3))}
    e11 = t["int11"][pc, pin[(2, 2)], s1[:, :, None], sm1[:, None, :]]
    e12 = t["int21"][pc, pin[(2, 3)], s1[:, :, None],
                     sm2[:, None, :], sm1[:, None, :]]
    e21 = t["int21"][pin[(3, 2)], pc, sm1[:, None, :],
                     s1[:, :, None], s2[:, :, None]]
    e22 = t["int22"][pc, pin[(3, 3)], s1[:, :, None], s2[:, :, None],
                     sm2[:, None, :], sm1[:, None, :]]
    del pin

    # d2 stem weights (boundary-aware): stem (k, l) gets
    # mm[pc, s[k-1], s[l+1]] inside, or single dangles at the boundary
    def stem_weight(mm_tbl):
        both = mm_tbl[pc, s_im1[:, :, None], s_ip1[:, None, :]]
        d5 = t["dangle5"][pc, s_im1[:, :, None]]
        d3 = t["dangle3"][pc, s_ip1[:, None, :]]
        k_is0 = (i_idx == 0)[None, :, None]
        l_isn = (i_idx == n - 1)[None, None, :]
        w = torch.where(k_is0 & l_isn, 0.0,
                        torch.where(k_is0, d3,
                                    torch.where(l_isn, d5, both)))
        return w + au

    mlw = stem_weight(t["mismatch_m"]) + rp.ML_INTERN
    extw = stem_weight(t["mismatch_e"])

    # multiloop closing pair (i, j): reversed pair, si1 = s[j-1], sj1 = s[i+1]
    mlclose = (rp.ML_CLOSE + rp.ML_INTERN + au
               + t["mismatch_m"][pc_rev, s_im1[:, None, :], s_ip1[:, :, None]])

    return dict(pc=pc, can_pair=can_pair, hp=hp, mi_out=mi_out, mi_in=mi_in,
                mi1n_out=mi1n_out, mi1n_in=mi1n_in,
                mi23_out=mi23_out, mi23_in=mi23_in,
                e11=e11, e12=e12, e21=e21, e22=e22,
                mlw=mlw, extw=extw, mlclose=mlclose,
                stack=t["stack"], bulge=t["bulge"], internal=t["internal"])


def _loop_grids():
    """Static interior-loop initiation grids.

    Returns ``(grid, c1n, c23)``: the generic (L-1, L-1) init+Ninio grid
    for a,b in 1..L-1 with INF at every cell handled by a dedicated path
    (a==1 or b==1 rows/cols, and the 2x2 / 2x3 / 3x2 cells); the 1xn
    init+Ninio vector over n = 3..L-1; and the 2x3 init+Ninio scalar."""
    t = rp.tables(512)
    L = MAXLOOP
    a = np.arange(1, L)[:, None]
    b = np.arange(1, L)[None, :]
    special = ((a == 1) | (b == 1)
               | ((a == 2) & (b == 2)) | ((a == 2) & (b == 3))
               | ((a == 3) & (b == 2)))
    grid = np.where(
        (a + b <= L) & ~special,
        t["internal"][np.clip(a + b, 0, 512)]
        + np.minimum(rp.NINIO_MAX, rp.NINIO * np.abs(a - b)),
        INF,
    )
    ns = np.arange(3, L)
    c1n = (t["internal"][1 + ns]
           + np.minimum(rp.NINIO_MAX, rp.NINIO * (ns - 1)))
    c23 = float(t["internal"][5] + min(rp.NINIO_MAX, rp.NINIO))
    return grid, c1n, c23


def _fold_run(pre, grid, c1n, c23: float, ml_base: float):
    """The DP over one chunk's precomputed tables (device tensors, f64):
    returns (V, fML, fM1, f5).

    The JAX package's x64 program, column by column in the same candidate
    order of minima: each column's ``v_new`` is put together in full
    before V, W and Vau are written, then fM1, then fML.
    """
    pc, can = pre["pc"], pre["can_pair"]
    hp, mi_out, mi_in = pre["hp"], pre["mi_out"], pre["mi_in"]
    mlw, extw, mlclose = pre["mlw"], pre["extw"], pre["mlclose"]
    e11, e12, e21, e22 = pre["e11"], pre["e12"], pre["e21"], pre["e22"]
    mi1n_out, mi1n_in = pre["mi1n_out"], pre["mi1n_in"]
    mi23_out, mi23_in = pre["mi23_out"], pre["mi23_in"]
    stack = pre["stack"]
    bulge = pre["bulge"][: MAXLOOP + 1]
    B, n, _ = hp.shape
    device, dt = hp.device, hp.dtype
    pair_is_au = torch.as_tensor(rp.PAIR_IS_AU, device=device, dtype=dt)
    au_out = pair_is_au[pc] * rp.TERMINAL_AU
    grid = torch.as_tensor(grid, device=device, dtype=dt)
    c1n = torch.as_tensor(c1n, device=device, dtype=dt)

    L = MAXLOOP
    iidx = torch.arange(n, device=device)
    a_in = torch.arange(1, L, device=device)    # interior a, b (29,)
    b_in = a_in
    bsz = torch.arange(1, L + 1, device=device)  # bulge sizes 1..30
    n_1n = torch.arange(3, L, device=device)    # 1xn long-side sizes (27,)

    def clipg(x):
        return torch.clamp(x, 0, n - 1)

    def clip(x: int) -> int:
        return min(max(x, 0), n - 1)

    # the gathers X[:, rows, col] and X[:, rows[:, None], cols[None, :]]
    # as single-axis gathers, which run far faster than a 2-D index
    def at_col(X, rows, col: int):
        return X[:, :, col].index_select(1, rows.reshape(-1)).view(
            B, *rows.shape)

    def at_grid(X, rows, cols):
        return X.index_select(2, cols).index_select(1, rows)

    kk0 = clipg(iidx + 1)
    kk2, kk3, kk4 = clipg(iidx + 2), clipg(iidx + 3), clipg(iidx + 4)
    kka = clipg(iidx[:, None] + 1 + bsz[None, :])          # (n, 30)
    kki = clipg(iidx[:, None] + 1 + a_in[None, :])         # (n, 29)
    kkn = clipg(iidx[:, None] + 1 + n_1n[None, :])         # (n, 27)
    bulge_bsz = bulge[bsz][None, None, :]
    size1_mask = (bsz == 1)[None, None, :]

    V = torch.full((B, n, n), INF, dtype=dt, device=device)
    W = V + mi_in                               # V + inner mismatch
    Vau = V.clone()                             # V + inner AU (for bulges)
    fML = V.clone()
    fM1 = V.clone()
    # fml_ik[b, i, k] = fML[b, i + 1, k - 1] and fml_k[b, i, k] =
    # fML[b, i, k - 1], INF off the edge: the shifted fML planes of the
    # multiloop minima, kept current as each fML column is written
    fml_ik = V.clone()
    fml_k = V.clone()

    for j in range(1, n):
        # ----- V(i, j) -----
        v_new = hp[:, :, j]
        # stack (a=0, b=0)
        ll0 = clip(j - 1)
        p1 = pc[:, :, j]
        p2 = at_col(pc, kk0, ll0)
        st = stack[p1, p2] + at_col(V, kk0, ll0)
        st = torch.where(iidx + 1 < j - 1, st, INF)
        v_new = torch.minimum(v_new, st)
        au_j = au_out[:, :, j][:, :, None]
        # bulges: a = 0, b >= 1  (inner pair (i+1, j-1-b))
        llb = clipg(j - 1 - bsz)                               # (30,)
        p2b = at_grid(pc, kk0, llb)                            # (B, n, 30)
        innb = at_grid(V, kk0, llb)
        vaub = at_grid(Vau, kk0, llb)
        size1 = stack[p1[:, :, None], p2b] + bulge[1] + innb
        sizeg = bulge_bsz + au_j + vaub
        eb = torch.where(size1_mask, size1, sizeg)
        valid_b = (iidx[None, :, None] + 1) < (j - 1 - bsz)[None, None, :]
        v_new = torch.minimum(v_new, torch.where(valid_b, eb, INF).amin(2))
        # bulges: b = 0, a >= 1 (inner pair (i+1+a, j-1))
        p2a = at_col(pc, kka, ll0)
        inna = at_col(V, kka, ll0)
        vaua = at_col(Vau, kka, ll0)
        size1a = stack[p1[:, :, None], p2a] + bulge[1] + inna
        sizega = bulge_bsz + au_j + vaua
        ea = torch.where(size1_mask, size1a, sizega)
        valid_a = (iidx[:, None] + 1 + bsz[None, :])[None] < (j - 1)
        v_new = torch.minimum(v_new, torch.where(valid_a, ea, INF).amin(2))
        # generic interior loops over the W window (cells with a dedicated
        # ViennaRNA path are INF in grid and handled below). Inner pair
        # (i+1+a, j-1-b) with a, b >= 1 is on the grid only for rows
        # i < j - 4; every cell of the other rows is masked, so their
        # minimum is INF, as in the whole-window minimum
        rows = max(j - 4, 0)
        gen = torch.full((B, n), INF, dtype=dt, device=device)
        with trace.span("mfe.window"):
            # W[:, kki, lli]: the 29 columns (j-1-b, clipped) once, then
            # each slice's rows
            w_cols = W.index_select(2, clipg(j - 1 - b_in))    # (B, n, 29)
            for a0 in range(0, L - 1, A_SLICE) if rows else ():
                kk = kki[:rows, a0:a0 + A_SLICE]
                win = w_cols.index_select(1, kk.reshape(-1)).view(
                    B, rows, kk.shape[1], L - 1)               # (B, r, s, 29)
                win.add_(grid[a0:a0 + A_SLICE])
                valid_i = kk[:, :, None] < (j - 1 - b_in)[None, None, :]
                win.masked_fill_(~valid_i, INF)
                gen[:, :rows] = torch.minimum(gen[:, :rows],
                                              win.amin((2, 3)))
        v_new = torch.minimum(v_new, mi_out[:, :, j] + gen)
        # 1x1 / 1x2 / 2x1 / 2x2 interior loops: dedicated tables; the
        # precomputed E matrices are the complete transition energy
        jm2, jm3, jm4 = clip(j - 2), clip(j - 3), clip(j - 4)

        def spec(E, kk, ll, dk, dl):
            ok = (iidx + dk) < (j - dl)
            return torch.where(ok, E[:, :, j] + at_col(V, kk, ll), INF)

        v_new = torch.minimum(v_new, spec(e11, kk2, jm2, 2, 2))
        v_new = torch.minimum(v_new, spec(e12, kk2, jm3, 2, 3))
        v_new = torch.minimum(v_new, spec(e21, kk3, jm2, 3, 2))
        v_new = torch.minimum(v_new, spec(e22, kk3, jm3, 3, 3))
        # 2x3 / 3x2: dedicated mismatch family, fixed inner offsets
        e23 = (c23 + mi23_out[:, :, j]
               + at_col(mi23_in, kk3, jm4) + at_col(V, kk3, jm4))
        v_new = torch.minimum(v_new, torch.where((iidx + 3) < (j - 4), e23, INF))
        e32 = (c23 + mi23_out[:, :, j]
               + at_col(mi23_in, kk4, jm3) + at_col(V, kk4, jm3))
        v_new = torch.minimum(v_new, torch.where((iidx + 4) < (j - 3), e32, INF))
        # 1xn (n >= 3): inner (i+2, j-1-n), 1n mismatch family
        ll1 = clipg(j - 1 - n_1n)                              # (27,)
        w1 = at_grid(V, kk2, ll1) + at_grid(mi1n_in, kk2, ll1)
        ok1 = (iidx + 2)[:, None] < (j - 1 - n_1n)[None, :]
        cand1 = torch.where(ok1[None], c1n[None, None] + w1, INF)
        v_new = torch.minimum(v_new, mi1n_out[:, :, j] + cand1.amin(2))
        # nx1 (n >= 3): inner (i+1+n, j-2)
        wn = at_col(V, kkn, jm2) + at_col(mi1n_in, kkn, jm2)
        okn = (iidx[:, None] + 1 + n_1n[None, :]) < (j - 2)
        candn = torch.where(okn[None], c1n[None, None] + wn, INF)
        v_new = torch.minimum(v_new, mi1n_out[:, :, j] + candn.amin(2))
        # multiloop closure: min over k of fML(i+1, k-1) + fM1(k, j-1)
        fm1_col = fM1[:, :, clip(j - 1)]                       # (B, n) over k
        ml_min = (fml_ik + fm1_col[:, None, :]).amin(2)
        v_new = torch.minimum(v_new, mlclose[:, :, j] + ml_min)

        v_new = torch.where(can[:, :, j] & (iidx[None, :] < j), v_new, INF)
        V[:, :, j] = v_new
        W[:, :, j] = v_new + mi_in[:, :, j]
        Vau[:, :, j] = v_new + au_out[:, :, j]  # inner AU == outer AU of same pair

        # ----- fM1(i, j) -----
        fm1_new = torch.minimum(fM1[:, :, clip(j - 1)] + ml_base,
                                v_new + mlw[:, :, j])
        fM1[:, :, j] = fm1_new

        # ----- fML(i, j) -----
        fml_new = torch.minimum(fML[:, :, clip(j - 1)] + ml_base, fm1_new)
        two = (fml_k + fm1_new[:, None, :]).amin(2)
        fml_new = torch.minimum(fml_new, two)
        # left-unpaired: fML(i,j) <- fML(i+1,j) + ml_base, i.e.
        # min over k >= i of fML(k,j) + (k-i)*ml_base. Rebase by
        # +i*ml_base, reverse-cummin, rebase back (the bias terms
        # cancel exactly when ml_base == 0, the Turner-2004 default).
        ibias = ml_base * iidx.to(dt)
        fml_new = torch.flip(
            torch.cummin(torch.flip(fml_new + ibias[None, :], [1]),
                         dim=1).values, [1]) - ibias[None, :]
        fML[:, :, j] = fml_new
        if j + 1 < n:
            fml_ik[:, :n - 1, j + 1] = fml_new[:, 1:]
            fml_k[:, :, j + 1] = fml_new

    # exterior loop
    Vext = V + extw
    f5 = torch.zeros((B, n), dtype=dt, device=device)
    zero = torch.zeros((B, 1), dtype=dt, device=device)
    for j in range(1, n):
        prev = f5[:, j - 1]
        f5k = torch.cat([zero, f5[:, :-1]], dim=1)
        best = (f5k + Vext[:, :, j]).amin(1)
        f5[:, j] = torch.minimum(prev, best)
    return V, fML, fM1, f5


# the precomputed tables the host traceback reads, besides the DP's
_TRACE_KEYS = ("pc", "hp", "mi_out", "mi_in", "extw", "mlclose",
               "e11", "e12", "e21", "e22", "mi1n_out", "mi1n_in",
               "mi23_out", "mi23_in")


def chunk_size(B: int, n: int, device: torch.device,
               chunk: int | None = None) -> int:
    """Guides per fold chunk: ``chunk`` if given, else as many as fit in
    FOLD_MEMORY_SHARE of ``device``'s free memory at ``guide_bytes(n)``
    each, up to MAX_CHUNK; at least 1, at most ``B``."""
    from ..device import free_bytes

    if chunk is None:
        chunk = min(MAX_CHUNK, int(free_bytes(device) * FOLD_MEMORY_SHARE)
                    // guide_bytes(n))
    return max(1, min(B, int(chunk)))


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array. From the GPU through
    page-locked memory: a pageable copy runs at the rate the host faults
    in fresh pages, and the pinned blocks are reused chunk after chunk."""
    if not x.is_cuda:
        return x.numpy()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out.numpy()


def fold_chunks(codes: np.ndarray, device=None, chunk: int | None = None):
    """Fold a (B, n) uint8 code batch chunk by chunk on ``device`` (None:
    the GPU; raises without one). Yields ``(energy, tables)`` per chunk in
    batch order: ``energy`` (b,) f64 and ``tables`` the chunk's DP tables
    and the precomputed tables :func:`traceback` reads, as host numpy
    arrays. On the GPU ``tables["device_ms"]`` is ``(precompute, DP)``
    from CUDA events. The chunk's device tensors are dropped before the
    chunk is yielded; drop its tables before asking for the next, so that
    their host memory serves the next chunk."""
    from ..device import resolve_device

    dev = resolve_device(device)
    codes = np.asarray(codes)
    B, n = codes.shape
    size = chunk_size(B, n, dev, chunk)
    t = _device_tables(dev)
    host = rp.tables(512)
    grid, c1n, c23 = _loop_grids()
    ml_base = float(rp.ML_BASE)
    cuda = dev.type == "cuda"
    for lo in range(0, B, size):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        with trace.span("mfe.precompute"):
            pre = _precompute(codes[lo:lo + size], dev, t)
        if cuda:
            ev[1].record()
        with trace.span("mfe.dp"):
            dp = _fold_run(pre, grid, c1n, c23, ml_base)
        if cuda:
            ev[2].record()
        pre["pc"] = pre["pc"].int()
        V, fML, fM1, f5 = (_to_host(x) for x in dp)
        tables = {
            "eps": 1e-6, "V": V, "fML": fML, "fM1": fM1, "f5": f5,
            "pre": {**{k: _to_host(pre[k]) for k in _TRACE_KEYS},
                    "stack": host["stack"], "bulge": host["bulge"],
                    "internal": host["internal"]},
        }
        if cuda:
            tables["device_ms"] = (ev[0].elapsed_time(ev[1]),
                                   ev[1].elapsed_time(ev[2]))
        del pre, dp
        yield np.minimum(f5[:, n - 1], 0.0), tables
        # the pinned blocks return to the host allocator for the next
        # chunk; traceback's mutually recursive closures leave reference
        # cycles over views of the chunk's arrays, which only a collection
        # frees
        del tables, V, fML, fM1, f5
        gc.collect()


def fold_batch(codes: np.ndarray, device=None, chunk: int | None = None):
    """MFE-fold a batch of equal-length RNA code arrays on ``device``.

    Parameters: ``codes`` (B, n) uint8. Returns ``(energy (B,), tables)``
    where ``tables`` is the dict of DP tables (host numpy, the chunks in
    batch order) used by :func:`traceback`.
    """
    parts = list(fold_chunks(codes, device, chunk))
    energy = np.concatenate([e for e, _ in parts])
    first = parts[0][1]
    tables = {"eps": first["eps"],
              **{k: np.concatenate([tb[k] for _, tb in parts])
                 for k in ("V", "fML", "fM1", "f5")},
              "pre": {k: (np.concatenate([tb["pre"][k] for _, tb in parts])
                          if k in _TRACE_KEYS else v)
                      for k, v in first["pre"].items()}}
    return energy, tables


def traceback(tables, b: int) -> str:
    """Host traceback of one structure from the DP tables (same model as
    the DP; EPS-tolerant comparisons absorb rounding)."""
    V = tables["V"][b]
    fML = tables["fML"][b]
    fM1 = tables["fM1"][b]
    f5 = tables["f5"][b]
    pre = tables["pre"]
    hp = pre["hp"][b]
    mi_out = pre["mi_out"][b]
    mi_in = pre["mi_in"][b]
    extw = pre["extw"][b]
    mlclose = pre["mlclose"][b]
    pc = pre["pc"][b]
    au = rp.PAIR_IS_AU[pc] * rp.TERMINAL_AU
    stack_t = pre["stack"]
    bulge_t = pre["bulge"]
    internal_t = pre["internal"]
    e11, e12 = pre["e11"][b], pre["e12"][b]
    e21, e22 = pre["e21"][b], pre["e22"][b]
    mi1n_out, mi1n_in = pre["mi1n_out"][b], pre["mi1n_in"][b]
    mi23_out, mi23_in = pre["mi23_out"][b], pre["mi23_in"][b]
    n = V.shape[0]
    L = MAXLOOP
    out = ["." for _ in range(n)]
    # f64 tables allow exact-tie matching (same tolerance as the C++
    # engine, so co-optimal ties break identically)
    EPS = tables.get("eps", 1e-2)

    def loop_cost(i, j, k, l):
        # mirrors native/fold.cpp loop_e (ViennaRNA E_IntLoop)
        a, bb = k - i - 1, j - l - 1
        size = a + bb
        if size == 0:
            return stack_t[pc[i, j], pc[k, l]]
        if a == 0 or bb == 0:
            if size == 1:
                return stack_t[pc[i, j], pc[k, l]] + bulge_t[1]
            return bulge_t[size] + au[i, j] + au[k, l]
        if (a, bb) == (1, 1):
            return e11[i, j]
        if (a, bb) == (1, 2):
            return e12[i, j]
        if (a, bb) == (2, 1):
            return e21[i, j]
        if (a, bb) == (2, 2):
            return e22[i, j]
        ninio = min(rp.NINIO_MAX, rp.NINIO * abs(a - bb))
        if a == 1 or bb == 1:
            return (internal_t[size] + ninio
                    + mi1n_out[i, j] + mi1n_in[k, l])
        if size == 5:
            return (internal_t[5] + ninio
                    + mi23_out[i, j] + mi23_in[k, l])
        return internal_t[size] + ninio + mi_out[i, j] + mi_in[k, l]

    def trace_v(i, j):
        out[i] = "("
        out[j] = ")"
        e = V[i, j]
        if abs(e - hp[i, j]) < EPS:
            return
        # candidate order matches native/fold.cpp (k ascending, l
        # descending) so co-optimal ties break identically across engines
        for k in range(i + 1, min(j - 1, i + 2 + L)):
            for l in range(j - 1, max(k + 1, j - 1 - (L - (k - i - 1))) - 1, -1):
                if pc[k, l] == 6:
                    continue
                if abs(e - (loop_cost(i, j, k, l) + V[k, l])) < EPS:
                    trace_v(k, l)
                    return
        for k in range(i + 2, j):
            if abs(e - (mlclose[i, j] + fML[i + 1, k - 1]
                        + fM1[k, j - 1])) < EPS:
                trace_fml(i + 1, k - 1)
                trace_fm1(k, j - 1)
                return

    def trace_fm1(i, j):
        while j > i and abs(fM1[i, j] - (fM1[i, j - 1] + rp.ML_BASE)) < EPS:
            j -= 1
        trace_v(i, j)

    def trace_fml(i, j):
        while True:
            if abs(fML[i, j] - fM1[i, j]) < EPS:
                trace_fm1(i, j)
                return
            if i < j and abs(fML[i, j] - (fML[i + 1, j] + rp.ML_BASE)) < EPS:
                i += 1
                continue
            if j > i and abs(fML[i, j] - (fML[i, j - 1] + rp.ML_BASE)) < EPS:
                j -= 1
                continue
            done = False
            for k in range(i + 1, j + 1):
                if abs(fML[i, j] - (fML[i, k - 1] + fM1[k, j])) < EPS:
                    trace_fm1(k, j)
                    j = k - 1
                    done = True
                    break
            if not done:
                return

    def trace_f5(j):
        while j > 0:
            if abs(f5[j] - f5[j - 1]) < EPS:
                j -= 1
                continue
            found = False
            for k in range(0, j - 3):
                prev = f5[k - 1] if k >= 1 else 0.0
                if abs(f5[j] - (prev + V[k, j] + extw[k, j])) < EPS:
                    trace_v(k, j)
                    j = k - 1
                    found = True
                    break
            if not found:
                return

    if f5[n - 1] < INF / 2 and f5[n - 1] < -EPS:
        trace_f5(n - 1)
    return "".join(out)


def fold_sequences(seqs: list[str], device=None, chunk: int | None = None):
    """Fold a list of equal-length RNA strings on ``device`` (None: the
    GPU), tracing each chunk back on the host before the next is folded.

    Returns (structures, energies) where structures are dot-bracket strings
    and energies are floats (kcal/mol, 0.0 for a fully unpaired strand).
    """
    if not seqs:
        return [], np.zeros(0)
    codes = np.stack([encode_rna(s) for s in seqs])
    structures, energies = [], []
    for energy, tables in fold_chunks(codes, device, chunk):
        structures += [traceback(tables, b) for b in range(len(energy))]
        energies.append(energy)
        del tables
    return structures, np.concatenate(energies)
