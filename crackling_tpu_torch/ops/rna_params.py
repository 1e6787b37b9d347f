"""Turner-2004 RNA nearest-neighbor energy model — single source of truth.

Both MFE engines consume these tables: the native C++ fold
(native/fold.cpp, via the packed blob from :func:`param_blob`) and the
batched JAX fold (ops/mfe.py). Because the tables are defined exactly once,
the two engines agree bit-for-bit on the model and cross-validate each
other; the ViennaRNA backend (pipeline/secondary_structure.py) remains the
external oracle where an RNAfold binary exists.

The model follows RNAfold's default ``-d2`` decomposition
(reference behavior: /root/reference/src/crackling/Crackling.py:426-435
shells out to ``RNAfold --noPS``):

* hairpins: length initiation + terminal mismatch (loops >3) or terminal
  AU/GU penalty (triloops), special tetraloop bonuses;
* helices: Watson-Crick/wobble stacking;
* bulges: length initiation, size-1 bulges keep the flanking stack;
* interior loops: length initiation + Ninio asymmetry + terminal
  mismatches on both closing pairs;
* multiloops: affine (closing + per-branch + per-unpaired) with d2-style
  terminal mismatches on every stem including the closing pair;
* exterior loop: d2-style terminal mismatches on every stem.

Provenance: values marked EXACT below are the published Turner-2004
numbers (NNDB, rna.urmc.rochester.edu/NNDB; mirrored in ViennaRNA's
``rna_turner2004.par``). Values marked RECONSTRUCTED are rebuilt from the
published dangle/mismatch structure with literature-scale magnitudes
because the full parameter file is not redistributed here; they carry the
right sign, ordering, and scale but are not digit-exact, so verdicts can
differ from RNAfold near the energy thresholds. ``tests/test_mfe.py``
measures engine agreement, and the vienna-gated harness records the
RNAfold verdict-agreement rate whenever the binary is present.

**Digit-exact path**: :func:`set_parameter_file` loads a ViennaRNA
parameter file (``rna_turner2004.par``, shipped with every ViennaRNA
install; GPL, so not vendored here) and overrides every table and scalar
this model consumes — including the special interior-loop tables (int11 /
int21 / int22, 1xn and 2x3 mismatch families) and the special-hairpin
totals that ViennaRNA substitutes for the generic formulas. The engines
implement ViennaRNA's exact loop decomposition (loop_energies.h
``E_Hairpin`` / ``E_IntLoop`` semantics), so with the real parameter file
the model is structurally identical to RNAfold's default ``-d2`` energy
computation. Without a file, the special tables default to the generic
decomposition (behavior identical to the reconstructed model). Wire-up:
``[rnafold] parameter-file`` in the pipeline config.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

INF = 1e6
MAXLOOP = 30          # max unpaired bases in a bulge/interior loop (EXACT)

# base codes: A=0, C=1, G=2, U=3
# pair types: 0 CG, 1 GC, 2 GU, 3 UG, 4 AU, 5 UA, 6 none (ViennaRNA order)
PAIR_NAMES = ["CG", "GC", "GU", "UG", "AU", "UA"]
PAIR_CODE = -np.ones((4, 4), dtype=np.int32)
for _k, (_a, _b) in enumerate([(1, 2), (2, 1), (2, 3), (3, 2), (0, 3), (3, 0)]):
    PAIR_CODE[_a, _b] = _k
# reversed(pair p) = pair seen from the other strand: CG<->GC, GU<->UG, AU<->UA
PAIR_REV = np.array([1, 0, 3, 2, 5, 4, 6], dtype=np.int32)
# pairs that close with A-U or G-U (terminal AU/GU penalty applies): EXACT
PAIR_IS_AU = np.array([0, 0, 1, 1, 1, 1, 0], dtype=np.int32)

TERMINAL_AU = 0.50    # EXACT
NINIO = 0.60          # per unpaired-count asymmetry unit (EXACT)
NINIO_MAX = 3.00      # EXACT
ML_CLOSE = 3.40       # multiloop closing (NNDB affine fit; ViennaRNA's
ML_INTERN = 0.40      #   Turner-2004 file uses its own linear-fit values —
ML_BASE = 0.00        #   loaded via set_parameter_file when available)
LXC = 1.75 * 0.6163   # Jacobson-Stockmayer ln coefficient (EXACT)

# -- stacking (EXACT, Turner 2004) -----------------------------------------
_S = {
    ("CG", "CG"): -3.26, ("CG", "GC"): -3.42, ("CG", "GU"): -2.11,
    ("CG", "UG"): -1.41, ("CG", "AU"): -2.24, ("CG", "UA"): -2.08,
    ("GC", "CG"): -2.36, ("GC", "GC"): -3.26, ("GC", "GU"): -1.53,
    ("GC", "UG"): -2.51, ("GC", "AU"): -2.35, ("GC", "UA"): -2.11,
    ("GU", "CG"): -2.51, ("GU", "GC"): -1.41, ("GU", "GU"): -0.50,
    ("GU", "UG"): +1.29, ("GU", "AU"): -1.27, ("GU", "UA"): -1.00,
    ("UG", "CG"): -1.53, ("UG", "GC"): -2.11, ("UG", "GU"): +0.30,
    ("UG", "UG"): -0.50, ("UG", "AU"): -1.00, ("UG", "UA"): -0.80,
    ("AU", "CG"): -2.11, ("AU", "GC"): -2.08, ("AU", "GU"): -1.00,
    ("AU", "UG"): -0.80, ("AU", "AU"): -0.93, ("AU", "UA"): -1.10,
    ("UA", "CG"): -2.35, ("UA", "GC"): -2.24, ("UA", "GU"): -1.27,
    ("UA", "UG"): -1.00, ("UA", "AU"): -1.33, ("UA", "UA"): -0.93,
}

# -- loop-length initiation (EXACT, Turner 2004; Jacobson-Stockmayer
#    extrapolation 1.75*RT*ln(n/30) beyond 30 handled at table build) ------
_HAIRPIN_INIT = [INF, INF, INF, 5.4, 5.6, 5.7, 5.4, 6.0, 5.5, 6.4, 6.5,
                 6.6, 6.7, 6.8, 6.9, 6.9, 7.0, 7.1, 7.1, 7.2, 7.2, 7.3,
                 7.3, 7.4, 7.4, 7.5, 7.5, 7.5, 7.6, 7.6, 7.7]
_BULGE_INIT = [INF, 3.8, 2.8, 3.2, 3.6, 4.0, 4.4, 4.6, 4.7, 4.8, 4.9,
               5.0, 5.1, 5.2, 5.3, 5.4, 5.4, 5.5, 5.5, 5.6, 5.7, 5.7,
               5.8, 5.8, 5.8, 5.9, 5.9, 6.0, 6.0, 6.0, 6.1]
_INTERNAL_INIT = [INF, INF, INF, INF, 1.1, 2.0, 2.0, 2.1, 2.3, 2.4, 2.5,
                  2.6, 2.7, 2.8, 2.9, 2.9, 3.0, 3.1, 3.1, 3.2, 3.3, 3.3,
                  3.4, 3.4, 3.5, 3.5, 3.5, 3.6, 3.6, 3.7, 3.7]

# -- dangles (RECONSTRUCTED: published sign/scale per pair family) ---------
# dangle3[p, b]: base b stacked 3' of the pair's 5' strand (i.e. after i)
_DANGLE3 = {
    "CG": [-1.1, -0.4, -1.3, -0.6],
    "GC": [-1.7, -0.8, -1.7, -1.2],
    "GU": [-0.8, -0.5, -0.8, -0.6],
    "UG": [-0.7, -0.1, -0.7, -0.1],
    "AU": [-0.7, -0.1, -0.7, -0.1],
    "UA": [-0.8, -0.5, -0.8, -0.6],
}
# dangle5[p, b]: base b stacked 5' of the pair (i.e. before i)
_DANGLE5 = {
    "CG": [-0.3, -0.3, -0.4, -0.2],
    "GC": [-0.2, -0.3, -0.0, -0.0],
    "GU": [-0.2, -0.2, -0.2, -0.2],
    "UG": [-0.3, -0.2, -0.2, -0.2],
    "AU": [-0.3, -0.3, -0.4, -0.2],
    "UA": [-0.3, -0.2, -0.2, -0.2],
}

# first-mismatch bonuses for hairpin/interior terminal mismatches
# (RECONSTRUCTED: G·A, U·U and G·G first mismatches are the published
# stabilizing cases; magnitudes literature-scale)
_MM_BONUS = {(2, 0): -0.8, (0, 2): -0.8, (3, 3): -0.7, (2, 2): -0.6}

# -- special hairpins (RECONSTRUCTED subset: the stable GNRA / UNCG / CUUG
#    families with literature-scale full-loop bonuses; keys are the loop
#    plus closing pair, 5'->3', as in ViennaRNA's Tetraloops table) --------
TETRALOOP_BONUS = {
    # GNRA family
    "CGAAAG": -2.2, "CGCAAG": -2.1, "CGAGAG": -2.0, "CGUGAG": -2.0,
    "CGGAAG": -2.2, "CGUAAG": -2.0, "CGGGAG": -1.9, "CGCGAG": -1.9,
    "GGAAAC": -2.6, "GGCAAC": -2.4, "GGAGAC": -2.3, "GGUGAC": -2.3,
    "GGGAAC": -2.6, "GGUAAC": -2.3, "GGGGAC": -2.2, "GGCGAC": -2.2,
    "UGAAAA": -1.6, "UGCAAA": -1.5, "UGAGAA": -1.4, "UGGAAA": -1.6,
    "AGAAAU": -1.6, "AGCAAU": -1.5, "AGAGAU": -1.4, "AGGAAU": -1.6,
    # UNCG family
    "CUUCGG": -3.0, "GUUCGC": -2.6, "AUUCGU": -1.8, "UUUCGA": -1.8,
    "CUACGG": -2.0, "CUCCGG": -1.9, "CUGCGG": -1.9,
    # CUUG
    "CCUUGG": -2.4, "GCUUGC": -2.0,
}
TRILOOP_BONUS: dict[str, float] = {}   # none in the reconstructed set
HEXALOOP_BONUS: dict[str, float] = {}


def _js_extend(init30: np.ndarray, nmax: int) -> np.ndarray:
    """Extend a 0..30 initiation table to 0..nmax with the
    Jacobson-Stockmayer term LXC*ln(n/30) (LXC = 1.75*RT, ViennaRNA's
    ``lxc``; RT = 0.6163 kcal/mol)."""
    out = np.full(nmax + 1, INF, dtype=np.float64)
    out[: init30.shape[0]] = init30
    base = init30[30]
    for n in range(31, nmax + 1):
        out[n] = base + LXC * np.log(n / 30.0)
    return out


@lru_cache(maxsize=4)
def tables(nmax: int = 512):
    """All model tables as a dict of float64 numpy arrays.

    Shapes (P = 7 pair codes incl. 'none'):
      stack (P,P); hairpin/bulge/internal (nmax+1,);
      mismatch_h/i/m/ext/1n/23 (P,4,4); dangle5/3 (P,4);
      int11 (P,P,4,4); int21 (P,P,4,4,4); int22 (P,P,4,4,4,4) —
      inner-pair dimension uses the REVERSED pair code (ViennaRNA's
      ``type_2`` convention, loop_energies.h E_IntLoop);
      tetra (4096,) / tri (1024,) / hexa (65536,) dense lookups over
      packed loop+closing-pair k-mers (lex, 2 bits/base) holding the
      TOTAL hairpin energy that replaces the generic formula (INF where
      no special entry exists).

    Defaults for the special interior tables are derived from the generic
    decomposition, so without a parameter file the model is identical to
    the reconstructed Turner-2004 model; :func:`set_parameter_file`
    overrides everything with digit-exact file values.
    """
    ov = dict((_PAR_OVERRIDE or {}).get("tables", {}))
    P = 7

    def dflt(key, build):
        return np.asarray(ov[key], dtype=np.float64) if key in ov else build()

    def build_stack():
        t = np.full((P, P), INF)
        for (a, b), v in _S.items():
            t[PAIR_NAMES.index(a), PAIR_NAMES.index(b)] = v
        return t

    stack = dflt("stack", build_stack)
    hairpin = _js_extend(
        dflt("hairpin", lambda: np.asarray(_HAIRPIN_INIT, np.float64)), nmax)
    bulge = _js_extend(
        dflt("bulge", lambda: np.asarray(_BULGE_INIT, np.float64)), nmax)
    internal = _js_extend(
        dflt("internal", lambda: np.asarray(_INTERNAL_INIT, np.float64)),
        nmax)

    def build_dangle(src):
        t = np.zeros((P, 4))
        for k, name in enumerate(PAIR_NAMES):
            t[k] = src[name]
        return t

    d5 = dflt("dangle5", lambda: build_dangle(_DANGLE5))
    d3 = dflt("dangle3", lambda: build_dangle(_DANGLE3))

    # terminal-mismatch tables from the dangle decomposition + first-
    # mismatch bonuses (RECONSTRUCTED; see module docstring).
    # Convention (shared by both engines, ViennaRNA-style):
    # mismatch_X[p][si1][sj1] where si1 is the base adjacent to the pair's
    # first (5') base and sj1 the base adjacent to its second (3') base.
    def mm(scale: float, with_bonus: bool) -> np.ndarray:
        t = np.zeros((P, 4, 4))
        for p in range(6):
            for a in range(4):
                for b in range(4):
                    e = scale * (d5[p, a] + d3[p, b])
                    if with_bonus:
                        e += _MM_BONUS.get((a, b), 0.0)
                    t[p, a, b] = e
        return t

    mismatch_h = dflt("mismatch_h", lambda: mm(1.0, True))
    mismatch_i = dflt("mismatch_i", lambda: mm(0.7, True))
    mismatch_m = dflt("mismatch_m", lambda: mm(1.0, False))
    mismatch_e = dflt("mismatch_e", lambda: mm(1.0, False))
    # 1xn and 2x3 interior mismatch families default to the generic
    # interior table (ViennaRNA uses dedicated tables; E_IntLoop)
    mismatch_1n = dflt("mismatch_1n", lambda: mismatch_i.copy())
    mismatch_23 = dflt("mismatch_23", lambda: mismatch_i.copy())

    # special small interior loops, indexed [outer, REV(inner), bases...];
    # defaults reproduce the generic formula exactly (size init + Ninio +
    # both terminal mismatches), so behavior is unchanged without a file
    ninio1 = min(NINIO_MAX, NINIO)

    def build_int11():
        t = np.full((P, P, 4, 4), INF)
        for p in range(6):
            for q in range(6):
                for x in range(4):
                    for y in range(4):
                        t[p, q, x, y] = (internal[2] + mismatch_i[p, x, y]
                                         + mismatch_i[q, y, x])
        return t

    def build_int21():
        t = np.full((P, P, 4, 4, 4), INF)
        for p in range(6):
            for q in range(6):
                for x in range(4):
                    for y in range(4):
                        for z in range(4):
                            t[p, q, x, y, z] = (
                                internal[3] + ninio1
                                + mismatch_i[p, x, z] + mismatch_i[q, y, x])
        return t

    def build_int22():
        t = np.full((P, P, 4, 4, 4, 4), INF)
        mi = mismatch_i
        for p in range(6):
            for q in range(6):
                for w in range(4):
                    for x in range(4):
                        for y in range(4):
                            for z in range(4):
                                t[p, q, w, x, y, z] = (
                                    internal[4] + mi[p, w, z] + mi[q, y, x])
        return t

    int11 = dflt("int11", build_int11)
    int21 = dflt("int21", build_int21)
    int22 = dflt("int22", build_int22)
    for arr in (int11, int21, int22):   # 'no pair' slots are never a loop
        arr[6, :] = INF
        arr[:, 6] = INF

    # special hairpins: dense TOTAL-energy lookups (INF = no entry).
    # Defaults convert the reconstructed bonuses to totals with the same
    # generic terms the engines would otherwise add, so the default model
    # is unchanged; parameter files provide totals directly.
    code = {"A": 0, "C": 1, "G": 2, "U": 3}

    def seq_codes(sq):
        return [code[ch] for ch in sq]

    def dense_total(table: dict[str, float], loop_len: int) -> np.ndarray:
        out = np.full(4 ** (loop_len + 2), INF)
        for sq, v in table.items():
            cs = seq_codes(sq)
            p = PAIR_CODE[cs[0], cs[-1]]
            p = 6 if p < 0 else int(p)
            idx = 0
            for c in cs:
                idx = idx * 4 + c
            if loop_len == 3:
                base = hairpin[3] + (TERMINAL_AU if PAIR_IS_AU[p] else 0.0)
            else:
                base = hairpin[loop_len] + mismatch_h[p, cs[1], cs[-2]]
            out[idx] = base + v
        return out

    def special(key, table, loop_len):
        if key in ov:
            return np.asarray(ov[key], dtype=np.float64)
        return dense_total(table, loop_len)

    return {
        "stack": stack,
        "hairpin": hairpin,
        "bulge": bulge,
        "internal": internal,
        "mismatch_h": mismatch_h,
        "mismatch_i": mismatch_i,
        "mismatch_m": mismatch_m,
        "mismatch_e": mismatch_e,
        "mismatch_1n": mismatch_1n,
        "mismatch_23": mismatch_23,
        "dangle5": d5,
        "dangle3": d3,
        "int11": int11,
        "int21": int21,
        "int22": int22,
        "tetra": special("tetra", TETRALOOP_BONUS, 4),
        "tri": special("tri", TRILOOP_BONUS, 3),
        "hexa": special("hexa", HEXALOOP_BONUS, 6),
    }


# ---- ViennaRNA parameter-file loading -------------------------------------

# scalar defaults captured for restore when the override is cleared
_DEFAULT_SCALARS = dict(TERMINAL_AU=TERMINAL_AU, NINIO=NINIO,
                        NINIO_MAX=NINIO_MAX, ML_CLOSE=ML_CLOSE,
                        ML_INTERN=ML_INTERN, ML_BASE=ML_BASE, LXC=LXC)
_PAR_OVERRIDE: dict | None = None
_PARAM_FILE: str | None = None

# (section name in the .par file, our table key, accepted layouts).
# ViennaRNA writes tables over pair types [CG GC GU UG AU UA NN] (same
# order as our codes 0..6) and 5-wide base dims [N A C G U]; layouts are
# matched by token count and N/NN slots sliced off. dG sections only
# (*_enthalpies are skipped by name).
_PAR_MATRIX_SECTIONS = {
    "stack": ("stack", [((7, 7), ())]),
    "mismatch_hairpin": ("mismatch_h", [((7, 5, 5), (1, 2))]),
    "mismatch_interior": ("mismatch_i", [((7, 5, 5), (1, 2))]),
    "mismatch_interior_1n": ("mismatch_1n", [((7, 5, 5), (1, 2))]),
    "mismatch_interior_23": ("mismatch_23", [((7, 5, 5), (1, 2))]),
    "mismatch_multi": ("mismatch_m", [((7, 5, 5), (1, 2))]),
    "mismatch_exterior": ("mismatch_e", [((7, 5, 5), (1, 2))]),
    "dangle5": ("dangle5", [((7, 5), (1,)), ((8, 5), (0, 1))]),
    "dangle3": ("dangle3", [((7, 5), (1,)), ((8, 5), (0, 1))]),
    "int11": ("int11", [((7, 7, 5, 5), (2, 3))]),
    "int21": ("int21", [((7, 7, 5, 5, 5), (2, 3, 4))]),
    "int22": ("int22", [((7, 7, 5, 5, 5, 5), (2, 3, 4, 5)),
                        ((6, 6, 4, 4, 4, 4), ())]),
    "hairpin": ("hairpin", [((31,), ())]),
    "bulge": ("bulge", [((31,), ())]),
    "interior": ("internal", [((31,), ())]),
}
_PAR_INF_CUTOFF = 1e4    # dcal values >= 10^6 (ViennaRNA INF) -> our INF


def parse_vienna_par(path: str) -> dict:
    """Parse a ViennaRNA 2.x parameter file (e.g. ``rna_turner2004.par``).

    Returns ``{"tables": {...}, "scalars": {...}}`` in this module's table
    format (kcal/mol; special-hairpin sections as dense TOTAL-energy
    lookups). Only the dG sections the model consumes are read; enthalpy
    sections (``*_enthalpies``) and duplex-init values are ignored.
    """
    text = open(path, encoding="utf-8", errors="replace").read()
    if "parameter file" not in text.splitlines()[0].lower():
        raise ValueError(f"{path}: not a ViennaRNA parameter file")
    # strip /* ... */ comments (may span lines)
    import re

    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    sections: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#"):
            current = line[1:].strip()
            sections.setdefault(current, [])
            continue
        if current and line:
            sections[current].extend(line.split())

    def to_e(tok: str) -> float:
        if tok in ("INF", "NST", "DEF"):
            return INF
        v = float(tok) / 100.0
        return INF if abs(v) >= _PAR_INF_CUTOFF else v

    out_tables: dict[str, np.ndarray] = {}
    for sec, (key, layouts) in _PAR_MATRIX_SECTIONS.items():
        toks = sections.get(sec)
        if not toks:
            continue
        vals = np.asarray([to_e(t) for t in toks])
        for shape, n_dims in layouts:
            if vals.size != int(np.prod(shape)):
                continue
            arr = vals.reshape(shape)
            for d in n_dims:                      # drop the N/unused slot
                arr = np.take(arr, range(1, arr.shape[d]), axis=d)
            if key in ("int11", "int21", "int22") and arr.shape[0] == 6:
                full_shape = (7, 7) + arr.shape[2:]
                full = np.full(full_shape, INF)
                full[:6, :6] = arr
                arr = full
            if key in ("hairpin", "bulge", "internal"):
                pass                              # 0..30 init vector
            out_tables[key] = arr
            break
        else:
            raise ValueError(
                f"{path}: section '{sec}' has {vals.size} values; "
                f"no known layout matches")

    # special hairpins: lines of "SEQ dG dH"; dG is the loop's TOTAL energy
    code = {"A": 0, "C": 1, "G": 2, "U": 3}
    for sec, key, loop_len in (("Triloops", "tri", 3),
                               ("Tetraloops", "tetra", 4),
                               ("Hexaloops", "hexa", 6)):
        toks = sections.get(sec)
        if toks is None:
            continue
        dense = np.full(4 ** (loop_len + 2), INF)
        for w in range(0, len(toks) - 1, 3):
            sq = toks[w]
            if len(sq) != loop_len + 2 or any(c not in code for c in sq):
                raise ValueError(f"{path}: bad {sec} entry {sq!r}")
            idx = 0
            for ch in sq:
                idx = idx * 4 + code[ch]
            dense[idx] = to_e(toks[w + 1])
        out_tables[key] = dense

    scalars: dict[str, float] = {}
    ml = sections.get("ML_params")
    if ml and len(ml) >= 6:        # cu cu_dH cc cc_dH ci ci_dH
        scalars["ML_BASE"] = to_e(ml[0])
        scalars["ML_CLOSE"] = to_e(ml[2])
        scalars["ML_INTERN"] = to_e(ml[4])
    ninio = sections.get("NINIO")
    if ninio and len(ninio) >= 3:  # m m_dH max
        scalars["NINIO"] = to_e(ninio[0])
        scalars["NINIO_MAX"] = to_e(ninio[2])
    misc = sections.get("Misc")
    if misc and len(misc) >= 3:    # DuplexInit dG/dH, TerminalAU dG/dH, lxc
        scalars["TERMINAL_AU"] = to_e(misc[2])
        if len(misc) >= 5:
            scalars["LXC"] = float(misc[4]) / 100.0
    return {"tables": out_tables, "scalars": scalars}


def set_parameter_file(path: str | None) -> None:
    """Globally load (or with ``None`` clear) a ViennaRNA parameter file.

    Overrides every table/scalar of the energy model for both fold
    engines; clears the table and blob caches so the next fold uses the
    new model."""
    global _PAR_OVERRIDE, _PARAM_FILE
    parsed = parse_vienna_par(path) if path else None
    _PAR_OVERRIDE = parsed
    _PARAM_FILE = path if path else None
    merged = dict(_DEFAULT_SCALARS)
    if parsed:
        merged.update(parsed["scalars"])
    globals().update(merged)
    tables.cache_clear()
    param_blob.cache_clear()


def active_parameter_file() -> str | None:
    return _PARAM_FILE


# ---- packed blob for the C++ engine --------------------------------------
# layout: little-endian float64 sections in this exact order; the C++ side
# (native/fold.cpp) hard-codes the same offsets and verifies the total
# length.
_BLOB_SECTIONS = [
    ("stack", (7, 7)),
    ("hairpin", (513,)),
    ("bulge", (513,)),
    ("internal", (513,)),
    ("mismatch_h", (7, 4, 4)),
    ("mismatch_i", (7, 4, 4)),
    ("mismatch_m", (7, 4, 4)),
    ("mismatch_e", (7, 4, 4)),
    ("mismatch_1n", (7, 4, 4)),
    ("mismatch_23", (7, 4, 4)),
    ("dangle5", (7, 4)),
    ("dangle3", (7, 4)),
    ("int11", (7, 7, 4, 4)),
    ("int21", (7, 7, 4, 4, 4)),
    ("int22", (7, 7, 4, 4, 4, 4)),
    ("tetra", (4096,)),
    ("tri", (1024,)),
    ("hexa", (65536,)),
]
_BLOB_SCALARS = ["TERMINAL_AU", "NINIO", "NINIO_MAX",
                 "ML_CLOSE", "ML_INTERN", "ML_BASE"]


@lru_cache(maxsize=1)
def param_blob() -> np.ndarray:
    """Flat float64 parameter blob consumed by native/fold.cpp."""
    t = tables(512)
    parts = []
    for name, shape in _BLOB_SECTIONS:
        arr = np.asarray(t[name], dtype=np.float64)
        assert arr.shape == shape, (name, arr.shape, shape)
        parts.append(arr.reshape(-1))
    parts.append(np.asarray(
        [globals()[k] for k in _BLOB_SCALARS], dtype=np.float64))
    return np.ascontiguousarray(np.concatenate(parts))
