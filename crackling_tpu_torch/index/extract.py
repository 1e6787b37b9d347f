"""Vectorized candidate-guide and off-target site extraction (host, numpy).

Replaces the reference's per-character regex scans with strided window
predicates over 2-bit-encoded sequence arrays:

* candidate guides — semantics of ``processSequence``
  (/root/reference/src/crackling/Crackling.py:151-165):
  forward ``(?=([ATCG]{21}GG))``, reverse ``(?=(CC[ACGT]{21}))`` with the
  reverse hit stored as its reverse complement, so every candidate ends GG.

* off-target sites — semantics of ``extractOfftargets.py:23-24,97-108``:
  forward ``(?=([ACG][ACGT]{19}[ACGT][AG]G))`` keeping the first 20 chars,
  reverse ``(?=(C[CT][ACGT][ACGT]{19}[TGC]))`` keeping
  ``rc(match[0:20])``. Note the reference's reverse rule takes the first 20
  characters of the 23-mer *before* reverse-complementing — i.e. the stored
  reverse-strand "site" is the PAM-proximal 17 nt of the spacer plus the
  3 nt PAM. That quirk is score-visible and is replicated exactly.
"""

from __future__ import annotations

import numpy as np

from ..codec import BAD, bytes_to_codes, codes_rc, pack_lofirst, seq_to_bytes

# Upper+lowercase mapping used by off-target extraction (the reference
# upcases there, extractOfftargets.py:56,92, but not in the pipeline scan).
_BYTE_TO_CODE_UPPER = np.full(256, BAD, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _BYTE_TO_CODE_UPPER[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    _BYTE_TO_CODE_UPPER[_b] = _c


def encode_seq(seq: str | bytes | np.ndarray, to_upper: bool = False) -> np.ndarray:
    """Sequence -> uint8 2-bit codes (255 for non-ACGT)."""
    if isinstance(seq, str):
        buf = seq_to_bytes(seq)
    elif isinstance(seq, (bytes, bytearray)):
        buf = np.frombuffer(seq, dtype=np.uint8)
    else:
        buf = np.asarray(seq, dtype=np.uint8)
    return _BYTE_TO_CODE_UPPER[buf] if to_upper else bytes_to_codes(buf)


def _window_valid(codes: np.ndarray, length: int) -> np.ndarray:
    """Boolean array v[i] == all of codes[i:i+length] are valid ACGT."""
    n = codes.shape[0]
    if n < length:
        return np.zeros(0, dtype=bool)
    bad = (codes == BAD).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(bad)])
    return (cum[length:] - cum[:-length]) == 0


def _gather_windows(codes: np.ndarray, starts: np.ndarray, length: int) -> np.ndarray:
    """(n_hits, length) windows of ``codes`` starting at ``starts``."""
    if starts.size == 0:
        return np.zeros((0, length), dtype=np.uint8)
    return codes[starts[:, None] + np.arange(length)[None, :]]


def extract_offtarget_sites_seq(seq, to_upper: bool = True) -> np.ndarray:
    """Sequence (str/bytes) -> off-target site signatures; native C++ scan
    when available, numpy fallback otherwise."""
    from .. import native

    if isinstance(seq, str):
        seq = seq.encode("ascii")
    out = native.extract_offtargets_native(seq, to_upper)
    if out is not None:
        return out
    return extract_offtarget_sites(encode_seq(np.frombuffer(seq, np.uint8),
                                               to_upper=to_upper))


def find_candidate_guides_seq(seq):
    """Sequence (str/bytes) -> (starts, strands, sigs23); native C++ scan
    when available, numpy fallback otherwise."""
    from .. import native

    if isinstance(seq, str):
        seq = seq.encode("ascii")
    res = native.extract_candidates_native(seq)
    if res is not None:
        sig, pos, strand = res
        strands = np.where(strand == 0, "+", "-").astype("U1")
        return pos, strands, sig
    return find_candidate_guides(encode_seq(np.frombuffer(seq, np.uint8)))


def find_candidate_guides(codes: np.ndarray):
    """Candidate 23-mer target sites in one sequence.

    Returns ``(starts, strands, sigs23)`` where ``strands`` is '+'/'-' as a
    ``U1`` array and ``sigs23`` are low-first uint64 signatures of the stored
    23-mer (reverse hits already reverse-complemented). The ordering matches
    the reference scan: all forward hits (ascending start), then all reverse
    hits (ascending start) — Crackling.py:158-165.
    """
    n = codes.shape[0]
    if n < 23:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros(0, dtype="U1"), np.zeros(0, dtype=np.uint64)
    v23 = _window_valid(codes, 23)
    c = codes
    fwd = v23 & (c[21:n - 1] == 2) & (c[22:n] == 2)
    rev = v23 & (c[0:n - 22] == 1) & (c[1:n - 21] == 1)
    fpos = np.flatnonzero(fwd)
    rpos = np.flatnonzero(rev)
    fsig = pack_lofirst(_gather_windows(c, fpos, 23))
    rsig = pack_lofirst(codes_rc(_gather_windows(c, rpos, 23)))
    starts = np.concatenate([fpos, rpos])
    strands = np.concatenate(
        [np.full(fpos.size, "+", dtype="U1"), np.full(rpos.size, "-", dtype="U1")]
    )
    sigs = np.concatenate([fsig, rsig])
    return starts, strands, sigs


def extract_offtarget_sites(codes: np.ndarray) -> np.ndarray:
    """All off-target 20-mer site signatures (low-first uint64) in one
    sequence, forward hits then reverse hits, replicating the reference
    patterns and the reverse-strand first-20-then-rc quirk."""
    n = codes.shape[0]
    if n < 23:
        return np.zeros(0, dtype=np.uint64)
    v23 = _window_valid(codes, 23)
    c = codes
    # forward: c0 in {A,C,G}, c21 in {A,G}, c22 == G
    fwd = v23 & (c[0:n - 22] != 3) & ((c[21:n - 1] & 1) == 0) & (c[22:n] == 2)
    # reverse: c0 == C, c1 in {C,T}, c22 in {T,G,C} (not A)
    rev = v23 & (c[0:n - 22] == 1) & ((c[1:n - 21] & 1) == 1) & (c[22:n] != 0)
    fpos = np.flatnonzero(fwd)
    rpos = np.flatnonzero(rev)
    fsig = pack_lofirst(_gather_windows(c, fpos, 20))
    rsig = pack_lofirst(codes_rc(_gather_windows(c, rpos, 20)))
    return np.concatenate([fsig, rsig])
