"""2-bit nucleotide codecs and small sequence helpers (host side, numpy).

Encoding contract (matches the reference ISSL tools,
/root/reference/src/ISSL/isslCreateIndex.cpp:39-57):

* base -> 2-bit value: A=0, C=1, G=2, T=3
* position ``j`` of the sequence occupies bits ``2j .. 2j+1`` of the
  signature, i.e. the *first* base lives in the **low** bits. The reference
  calls this layout "inverted" (isslScoreOfftargets.cpp:424-427).

Because TPUs have no native 64-bit integer lanes, device code carries a
signature as a pair of int32 words: ``lo`` holds positions 0..15 and ``hi``
holds positions 16..19 (for the standard 20-mer operating point).

A second, big-endian packing (first base in the *high* bits) is provided
because lexicographic order of equal-length ACGT strings equals numeric order
of the big-endian packing; the index builder uses it for sorting so that site
ids come out in the same order as the reference's sorted-text-file ids.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Scalar string helpers (semantics of /root/reference/src/crackling/Helpers.py)
# ---------------------------------------------------------------------------

_RC_TABLE = str.maketrans("acgtrymkbdhvACGTRYMKBDHV", "tgcayrkmvhdbTGCAYRKMVHDB")
_U2T = str.maketrans("Uu", "Tt")


def rc(dna: str) -> str:
    """IUPAC-aware reverse complement (reference Helpers.py:7-10)."""
    return dna.translate(_RC_TABLE)[::-1]


def trans_to_dna(rna: str) -> str:
    """Replace U with T (reference Helpers.py:14-17)."""
    return rna.translate(_U2T)


def at_percentage(seq: str) -> float:
    """AT% of ``seq`` (reference Helpers.py:21-27). Case sensitive: only
    uppercase 'A'/'T' count, exactly like the reference."""
    total = sum(1.0 for c in seq if c in "AT")
    return 100.0 * total / float(len(seq))


# ---------------------------------------------------------------------------
# numpy byte <-> code tables
# ---------------------------------------------------------------------------

# byte value -> 2-bit code; 255 marks anything that is not upper-case ACGT.
BAD = np.uint8(255)
_BYTE_TO_CODE = np.full(256, BAD, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _BYTE_TO_CODE[_b] = _c

_CODE_TO_BYTE = np.frombuffer(b"ACGT", dtype=np.uint8)

# byte value -> complement byte for upper-case ACGT (others map to 'N').
_BYTE_COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _BYTE_COMPLEMENT[_a] = _b


def seq_to_bytes(seq: str) -> np.ndarray:
    """ASCII string -> uint8 array view."""
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def bytes_to_codes(buf: np.ndarray) -> np.ndarray:
    """uint8 ASCII -> 2-bit codes (255 for non-ACGT)."""
    return _BYTE_TO_CODE[buf]


def codes_to_str(codes: np.ndarray) -> str:
    """2-bit codes (..., L) -> ACGT string (single sequence only)."""
    return _CODE_TO_BYTE[codes].tobytes().decode("ascii")


def codes_rc(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of valid 2-bit codes along the last axis.

    complement(code) == code ^ 3 for the A=0,C=1,G=2,T=3 alphabet.
    """
    return (codes ^ 3)[..., ::-1]


# ---------------------------------------------------------------------------
# Signature packing
# ---------------------------------------------------------------------------


def pack_lofirst(codes: np.ndarray) -> np.ndarray:
    """Pack (..., L) 2-bit codes into uint64, position j at bits 2j..2j+1.

    This is the reference's ``sequenceToSignature``
    (isslCreateIndex.cpp:39-47). L must be <= 32.
    """
    L = codes.shape[-1]
    if L > 32:
        raise ValueError(f"sequence length {L} > 32 not supported")
    shifts = (2 * np.arange(L, dtype=np.uint64))
    return (codes.astype(np.uint64) << shifts).sum(axis=-1, dtype=np.uint64)


def unpack_lofirst(sig: np.ndarray, length: int) -> np.ndarray:
    """Inverse of :func:`pack_lofirst`: uint64 (...,) -> (..., length) codes."""
    shifts = (2 * np.arange(length, dtype=np.uint64))
    return ((sig[..., None] >> shifts) & np.uint64(3)).astype(np.uint8)


def pack_lex(codes: np.ndarray) -> np.ndarray:
    """Pack codes big-endian (first base in high bits): numeric order of the
    result equals lexicographic order of the ACGT strings."""
    L = codes.shape[-1]
    if L > 32:
        raise ValueError(f"sequence length {L} > 32 not supported")
    shifts = (2 * np.arange(L - 1, -1, -1, dtype=np.uint64))
    return (codes.astype(np.uint64) << shifts).sum(axis=-1, dtype=np.uint64)


def lex_to_lofirst(sig_lex: np.ndarray, length: int) -> np.ndarray:
    """Convert a big-endian (lex) packing to the low-first packing."""
    out = np.zeros_like(sig_lex)
    for j in range(length):
        base = (sig_lex >> np.uint64(2 * (length - 1 - j))) & np.uint64(3)
        out |= base << np.uint64(2 * j)
    return out


def sig_split(sig: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 low-first signature -> (lo, hi) int32 words for device use.

    lo carries bits 0..31 (positions 0..15), hi carries bits 32..63.
    The int32 values bit-cast the uint32 halves (may appear negative).
    """
    lo = (sig & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (sig >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def sig_join(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) int32 words -> uint64 low-first signature."""
    lo_u = lo.view(np.uint32) if lo.dtype == np.int32 else lo.astype(np.uint32)
    hi_u = hi.view(np.uint32) if hi.dtype == np.int32 else hi.astype(np.uint32)
    return lo_u.astype(np.uint64) | (hi_u.astype(np.uint64) << np.uint64(32))


def sigs_to_strings(sigs: np.ndarray, length: int) -> list[str]:
    """Vectorized uint64 low-first signatures -> list of ACGT strings."""
    codes = unpack_lofirst(np.asarray(sigs, dtype=np.uint64), length)
    chars = _CODE_TO_BYTE[codes]
    return [row.tobytes().decode("ascii") for row in chars]


def strings_to_sigs(seqs: list[str] | np.ndarray, length: int) -> np.ndarray:
    """List of equal-length ACGT strings -> uint64 low-first signatures."""
    if len(seqs) == 0:
        return np.zeros(0, dtype=np.uint64)
    buf = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    codes = _BYTE_TO_CODE[buf].reshape(len(seqs), length)
    if (codes == BAD).any():
        raise ValueError("non-ACGT character in sequence")
    return pack_lofirst(codes)


def popcount64(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount for uint64 (host)."""
    return np.bitwise_count(x).astype(np.int64)
