"""Synthetic genomes from a seed, and the plain sequence helpers the
traffic generator and the reference share.

Bases are 2-bit codes A=0, C=1, G=2, T=3. A 20-mer's signature is the
port's input format: position ``j`` at bits ``2j..2j+1`` (first base in
the low bits), carried as int64.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
A, C, G, T = 0, 1, 2, 3


def make_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """``length`` uniform random bases as uint8 codes."""
    return rng.integers(0, 4, size=int(length), dtype=np.uint8)


def genome_bytes(codes: np.ndarray) -> bytes:
    """Upper-case ASCII of the codes, as a FASTA sequence holds them."""
    return BASES[codes].tobytes()


def pack(codes: torch.Tensor, starts: torch.Tensor, length: int,
         reverse: bool = False) -> torch.Tensor:
    """Signatures of the ``length``-mers at ``starts`` (int64); with
    ``reverse`` the reverse complement of each window."""
    sig = torch.zeros(starts.numel(), dtype=torch.int64, device=codes.device)
    for j in range(length):
        if reverse:
            base = 3 - codes[starts + (length - 1 - j)].long()
        else:
            base = codes[starts + j].long()
        sig |= base << (2 * j)
    return sig


def window_starts(codes: torch.Tensor, length: int) -> torch.Tensor:
    """Boolean mask over window starts: every base of the window is A, C,
    G or T (a genome from :func:`make_genome` has no other)."""
    n = codes.numel() - length + 1
    bad = torch.cat([codes.new_zeros(1, dtype=torch.int64),
                     torch.cumsum((codes > 3).long(), 0)])
    return (bad[length:] - bad[:n]) == 0


def candidate_guides(codes: torch.Tensor) -> torch.Tensor:
    """Crackling's candidate scan (forward ``[ACGT]{21}GG``, reverse
    ``CC[ACGT]{21}`` stored reverse-complemented), as the 20-mer guide of
    each candidate 23-mer: forward hits then reverse hits, duplicates
    kept."""
    if codes.numel() < 23:
        return codes.new_zeros(0, dtype=torch.int64)
    n = codes.numel() - 22
    ok = window_starts(codes, 23)
    fwd = ok & (codes[21:21 + n] == G) & (codes[22:22 + n] == G)
    rev = ok & (codes[0:n] == C) & (codes[1:1 + n] == C)
    fpos = torch.nonzero(fwd).flatten()
    rpos = torch.nonzero(rev).flatten()
    # the reverse candidate is rc(23-mer); its first 20 bases are the
    # reverse complement of the window's last 20
    return torch.cat([pack(codes, fpos, 20),
                      pack(codes, rpos + 3, 20, reverse=True)])
