"""Bit helpers on int64 tensors, for the CPU and CUDA alike.

PyTorch has no popcount, ctz or clz, and on the CPU it has no ``>>`` for
uint32. Signatures are 40-bit (2 bits per position, position ``p`` at
bits ``2p..2p+1``), so the port carries them as **int64**: they are
non-negative there, ``>>`` is then a logical shift, and XOR needs no
lo/hi word split. Every helper here expects non-negative int64 input
(values below 2^63) and returns int64.
"""

from __future__ import annotations

import torch

SIG40 = (1 << 40) - 1            # the 20-position signature bits
ODD40 = 0x5555555555             # bit 2p of every 40-bit position pair
_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count (multiply-free, so nothing overflows)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def ctz(x: torch.Tensor) -> torch.Tensor:
    """Count of trailing zero bits; 64 for 0."""
    # (x & -x) - 1 sets exactly the trailing-zero bits; for x == 0 it is
    # -1, whose 64 ones popcount reports as 64 after the final mask
    return popcount(((x & -x) - 1) & ((1 << 63) - 1)) + (x == 0).long()


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit plus one; 0 for 0."""
    for sh in (1, 2, 4, 8, 16, 32):
        x = x | (x >> sh)
    return popcount(x)


def clz(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zero bits of the 64-bit word; 64 for 0."""
    return 64 - bit_length(x)


def collapse_pairs(x: torch.Tensor) -> torch.Tensor:
    """The reference's pair collapse (isslScoreOfftargets.cpp:376-379) of
    an XOR: ``01`` in every 2-bit slot that is nonzero, so bit ``2p`` is
    set iff position ``p`` mismatches."""
    return (x | (x >> 1)) & _M1


def compress_even_bits(c: torch.Tensor) -> torch.Tensor:
    """Gather bits 0, 2, 4, ... of ``c`` into bits 0, 1, 2, ...: a
    collapsed 40-bit pair mask becomes the 20-bit position mask (bit ``p``
    set iff position ``p`` mismatches)."""
    c = c & _M1
    c = (c | (c >> 1)) & _M2
    c = (c | (c >> 2)) & _M4
    c = (c | (c >> 4)) & _M8
    c = (c | (c >> 8)) & _M16
    return (c | (c >> 16)) & _M32


def earlier_slice_clean(c40: torch.Tensor, s) -> torch.Tensor:
    """First-clean-slice dedup test on the collapsed mask: True where a
    slice ``s' < s`` matches the query exactly, i.e. where byte ``s'`` of
    the collapsed low word is zero (slice ``s'`` holds positions
    4s'..4s'+3, bits 8s'..8s'+7). Such a pair was already counted in slice
    ``s'`` (the stateless form of the reference's seen-set,
    isslScoreOfftargets.cpp:385-387). ``s`` is an int or a tensor that
    broadcasts against ``c40``; slice 4 is never an earlier slice."""
    if not torch.is_tensor(s):
        s = torch.tensor(int(s), dtype=torch.int64, device=c40.device)
    earlier = (torch.ones_like(s) << (8 * s)) - 1        # bytes 0..s-1
    xb = (c40 & _M32) | (earlier ^ _M32)
    return ((xb - 0x01010101) & ~xb & 0x80808080) != 0


def earlier_slice_clean_mask(mask: torch.Tensor, s) -> torch.Tensor:
    """The same dedup test on the 20-bit position mask (bit ``p`` set iff
    position ``p`` mismatches): True where nibble ``s' < s`` of the mask
    (slice ``s'``'s four positions) is zero. The SWAR zero-nibble test of
    the JAX one-hot finder (crackling_tpu/ops/issl_compact.py:410-414)."""
    if not torch.is_tensor(s):
        s = torch.tensor(int(s), dtype=torch.int64, device=mask.device)
    earlier = (torch.ones_like(s) << (4 * s)) - 1        # nibbles 0..s-1
    x = (mask & _M32) | (earlier ^ _M32)
    return ((x - 0x11111111) & ~x & 0x88888888) != 0


def earlier_slice_clean_raw(x: torch.Tensor, s, width: int,
                            slices: int) -> torch.Tensor:
    """The same dedup test at any slice width, on the raw XOR ``x`` of
    query and site: True where a slice ``s' < s`` (of ``slices``, each
    ``width`` bits, slice ``s'`` at bits ``s'*width``) has all its XOR
    bits 0. ``s`` is an int or a tensor that broadcasts against ``x``."""
    mask = (1 << width) - 1
    seen = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for sp in range(slices - 1):
        seen |= (((x >> (sp * width)) & mask) == 0) & (sp < s)
    return seen
