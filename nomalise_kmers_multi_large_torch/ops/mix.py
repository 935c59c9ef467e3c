"""Bijective bit mixing for bucket-table placement (torch and numpy).

Port of nomalise_kmers_multi_large_tpu/ops/mix.py. A k <= 15 code c of
``bits = 2k`` bits is placed at ``mix32(c)``, a bijection on the
``bits``-bit space (odd multiplies and xor-shifts), so the bucket row (high
bits) and the stored fingerprint (low bits) recover c exactly. A k = 16..31
code (b = 2k bits, up to 62) goes through ``feistel_words``: a 3-round
unbalanced Feistel with ``mix32(., 32)`` rounds, returned as two 32-bit sort
words (w1 = top 32 bits of the mixed value, w2 = its low b - 32 bits).

Torch on the CPU has no uint32 shifts or compares, so the torch version
carries values as int64 in [0, 2^32) and masks after every step; a 32-bit
multiply is split in 16-bit halves so no int64 product overflows. The numpy
forward and inverse serve ``export`` and the tests.
"""
from __future__ import annotations

import numpy as np
import torch

# odd constants (from splitmix/murmur lineage), as in the reference module
_C1 = 0x7FEB352D
_C2 = 0x846CA68B
# Feistel round keys (pi digits) and the 31-bit right-half mask
_CA, _CB, _CC = 0x243F6A88, 0x85A308D3, 0x13198A2E
_M31 = (1 << 31) - 1


def shifts(bits: int) -> tuple[int, int, int]:
    """Xor-shift distances scaled to the mixed width (murmur32 uses 16/13/16
    for 32 bits)."""
    s = max(bits // 2, 1)
    s2 = max((bits * 13) // 32, 1)
    return s, s2, s


def _mul(x: torch.Tensor, c: int, mask: int) -> torch.Tensor:
    """(x * c) & mask for int64 x < 2^32 and mask < 2^32, without an int64
    product above 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & mask


def mix32(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Bijective mix of int64 values < 2^bits (2 <= bits <= 32); the result
    is int64 < 2^bits."""
    if not 2 <= bits <= 32:
        raise ValueError(f"mix32 takes 2..32 bits, got {bits}")
    mask = (1 << bits) - 1
    s1, s2, s3 = shifts(bits)
    x = x.to(torch.int64)
    x = (x ^ (x >> s1)) & mask
    x = _mul(x, _C1 | 1, mask)
    x = (x ^ (x >> s2)) & mask
    x = _mul(x, _C2 | 1, mask)
    return (x ^ (x >> s3)) & mask


def feistel_words(hi: torch.Tensor, lo: torch.Tensor, b: int):
    """Mix of b-bit codes given as (hi, lo) 32-bit words (int64 carriers,
    code < 2^b, 32 <= b <= 62). Returns int64 (w1, w2) in [0, 2^32):
    ordering by (w1, w2) is ordering by the mixed value, and a real w2 is
    < 2^(b - 32), so (0xFFFFFFFF, 0xFFFFFFFF) stays free for the sentinel."""
    if not 32 <= b <= 62:
        raise ValueError(f"feistel_words takes 32..62 bits, got {b}")
    hi = hi.to(torch.int64) & 0xFFFFFFFF
    lo = lo.to(torch.int64) & 0xFFFFFFFF
    if b == 32:  # k = 16: the code fits one word; plain 32-bit mix, w2 = 0
        return mix32(lo, 32), torch.zeros_like(lo)
    m_l = (1 << (b - 31)) - 1
    r = ((hi << (63 - b)) | (lo >> (b - 31))) & _M31
    left = lo & m_l
    r = r ^ (mix32(left ^ _CA, 32) & _M31)
    left = left ^ (mix32(r ^ _CB, 32) & m_l)
    r = r ^ (mix32(left ^ _CC, 32) & _M31)
    w1 = ((r << 1) | (left >> (b - 32))) & 0xFFFFFFFF
    return w1, left & ((1 << (b - 32)) - 1)


def mix32_np(x: np.ndarray, bits: int) -> np.ndarray:
    mask = np.uint64((1 << bits) - 1)
    s1, s2, s3 = shifts(bits)
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(s1))) & mask
    x = (x * np.uint64(_C1 | 1)) & mask
    x = (x ^ (x >> np.uint64(s2))) & mask
    x = (x * np.uint64(_C2 | 1)) & mask
    x = (x ^ (x >> np.uint64(s3))) & mask
    return x.astype(np.uint32)


def _inv_odd(c: int, bits: int) -> int:
    """Modular inverse of odd c mod 2^bits (Newton iteration)."""
    m = (1 << bits) - 1
    inv = c & m
    for _ in range(6):
        inv = (inv * (2 - c * inv)) & m
    return inv


def _unxorshift(x: np.ndarray, s: int, bits: int) -> np.ndarray:
    mask = np.uint64((1 << bits) - 1)
    y = x.copy()
    # y = x ^ (y >> s) reaches its fixpoint in ceil(bits / s) steps
    for _ in range(-(-bits // s)):
        y = (x ^ (y >> np.uint64(s))) & mask
    return y


def unmix32_np(x: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of mix32 on the host."""
    mask = np.uint64((1 << bits) - 1)
    s1, s2, s3 = shifts(bits)
    i1 = np.uint64(_inv_odd(_C1 | 1, bits))
    i2 = np.uint64(_inv_odd(_C2 | 1, bits))
    x = x.astype(np.uint64) & mask
    x = _unxorshift(x, s3, bits)
    x = (x * i2) & mask
    x = _unxorshift(x, s2, bits)
    x = (x * i1) & mask
    x = _unxorshift(x, s1, bits)
    return x.astype(np.uint32)


def feistel_words_np(code: np.ndarray, b: int):
    """Host forward of feistel_words: uint64 codes < 2^b -> (w1, w2)
    uint32."""
    code = code.astype(np.uint64)
    if b == 32:
        w1 = mix32_np(code.astype(np.uint32), 32)
        return w1, np.zeros_like(w1)
    m_l = np.uint64((1 << (b - 31)) - 1)
    r = (code >> np.uint64(b - 31)).astype(np.uint32)
    left = code & m_l
    r = r ^ (mix32_np(left.astype(np.uint32) ^ np.uint32(_CA), 32)
             & np.uint32(_M31))
    left = left ^ (mix32_np(r ^ np.uint32(_CB), 32).astype(np.uint64) & m_l)
    r = r ^ (mix32_np(left.astype(np.uint32) ^ np.uint32(_CC), 32)
             & np.uint32(_M31))
    m = (r.astype(np.uint64) << np.uint64(b - 31)) | left
    return ((m >> np.uint64(b - 32)).astype(np.uint32),
            (m & np.uint64((1 << (b - 32)) - 1)).astype(np.uint32))


def unfeistel_np(w1: np.ndarray, w2: np.ndarray, b: int) -> np.ndarray:
    """Host inverse of feistel_words: (w1, w2) -> the b-bit code
    (uint64)."""
    if b == 32:
        return unmix32_np(w1, 32).astype(np.uint64)
    m = (w1.astype(np.uint64) << np.uint64(b - 32)) | w2.astype(np.uint64)
    m_l = np.uint64((1 << (b - 31)) - 1)
    r = (m >> np.uint64(b - 31)).astype(np.uint32)
    left = m & m_l
    r = r ^ (mix32_np(left.astype(np.uint32) ^ np.uint32(_CC), 32)
             & np.uint32(_M31))
    left = left ^ (mix32_np(r ^ np.uint32(_CB), 32).astype(np.uint64) & m_l)
    r = r ^ (mix32_np(left.astype(np.uint32) ^ np.uint32(_CA), 32)
             & np.uint32(_M31))
    return (r.astype(np.uint64) << np.uint64(b - 31)) | left
