"""Bijective bit mixing for bucket-table placement (torch and numpy).

Port of nomalise_kmers_multi_large_tpu/ops/mix.py for the k <= 15 path: a
code c of ``bits = 2k`` bits is placed at ``mix32(c)``, a bijection on the
``bits``-bit space (odd multiplies and xor-shifts), so the bucket row (high
bits) and the stored fingerprint (low bits) recover c exactly.

Torch on the CPU has no uint32 shifts or compares, so the torch version
carries values as int64 in [0, 2^32) and masks after every step. The numpy
forward and inverse serve ``export`` and the tests.
"""
from __future__ import annotations

import numpy as np
import torch

# odd constants (from splitmix/murmur lineage), as in the reference module
_C1 = 0x7FEB352D
_C2 = 0x846CA68B


def shifts(bits: int) -> tuple[int, int, int]:
    """Xor-shift distances scaled to the mixed width (murmur32 uses 16/13/16
    for 32 bits)."""
    s = max(bits // 2, 1)
    s2 = max((bits * 13) // 32, 1)
    return s, s2, s


def mix32(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Bijective mix of int64 values < 2^bits (2 <= bits <= 30); the result
    is int64 < 2^bits."""
    if not 2 <= bits <= 30:
        raise ValueError(f"mix32 takes 2..30 bits, got {bits}")
    mask = (1 << bits) - 1
    s1, s2, s3 = shifts(bits)
    x = x.to(torch.int64)
    x = (x ^ (x >> s1)) & mask
    x = (x * (_C1 | 1)) & mask
    x = (x ^ (x >> s2)) & mask
    x = (x * (_C2 | 1)) & mask
    return (x ^ (x >> s3)) & mask


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
