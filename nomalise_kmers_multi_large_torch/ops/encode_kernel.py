"""Fused encode: bases -> sort-ready mixed window keys (K1, k <= 15).

Port of nomalise_kmers_multi_large_tpu/ops/encode_kernel.py::encode_keys.
Keys are int32 bit patterns of the reference's uint32 keys: a valid window
holds ``mix32(code, 2k)`` (< 2^30, so non-negative) and an invalid one the
sentinel 0xFFFFFFFF, which reads as -1. Window w of a read is valid iff
``w <= clip(len, 0, 1023) - k`` and its (canonical) code is not 0, the
reference's poly-A drop; with ``canonical`` a poly-T window is dropped too,
because min(code, revcomp) is then 0.

``encode_keys`` launches the CUDA kernel (csrc/encode.cu) for CUDA tensors
and runs ``encode_keys_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from nomalise_kmers_multi_large_torch import backend
from nomalise_kmers_multi_large_torch.ops.mix import mix32, shifts

SENTINEL = -1  # int32 bit pattern of the sort sentinel 0xFFFFFFFF

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def encode_keys_plain(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                      canonical: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    R, L = bases.shape
    W = L - k + 1
    b = bases.to(torch.int64)
    code = torch.zeros((R, W), dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(code)
    for j in range(k):
        col = b[:, j:j + W]
        code = (code << 2) | col
        rc = rc | ((col ^ 3) << (2 * j))
    if canonical:
        code = torch.minimum(code, rc)
    lens = lengths.to(torch.int64).clamp(0, 1023)
    win = torch.arange(W, device=bases.device)
    valid = (win[None, :] <= lens[:, None] - k) & (code != 0)
    key = torch.where(valid, mix32(code, 2 * k), SENTINEL)
    return key.to(torch.int32)


def encode_keys(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                canonical: bool) -> torch.Tensor:
    """Sort keys for all k-windows of every read.

    Args:
      bases: uint8 [R, L] 2-bit base codes (0..3).
      lengths: int32 [R] read lengths (0 marks an invalid read).
      k: k-mer size, 5 <= k <= 15.

    Returns:
      int32 [R, L - k + 1] keys; ``key != -1`` is window validity.
    """
    if not 1 <= k <= 15:
        raise ValueError(f"encode_keys takes k <= 15, got {k}")
    if bases.dim() != 2 or lengths.shape != (bases.shape[0],):
        raise ValueError(f"encode_keys: bases [R, L] and lengths [R], got "
                         f"{tuple(bases.shape)} and {tuple(lengths.shape)}")
    if bases.shape[1] < k:
        raise ValueError(f"encode_keys: reads of width {bases.shape[1]} < k={k}")
    if bases.device.type == "cpu":
        return encode_keys_plain(bases, lengths, k, canonical)
    backend.require_cuda("encode_keys", bases, lengths)
    if bases.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("encode_keys: bases must be uint8 and lengths int32")
    R, L = bases.shape
    keys = torch.empty((R, L - k + 1), dtype=torch.int32, device=bases.device)
    s1, s2, _ = shifts(2 * k)
    fn = backend.function("encode_keys", "nkm_encode_keys", _ARGTYPES)
    backend.launch("encode_keys", fn, bases.data_ptr(), lengths.data_ptr(),
                   R, L, k, int(canonical), s1, s2, keys.data_ptr(),
                   bases.device.index or 0, backend.stream_of(bases))
    return keys
