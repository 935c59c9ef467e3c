"""Fused encode: bases -> sort-ready mixed window keys (K1, k <= 15; K2,
k = 16..31).

Port of nomalise_kmers_multi_large_tpu/ops/encode_kernel.py::encode_keys and
::encode_keys_wide. Keys are int32 bit patterns of the reference's uint32
keys. Narrow: a valid window holds ``mix32(code, 2k)`` (< 2^30, so
non-negative) and an invalid one the sentinel 0xFFFFFFFF, which reads as -1.
Wide: a valid window holds the ``feistel_words(code, 2k)`` pair (w1, w2) and
an invalid one the sentinel pair (-1, -1); a real w2 is < 2^30, so
``w2 != -1`` is validity. Window w of a read is valid iff
``w <= clip(len, 0, 1023) - k`` and its (canonical) code is not 0, the
reference's poly-A drop; with ``canonical`` a poly-T window is dropped too,
because min(code, revcomp) is then 0.

``encode_keys`` and ``encode_keys_wide`` launch the CUDA kernels
(csrc/encode.cu, csrc/encode_wide.cu) for CUDA tensors and run their
``*_plain`` versions for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from nomalise_kmers_multi_large_torch import backend
from nomalise_kmers_multi_large_torch.ops.mix import (
    feistel_words, mix32, shifts,
)

SENTINEL = -1  # int32 bit pattern of the sort sentinel 0xFFFFFFFF

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_WIDE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of int64 values in [-1, 2^32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _window_codes(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                  canonical: bool):
    """int64 [R, W] 2k-bit window codes (canonical min with the reverse
    complement when asked) and their validity."""
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
    return code, (win[None, :] <= lens[:, None] - k) & (code != 0)


def _check_args(name: str, bases, lengths, k: int, lo: int, hi: int):
    if not lo <= k <= hi:
        raise ValueError(f"{name} takes k = {lo}..{hi}, got {k}")
    if bases.dim() != 2 or lengths.shape != (bases.shape[0],):
        raise ValueError(f"{name}: bases [R, L] and lengths [R], got "
                         f"{tuple(bases.shape)} and {tuple(lengths.shape)}")
    if bases.shape[1] < k:
        raise ValueError(f"{name}: reads of width {bases.shape[1]} < k={k}")
    if bases.device.type != "cpu":
        backend.require_cuda(name, bases, lengths)
        if bases.dtype != torch.uint8 or lengths.dtype != torch.int32:
            raise TypeError(f"{name}: bases must be uint8 and lengths int32")


def encode_keys_plain(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                      canonical: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    code, valid = _window_codes(bases, lengths, k, canonical)
    return torch.where(valid, mix32(code, 2 * k), SENTINEL).to(torch.int32)


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
    _check_args("encode_keys", bases, lengths, k, 1, 15)
    if bases.device.type == "cpu":
        return encode_keys_plain(bases, lengths, k, canonical)
    R, L = bases.shape
    keys = torch.empty((R, L - k + 1), dtype=torch.int32, device=bases.device)
    s1, s2, _ = shifts(2 * k)
    fn = backend.function("encode_keys", "nkm_encode_keys", _ARGTYPES)
    backend.launch("encode_keys", fn, bases.data_ptr(), lengths.data_ptr(),
                   R, L, k, int(canonical), s1, s2, keys.data_ptr(),
                   bases.device.index or 0, backend.stream_of(bases))
    return keys


def encode_keys_wide_plain(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                           canonical: bool):
    """Plain PyTorch version of the wide kernel, on any device."""
    code, valid = _window_codes(bases, lengths, k, canonical)
    w1, w2 = feistel_words(code >> 32, code & 0xFFFFFFFF, 2 * k)
    return (as_int32(torch.where(valid, w1, SENTINEL)),
            as_int32(torch.where(valid, w2, SENTINEL)))


def encode_keys_wide(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                     canonical: bool):
    """Feistel sort words for all k-windows of every read, k = 16..31.

    Args as encode_keys. Returns (w1, w2) int32 [R, L - k + 1]; an invalid
    window holds (-1, -1), and ``w2 != -1`` is window validity.
    """
    _check_args("encode_keys_wide", bases, lengths, k, 16, 31)
    if bases.device.type == "cpu":
        return encode_keys_wide_plain(bases, lengths, k, canonical)
    R, L = bases.shape
    w1 = torch.empty((R, L - k + 1), dtype=torch.int32, device=bases.device)
    w2 = torch.empty_like(w1)
    fn = backend.function("encode_keys_wide", "nkm_encode_keys_wide",
                          _ARGTYPES_WIDE)
    backend.launch("encode_keys_wide", fn, bases.data_ptr(),
                   lengths.data_ptr(), R, L, k, int(canonical),
                   w1.data_ptr(), w2.data_ptr(), bases.device.index or 0,
                   backend.stream_of(bases))
    return w1, w2
