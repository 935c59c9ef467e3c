"""Rank / candidate scan over the sorted key stream (K3 narrow, K3w wide).

Port of nomalise_kmers_multi_large_tpu/ops/segscan.py::rank_cand_scan. For
the (code, read id)-sorted stream it returns

  p2 = (min(rid, n_reads - 1) << 16) | rank, rank = 1-based position in the
       run of equal codes, clamped to 65535;
  p3 = cand, the code's index among the distinct codes of its bucket row,
       clamped to 128.

Narrow: the code is ``skey`` and the row ``key >> fp_bits``. Wide (``skey2``
given, k > 15): the code is the pair (skey, skey2), so it changes when
either word changes, and the row is ``skey >> row_shift``.

Keys are int32 bit patterns (sentinel -1 = 0xFFFFFFFF, sorted last). The
stream length needs no padding. ``rank_cand_scan`` launches the CUDA kernel
(csrc/segscan.cu, one pass with decoupled look-back over tiles of _TILE
elements; ``rank_cand_scan_wide`` is its wide entry point) for CUDA tensors
and runs ``rank_cand_scan_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from nomalise_kmers_multi_large_torch import backend

_TILE = 4096  # elements per scan tile; csrc/segscan.cu kTile

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_WIDE = _ARGTYPES[:1] + [ctypes.c_void_p] + _ARGTYPES[1:]


def rank_cand_scan_plain(skey: torch.Tensor, srid: torch.Tensor, *,
                         fp_bits: int, n_reads: int, skey2=None,
                         row_shift: int = -1):
    """Plain PyTorch version of the kernel, on any device."""
    key = skey.to(torch.int64) & 0xFFFFFFFF
    n = key.numel()
    iota = torch.arange(n, device=key.device)
    changed = torch.ones(n, dtype=torch.bool, device=key.device)
    changed[1:] = key[1:] != key[:-1]
    if skey2 is not None:
        changed[1:] |= skey2[1:] != skey2[:-1]
    row = key >> (fp_bits if skey2 is None else row_shift)
    rchanged = torch.ones_like(changed)
    rchanged[1:] = row[1:] != row[:-1]
    head = torch.cummax(torch.where(changed, iota, 0), 0).values
    rank = (iota - head + 1).clamp(max=65535)
    segidx = torch.cumsum(changed, 0) - 1
    rowhead = torch.cummax(torch.where(rchanged, segidx, 0), 0).values
    cand = (segidx - rowhead).clamp(max=128)
    rid = srid.to(torch.int64).clamp(max=n_reads - 1)
    return ((rid << 16) | rank).to(torch.int32), cand.to(torch.int32)


def rank_cand_scan(skey: torch.Tensor, srid: torch.Tensor, *, fp_bits: int,
                   n_reads: int, skey2=None, row_shift: int = -1):
    """(p2, p3) int32 [N] for the bucket kernel.

    Args:
      skey: int32 [N] keys sorted as uint32 (sentinel -1 last); the first
        sort word on the wide path.
      srid: int32 [N] read id of each sorted element.
      fp_bits: fingerprint bits; the narrow bucket row is ``key >> fp_bits``
        (unused on the wide path).
      n_reads: reads in the batch (read ids clamp to n_reads - 1).
      skey2: int32 [N] second sort word (wide path, k > 15), or None.
      row_shift: the wide bucket row is ``skey >> row_shift``, 8..23
        (2^24..2^9 rows).
    """
    wide = skey2 is not None
    shift, lo, hi = (row_shift, 8, 23) if wide else (fp_bits, 1, 16)
    if skey.dim() != 1 or srid.shape != skey.shape or \
            (wide and skey2.shape != skey.shape):
        raise ValueError("rank_cand_scan: skey, skey2 and srid must be [N]")
    if not lo <= shift <= hi or not 1 <= n_reads <= 16384:
        raise ValueError(f"rank_cand_scan: row shift {shift} (not in "
                         f"{lo}..{hi}) or n_reads={n_reads} out of range")
    if skey.device.type == "cpu":
        return rank_cand_scan_plain(skey, srid, fp_bits=fp_bits,
                                    n_reads=n_reads, skey2=skey2,
                                    row_shift=row_shift)
    words = (skey, skey2) if wide else (skey,)
    backend.require_cuda("rank_cand_scan", *words, srid)
    if any(t.dtype != torch.int32 for t in (*words, srid)):
        raise TypeError("rank_cand_scan: skey, skey2 and srid must be int32")
    n = skey.numel()
    n_tiles = -(-n // _TILE)
    p2 = torch.empty_like(skey)
    p3 = torch.empty_like(skey)
    # the tile states and the tile counter; the C entry point zeroes them
    tiles = torch.empty(n_tiles + 1, dtype=torch.int64, device=skey.device)
    name = "rank_cand_scan_wide" if wide else "rank_cand_scan"
    fn = backend.function(name, "nkm_" + name,
                          _ARGTYPES_WIDE if wide else _ARGTYPES)
    backend.launch(name, fn, *(t.data_ptr() for t in words), srid.data_ptr(),
                   n, shift, n_reads, tiles.data_ptr(), n_tiles,
                   p2.data_ptr(), p3.data_ptr(), skey.device.index or 0,
                   backend.stream_of(skey))
    return p2, p3
