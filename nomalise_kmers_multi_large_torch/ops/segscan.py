"""Rank / candidate scan over the sorted key stream (K3, narrow keys).

Port of nomalise_kmers_multi_large_tpu/ops/segscan.py::rank_cand_scan with
``wide=False``. For the (key, read id)-sorted stream it returns

  p2 = (min(rid, n_reads - 1) << 16) | rank, rank = 1-based position in the
       run of equal keys, clamped to 65535;
  p3 = cand, the key's index among the distinct keys of its bucket row
       (row = key >> fp_bits), clamped to 128.

Keys are int32 bit patterns (sentinel -1 = 0xFFFFFFFF, sorted last). The
stream length needs no padding. ``rank_cand_scan`` launches the CUDA kernel
(csrc/segscan.cu) for CUDA tensors and runs ``rank_cand_scan_plain`` for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from nomalise_kmers_multi_large_torch import backend

_TILE = 2048  # elements per scan tile; csrc/segscan.cu kTile

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def rank_cand_scan_plain(skey: torch.Tensor, srid: torch.Tensor, *,
                         fp_bits: int, n_reads: int):
    """Plain PyTorch version of the kernel, on any device."""
    key = skey.to(torch.int64) & 0xFFFFFFFF
    n = key.numel()
    iota = torch.arange(n, device=key.device)
    changed = torch.ones(n, dtype=torch.bool, device=key.device)
    changed[1:] = key[1:] != key[:-1]
    row = key >> fp_bits
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
                   n_reads: int):
    """(p2, p3) int32 [N] for the bucket kernel.

    Args:
      skey: int32 [N] keys sorted as uint32 (sentinel -1 last).
      srid: int32 [N] read id of each sorted element.
      fp_bits: fingerprint bits; the bucket row is ``key >> fp_bits``.
      n_reads: reads in the batch (read ids clamp to n_reads - 1).
    """
    if skey.dim() != 1 or srid.shape != skey.shape:
        raise ValueError("rank_cand_scan: skey and srid must be [N]")
    if not 1 <= fp_bits <= 16 or not 1 <= n_reads <= 16384:
        raise ValueError(f"rank_cand_scan: fp_bits={fp_bits}, "
                         f"n_reads={n_reads} out of range")
    if skey.device.type == "cpu":
        return rank_cand_scan_plain(skey, srid, fp_bits=fp_bits,
                                    n_reads=n_reads)
    backend.require_cuda("rank_cand_scan", skey, srid)
    if skey.dtype != torch.int32 or srid.dtype != torch.int32:
        raise TypeError("rank_cand_scan: skey and srid must be int32")
    n = skey.numel()
    n_tiles = -(-n // _TILE)
    p2 = torch.empty_like(skey)
    p3 = torch.empty_like(skey)
    tiles = torch.empty((max(n_tiles, 1), 4), dtype=torch.int32,
                        device=skey.device)
    fn = backend.function("rank_cand_scan", "nkm_rank_cand_scan", _ARGTYPES)
    backend.launch("rank_cand_scan", fn, skey.data_ptr(), srid.data_ptr(), n,
                   fp_bits, n_reads, tiles.data_ptr(), n_tiles,
                   p2.data_ptr(), p3.data_ptr(), skey.device.index or 0,
                   backend.stream_of(skey))
    return p2, p3
