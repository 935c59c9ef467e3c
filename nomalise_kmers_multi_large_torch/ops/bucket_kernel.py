"""Bucket-table upsert + classify for one batch (K4, k <= 15).

Port of nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py::bucket_batch.
Data structure (unchanged): a code's mixed key m = mix32(code, 2k) goes to
bucket row ``m >> fp_bits``; ``fp[row, lane]`` stores the fingerprint
``(m & (2^fp_bits - 1)) + 1`` (0 = empty slot) and ``counts[row, lane]`` its
count. Rows are left-packed and a new code takes lane ``occ[row] +`` the
number of this batch's earlier inserts into the row, so the planes equal
the JAX tables lane for lane.

``bucket_batch`` sorts the stream on one packed int64 key
``(key << 14) | read id`` (exact mode; read ids < 16384), runs the rank /
candidate scan (K3) and then ``bucket_upsert`` (K4), which updates ``fp`` and
``counts`` IN PLACE (the JAX kernel aliases them too; in place saves a
second copy of a table of up to 1 GiB). ``bucket_upsert`` launches the CUDA
kernel (csrc/bucket.cu) for CUDA tensors and runs ``bucket_upsert_plain``
for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nomalise_kmers_multi_large_torch import backend
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan

_RID_BITS = 14                # read ids per batch < 2^14 = 16384
MAX_READS = 1 << _RID_BITS

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]


class BucketBatchOut(NamedTuple):
    fp: torch.Tensor             # int32 [rows, lanes] fingerprints (+1; 0 = empty)
    counts: torch.Tensor         # int32 [rows, lanes]
    high_per_read: torch.Tensor  # int32 [n_reads] high windows per read
    overflow: torch.Tensor       # int32 [] codes dropped (row full / cand >= lanes)
    inserted: torch.Tensor       # int32 [] slots newly occupied


def bucket_upsert_plain(fp, counts, skey, p2, p3, *, fp_bits: int,
                        depth: int, seed: bool, n_reads: int):
    """Plain PyTorch version of the kernel, on any device: per-code work on
    the run heads (rank 1), then multiplicities scattered back. Updates fp
    and counts in place; returns (high_per_read, stats[dropped, inserted])."""
    dev = fp.device
    rows, lanes = fp.shape
    key = skey.to(torch.int64) & 0xFFFFFFFF
    row = key >> fp_bits
    sel = torch.nonzero((key != 0xFFFFFFFF) & (row < rows)).squeeze(1)
    row = row[sel]
    f = (key[sel] & ((1 << fp_bits) - 1)) + 1
    q = p2[sel].to(torch.int64) & 0xFFFFFFFF
    rank, rid = q & 0xFFFF, q >> 16
    cand = p3[sel].to(torch.int64)

    # one run per distinct code, starting at its rank-1 occurrence
    head = rank == 1
    run = torch.cumsum(head, 0) - 1
    hidx = torch.nonzero(head).squeeze(1)
    h_row, h_f, h_cand = row[hidx], f[hidx], cand[hidx]
    mult = torch.bincount(run, minlength=hidx.numel())
    row_fp = fp[h_row]                                  # [H, lanes]
    eq = row_fp == h_f[:, None].to(fp.dtype)
    matched = eq.any(1)
    m_lane = eq.to(torch.int8).argmax(1)
    prior = torch.where(matched, counts[h_row, m_lane].to(torch.int64), 0)

    high = torch.zeros(n_reads, dtype=torch.int32, device=dev)
    if not seed:
        is_high = prior[run] + rank >= depth
        high += torch.bincount(rid[is_high], minlength=n_reads).to(torch.int32)

    # inserts in stream order: lane = occ[row] + earlier inserts of the row
    new = ~matched
    eidx = torch.nonzero(new & (h_cand < lanes)).squeeze(1)
    e_row = h_row[eidx]
    pos = torch.arange(eidx.numel(), device=dev)
    rstart = torch.ones(eidx.numel(), dtype=torch.bool, device=dev)
    rstart[1:] = e_row[1:] != e_row[:-1]
    within = pos - torch.cummax(torch.where(rstart, pos, 0), 0).values
    occ = (fp[e_row] != 0).sum(1)
    lane = occ + within
    fits = lane < lanes
    ins = eidx[fits]
    i_row, i_lane = h_row[ins], lane[fits]

    if not seed:
        m = torch.nonzero(matched).squeeze(1)
        counts[h_row[m], m_lane[m]] += mult[m].to(counts.dtype)
        counts[i_row, i_lane] += mult[ins].to(counts.dtype)
    fp[i_row, i_lane] = h_f[ins].to(fp.dtype)

    n_ins = ins.numel()
    stats = torch.tensor([int(new.sum()) - n_ins, n_ins], dtype=torch.int32,
                         device=dev)
    return high, stats


def bucket_upsert(fp, counts, skey, p2, p3, *, fp_bits: int, depth: int,
                  seed: bool, n_reads: int):
    """Upsert + classify a sorted stream into the table (in place).

    Args:
      fp, counts: int32 [rows, lanes] table planes, updated in place.
      skey: int32 [N] sorted keys (sentinel -1 last); p2, p3: int32 [N] from
        rank_cand_scan.
      fp_bits: fingerprint bits (rows * 2^fp_bits = 4^k).
      depth: high-count threshold, <= 65535.
      seed: insert with count 0 and tally nothing (the seed pass).
      n_reads: length of the returned per-read tallies, <= 16384.

    Returns (high_per_read int32 [n_reads], stats int32 [2] = (dropped
    inserts, inserted slots)).
    """
    if fp.shape != counts.shape or fp.dim() != 2:
        raise ValueError("bucket_upsert: fp and counts must be [rows, lanes]")
    if not (skey.shape == p2.shape == p3.shape and skey.dim() == 1):
        raise ValueError("bucket_upsert: skey, p2, p3 must be [N]")
    rows, lanes = fp.shape
    if rows & (rows - 1) or lanes % 32 or lanes > 128:
        raise ValueError(f"bucket_upsert: rows must be a power of two and "
                         f"lanes a multiple of 32 up to 128, got {fp.shape}")
    if not 1 <= fp_bits <= 16 or not 1 <= n_reads <= MAX_READS:
        raise ValueError(f"bucket_upsert: fp_bits={fp_bits}, "
                         f"n_reads={n_reads} out of range")
    if depth > 65535:
        raise ValueError(f"bucket_upsert: depth {depth} > 65535")
    if fp.device.type == "cpu":
        return bucket_upsert_plain(fp, counts, skey, p2, p3, fp_bits=fp_bits,
                                   depth=depth, seed=seed, n_reads=n_reads)
    backend.require_cuda("bucket_upsert", fp, counts, skey, p2, p3)
    for t in (fp, counts, skey, p2, p3):
        if t.dtype != torch.int32:
            raise TypeError("bucket_upsert: every tensor must be int32")
    high = torch.zeros(n_reads, dtype=torch.int32, device=fp.device)
    stats = torch.zeros(2, dtype=torch.int32, device=fp.device)
    fn = backend.function("bucket_batch", "nkm_bucket_batch", _ARGTYPES)
    backend.launch("bucket_batch", fn, skey.data_ptr(), p2.data_ptr(),
                   p3.data_ptr(), skey.numel(), fp.data_ptr(),
                   counts.data_ptr(), rows, lanes, fp_bits, depth, int(seed),
                   high.data_ptr(), n_reads, stats.data_ptr(),
                   fp.device.index or 0, backend.stream_of(fp))
    return high, stats


def sort_stream(key_flat: torch.Tensor, rid_flat: torch.Tensor):
    """Exact-mode sort on (key as uint32, read id): one packed int64 key."""
    packed = ((key_flat.to(torch.int64) & 0xFFFFFFFF) << _RID_BITS) | rid_flat
    packed = torch.sort(packed).values
    return ((packed >> _RID_BITS).to(torch.int32),
            (packed & (MAX_READS - 1)).to(torch.int32))


def bucket_batch(fp, counts, key_flat, rid_flat, *, fp_bits: int,
                 depth: int, n_reads: int, seed: bool = False
                 ) -> BucketBatchOut:
    """Run one batch through the bucket table: sort, scan, upsert.

    Args:
      fp, counts: int32 [rows, lanes] table planes, updated in place.
      key_flat: int32 [N] keys in stream order (sentinel -1 = invalid).
      rid_flat: int64 [N] read id of each element, in [0, n_reads).
      fp_bits: fingerprint bits (rows * 2^fp_bits = 4^k); depth: high
        threshold (<= 65535).
    """
    skey, srid = sort_stream(key_flat, rid_flat)
    p2, p3 = rank_cand_scan(skey, srid, fp_bits=fp_bits, n_reads=n_reads)
    high, stats = bucket_upsert(fp, counts, skey, p2, p3, fp_bits=fp_bits,
                                depth=depth, seed=seed, n_reads=n_reads)
    return BucketBatchOut(fp=fp, counts=counts, high_per_read=high,
                          overflow=stats[0], inserted=stats[1])
