"""Bucket-table upsert + classify for one batch (K4, k <= 15; K5, k = 16..31).

Port of nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py::bucket_batch
and ::bucket_batch_wide.
Data structure (unchanged): a code's mixed key m = mix32(code, 2k) goes to
bucket row ``m >> fp_bits``; ``fp[row, lane]`` stores the fingerprint
``(m & (2^fp_bits - 1)) + 1`` (0 = empty slot) and ``counts[row, lane]`` its
count. Rows are left-packed and a new code takes lane ``occ[row] +`` the
number of this batch's earlier inserts into the row, so the planes equal
the JAX tables lane for lane.

``bucket_batch`` sorts the stream on one packed int64 key
``(key << 14) | read id`` (exact mode; read ids < 16384; relaxed mode sorts
the 32-bit key alone, see ``sort_stream``), runs the rank /
candidate scan (K3) and then ``bucket_upsert`` (K4), which updates ``fp`` and
``counts`` IN PLACE (the JAX kernel aliases them too; in place saves a
second copy of a table of up to 1 GiB). ``bucket_upsert`` launches the CUDA
kernel (csrc/bucket.cu) for CUDA tensors and runs ``bucket_upsert_plain``
for CPU tensors.

The wide table (k = 16..31) keys a code by its Feistel sort words (w1, w2)
(ops/mix.py feistel_words): row ``w1 >> row_shift``, fingerprint planes
``fpA = (w1 & (2^row_shift - 1)) + 1`` (0 = empty) and ``fpB = w2`` (no fpB
at k = 16). ``bucket_batch_wide`` sorts on one int64 key ``(w1 << 30) | w2``
(a real w2 is < 2^30; the sentinel pair maps to INT64_MAX) with a stable
sort (unstable in relaxed mode), so the read id is the sorted position's
stream index // windows per read; then the wide scan (K3w) and ``bucket_upsert_wide`` (K5,
csrc/bucket_wide.cu; ``bucket_upsert_wide_plain`` for CPU tensors). Window
validity is ``w2 != 0xFFFFFFFF``: a sentinel's w1 maps to row
``2^(32 - row_shift) - 1``, the last row of a whole table and past the rows
of a row shard (Mode B), and no invalid element's row is ever read.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from nomalise_kmers_multi_large_torch import backend
from nomalise_kmers_multi_large_torch.ops.encode_kernel import as_int32
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan

_RID_BITS = 14                # read ids per batch < 2^14 = 16384
MAX_READS = 1 << _RID_BITS

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_WIDE = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p])
_W2_BITS = 30                 # a real w2 is < 2^30
_SORT_SENTINEL = (1 << 63) - 1
_INT32_MIN = -(1 << 31)       # key ^ INT32_MIN orders int32 keys as uint32


class BucketBatchOut(NamedTuple):
    fp: torch.Tensor             # int32 [rows, lanes] fingerprints (+1; 0 = empty)
    counts: torch.Tensor         # int32 [rows, lanes]
    high_per_read: torch.Tensor  # int32 [n_reads] high windows per read
    overflow: torch.Tensor       # int32 [] codes dropped (row full / cand >= lanes)
    inserted: torch.Tensor       # int32 [] slots newly occupied


def _upsert_plain(planes, counts, row, fvals, sel, p2, p3, *, depth: int,
                  seed: bool, n_reads: int):
    """Plain upsert of the selected (valid) elements of a sorted stream:
    per-code work on the run heads (rank 1), then multiplicities scattered
    back. A code matches a slot where every plane equals its value in
    `fvals`; the first plane is nonzero exactly on occupied slots. Updates
    the planes and counts in place; returns (high_per_read, stats[dropped,
    inserted])."""
    dev = counts.device
    lanes = counts.shape[1]
    row = row[sel]
    fvals = [f[sel] for f in fvals]
    q = p2[sel].to(torch.int64) & 0xFFFFFFFF
    rank, rid = q & 0xFFFF, q >> 16
    cand = p3[sel].to(torch.int64)

    # one run per distinct code, starting at its rank-1 occurrence
    head = rank == 1
    run = torch.cumsum(head, 0) - 1
    hidx = torch.nonzero(head).squeeze(1)
    h_row, h_cand = row[hidx], cand[hidx]
    h_f = [f[hidx] for f in fvals]
    mult = torch.bincount(run, minlength=hidx.numel())
    eq = torch.ones((hidx.numel(), lanes), dtype=torch.bool, device=dev)
    for plane, f in zip(planes, h_f):
        eq &= plane[h_row] == f[:, None].to(plane.dtype)
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
    occ = (planes[0][e_row] != 0).sum(1)
    lane = occ + within
    fits = lane < lanes
    ins = eidx[fits]
    i_row, i_lane = h_row[ins], lane[fits]

    if not seed:
        m = torch.nonzero(matched).squeeze(1)
        counts[h_row[m], m_lane[m]] += mult[m].to(counts.dtype)
        counts[i_row, i_lane] += mult[ins].to(counts.dtype)
    for plane, f in zip(planes, h_f):
        plane[i_row, i_lane] = f[ins].to(plane.dtype)

    n_ins = ins.numel()
    stats = torch.tensor([int(new.sum()) - n_ins, n_ins], dtype=torch.int32,
                         device=dev)
    return high, stats


def bucket_upsert_plain(fp, counts, skey, p2, p3, *, fp_bits: int,
                        depth: int, seed: bool, n_reads: int):
    """Plain PyTorch version of the kernel, on any device. Updates fp and
    counts in place; returns (high_per_read, stats[dropped, inserted])."""
    key = skey.to(torch.int64) & 0xFFFFFFFF
    row = key >> fp_bits
    sel = torch.nonzero((key != 0xFFFFFFFF) & (row < fp.shape[0])).squeeze(1)
    f = (key & ((1 << fp_bits) - 1)) + 1
    return _upsert_plain((fp,), counts, row, (f,), sel, p2, p3, depth=depth,
                         seed=seed, n_reads=n_reads)


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


def sort_stream(key_flat: torch.Tensor, rid_flat: torch.Tensor,
                relaxed: bool = False):
    """Sort the stream on (key as uint32, read id): one packed int64 key.

    Relaxed mode (``--mode relaxed``) sorts the 32-bit key alone, unstably,
    with the stream index as the payload: equal keys then reach the scan in
    any order, so which read sees which occurrence rank among a batch's
    copies of one code is arbitrary (the JAX package's ``num_keys=1``
    sort). Counts and every code's multiset of observed values are as in
    exact mode, and half the key width halves a radix sort's passes.
    Returns (skey, srid) int32 [N]."""
    if relaxed:
        flipped, order = torch.sort(key_flat.to(torch.int32) ^ _INT32_MIN,
                                    stable=False)
        return flipped ^ _INT32_MIN, rid_flat[order].to(torch.int32)
    packed = ((key_flat.to(torch.int64) & 0xFFFFFFFF) << _RID_BITS) | rid_flat
    packed = torch.sort(packed).values
    return ((packed >> _RID_BITS).to(torch.int32),
            (packed & (MAX_READS - 1)).to(torch.int32))


def bucket_batch(fp, counts, key_flat, rid_flat, *, fp_bits: int,
                 depth: int, n_reads: int, seed: bool = False,
                 relaxed: bool = False) -> BucketBatchOut:
    """Run one batch through the bucket table: sort, scan, upsert.

    Args:
      fp, counts: int32 [rows, lanes] table planes, updated in place.
      key_flat: int32 [N] keys in stream order (sentinel -1 = invalid).
      rid_flat: int64 [N] read id of each element, in [0, n_reads).
      fp_bits: fingerprint bits (rows * 2^fp_bits = 4^k); depth: high
        threshold (<= 65535).
      relaxed: sort on the key alone (sort_stream).
    """
    skey, srid = sort_stream(key_flat, rid_flat, relaxed)
    p2, p3 = rank_cand_scan(skey, srid, fp_bits=fp_bits, n_reads=n_reads)
    high, stats = bucket_upsert(fp, counts, skey, p2, p3, fp_bits=fp_bits,
                                depth=depth, seed=seed, n_reads=n_reads)
    return BucketBatchOut(fp=fp, counts=counts, high_per_read=high,
                          overflow=stats[0], inserted=stats[1])


# ----------------------------------------------------------------------
# wide table, k = 16..31

class BucketBatchWideOut(NamedTuple):
    fpA: torch.Tensor            # int32 [rows, lanes] plane A (+1; 0 = empty)
    fpB: Optional[torch.Tensor]  # int32 [rows, lanes] plane B; None at k = 16
    counts: torch.Tensor         # int32 [rows, lanes]
    high_per_read: torch.Tensor  # int32 [n_reads] high windows per read
    overflow: torch.Tensor       # int32 [] codes dropped (row full / cand >= lanes)
    inserted: torch.Tensor       # int32 [] slots newly occupied


def bucket_upsert_wide_plain(fpA, fpB, counts, sk1, sk2, p2, p3, *,
                             row_shift: int, depth: int, seed: bool,
                             n_reads: int):
    """Plain PyTorch version of the wide kernel, on any device. Updates the
    planes and counts in place; returns (high_per_read, stats[dropped,
    inserted])."""
    w1 = sk1.to(torch.int64) & 0xFFFFFFFF
    w2 = sk2.to(torch.int64) & 0xFFFFFFFF
    sel = torch.nonzero(w2 != 0xFFFFFFFF).squeeze(1)
    f_a = (w1 & ((1 << row_shift) - 1)) + 1
    planes, fvals = ((fpA,), (f_a,)) if fpB is None else \
        ((fpA, fpB), (f_a, w2))
    return _upsert_plain(planes, counts, w1 >> row_shift, fvals, sel, p2, p3,
                         depth=depth, seed=seed, n_reads=n_reads)


def bucket_upsert_wide(fpA, fpB, counts, sk1, sk2, p2, p3, *, row_shift: int,
                       depth: int, seed: bool, n_reads: int):
    """Upsert + classify a sorted wide stream into the table (in place).

    Args:
      fpA, counts: int32 [rows, lanes] planes, updated in place; fpB the
        same, or None at k = 16.
      sk1, sk2: int32 [N] sorted sort words (sentinel pair (-1, -1) last);
        p2, p3: int32 [N] from the wide rank_cand_scan.
      row_shift: the row of w1 is ``w1 >> row_shift``, 8..23; rows is
        2^(32 - row_shift) for a whole table, less for a row shard of one
        (Mode B), whose stream holds only its own rebased rows.
      depth, seed, n_reads: as bucket_upsert.

    Returns (high_per_read int32 [n_reads], stats int32 [2] = (dropped
    inserts, inserted slots)).
    """
    planes = (fpA, counts) if fpB is None else (fpA, fpB, counts)
    if any(t.shape != fpA.shape for t in planes) or fpA.dim() != 2:
        raise ValueError("bucket_upsert_wide: planes must share [rows, lanes]")
    if not (sk1.shape == sk2.shape == p2.shape == p3.shape
            and sk1.dim() == 1):
        raise ValueError("bucket_upsert_wide: sk1, sk2, p2, p3 must be [N]")
    rows, lanes = fpA.shape
    if not 8 <= row_shift <= 23 or rows < 1 or rows & (rows - 1) or \
            rows << row_shift > 1 << 32 or lanes % 32 or lanes > 128:
        raise ValueError(f"bucket_upsert_wide: planes {tuple(fpA.shape)} "
                         f"with row_shift {row_shift}: need power-of-two "
                         "rows <= 2^(32 - row_shift) (a table, or one of "
                         "its row shards) and lanes a multiple of 32 up to "
                         "128")
    if not 1 <= n_reads <= MAX_READS or depth > 65535:
        raise ValueError(f"bucket_upsert_wide: n_reads={n_reads} or "
                         f"depth={depth} out of range")
    if fpA.device.type == "cpu":
        return bucket_upsert_wide_plain(
            fpA, fpB, counts, sk1, sk2, p2, p3, row_shift=row_shift,
            depth=depth, seed=seed, n_reads=n_reads)
    backend.require_cuda("bucket_upsert_wide", *planes, sk1, sk2, p2, p3)
    if any(t.dtype != torch.int32 for t in (*planes, sk1, sk2, p2, p3)):
        raise TypeError("bucket_upsert_wide: every tensor must be int32")
    high = torch.zeros(n_reads, dtype=torch.int32, device=fpA.device)
    stats = torch.zeros(2, dtype=torch.int32, device=fpA.device)
    fn = backend.function("bucket_batch_wide", "nkm_bucket_batch_wide",
                          _ARGTYPES_WIDE)
    backend.launch("bucket_batch_wide", fn, sk1.data_ptr(), sk2.data_ptr(),
                   p2.data_ptr(), p3.data_ptr(), sk1.numel(), fpA.data_ptr(),
                   None if fpB is None else fpB.data_ptr(), counts.data_ptr(),
                   rows, lanes, row_shift, depth, int(seed), high.data_ptr(),
                   n_reads, stats.data_ptr(), fpA.device.index or 0,
                   backend.stream_of(fpA))
    return high, stats


def sort_stream_wide(w1_flat: torch.Tensor, w2_flat: torch.Tensor,
                     windows_per_read: int, relaxed: bool = False,
                     rid_flat: Optional[torch.Tensor] = None):
    """Sort a stream on (w1, w2, read id).

    One int64 key ``(w1 << 30) | w2`` (< 2^62), the sentinel pair mapped to
    INT64_MAX, sorted stably: equal codes keep stream order. In a read-major
    stream the sorted position's stream index // windows_per_read is then
    its read id. A stream that is not read-major (Mode B's received
    stream: the pieces of D senders, each sorted by (w1, w2, read id))
    passes its read ids as `rid_flat`, the sort's payload; the order is
    then (w1, w2, read id) exactly when each code's copies arrive in
    read-id order, which the senders' order gives. Relaxed mode sorts
    unstably (the JAX package's ``num_keys=2``): equal codes reach the scan
    in any order. Returns (sk1, sk2, srid) int32 [N], the sentinel pair
    back at (-1, -1)."""
    w1 = w1_flat.to(torch.int64) & 0xFFFFFFFF
    w2 = w2_flat.to(torch.int64) & 0xFFFFFFFF
    packed = torch.where(w2 == 0xFFFFFFFF, _SORT_SENTINEL,
                         (w1 << _W2_BITS) | w2)
    packed, order = torch.sort(packed, stable=not relaxed)
    sent = packed == _SORT_SENTINEL
    sk1 = as_int32(torch.where(sent, -1, packed >> _W2_BITS))
    sk2 = as_int32(torch.where(sent, -1, packed & ((1 << _W2_BITS) - 1)))
    srid = order // windows_per_read if rid_flat is None else rid_flat[order]
    return sk1, sk2, srid.to(torch.int32)


def bucket_batch_wide(fpA, fpB, counts, w1_flat, w2_flat, *,
                      windows_per_read: int, row_shift: int, depth: int,
                      seed: bool = False, relaxed: bool = False
                      ) -> BucketBatchWideOut:
    """Run one read-major batch through the wide bucket table: sort, wide
    scan (K3w), wide upsert (K5). The planes are updated in place.

    Args:
      fpA, fpB, counts: the table planes (fpB None at k = 16).
      w1_flat, w2_flat: int32 [N] sort words in stream order, N a multiple
        of windows_per_read; an invalid window holds (-1, -1).
      row_shift, depth, seed: as bucket_upsert_wide.
      relaxed: sort unstably (sort_stream_wide).
    """
    n_reads = w1_flat.numel() // windows_per_read
    sk1, sk2, srid = sort_stream_wide(w1_flat, w2_flat, windows_per_read,
                                      relaxed)
    p2, p3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=n_reads,
                            skey2=sk2, row_shift=row_shift)
    high, stats = bucket_upsert_wide(fpA, fpB, counts, sk1, sk2, p2, p3,
                                     row_shift=row_shift, depth=depth,
                                     seed=seed, n_reads=n_reads)
    return BucketBatchWideOut(fpA=fpA, fpB=fpB, counts=counts,
                              high_per_read=high, overflow=stats[0],
                              inserted=stats[1])
