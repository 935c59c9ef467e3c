"""Bucket count tables on torch tensors (k <= 15, and k = 16..31).

Port of nomalise_kmers_multi_large_tpu/table/bucket.py::BucketTable and
::BucketTableWide. Codes live in lane-wide bucket rows (64 slots by default)
addressed by the bijective mixes of ops/mix.py; one batch goes through
ops/bucket_kernel.py (sort, rank/cand scan, upsert kernel), which updates
the planes in place.

State mapping onto TableState:
  counts   -> int32 [rows, lanes] slot counts
  keys     -> int32 [rows, lanes] fingerprint+1 (0 = empty slot); on the
              wide table (w1 & (2^row_shift - 1)) + 1
  keys2    -> wide table at k > 16 only: int32 [rows, lanes] w2
  used     -> int32 [] occupied slots, kept live from the kernel's inserts
  overflow -> int32 [] dropped inserts (a full row); nonzero => grow
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    BucketBatchOut, bucket_batch, bucket_batch_wide,
)
from nomalise_kmers_multi_large_torch.ops.mix import unfeistel_np, unmix32_np
from nomalise_kmers_multi_large_torch.table.base import CountTable, TableState

#: default slots per bucket row
DEFAULT_LANES = 64


def default_rows(k: int, memory_bytes: Optional[int] = None) -> int:
    """Bucket-row count, as the reference package picks it: enough rows that
    fingerprints fit 16 bits (rows >= 4^k / 2^16), at least 128, 16384 by
    default for k >= 13, or about 8 bytes per slot of a --memory_start budget
    capped at min(4^k / 64, 2^21) rows."""
    lanes = DEFAULT_LANES
    floor = max(128, (4 ** k) >> 16)
    ceiling = max(floor, min(4 ** k // lanes, 1 << 21))
    if memory_bytes is None:
        rows = max(floor, 16384 if k >= 13 else floor)
    else:
        rows = floor
        while rows * lanes * 8 * 2 <= memory_bytes and rows < ceiling:
            rows *= 2
    return min(max(rows, floor), ceiling)


#: rows of one _split_rows block: bounds its transients (an int64 lane
#: index per slot) to 512 MiB whatever the table's size
_SPLIT_BLOCK_ROWS = 1 << 20


def _split_rows(keys: torch.Tensor, counts: torch.Tensor, fb: int,
                keys2: Optional[torch.Tensor] = None):
    """Row-doubling remap: the entry at (r, fp) moves to row 2r + top_bit(fp)
    with that bit stripped from its fingerprint; each old row splits into two
    left-packed new rows, entries in their old lane order. `keys2` (the wide
    table's second plane) follows the same lane permutation unchanged.
    Returns (keys, counts, keys2) of 2 * rows rows.

    The new planes are allocated once, as [rows, 2, lanes] (row r's halves
    side by side), and filled block by block of old rows, so the remap holds
    little beyond its inputs and outputs even at 2^24 rows."""
    rows, lanes = keys.shape
    planes = [keys, counts] + ([keys2] if keys2 is not None else [])
    outs = [torch.zeros((rows, 2, lanes), dtype=p.dtype, device=p.device)
            for p in planes]
    low = (1 << (fb - 1)) - 1
    for r0 in range(0, rows, _SPLIT_BLOCK_ROWS):
        blk = slice(r0, min(rows, r0 + _SPLIT_BLOCK_ROWS))
        k = keys[blk]
        occ = k != 0
        top = (((k - 1) >> (fb - 1)) & 1).to(torch.bool)
        src = [torch.where(occ, ((k - 1) & low) + 1, 0)] + \
            [p[blk] for p in planes[1:]]
        for bit in (False, True):
            take = occ & (top == bit)
            # lane in the new row; an entry that stays out writes 0 into the
            # last lane, which a taken entry reaches only when every lane
            # of the row is taken (and then none stays out)
            dest = torch.cumsum(take, 1)
            dest -= 1
            dest.masked_fill_(~take, lanes - 1)
            for plane, out in zip(src, outs):
                out[blk, int(bit)].scatter_(1, dest,
                                            torch.where(take, plane, 0))
    out = [o.view(2 * rows, lanes) for o in outs]
    return out[0], out[1], out[2] if keys2 is not None else None


class BucketTable(CountTable):
    #: True on the k > 15 table: two sort words, two fingerprint planes
    wide = False
    bucket = True

    def __init__(self, k: int, rows: Optional[int] = None,
                 lanes: int = DEFAULT_LANES, device="cpu"):
        if not 1 <= k <= 15:
            raise ValueError("BucketTable supports k <= 15 (single-plane "
                             "30-bit codes)")
        self.k = k
        self.rows = rows or default_rows(k)
        self.lanes = lanes
        self.device = torch.device(device)
        if self.rows & (self.rows - 1) or not 1 <= self.fp_bits <= 16:
            raise ValueError(f"need power-of-two rows >= 4^k/2^16: k={k} "
                             f"rows={self.rows}")

    @property
    def fp_bits(self) -> int:
        return 2 * self.k - (self.rows.bit_length() - 1)

    @property
    def capacity(self) -> int:
        return self.rows * self.lanes

    def init(self) -> TableState:
        z = torch.zeros((self.rows, self.lanes), dtype=torch.int32,
                        device=self.device)
        return TableState(counts=z, keys=torch.zeros_like(z),
                          used=torch.zeros((), dtype=torch.int32,
                                           device=self.device),
                          overflow=torch.zeros((), dtype=torch.int32,
                                               device=self.device))

    def _check(self, state: TableState):
        if tuple(state.keys.shape) != (self.rows, self.lanes):
            raise ValueError(f"state planes {tuple(state.keys.shape)} do not "
                             f"fit a table of {self.rows} x {self.lanes}")

    # ------------------------------------------------------------------
    def process_batch_mixed(self, state: TableState, key: torch.Tensor, *,
                            depth: int, seed: bool = False,
                            relaxed: bool = False,
                            ) -> tuple[TableState, BucketBatchOut]:
        """One whole-batch upsert + classify. `key` is int32 [R, W] in stream
        order (encode_keys output; -1 marks an invalid window). The planes
        of `state` are updated in place; the returned state shares them.
        `relaxed` sorts on the key alone (bucket_batch)."""
        self._check(state)
        R, W = key.shape
        rid = torch.arange(R * W, device=key.device) // W
        out = bucket_batch(state.keys, state.counts, key.reshape(R * W), rid,
                           fp_bits=self.fp_bits, depth=depth, n_reads=R,
                           seed=seed, relaxed=relaxed)
        new_state = TableState(
            counts=out.counts, keys=out.fp,
            used=state.used + out.inserted,
            overflow=state.overflow + out.overflow,
        )
        return new_state, out

    # ------------------------------------------------------------------
    @property
    def grow_headroom(self) -> float:
        """Occupancy fraction that triggers growth: 0.45 at 64 lanes (a row
        averages ~29 entries, ~6.5 sigma below 64), 0.55 at 128."""
        return 0.55 if self.lanes >= 128 else 0.45

    @property
    def can_grow(self) -> bool:
        """Growable until capacity reaches 4^k, where no row can overflow."""
        return self.capacity < 4 ** self.k

    def grown(self, state: TableState) -> tuple["BucketTable", TableState]:
        """Double the rows: fp_bits drops by one, so the entry at (r, fp)
        moves to row 2r + top_bit(fp). The state must belong to this
        descriptor: the shift is derived from its rows."""
        self._check(state)
        if not self.can_grow or self.fp_bits < 2:
            raise ValueError("table already at 4^k capacity")
        keys2x, cnt2x, _ = _split_rows(state.keys, state.counts, self.fp_bits)
        new = BucketTable(self.k, rows=2 * self.rows, lanes=self.lanes,
                          device=self.device)
        return new, TableState(counts=cnt2x, keys=keys2x, used=state.used,
                               overflow=state.overflow)

    def for_state(self, state: TableState) -> "BucketTable":
        rows, lanes = (int(x) for x in state.keys.shape)
        if (rows, lanes) == (self.rows, self.lanes):
            return self
        return type(self)(self.k, rows=rows, lanes=lanes, device=self.device)

    def used_count(self, state: TableState, seeded_lo=None) -> int:
        """Occupied slots (reference ht->used); seeds are real entries."""
        return int((state.keys != 0).sum())

    def export(self, state: TableState, seeded_lo=None):
        """(hi, lo, count) of occupied slots in ascending code order."""
        fp = state.keys.cpu().numpy()
        cnt = state.counts.cpu().numpy()
        occ_r, occ_l = np.nonzero(fp)
        mixed = (occ_r.astype(np.uint64) << np.uint64(self.fp_bits)) | \
            (fp[occ_r, occ_l].astype(np.uint64) - 1)
        codes = unmix32_np(mixed.astype(np.uint32), 2 * self.k)
        vals = cnt[occ_r, occ_l].astype(np.int32)
        order = np.argsort(codes, kind="stable")
        codes, vals = codes[order], vals[order]
        return np.zeros_like(codes), codes.astype(np.uint32), vals


# ----------------------------------------------------------------------
# wide table, k = 16..31

def default_rows_wide(k: int, memory_bytes: Optional[int] = None) -> int:
    """Row count of the wide table, as the reference package picks it: 2^14
    rows (1M slots at 64 lanes) by default, or as much of a --memory_start
    budget as fits below 2^20 rows at 8 (k = 16) or 12 bytes per slot."""
    floor, ceiling = 1 << 14, 1 << 20
    if memory_bytes is None:
        return floor
    bps = 8 if k == 16 else 12
    rows = floor
    while rows * DEFAULT_LANES * bps * 2 <= memory_bytes and rows < ceiling:
        rows *= 2
    return rows


class BucketTableWide(BucketTable):
    """Exact bucket table for k = 16..31 (codes up to 62 bits).

    The design of BucketTable, with the code mixed by the two-word Feistel
    of ops/mix.py: row ``w1 >> row_shift``, ``keys`` holds
    ``(w1 & (2^row_shift - 1)) + 1`` (0 = empty) and ``keys2`` holds w2
    (absent at k = 16, where w2 is 0)."""

    wide = True
    #: growth ceiling: 2^24 rows = 2^30 slots, 12 GiB of planes at 64 lanes
    #: and k > 16 (row_shift 8; a slot index still fits int32)
    MAX_ROWS = 1 << 24

    def __init__(self, k: int, rows: Optional[int] = None,
                 lanes: int = DEFAULT_LANES, device="cpu"):
        if not 16 <= k <= 31:
            raise ValueError("BucketTableWide supports k = 16..31")
        self.k = k
        self.rows = rows or default_rows_wide(k)
        self.lanes = lanes
        self.device = torch.device(device)
        if self.rows & (self.rows - 1) or not 512 <= self.rows <= \
                self.MAX_ROWS:
            raise ValueError(f"wide bucket table needs power-of-two rows in "
                             f"512..{self.MAX_ROWS}, got {self.rows}")

    @property
    def row_shift(self) -> int:
        """w1 bits below the row: rows = 2^(32 - row_shift)."""
        return 32 - (self.rows.bit_length() - 1)

    @property
    def has_plane_b(self) -> bool:
        return self.k > 16

    def init(self) -> TableState:
        st = super().init()
        return st._replace(keys2=torch.zeros_like(st.keys)
                           if self.has_plane_b else None)

    def process_batch_keys(self, state: TableState, w1: torch.Tensor,
                           w2: torch.Tensor, *, depth: int,
                           seed: bool = False, relaxed: bool = False
                           ) -> tuple[TableState, BucketBatchOut]:
        """One whole-batch upsert + classify. `w1`, `w2` are int32 [R, W]
        Feistel sort words in stream order (encode_keys_wide output; the
        pair (-1, -1) marks an invalid window). The planes of `state` are
        updated in place; the returned state shares them. `relaxed` sorts
        unstably (bucket_batch_wide)."""
        self._check(state)
        R, W = w1.shape
        out = bucket_batch_wide(state.keys, state.keys2, state.counts,
                                w1.reshape(R * W), w2.reshape(R * W),
                                windows_per_read=W, row_shift=self.row_shift,
                                depth=depth, seed=seed, relaxed=relaxed)
        new_state = TableState(
            counts=out.counts, keys=out.fpA,
            used=state.used + out.inserted,
            overflow=state.overflow + out.overflow, keys2=out.fpB,
        )
        return new_state, BucketBatchOut(
            fp=out.fpA, counts=out.counts, high_per_read=out.high_per_read,
            overflow=out.overflow, inserted=out.inserted)

    def process_batch_mixed(self, *a, **kw):
        raise NotImplementedError("the wide table takes Feistel word pairs "
                                  "(process_batch_keys)")

    @property
    def can_grow(self) -> bool:
        return self.rows < self.MAX_ROWS

    def grown(self, state: TableState
              ) -> tuple["BucketTableWide", TableState]:
        """Double the rows: the top bit of plane A's fingerprint picks the
        new row, and plane B follows the lane permutation unchanged. The
        state must belong to this descriptor."""
        self._check(state)
        if not self.can_grow:
            raise ValueError(f"wide table already at {self.MAX_ROWS} rows")
        keys2x, cnt2x, b2x = _split_rows(state.keys, state.counts,
                                         self.row_shift, state.keys2)
        new = BucketTableWide(self.k, rows=2 * self.rows, lanes=self.lanes,
                              device=self.device)
        return new, TableState(counts=cnt2x, keys=keys2x, used=state.used,
                               overflow=state.overflow, keys2=b2x)

    def export(self, state: TableState, seeded_lo=None):
        """(hi, lo, count) of occupied slots in ascending code order."""
        fp = state.keys.cpu().numpy()
        cnt = state.counts.cpu().numpy()
        occ_r, occ_l = np.nonzero(fp)
        w1 = (occ_r.astype(np.uint32) << np.uint32(self.row_shift)) | \
            (fp[occ_r, occ_l].astype(np.uint32) - 1)
        w2 = (state.keys2.cpu().numpy()[occ_r, occ_l].astype(np.uint32)
              if state.keys2 is not None else np.zeros_like(w1))
        codes = unfeistel_np(w1, w2, 2 * self.k)
        vals = cnt[occ_r, occ_l].astype(np.int32)
        order = np.argsort(codes, kind="stable")
        codes, vals = codes[order], vals[order]
        return ((codes >> np.uint64(32)).astype(np.uint32),
                (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32), vals)

