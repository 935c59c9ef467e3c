"""Bucket count table on torch tensors (k <= 15).

Port of nomalise_kmers_multi_large_tpu/table/bucket.py::BucketTable. Codes
live in lane-wide bucket rows (64 slots by default) addressed by the
bijective mix of ops/mix.py; one batch goes through ops/bucket_kernel.py
(sort, rank/cand scan, upsert kernel), which updates the planes in place.

State mapping onto TableState:
  counts   -> int32 [rows, lanes] slot counts
  keys     -> int32 [rows, lanes] fingerprint+1 (0 = empty slot)
  used     -> int32 [] occupied slots, kept live from the kernel's inserts
  overflow -> int32 [] dropped inserts (a full row); nonzero => grow
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    BucketBatchOut, bucket_batch,
)
from nomalise_kmers_multi_large_torch.ops.mix import unmix32_np
from nomalise_kmers_multi_large_torch.table.base import TableState

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


def _split_rows(keys: torch.Tensor, counts: torch.Tensor, fb: int):
    """Row-doubling remap: the entry at (r, fp) moves to row 2r + top_bit(fp)
    with that bit stripped from its fingerprint; each old row splits into two
    left-packed new rows, entries in their old lane order."""
    rows, lanes = keys.shape
    occ = keys != 0
    top = ((keys - 1) >> (fb - 1)) & 1
    stripped = torch.where(occ, ((keys - 1) & ((1 << (fb - 1)) - 1)) + 1, 0)
    halves_k, halves_c = [], []
    for bit in (0, 1):
        take = occ & (top == bit)
        # lane in the new row; entries that stay out go to a spill column
        dest = torch.where(take, torch.cumsum(take, 1) - 1, lanes)
        out_k = torch.zeros((rows, lanes + 1), dtype=keys.dtype,
                            device=keys.device)
        out_c = torch.zeros_like(out_k)
        out_k.scatter_(1, dest, torch.where(take, stripped, 0))
        out_c.scatter_(1, dest, torch.where(take, counts, 0))
        halves_k.append(out_k[:, :lanes])
        halves_c.append(out_c[:, :lanes])
    return (torch.stack(halves_k, 1).reshape(2 * rows, lanes),
            torch.stack(halves_c, 1).reshape(2 * rows, lanes))


class BucketTable:
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
                            ) -> tuple[TableState, BucketBatchOut]:
        """One whole-batch upsert + classify. `key` is int32 [R, W] in stream
        order (encode_keys output; -1 marks an invalid window). The planes
        of `state` are updated in place; the returned state shares them."""
        self._check(state)
        R, W = key.shape
        rid = torch.arange(R * W, device=key.device) // W
        out = bucket_batch(state.keys, state.counts, key.reshape(R * W), rid,
                           fp_bits=self.fp_bits, depth=depth, n_reads=R,
                           seed=seed)
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
        keys2x, cnt2x = _split_rows(state.keys, state.counts, self.fp_bits)
        new = BucketTable(self.k, rows=2 * self.rows, lanes=self.lanes,
                          device=self.device)
        return new, TableState(counts=cnt2x, keys=keys2x, used=state.used,
                               overflow=state.overflow)

    def used_count(self, state: TableState) -> int:
        """Occupied slots (reference ht->used); seeds are real entries."""
        return int((state.keys != 0).sum())

    def export(self, state: TableState):
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


def state_from_numpy(st, device="cpu") -> TableState:
    """Port state from a table state of numpy arrays (for example a JAX
    TableState passed through np.asarray field by field)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

    return TableState(counts=t(st.counts), keys=t(st.keys), used=t(st.used),
                      overflow=t(st.overflow))


def state_to_numpy(state: TableState) -> TableState:
    """The same state with every field as a numpy array on the host."""
    return TableState(*(x.cpu().numpy() for x in state))
