"""Hashed count table: open addressing on the device, with growth.

Port of nomalise_kmers_multi_large_tpu/table/hashed.py::HashedTable, the
table for k > 15 where a dense 4^k array cannot fit. Like the JAX table, and
unlike the reference's ``store_kmer`` (normalise_kmers_multi_large.c:929-
1108): a mixing slot hash, power-of-two capacity with triangular probing,
and a correct upsert where the reference's collision branch corrupts counts.
One batch is one launch of the find-or-insert kernel (ops/hashed_kernel.py,
csrc/hashed.cu), which also reads each code's prior count and adds its
multiplicity.

State mapping onto TableState:
  counts   -> int32 [C] slot counts
  keys     -> int64 [C] slot code, 0 = empty (code 0 is never counted);
              the JAX table's uint32 (hi, lo) planes [2, C] on the host
              (table/base.py state_to_numpy / state_from_numpy)
  used     -> int32 [] occupied slots
  overflow -> int32 [] codes left unresolved after 64 probes; nonzero =>
              the engine grows and replays

Two repairs of the JAX table. ``grown`` keeps ``overflow`` (the JAX table
resets it to 0, hashed.py:177, and the engine's replay check compares a
monotone counter with its host mirror, so a reset hides a replay that
overflowed again). And an unresolved code is neither read nor counted: the
JAX table indexes its counts with slot -1, which JAX wraps to the last
slot, so it reads and adds to slot C - 1's count.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.ops.hashed_kernel import hashed_insert
from nomalise_kmers_multi_large_torch.ops.streamrank import SortedStream
from nomalise_kmers_multi_large_torch.table.base import CountTable, TableState

#: growth ceiling: slot indices are int32; 2^30 slots hold 12 GiB of state
MAX_CAPACITY = 1 << 30


class HashedTable(CountTable):
    #: the engine grows past half load: probe chains need a sparse table
    #: (the reference grows at 0.8, nk.c:143,933-934)
    grow_headroom = 0.5

    def __init__(self, k: int, initial_capacity: int, device="cpu"):
        c = initial_capacity
        if c < 2 or c & (c - 1) or c > MAX_CAPACITY:
            raise ValueError(f"hashed table capacity must be a power of two "
                             f"up to 2^30, got {c}")
        self.k = k
        self._capacity = c
        self.device = torch.device(device)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def can_grow(self) -> bool:
        return self._capacity < MAX_CAPACITY

    def init(self) -> TableState:
        def scalar():
            return torch.zeros((), dtype=torch.int32, device=self.device)

        return TableState(
            counts=torch.zeros(self._capacity, dtype=torch.int32,
                               device=self.device),
            keys=torch.zeros(self._capacity, dtype=torch.int64,
                             device=self.device),
            used=scalar(), overflow=scalar())

    def _check(self, state: TableState):
        if tuple(state.keys.shape) != (self._capacity,):
            raise ValueError(f"state of {tuple(state.keys.shape)} slots does "
                             f"not fit a table of {self._capacity}")

    def count_and_update(self, state: TableState, stream: SortedStream,
                         seed: bool = False):
        """Insert the batch's codes (its run heads) and, unless seeding, add
        each one's multiplicity; an occurrence observes its head's prior
        count plus its rank. An unresolved code observes its rank alone and
        is not counted. The planes are updated in place."""
        self._check(state)
        heads = torch.where(stream.boundary, stream.code, 0)
        if seed:
            out = hashed_insert(state.keys, heads, outputs=False)
        else:
            out = hashed_insert(state.keys, heads, stream.mult, state.counts)
        stats = out.stats.to(torch.int32)
        state = state._replace(used=state.used + stats[0],
                               overflow=state.overflow + stats[1])
        if seed:
            return state, torch.zeros_like(stream.rank)
        # a run's head sits rank - 1 places before each of its occurrences
        pos = torch.arange(stream.rank.numel(), device=stream.rank.device)
        return state, out.prior[pos - stream.rank + 1] + stream.rank

    def grown(self, state: TableState) -> tuple["HashedTable", TableState]:
        """Twice the capacity, every occupied slot inserted anew with its
        count by the same kernel (the role of the reference's expand_local_
        hash_table :1055-1108); `overflow` is kept."""
        self._check(state)
        if not self.can_grow:
            raise ValueError(f"hashed table already at {MAX_CAPACITY} slots")
        new = HashedTable(self.k, 2 * self._capacity, device=self.device)
        st = new.init()
        out = hashed_insert(st.keys, state.keys, state.counts, st.counts,
                            outputs=False)
        stats = out.stats.to(torch.int32)
        return new, st._replace(used=stats[0],
                                overflow=state.overflow + stats[1])

    def for_state(self, state: TableState) -> "HashedTable":
        c = int(state.counts.shape[0])
        return self if c == self._capacity else \
            HashedTable(self.k, c, device=self.device)

    def used_count(self, state: TableState,
                   seeded_lo: Optional[np.ndarray] = None) -> int:
        return int(state.used)

    def export(self, state: TableState,
               seeded_lo: Optional[np.ndarray] = None):
        occ = torch.nonzero(state.keys).squeeze(1)
        code, order = torch.sort(state.keys[occ])
        vals = state.counts[occ[order]].cpu().numpy()
        code = code.cpu().numpy().view(np.uint64)
        return ((code >> np.uint64(32)).astype(np.uint32),
                (code & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                vals.astype(np.int32))
