"""Direct-address count table: a dense int32 [4^k] array indexed by the code.

Port of nomalise_kmers_multi_large_tpu/table/direct.py::DirectTable. This is
what the reference's open-addressing table degenerates to when sized as its
own advice says (normalise_kmers_multi_large.c:20-22): ``hash % 4^k`` is the
identity, so counting is exact and collision-free, at 4 bytes a slot.

Code 0 (poly-A) is never counted (:1483-1484), so slot 0 stays 0 and an
occupied slot is a nonzero one. Seeds are inserted with count 0 (seed_kmer_
hash :1322-1373), which a count array cannot show: the engine keeps the
seeded codes on the host (``seeded_lo``), and only ``used_count`` and
``export`` read them; the device step ignores seeding.

The table never grows (``grow_headroom`` None).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.ops.streamrank import SortedStream
from nomalise_kmers_multi_large_torch.table.base import CountTable, TableState

#: slots counted at once by used_count
_COUNT_CHUNK = 1 << 26


class DirectTable(CountTable):
    seeds_on_host = True

    def __init__(self, k: int, device="cpu"):
        if not 1 <= k <= 15:
            raise ValueError("DirectTable supports k <= 15 (4^k int32 slots)")
        self.k = k
        self.device = torch.device(device)

    @property
    def capacity(self) -> int:
        return 4 ** self.k

    def init(self) -> TableState:
        def scalar():
            return torch.zeros((), dtype=torch.int32, device=self.device)

        return TableState(counts=torch.zeros(self.capacity, dtype=torch.int32,
                                             device=self.device),
                          keys=None, used=scalar(), overflow=scalar())

    def _scatter_index(self, code: torch.Tensor, valid: torch.Tensor):
        """Slots to add to: the code, or for an invalid position (which adds
        0) its own index folded into the table, so that those no-op adds
        spread over the table instead of piling atomics onto one slot."""
        spread = torch.arange(code.numel(), device=code.device) & \
            (self.capacity - 1)
        return torch.where(valid, code, spread)

    def count_and_update(self, state: TableState, stream: SortedStream,
                         seed: bool = False):
        """observed = prior count + rank at every valid occurrence; each
        code's multiplicity is added once, at its run head. The counts are
        updated in place."""
        if seed:
            return state, torch.zeros_like(stream.rank)
        slot = self._scatter_index(stream.code, stream.valid)
        prior = torch.where(stream.valid, state.counts[slot], 0)
        state.counts.index_add_(0, slot, stream.mult)
        return state, prior + stream.rank

    def relaxed_update(self, state: TableState, code: torch.Tensor,
                       valid: torch.Tensor):
        """Sort-free relaxed-mode update of a stream-order batch: the prior
        count of every occurrence, then one add per valid occurrence (the
        JAX table's duplicate-index scatter-add). The caller adds ranks
        local to each record. Returns (state, prior int32 [N])."""
        slot = self._scatter_index(code, valid)
        prior = torch.where(valid, state.counts[slot], 0)
        state.counts.index_add_(0, slot, valid.to(torch.int32))
        return state, prior

    def used_count(self, state: TableState,
                   seeded_lo: Optional[np.ndarray] = None) -> int:
        """Nonzero counts, plus the seeded codes whose count is still 0
        (they hold a slot in the reference). Counted in chunks: on CUDA,
        count_nonzero of a whole 4^15 array allocates transients larger
        than the array itself."""
        used = sum(int(torch.count_nonzero(c))
                   for c in state.counts.split(_COUNT_CHUNK))
        if seeded_lo is not None and seeded_lo.size:
            idx = torch.from_numpy(seeded_lo.astype(np.int64)).to(
                state.counts.device)
            used += int((state.counts[idx] == 0).sum())
        return used

    def export(self, state: TableState,
               seeded_lo: Optional[np.ndarray] = None):
        occ = torch.nonzero(state.counts).squeeze(1)
        vals = state.counts[occ].cpu().numpy()
        occ = occ.cpu().numpy()
        if seeded_lo is not None and seeded_lo.size:
            seeds = seeded_lo.astype(np.int64)
            seed_counts = state.counts[torch.from_numpy(seeds).to(
                state.counts.device)].cpu().numpy()
            zero = seeds[seed_counts == 0]
            occ = np.concatenate([occ, zero])
            vals = np.concatenate([vals, np.zeros(zero.size, np.int32)])
            order = np.argsort(occ, kind="stable")
            occ, vals = occ[order], vals[order]
        return (np.zeros(occ.size, np.uint32), occ.astype(np.uint32),
                vals.astype(np.int32))
