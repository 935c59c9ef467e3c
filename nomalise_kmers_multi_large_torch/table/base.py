"""Table state of one shard, as torch tensors, and what every table offers.

``TableState`` has the fields of nomalise_kmers_multi_large_tpu/table/
base.py::TableState, in its order, so a JAX state converted to numpy maps
onto it field by field (``state_from_numpy`` / ``state_to_numpy``). One
layout differs: the hashed table keeps a slot's code as one int64 word
(0 = empty), where the JAX table keeps uint32 (hi, lo) planes [2, C]; the
two converters translate, so states and checkpoints cross both ways.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch


class TableState(NamedTuple):
    counts: torch.Tensor    # int32 [rows, lanes] (bucket) or [C] slot counts
    #: bucket: int32 [rows, lanes] fingerprint+1 (0 = empty); hashed: int64
    #: [C] slot code (0 = empty); direct: None
    keys: Optional[torch.Tensor]
    used: torch.Tensor      # int32 [] occupied slots
    overflow: torch.Tensor  # int32 [] inserts dropped for want of a slot
    #: int32 [rows, lanes] second fingerprint plane of the wide table at
    #: k > 16 (w2); None for every other table
    keys2: Optional[torch.Tensor] = None


class CountTable:
    """What the engine asks of a count table (descriptor; the state lives
    in a TableState). The bucket tables take a batch through their own
    kernels (process_batch_mixed / process_batch_keys); the direct and
    hashed tables take the sorted occurrence stream (count_and_update)."""

    #: occupancy fraction that triggers growth; None: the table never grows
    grow_headroom: Optional[float] = None
    #: True where a batch goes through the encode kernels' keys (K1/K2)
    #: and the bucket kernels, False on the codec path
    bucket = False
    #: True where a seeded code (count 0) cannot be told from an absent one
    #: (the direct tables): the engine keeps the seeds on the host
    #: (``seeded_lo``), and used_count and export read them
    seeds_on_host = False
    device: torch.device

    def on(self, device) -> "CountTable":
        """This descriptor, or a copy of it whose states live on `device`
        (the shards of a multi-device run)."""
        device = torch.device(device)
        if device == self.device:
            return self
        t = copy.copy(self)
        t.device = device
        return t

    @property
    def capacity(self) -> int:
        raise NotImplementedError

    @property
    def can_grow(self) -> bool:
        return False

    def init(self) -> TableState:
        raise NotImplementedError

    def count_and_update(self, state: TableState, stream, seed: bool = False):
        """Apply one batch of upserts from an ops.streamrank.SortedStream;
        return (state', observed int32 [N]): per sorted occurrence, the
        count the reference would see after its own increment. With
        ``seed``, codes are inserted with count 0 and observed means
        nothing."""
        raise NotImplementedError

    def used_count(self, state: TableState,
                   seeded_lo: Optional[np.ndarray] = None) -> int:
        """Occupied slots (reference ht->used). `seeded_lo`: the host set of
        seeded codes, which only the direct table needs."""
        raise NotImplementedError

    def export(self, state: TableState,
               seeded_lo: Optional[np.ndarray] = None):
        """(hi uint32, lo uint32, count int32) of the occupied slots in
        ascending code order, the -P dump's order on every table."""
        raise NotImplementedError

    def grown(self, state: TableState):
        raise NotImplementedError(f"{type(self).__name__} does not grow")

    def for_state(self, state: TableState) -> "CountTable":
        """A descriptor of this kind that fits `state` (a checkpoint may
        hold a grown table)."""
        return self


def state_from_numpy(st, device="cpu") -> TableState:
    """Port state from a table state of numpy arrays (for example a JAX
    TableState passed through np.asarray field by field, or a checkpoint's
    arrays); a None plane stays None. Hashed keys arrive as (hi, lo) planes
    [2, C] beside counts [C] and become one int64 word per slot."""
    st = TableState(*st)

    def t(x, dtype=np.int32):
        if x is None:
            return None
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    keys = t(st.keys)
    if st.keys is not None and np.ndim(st.counts) == 1:
        planes = np.asarray(st.keys).astype(np.uint32).astype(np.uint64)
        keys = t((planes[0] << np.uint64(32)) | planes[1], np.int64)
    return TableState(counts=t(st.counts), keys=keys, used=t(st.used),
                      overflow=t(st.overflow), keys2=t(st.keys2))


def state_to_numpy(state: TableState) -> TableState:
    """The same state with every field as a numpy array on the host, in
    the JAX package's layout (hashed keys as uint32 (hi, lo) planes [2,
    C]); a None plane stays None."""
    out = TableState(*(None if x is None else x.cpu().numpy()
                       for x in state))
    if out.keys is not None and out.keys.dtype == np.int64:
        code = out.keys.view(np.uint64)
        out = out._replace(keys=np.stack([
            (code >> np.uint64(32)).astype(np.uint32),
            (code & np.uint64(0xFFFFFFFF)).astype(np.uint32)]))
    return out
