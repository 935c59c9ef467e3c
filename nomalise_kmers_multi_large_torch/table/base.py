"""Table state of one shard, as torch tensors.

The fields of nomalise_kmers_multi_large_tpu/table/base.py::TableState, in
its order, so a JAX state converted to numpy maps onto it field by field
(table/bucket.py state_from_numpy / state_to_numpy).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TableState(NamedTuple):
    counts: torch.Tensor    # int32 [rows, lanes] slot counts
    keys: torch.Tensor      # int32 [rows, lanes] fingerprint+1 (0 = empty)
    used: torch.Tensor      # int32 [] occupied slots (live, counted in-kernel)
    overflow: torch.Tensor  # int32 [] inserts dropped for a full row
    #: int32 [rows, lanes] second fingerprint plane of the wide table at
    #: k > 16 (w2); None for the narrow table and at k = 16
    keys2: Optional[torch.Tensor] = None
