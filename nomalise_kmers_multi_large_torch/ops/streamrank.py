"""Sort-based exact occurrence ranking (the direct and hashed tables' path).

Port of nomalise_kmers_multi_large_tpu/ops/streamrank.py. In the reference,
a read's keep/skip decision depends on every k-mer upsert before it,
including earlier k-mers of the same read (``sequence_to_hash``
normalise_kmers_multi_large.c:1459-1499 increments, then tests). A batch
restores that order algebraically: occurrence g of code c observes

    table_count_before_batch[c] + rank(g)

where rank(g) is g's 1-based index among the batch's occurrences of c in
stream order. One stable sort of the stream by code gives every rank, each
code's multiplicity (one aggregated table update per code) and the sorted
unique table indices.

The JAX package sorts (hi, lo, position) as three uint32 keys, and two at
k <= 15, except at k = 16, where the all-T code's lo equals its 32-bit
sentinel. Here a code (< 2^62) is one int64 key, an invalid occurrence is
INT64_MAX, and torch.sort(stable=True) keeps equal codes in stream order:
one key at every k, with no special case.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SENTINEL", "SortedStream", "sorted_occurrence_stream"]

#: sort key of an invalid occurrence: after every code (codes are < 2^62)
SENTINEL = torch.iinfo(torch.int64).max


class SortedStream(NamedTuple):
    """The batch occurrence stream, sorted by (code, stream position)."""

    code: torch.Tensor      # int64 [N] sorted codes (SENTINEL = invalid)
    src: torch.Tensor       # int64 [N] stream position of each sorted slot
    valid: torch.Tensor     # bool  [N] not a sentinel
    boundary: torch.Tensor  # bool  [N] first occurrence of its code (head)
    rank: torch.Tensor      # int32 [N] 1-based rank within the code's run
    mult: torch.Tensor      # int32 [N] at heads: the code's occurrences in
                            #           the batch; elsewhere 0

    def unsort(self, values_sorted: torch.Tensor) -> torch.Tensor:
        """Per-sorted-slot values back in stream order."""
        out = torch.empty_like(values_sorted)
        out[self.src] = values_sorted
        return out


def sorted_occurrence_stream(code: torch.Tensor,
                             valid: torch.Tensor) -> SortedStream:
    """Sort a flat occurrence stream and derive its run structure.

    Args:
      code: int64 [N] k-mer codes in stream order.
      valid: bool [N]; invalid occurrences sort last and are excluded.
    """
    n = code.numel()
    key = torch.where(valid, code, SENTINEL)
    skey, src = torch.sort(key, stable=True)
    pos = torch.arange(n, device=code.device)
    svalid = skey != SENTINEL
    changed = torch.ones(n, dtype=torch.bool, device=code.device)
    changed[1:] = skey[1:] != skey[:-1]
    boundary = changed & svalid
    # each slot's run head, carried forward; the next run's head, carried
    # back, bounds the run
    head = torch.cummax(torch.where(changed, pos, 0), 0).values
    next_head = torch.where(changed, pos, n).flip(0).cummin(0).values.flip(0)
    after = torch.full_like(pos, n)
    after[:-1] = next_head[1:]
    rank = (pos - head + 1).to(torch.int32)
    mult = torch.where(boundary, after - head, 0).to(torch.int32)
    return SortedStream(code=skey, src=src, valid=svalid, boundary=boundary,
                        rank=rank, mult=mult)
