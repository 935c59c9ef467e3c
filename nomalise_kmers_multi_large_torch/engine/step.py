"""The per-batch device step: encode -> count -> classify.

Port of nomalise_kmers_multi_large_tpu/engine/step.py::BatchStep, for every
table, in exact and relaxed mode. The bucket tables, k <= 15:

  bases[R, L] --K1 encode--> keys[R, W] --sort (key, read id)--> K3 scan
      --K4 upsert--> high[R], with total[R] = valid windows --> keep[B]

k = 16..31 (BucketTableWide): K2 encode gives the sort words (w1, w2), the
sort runs on (w1, w2, read id), then K3w and K5; a window is valid iff
``w2 != -1``. Stride samples both words after the encode kernel.

``mode="relaxed"`` changes only the sort: the read id stops being a sort
key, so ranks among a batch's copies of one code reach reads in arbitrary
order. Table counts stay exact, and so does each code's multiset of
observed values.

The direct and hashed tables (the JAX step's unfused path, :226-261):

  bases --ops/codec.py--> int64 codes[R, W] + validity --stride--> stream
      --sort (ops/streamrank.py)--> count_and_update --unsort--> high[R, W]

There ``mode="relaxed"`` keeps ranks sequential only within a record (read
pair): the direct table skips the sort (relaxed_update: each occurrence
observes the pre-batch count plus its rank in its own record); the hashed
table still sorts to upsert, then an occurrence observes its code's pre-
batch count plus its record-local rank.

PyTorch runs eagerly, so there is nothing to compile; ``step_many`` is a
Python loop that carries the state through G batches, with the same results
as G calls of ``step``. The table planes are updated in place: the state
passed in is consumed (the JAX step donates it likewise).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.models.diginorm import (
    keep_mask_paired,
    keep_mask_single,
)
from nomalise_kmers_multi_large_torch.ops import codec
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    SENTINEL, encode_keys, encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.ops.streamrank import (
    sorted_occurrence_stream,
)
from nomalise_kmers_multi_large_torch.table.base import CountTable, TableState
from nomalise_kmers_multi_large_torch.table.bucket import BucketTable
from nomalise_kmers_multi_large_torch.table.direct import DirectTable

#: elements of one chunk of _relaxed_ranks' [records, m, m] comparison
#: (m windows a record): bounds its transient to 64 MiB of bools
_RANK_CHUNK = 1 << 26


class StepStats(NamedTuple):
    processed: torch.Tensor  # int32 [] valid records/pairs in this batch
    printed: torch.Tensor    # int32 []
    skipped: torch.Tensor    # int32 []


class ReadTallies(NamedTuple):
    high: torch.Tensor   # int32 [R] high-count windows per read
    total: torch.Tensor  # int32 [R] valid windows per read


def _on(x, device: torch.device) -> torch.Tensor:
    """A host numpy array or a tensor, as a tensor on `device`."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class BatchStep:
    """Batch functions of one table shard."""

    def __init__(self, table: CountTable, *, k: int, depth_per_shard: int,
                 coverage: float, canonical: bool, paired: bool,
                 mode: str = "exact", pair_rule: str = "and",
                 stride: int = 1):
        if mode not in ("exact", "relaxed"):
            raise ValueError(f"mode must be exact or relaxed, not {mode!r}")
        self.table = table
        self.device = table.device
        self.k = k
        self.depth = depth_per_shard
        self.coverage = coverage
        self.canonical = canonical
        self.paired = paired
        self.pair_rule = pair_rule
        self.relaxed = mode == "relaxed"
        #: window stride: 1 = every window; s > 1 samples every s-th window
        #: of the encoded keys (the same subset as the reference package)
        self.stride = stride

    def _upsert(self, state: TableState, bases, lengths, seed: bool):
        """Encode, stride-sample and count one batch on a bucket table.
        Returns (state', the table's BucketBatchOut, total int32 [R] valid
        windows per read)."""
        b, ln = _on(bases, self.device), _on(lengths, self.device)
        if self.table.wide:
            words = encode_keys_wide(b, ln, self.k, self.canonical)
        else:
            words = (encode_keys(b, ln, self.k, self.canonical),)
        if self.stride > 1:
            words = tuple(w[:, ::self.stride].contiguous() for w in words)
        if self.table.wide:
            state, out = self.table.process_batch_keys(
                state, *words, depth=self.depth, seed=seed,
                relaxed=self.relaxed)
        else:
            state, out = self.table.process_batch_mixed(
                state, *words, depth=self.depth, seed=seed,
                relaxed=self.relaxed)
        # the last word is the validity word: the key, or w2 on the wide path
        total = (words[-1] != SENTINEL).sum(1, dtype=torch.int32)
        return state, out, total

    # ------------------------------------------------------------------
    def step(self, state: TableState, bases, lengths, rec_valid):
        """One batch.

        Args:
          state: table shard state (consumed: its planes are updated).
          bases: uint8 [R, L] 2-bit base codes, rows in stream order
            (paired: fwd0, rev0, fwd1, rev1, ...).
          lengths: int32 [R]; 0 marks an invalid mate/read.
          rec_valid: bool [B] record validity.

        Returns (state', keep bool [B], StepStats, ReadTallies).
        """
        rec_valid = _on(rec_valid, self.device)
        if not isinstance(self.table, BucketTable):
            return self._step_stream(state, bases, lengths, rec_valid)
        state, out, total = self._upsert(state, bases, lengths, seed=False)
        return self._classify(state, out.high_per_read, total, rec_valid)

    # ------------------------------------------------------------------
    # the direct and hashed tables

    def _encode(self, bases, lengths, device=None):
        """int64 codes [R, W'] and their validity, stride-sampled, on
        `device` (default: the table's)."""
        device = device or self.device
        b, ln = _on(bases, device), _on(lengths, device)
        code = codec.window_codes(b, self.k, self.canonical)
        valid = codec.code_validity(ln, code, self.k)
        if self.stride > 1:
            code = code[:, ::self.stride].contiguous()
            valid = valid[:, ::self.stride].contiguous()
        return code, valid

    def _relaxed_ranks(self, code, valid):
        """Record-local ranks without a global sort: the rank of window i
        of a record (a read, or a pair with the forward mate's windows
        first) is the number of valid windows j <= i of the record with its
        code. Exact for duplicates inside a record; copies in other records
        of the batch are not ranked against it. The [records, m, m]
        comparison runs in chunks of records (_RANK_CHUNK)."""
        R, W = code.shape
        rpr = 2 if self.paired else 1
        m = rpr * W
        c, v = code.reshape(R // rpr, m), valid.reshape(R // rpr, m)
        tri = torch.ones((m, m), dtype=torch.bool,
                         device=code.device).tril()
        rank = torch.empty(c.shape, dtype=torch.int32, device=code.device)
        step = max(1, _RANK_CHUNK // (m * m))
        for r0 in range(0, c.shape[0], step):
            cc, vv = c[r0:r0 + step], v[r0:r0 + step]
            eq = (cc[:, :, None] == cc[:, None, :]) & vv[:, None, :] & tri
            rank[r0:r0 + step] = eq.sum(2, dtype=torch.int32)
        return rank.reshape(R, W)

    def _step_stream(self, state, bases, lengths, rec_valid):
        code, valid = self._encode(bases, lengths)
        R, W = code.shape
        if self.relaxed and isinstance(self.table, DirectTable):
            state, prior = self.table.relaxed_update(
                state, code.reshape(-1), valid.reshape(-1))
            observed = prior.reshape(R, W) + self._relaxed_ranks(code, valid)
            high = (observed >= self.depth) & valid
        else:
            stream = sorted_occurrence_stream(code.reshape(-1),
                                              valid.reshape(-1))
            state, observed = self.table.count_and_update(state, stream)
            if self.relaxed:
                local = self._relaxed_ranks(code, valid).reshape(-1)
                observed = observed - stream.rank + local[stream.src]
            high = stream.unsort((observed >= self.depth) & stream.valid)
            high = high.reshape(R, W)
        total = valid.sum(1, dtype=torch.int32)
        high_per_read = (high & valid).sum(1, dtype=torch.int32)
        return self._classify(state, high_per_read, total, rec_valid)

    def _classify(self, state, high_per_read, total_per_read, rec_valid):
        """Keep/skip decision + batch stats from per-read window tallies."""
        if self.paired:
            keep = keep_mask_paired(
                high_per_read[0::2], total_per_read[0::2],
                high_per_read[1::2], total_per_read[1::2],
                self.coverage, self.pair_rule,
            )
        else:
            keep = keep_mask_single(high_per_read, total_per_read,
                                    self.coverage)
        keep = keep & rec_valid
        nvalid = rec_valid.sum(dtype=torch.int32)
        nprint = keep.sum(dtype=torch.int32)
        stats = StepStats(processed=nvalid, printed=nprint,
                          skipped=nvalid - nprint)
        return state, keep, stats, ReadTallies(high=high_per_read,
                                               total=total_per_read)

    def step_many(self, state: TableState, bases, lengths, rec_valid):
        """G batches in sequence (leading axis G on every operand), each
        seeing the previous one's counts. Returns (state', keep [G, B],
        StepStats of [G], ReadTallies of [G, R])."""
        keeps, stats, tallies = [], [], []
        for b, ln, rv in zip(bases, lengths, rec_valid):
            state, keep, st, ta = self.step(state, b, ln, rv)
            keeps.append(keep)
            stats.append(st)
            tallies.append(ta)
        return (state, torch.stack(keeps),
                StepStats(*(torch.stack(x) for x in zip(*stats))),
                ReadTallies(*(torch.stack(x) for x in zip(*tallies))))

    def seed_step(self, state: TableState, bases, lengths) -> TableState:
        """Seeding: insert k-mers with count 0. The host pre-filters records
        to the reference's len > k rule by zeroing their lengths."""
        if isinstance(self.table, BucketTable):
            return self._upsert(state, bases, lengths, seed=True)[0]
        code, valid = self._encode(bases, lengths)
        stream = sorted_occurrence_stream(code.reshape(-1), valid.reshape(-1))
        return self.table.count_and_update(state, stream, seed=True)[0]
