"""The streaming engine over several devices.

Port of nomalise_kmers_multi_large_tpu/parallel/engine.py::MeshNormalizer:
the one-device Normalizer's streaming loop (staging, --dispatch-group,
growth, grow-and-replay, checkpoints, -P dumps, the debug tiers), with the
shards placed on a list of devices (parallel/mesh.py):

- Mode A (``--sharding local``, the default): one table per device, each a
  copy of the seeded table; every batch is cut into D contiguous record
  slices, slice d going to device d, whose shard writes thread-d files and
  sees depth // D (``norm{depth // D}`` in the names). A shard is a shard
  of the one-device engine: it grows, and replays a dispatch that dropped
  inserts, on its own (the JAX mesh engines skip grow-and-replay, so a full
  row loses inserts there; the port does not copy that).
- Mode B (``--sharding global``): one exact table sharded over the devices
  (parallel/modes.py: the bucket table by row range, the direct table by
  code range, the hashed table by the top bits of the slot hash), thread-0
  files, full depth, decisions equal to a one-device run's. It grows as one
  table (every shard doubles), gated on the whole table's occupancy, and
  replays as the one-device engine does: the hashed table too, which the
  JAX package starts at --memory_start and lets saturate there. The direct
  table neither grows nor replays, and keeps its seeds on the host.

Checkpoints keep the JAX package's layouts: D shard states in Mode A, one
whole-table state in Mode B (the row or code ranges concatenated; the
hashed shards inserted into one table of the whole capacity), which the
one-device engines of both packages resume, and the reverse.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys

from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import (
    Normalizer, _slice_batch,
)
from nomalise_kmers_multi_large_torch.parallel.mesh import data_devices
from nomalise_kmers_multi_large_torch.parallel.modes import (
    ModeAStep, ModeBBucketStep, ModeBStreamStep, mode_b_table,
)


class MeshNormalizer(Normalizer):
    def __init__(self, cfg: Config, devices):
        self.devices = list(devices)
        n = len(self.devices)
        self.mode_b = cfg.sharding == "global"
        if self.mode_b:
            # the device count and the table are checked by the Mode B
            # table (mode_b_table), the batch's read rows by Config
            eff = dataclasses.replace(cfg, shards=1)
        else:
            # the reference's -p sets depth per thread and the output
            # names; a --cpu that disagrees with the device count is said
            if cfg.shards not in (1, n):
                print(
                    f"NOTE: --cpu {cfg.shards} overridden to the device "
                    f"count ({n}): mesh shards map 1:1 onto devices "
                    f"(depth/shard and output names follow the device "
                    f"count)", file=sys.stderr)
            eff = dataclasses.replace(cfg, shards=n)
        self._mode_a = ModeAStep(self.devices)
        super().__init__(eff, self.devices[0])
        if self.mode_b:
            self.step_class = (ModeBBucketStep if self.tables[0].bucket
                               else ModeBStreamStep)

    def _shard_tables(self, t0) -> list:
        if self.mode_b:
            return [mode_b_table(t0, self.devices)]
        return self._mode_a.tables(t0)

    def _deal(self, rr: int, batch, bases, lengths, rec_valid) -> list:
        """Mode A: slice d of the batch to device d's shard; Mode B: the
        whole batch to its one shard."""
        if self.mode_b:
            return [(0, (batch, bases, lengths, rec_valid))]
        rpr = 2 if batch.rev is not None else 1
        return [(d, (_slice_batch(batch, lo, hi), bases[lo * rpr:hi * rpr],
                     lengths[lo * rpr:hi * rpr], rec_valid[lo:hi]))
                for d, (lo, hi) in enumerate(self._mode_a.cut(len(batch)))]

    def _retire_flush(self, entries: list, paired: bool) -> int:
        """Mode A retires as the JAX mesh engine does: batch by batch, every
        shard's slice of batch g of a --dispatch-group before batch g + 1,
        so the --debug lines come in its order."""
        if self.mode_b:
            return super()._retire_flush(entries, paired)
        parts = [self._checked(e, paired) for e in entries]
        return sum(self._retire(*part)
                   for batch in itertools.zip_longest(*parts)
                   for part in batch if part is not None)

    # -- states in the checkpoint layouts --------------------------------
    def _install_resumed_states(self, states: list):
        if not self.mode_b:
            self.states = self._mode_a.place(states)
            return
        self.tables = [self.tables[0].for_whole(states[0])]
        self.states = [self.tables[0].split(states[0])]

    def _states_for_checkpoint(self) -> list:
        if self.mode_b:
            # the hashed table's gather inserts on the first device (its
            # kernel), one shard at a time; the checkpoint copies to host
            return [self.tables[0].gather(self.states[0], self.devices[0])]
        return self.states


def make_normalizer(cfg: Config, device="cuda") -> Normalizer:
    """The engine of a run on cfg.n_devices devices of `device`'s type
    (0: every local one): the one-device Normalizer on one device, else a
    MeshNormalizer."""
    devices = data_devices(cfg.n_devices, device)
    if len(devices) > 1:
        return MeshNormalizer(cfg, devices)
    return Normalizer(cfg, devices[0])
