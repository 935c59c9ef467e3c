"""Multi-device steps: Mode A (a table per device) and Mode B (one exact
table sharded over the devices) on every table.

Port of nomalise_kmers_multi_large_tpu/parallel/modes.py::ModeAStep,
::ModeBBucketStep and ::ModeBStep. One process drives every device
(parallel/mesh.py); a device here is a torch.device, and a list may repeat
one.

Mode A: each device holds its own table, a copy of the seeded one; each
batch is cut into D contiguous record slices and slice d runs the one-device
step on device d's table at depth // D, the reference's independent threads
(README.md:68). The engine (parallel/engine.py) dispatches and retires each
slice as a shard of its own, so a table that overflows grows and replays
alone.

Mode B on the bucket table: ONE exact bucket table whose rows are cut into D
equal ranges, range d on device d (RowShardedBucketTable). A code's owner is
the top log2 D bits of its key (k <= 15) or of w1 (k = 16..31), so a row
shard is a bucket table of its own over keys rebased by d * span, with the
whole table's fingerprint width, and a doubling (row r -> 2r + b) never
moves a code to another shard. Per batch (ModeBBucketStep), on each device:

  1. K1/K2 encode its contiguous slice of reads, read ids global;
  2. a local sort on (key, read id), cut by owner (searchsorted);
  3. the exchange: the D x D segment lengths are read on the host, once a
     batch, and each segment is copied whole to its owner (device-to-device;
     nothing goes through the host); no bin has a fixed size, so no routed
     window is ever dropped, whatever the skew;
  4. the owner rebases the keys to its rows and sorts the D pieces (the
     read id an explicit payload on the wide path: the pieces arrive in
     sender order, each sorted by read id, so a stable sort keeps each
     code's copies in read-id order);
  5. K3/K3w and K4/K5 on its row shard, with global read ids;
  6. the per-read high tallies are summed over the devices and the batch
     is classified, on the first device.

Mode B on the direct and hashed tables: the JAX package shards the slot
axis and lets GSPMD partition the gather, the scatter and the hashed probe
loop. A slot range of a hashed table cannot be probed shard by shard (a
triangular probe sequence crosses range boundaries), so the port shards by
owner instead, as on the bucket table:

- RangeShardedDirectTable: shard d counts the codes of [d * span, (d + 1) *
  span), span = 4^k / D, indexed by the rebased code (the JAX layout:
  gather is a concatenation, split a cut); owner = code >> (2k - log2 D);
- SlotShardedHashedTable: shard d is a hashed table of C / D slots on
  device d holding the codes whose 32-bit slot hash has d in its top log2 D
  bits; the hashed kernel probes it unchanged, on the hash's low bits,
  which are disjoint from the owner bits for any C <= 2^32, and a doubling
  doubles every shard without moving a code. The whole table's layout is
  not JAX's, so gather and split re-insert codes through the kernel.

Per batch (ModeBStreamStep), on each device: the codec encodes its slice
of records (relaxed mode: record-local ranks there, since no record spans
two devices), a stable sort on the owner cuts the valid windows by owner in
stream order, the D x D lengths come to the host once, and each segment
(code, global stream position, local rank) is copied whole to its owner.
The owner concatenates the pieces in sender order, which is global stream
order, and runs the one-device stream path on its shard; the high flags go
back to their reads by ``position // W'``.

Either way, every occurrence sees its code's count before the batch plus its
rank in the whole batch's order, so decisions and the table equal a
one-device exact run at full depth, byte for byte.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.config import ConfigError
from nomalise_kmers_multi_large_torch.engine.step import (
    BatchStep, ReadTallies, _on,
)
from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    _RID_BITS, _SORT_SENTINEL as _INT64_MAX, _W2_BITS, MAX_READS,
    bucket_upsert, bucket_upsert_wide, sort_stream, sort_stream_wide,
)
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    SENTINEL, as_int32, encode_keys, encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
    hashed_insert, slot_hash,
)
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
from nomalise_kmers_multi_large_torch.ops.streamrank import (
    sorted_occurrence_stream,
)
from nomalise_kmers_multi_large_torch.table.base import CountTable, TableState
from nomalise_kmers_multi_large_torch.table.bucket import (
    BucketTable, _split_rows,
)
from nomalise_kmers_multi_large_torch.table.direct import DirectTable
from nomalise_kmers_multi_large_torch.table.hashed import (
    MAX_CAPACITY, HashedTable,
)

_MASK32 = 0xFFFFFFFF
#: the smallest row shard: default_rows' floor (k <= 15) and the wide
#: table's smallest size (k = 16..31)
MIN_SHARD_ROWS = {False: 128, True: 512}


class ModeAStep:
    """Mode A's placement: one table descriptor per device, and each batch
    cut into contiguous record slices, slice d for device d (the JAX
    package pads the batch to a multiple of D with empty records, which
    count nothing; the port drops the empty tail)."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.n = len(self.devices)

    def tables(self, t0: CountTable) -> list:
        return [t0.on(d) for d in self.devices]

    def cut(self, n_records: int) -> list[tuple[int, int]]:
        """[(lo, hi)] of the non-empty slices, in device order: slice d is
        records [d * per, (d + 1) * per), per = ceil(n / D)."""
        per = max(1, -(-n_records // self.n))
        return [(lo, min(lo + per, n_records))
                for lo in range(0, n_records, per)]

    def place(self, states: list) -> list:
        """Per-shard states (from a checkpoint) onto their devices."""
        return [TableState(*(None if x is None else x.to(d) for x in st))
                for st, d in zip(states, self.devices)]


# ----------------------------------------------------------------------
# Mode B

def _mode_b_devices(devices, table: str) -> list[torch.device]:
    """The devices of a Mode B table; their count must be a power of two
    (the owner is a code's top log2 D bits)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n < 1 or n & (n - 1):
        raise ConfigError(f"--sharding global --table {table} needs a "
                          f"power-of-two device count, got {n}")
    return devices


def _scalar(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


class RowShardedBucketTable(CountTable):
    """The bucket table of a Mode B run: the whole table `whole` (a
    BucketTable or BucketTableWide) with its rows cut into D equal ranges,
    range d on devices[d].

    State: a TableState whose counts, keys and keys2 (None where the whole
    table has no plane B) are tuples of D row shards, and whose used and
    overflow count the whole table, on devices[0]. ``gather`` and
    ``split`` convert from and to a whole table's state (checkpoints, -P
    dumps, --spectrum)."""

    bucket = True

    def __init__(self, whole: BucketTable, devices):
        devices = _mode_b_devices(devices, "bucket")
        n = len(devices)
        floor = MIN_SHARD_ROWS[whole.wide]
        if whole.rows % n or whole.rows // n < floor:
            raise ConfigError(
                f"global bucket table rows ({whole.rows}) must split into "
                f">= {floor}-row shards across {n} devices; raise "
                "--memory_start")
        self.whole = whole.on(devices[0])
        self.devices = devices
        self.device = devices[0]
        self.k, self.wide, self.lanes = whole.k, whole.wide, whole.lanes

    @property
    def rows(self) -> int:
        return self.whole.rows

    @property
    def shard_rows(self) -> int:
        return self.whole.rows // len(self.devices)

    @property
    def shift(self) -> int:
        """Key bits below the row: the whole table's fingerprint width."""
        return self.whole.row_shift if self.wide else self.whole.fp_bits

    @property
    def span(self) -> int:
        """Keys (w1 on the wide table) per row shard: shard d owns
        [d * span, (d + 1) * span)."""
        return self.shard_rows << self.shift

    @property
    def capacity(self) -> int:
        return self.whole.capacity

    @property
    def grow_headroom(self) -> float:
        return self.whole.grow_headroom

    @property
    def can_grow(self) -> bool:
        return self.whole.can_grow

    def _has_b(self) -> bool:
        return self.wide and self.whole.has_plane_b

    def init(self) -> TableState:
        def planes():
            return tuple(torch.zeros((self.shard_rows, self.lanes),
                                     dtype=torch.int32, device=d)
                         for d in self.devices)

        return TableState(counts=planes(), keys=planes(),
                          used=_scalar(self.device),
                          overflow=_scalar(self.device),
                          keys2=planes() if self._has_b() else None)

    def with_rows(self, rows: int) -> "RowShardedBucketTable":
        whole = type(self.whole)(self.k, rows=rows, lanes=self.lanes,
                                 device=self.device)
        return RowShardedBucketTable(whole, self.devices)

    def grown(self, state: TableState):
        """Double the rows: each row shard splits on its own (row r ->
        2r + top fingerprint bit stays in the owner's range), with the
        whole table's fingerprint width."""
        if not self.can_grow or (not self.wide and self.shift < 2):
            raise ValueError("table already at its largest size")
        parts = [_split_rows(state.keys[d], state.counts[d], self.shift,
                             state.keys2[d] if state.keys2 else None)
                 for d in range(len(self.devices))]
        return self.with_rows(2 * self.rows), TableState(
            counts=tuple(p[1] for p in parts),
            keys=tuple(p[0] for p in parts), used=state.used,
            overflow=state.overflow,
            keys2=tuple(p[2] for p in parts) if state.keys2 else None)

    def for_state(self, state: TableState) -> "RowShardedBucketTable":
        rows = sum(int(k.shape[0]) for k in state.keys)
        return self if rows == self.rows else self.with_rows(rows)

    def for_whole(self, state: TableState) -> "RowShardedBucketTable":
        """A descriptor of this kind that fits a whole table's state."""
        rows = int(state.keys.shape[0])
        return self if rows == self.rows else self.with_rows(rows)

    def used_count(self, state: TableState, seeded_lo=None) -> int:
        return sum(int((k != 0).sum()) for k in state.keys)

    def gather(self, state: TableState, device) -> TableState:
        """The whole table's state on `device`: the row shards in order."""
        def cat(x):
            return None if x is None else torch.cat([p.to(device) for p in x])

        return TableState(counts=cat(state.counts), keys=cat(state.keys),
                          used=state.used.to(device),
                          overflow=state.overflow.to(device),
                          keys2=cat(state.keys2))

    def split(self, state: TableState) -> TableState:
        """A whole table's state (of this table's rows) cut into row
        shards on the devices."""
        def cut(x):
            if x is None:
                return None
            return tuple(x[d * self.shard_rows:(d + 1) * self.shard_rows]
                         .to(dev, copy=True).contiguous()
                         for d, dev in enumerate(self.devices))

        return TableState(counts=cut(state.counts), keys=cut(state.keys),
                          used=state.used.to(self.device),
                          overflow=state.overflow.to(self.device),
                          keys2=cut(state.keys2))

    def export(self, state: TableState, seeded_lo=None):
        return self.whole.export(self.gather(state, "cpu"))


class _DirectShard(DirectTable):
    """One code range of a RangeShardedDirectTable: the counts of `span`
    codes, indexed by the code rebased to the range."""

    def __init__(self, k: int, span: int, device):
        super().__init__(k, device)
        self._span = span

    @property
    def capacity(self) -> int:
        return self._span


class RangeShardedDirectTable(CountTable):
    """The direct table of a Mode B run: the 4^k counts cut into D equal
    code ranges, range d (span codes from d * span) on devices[d], the JAX
    package's slot sharding.

    State: a TableState whose counts are a tuple of D count arrays over the
    rebased codes, keys None, and used and overflow (never changed: the
    table neither grows nor drops) on devices[0]. The seeds stay on the
    host (``seeded_lo``), as on one device."""

    seeds_on_host = True

    def __init__(self, whole: DirectTable, devices):
        devices = _mode_b_devices(devices, "direct")
        self.k = whole.k
        self.devices, self.device = devices, devices[0]
        self.span = whole.capacity // len(devices)
        self.shards = [_DirectShard(self.k, self.span, d) for d in devices]
        self._shift = self.span.bit_length() - 1   # log2 span

    @property
    def capacity(self) -> int:
        return self.span * len(self.devices)

    def owner(self, code: torch.Tensor) -> torch.Tensor:
        return code >> self._shift

    def rebase(self, code: torch.Tensor, j: int) -> torch.Tensor:
        return code - j * self.span

    def init(self) -> TableState:
        return TableState(counts=tuple(s.init().counts for s in self.shards),
                          keys=None, used=_scalar(self.device),
                          overflow=_scalar(self.device))

    def shard_state(self, state: TableState, j: int) -> TableState:
        """Shard j's counts, with used and overflow counting from 0."""
        dev = self.devices[j]
        return TableState(counts=state.counts[j], keys=None,
                          used=_scalar(dev), overflow=_scalar(dev))

    def for_whole(self, state: TableState) -> "RangeShardedDirectTable":
        return self

    def _parts(self, state: TableState, seeded_lo):
        """(shard, its state, its seeds rebased or None), shard by shard."""
        seeds = None if seeded_lo is None else seeded_lo.astype(np.int64)
        for j, shard in enumerate(self.shards):
            mine = None if seeds is None else \
                seeds[(seeds >> self._shift) == j] - j * self.span
            yield shard, self.shard_state(state, j), mine

    def used_count(self, state: TableState, seeded_lo=None) -> int:
        return sum(shard.used_count(st, seeds)
                   for shard, st, seeds in self._parts(state, seeded_lo))

    def export(self, state: TableState, seeded_lo=None):
        """The shards' exports, each in code order, one range after
        another: in code order."""
        parts = [shard.export(st, seeds)
                 for shard, st, seeds in self._parts(state, seeded_lo)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] + np.uint32(j * self.span)
                                for j, p in enumerate(parts)]),
                np.concatenate([p[2] for p in parts]))

    def gather(self, state: TableState, device) -> TableState:
        """The whole table's state on `device`: the ranges in order."""
        return TableState(
            counts=torch.cat([c.to(device) for c in state.counts]),
            keys=None, used=state.used.to(device),
            overflow=state.overflow.to(device))

    def split(self, state: TableState) -> TableState:
        """A whole table's state cut into the ranges on the devices."""
        return TableState(
            counts=tuple(state.counts[j * self.span:(j + 1) * self.span]
                         .to(d, copy=True).contiguous()
                         for j, d in enumerate(self.devices)),
            keys=None, used=state.used.to(self.device),
            overflow=state.overflow.to(self.device))


class SlotShardedHashedTable(CountTable):
    """The hashed table of a Mode B run: C slots in all, as D hashed tables
    of C / D slots, shard d on devices[d] holding the codes whose 32-bit
    slot hash has d in its top log2 D bits.

    State: a TableState whose counts and keys are tuples of D shard planes,
    and whose used and overflow count the whole table, on devices[0]. It
    grows as one table (every shard doubles on its own, and no code
    changes owner); ``gather`` and ``split`` convert from and to a
    one-device hashed table's state through the hashed kernel."""

    grow_headroom = HashedTable.grow_headroom

    def __init__(self, whole: HashedTable, devices):
        devices = _mode_b_devices(devices, "hashed")
        n = len(devices)
        if whole.capacity < 2 * n:
            raise ConfigError(
                f"global hashed table slots ({whole.capacity}) must split "
                f"into >= 2-slot shards across {n} devices; raise "
                "--memory_start")
        self.k = whole.k
        self.devices, self.device = devices, devices[0]
        self._capacity = whole.capacity
        self.shards = [HashedTable(self.k, whole.capacity // n, device=d)
                       for d in devices]
        self._shift = 33 - n.bit_length()   # 32 - log2 D

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def can_grow(self) -> bool:
        return self._capacity < MAX_CAPACITY

    def owner(self, code: torch.Tensor) -> torch.Tensor:
        return slot_hash(code) >> self._shift

    def rebase(self, code: torch.Tensor, j: int) -> torch.Tensor:
        return code

    def with_capacity(self, capacity: int) -> "SlotShardedHashedTable":
        return SlotShardedHashedTable(HashedTable(self.k, capacity),
                                      self.devices)

    def init(self) -> TableState:
        parts = [s.init() for s in self.shards]
        return TableState(counts=tuple(p.counts for p in parts),
                          keys=tuple(p.keys for p in parts),
                          used=_scalar(self.device),
                          overflow=_scalar(self.device))

    def shard_state(self, state: TableState, j: int) -> TableState:
        """Shard j's planes, with used and overflow counting from 0."""
        dev = self.devices[j]
        return TableState(counts=state.counts[j], keys=state.keys[j],
                          used=_scalar(dev), overflow=_scalar(dev))

    def grown(self, state: TableState):
        """Twice the slots: every shard grown on its own by the hashed
        kernel; `overflow` is kept."""
        if not self.can_grow:
            raise ValueError(f"hashed table already at {MAX_CAPACITY} slots")
        parts = [shard.grown(self.shard_state(state, j))[1]
                 for j, shard in enumerate(self.shards)]
        return self.with_capacity(2 * self._capacity), TableState(
            counts=tuple(p.counts for p in parts),
            keys=tuple(p.keys for p in parts),
            used=sum(p.used.to(self.device) for p in parts),
            overflow=state.overflow
            + sum(p.overflow.to(self.device) for p in parts))

    def for_state(self, state: TableState) -> "SlotShardedHashedTable":
        c = sum(int(k.shape[0]) for k in state.keys)
        return self if c == self._capacity else self.with_capacity(c)

    def for_whole(self, state: TableState) -> "SlotShardedHashedTable":
        c = int(state.keys.shape[0])
        return self if c == self._capacity else self.with_capacity(c)

    def used_count(self, state: TableState, seeded_lo=None) -> int:
        return int(state.used)

    def export(self, state: TableState, seeded_lo=None):
        parts = [shard.export(self.shard_state(state, j))
                 for j, shard in enumerate(self.shards)]
        hi, lo, counts = (np.concatenate(x) for x in zip(*parts))
        order = np.lexsort((lo, hi))
        return hi[order], lo[order], counts[order]

    def gather(self, state: TableState, device) -> TableState:
        """The whole table's state on `device`: a fresh table of C slots
        into which the hashed kernel (its plain version on the CPU)
        inserts every shard's (code, count), one shard at a time, as
        HashedTable.grown does. A one-device hashed table's state; its
        slots are placed anew."""
        st = HashedTable(self.k, self._capacity, device=device).init()
        stats = torch.zeros(3, dtype=torch.int64, device=device)
        for keys, counts in zip(state.keys, state.counts):
            occ = torch.nonzero(keys).squeeze(1)
            stats += hashed_insert(st.keys, keys[occ].to(device),
                                   counts[occ].to(device), st.counts,
                                   outputs=False).stats
        stats = stats.to(torch.int32)
        return st._replace(used=stats[0],
                           overflow=state.overflow.to(device) + stats[1])

    def split(self, state: TableState) -> TableState:
        """A whole hashed table's state (of this table's capacity) as shard
        states: each owner's codes inserted into its shard with their
        counts."""
        occ = torch.nonzero(state.keys).squeeze(1)
        code, counts = state.keys[occ], state.counts[occ]
        owner = self.owner(code)
        out = self.init()
        stats = torch.zeros(3, dtype=torch.int64, device=self.device)
        for j, dev in enumerate(self.devices):
            mine = owner == j
            stats += hashed_insert(out.keys[j], code[mine].to(dev),
                                   counts[mine].to(dev), out.counts[j],
                                   outputs=False).stats.to(self.device)
        stats = stats.to(torch.int32)
        return out._replace(used=stats[0], overflow=state.overflow.to(
            self.device) + stats[1])


def mode_b_table(t0: CountTable, devices) -> CountTable:
    """The Mode B descriptor of a one-device table `t0` on `devices`."""
    if t0.bucket:
        return RowShardedBucketTable(t0, devices)
    if isinstance(t0, DirectTable):
        return RangeShardedDirectTable(t0, devices)
    return SlotShardedHashedTable(t0, devices)


def owner_edges_narrow(key: torch.Tensor, rid: torch.Tensor, n_shards: int,
                       span: int):
    """A sender's half of the exchange, k <= 15: its stream sorted on one
    packed int64 ``(key << 14) | read id`` and the edges of each owner's
    segment in it, int64 [D + 1] (owner j: [edges[j], edges[j + 1]));
    sentinels (key 0xFFFFFFFF, above every real key < 4^k) lie past
    edges[D]. `key` int32 [N], `rid` int64 [N] global read ids."""
    packed = torch.sort(((key.to(torch.int64) & _MASK32) << _RID_BITS)
                        | rid).values
    bounds = torch.arange(n_shards + 1, dtype=torch.int64,
                          device=key.device) * span << _RID_BITS
    return packed, torch.searchsorted(packed, bounds)


def owner_edges_wide(w1: torch.Tensor, w2: torch.Tensor, rid: torch.Tensor,
                     n_shards: int, span: int):
    """The same on the wide path: (sk1, sk2, srid) int32, the stream sorted
    stably on (w1, w2) with the read ids as payload, so on (w1, w2, read
    id) for a read-major stream, and the owner edges by w1. Validity is
    w2 != 0xFFFFFFFF (a real w1 may be 0xFFFFFFFF, and belongs to the last
    shard), so the edges are found on the sort key ``(w1 << 30) | w2``
    with the sentinels at INT64_MAX, past every real key."""
    sk1, sk2, srid = sort_stream_wide(w1, w2, 1, rid_flat=rid)
    key = torch.where(sk2 == SENTINEL, _INT64_MAX,
                      ((sk1.to(torch.int64) & _MASK32) << _W2_BITS)
                      | sk2.to(torch.int64))
    bounds = torch.arange(n_shards + 1, dtype=torch.int64,
                          device=w1.device) * span << _W2_BITS
    bounds[-1] = _INT64_MAX
    return (sk1, sk2, srid), torch.searchsorted(key, bounds)


class _ModeBStep(BatchStep):
    """BatchStep's interface (step, step_many, seed_step) over a Mode B
    table; a subclass routes and counts one batch (_routed_upsert)."""

    def _routed_upsert(self, state: TableState, bases, lengths, seed: bool):
        """Encode, route and count one batch. Returns (state', high int32
        [R'], total int32 [R']) on the first device, R' the rows padded to
        a multiple of D records."""
        raise NotImplementedError

    def _rows_per_device(self, rows: int) -> int:
        """Rows of each device's contiguous slice: whole records, the batch
        padded to a multiple of D records."""
        rpr = 2 if self.paired else 1
        n = len(self.table.devices)
        return -(-rows // (rpr * n)) * rpr

    def step(self, state: TableState, bases, lengths, rec_valid):
        """As BatchStep.step: (state', keep bool [B], StepStats,
        ReadTallies), on the first device."""
        n_rec, rows = rec_valid.shape[0], bases.shape[0]
        state, high, total = self._routed_upsert(state, bases, lengths,
                                                 seed=False)
        pad = high.shape[0] // (2 if self.paired else 1) - n_rec
        rv = torch.cat([_on(rec_valid, self.device),
                        torch.zeros(pad, dtype=torch.bool,
                                    device=self.device)])
        state, keep, stats, tallies = self._classify(state, high, total, rv)
        return state, keep[:n_rec], stats, ReadTallies(
            high=tallies.high[:rows], total=tallies.total[:rows])

    def seed_step(self, state: TableState, bases, lengths) -> TableState:
        return self._routed_upsert(state, bases, lengths, seed=True)[0]


class ModeBBucketStep(_ModeBStep):
    """The Mode B step over a RowShardedBucketTable (the module
    docstring's steps 1-6). The batch must hold at most MAX_READS reads
    (rows) once padded to a multiple of D records (the scan kernel refuses
    more); stride 1 only."""

    def __init__(self, table: RowShardedBucketTable, **kw):
        super().__init__(table, **kw)
        if self.stride != 1:
            raise ValueError("Mode B routes every window: stride must be 1")

    def _routed_upsert(self, state: TableState, bases, lengths, seed: bool):
        t: RowShardedBucketTable = self.table
        devs, n = t.devices, len(t.devices)
        per = self._rows_per_device(bases.shape[0])
        n_reads = per * n
        sent, totals = [], []
        for d, dev in enumerate(devs):
            b = _padded_rows(bases, d * per, (d + 1) * per, dev)
            ln = _padded_rows(lengths, d * per, (d + 1) * per, dev)
            rid = d * per + torch.arange(per, device=dev).repeat_interleave(
                b.shape[1] - self.k + 1)
            if t.wide:
                w1, w2 = encode_keys_wide(b, ln, self.k, self.canonical)
                totals.append((w2 != SENTINEL).sum(1, dtype=torch.int32))
                sent.append(owner_edges_wide(w1.reshape(-1), w2.reshape(-1),
                                             rid, n, t.span))
            else:
                key = encode_keys(b, ln, self.k, self.canonical)
                totals.append((key != SENTINEL).sum(1, dtype=torch.int32))
                sent.append(owner_edges_narrow(key.reshape(-1), rid, n,
                                               t.span))
        # the D x D segment lengths: the exchange's one host read a batch
        edges = [e.cpu().tolist() for _, e in sent]
        highs, inserted, dropped = [], [], []
        for j, dev in enumerate(devs):
            def piece(x, d):
                return x[edges[d][j]:edges[d][j + 1]].to(dev)

            base = j * t.span
            if t.wide:
                sk1, sk2, srid = (torch.cat([piece(s[0][i], d)
                                             for d, s in enumerate(sent)])
                                  for i in range(3))
                words = (as_int32((sk1.to(torch.int64) & _MASK32) - base),
                         sk2)
            else:
                recv = torch.cat([piece(s[0], d) for d, s in enumerate(sent)])
                words = (as_int32((recv >> _RID_BITS) - base),)
                srid = recv & (MAX_READS - 1)
            high, stats = self._count_shard(state, j, words, srid, n_reads,
                                            seed)
            highs.append(high.to(devs[0]))
            dropped.append(stats[0].to(devs[0]))
            inserted.append(stats[1].to(devs[0]))
        state = state._replace(used=state.used + sum(inserted),
                               overflow=state.overflow + sum(dropped))
        total = torch.cat([x.to(devs[0]) for x in totals])
        return state, sum(highs), total

    def _count_shard(self, state: TableState, j: int, words, rid, n_reads,
                     seed: bool):
        """Sort, scan and upsert row shard j's received stream (rebased
        keys, global read ids). Returns (high int32 [n_reads], stats
        int32 [2] = (dropped, inserted))."""
        t: RowShardedBucketTable = self.table
        fp, counts = state.keys[j], state.counts[j]
        if words[0].numel() == 0:
            z = torch.zeros(n_reads + 2, dtype=torch.int32, device=fp.device)
            return z[:n_reads], z[n_reads:]
        kw = dict(depth=self.depth, seed=seed, n_reads=n_reads)
        if t.wide:
            sk1, sk2, srid = sort_stream_wide(*words, 1, self.relaxed,
                                              rid_flat=rid)
            p2, p3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=n_reads,
                                    skey2=sk2, row_shift=t.shift)
            fpb = state.keys2[j] if state.keys2 else None
            return bucket_upsert_wide(fp, fpb, counts, sk1, sk2, p2, p3,
                                      row_shift=t.shift, **kw)
        skey, srid = sort_stream(words[0], rid, self.relaxed)
        p2, p3 = rank_cand_scan(skey, srid, fp_bits=t.shift, n_reads=n_reads)
        return bucket_upsert(fp, counts, skey, p2, p3, fp_bits=t.shift, **kw)


class ModeBStreamStep(_ModeBStep):
    """The Mode B step over a RangeShardedDirectTable or a
    SlotShardedHashedTable (the module docstring's stream path): stride,
    relaxed mode, paired and single reads, canonical k-mers."""

    def _routed_upsert(self, state: TableState, bases, lengths, seed: bool):
        t = self.table
        devs, n = t.devices, len(t.devices)
        per = self._rows_per_device(bases.shape[0])
        sent, counts, totals = [], [], []
        for d, dev in enumerate(devs):
            code, valid = self._encode(
                _padded_rows(bases, d * per, (d + 1) * per, dev),
                _padded_rows(lengths, d * per, (d + 1) * per, dev), dev)
            w = code.shape[1]
            totals.append(valid.sum(1, dtype=torch.int32))
            # a stable sort on the owner (D for an invalid window, last)
            # cuts the slice by owner, each segment in stream order; the
            # sort's indices are the windows' positions in the slice
            flat = valid.reshape(-1)
            owner = torch.where(flat, t.owner(code.reshape(-1)), n)
            order = torch.sort(owner, stable=True).indices
            payload = [code.reshape(-1)[order], order + d * per * w]
            if self.relaxed and not seed:
                payload.append(
                    self._relaxed_ranks(code, valid).reshape(-1)[order])
            sent.append(payload)
            counts.append(torch.bincount(owner, minlength=n + 1)[:n])
        # the D x D segment lengths: the exchange's one host read a batch
        lens = torch.stack([c.to(devs[0]) for c in counts]).cpu().tolist()
        edges = [[0, *itertools.accumulate(row)] for row in lens]
        highs, used, over = [], [], []
        for j, dev in enumerate(devs):
            recv = [torch.cat([x[edges[d][j]:edges[d][j + 1]].to(dev)
                               for d, x in enumerate(xs)])
                    for xs in zip(*sent)]
            high, st = self._count_shard(state, j, recv, per * n, w, seed)
            highs.append(high.to(devs[0]))
            used.append(st.used.to(devs[0]))
            over.append(st.overflow.to(devs[0]))
        state = state._replace(used=state.used + sum(used),
                               overflow=state.overflow + sum(over))
        total = torch.cat([x.to(devs[0]) for x in totals])
        return state, sum(highs), total

    def _count_shard(self, state: TableState, j: int, recv, n_rows: int,
                     w: int, seed: bool):
        """Count owner j's received windows (codes, global stream positions
        ``row * w + window`` and, relaxed, record-local ranks; in stream
        order) on its shard. Returns (high int32 [n_rows], the shard's
        state after the batch, whose used and overflow count from 0)."""
        t = self.table
        shard, st = t.shards[j], t.shard_state(state, j)
        code, pos, *rank = recv
        high = torch.zeros(n_rows, dtype=torch.int32, device=code.device)
        if code.numel() == 0:
            return high, st
        code = t.rebase(code, j)
        ones = torch.ones_like(code, dtype=torch.bool)
        if self.relaxed and not seed and isinstance(shard, DirectTable):
            st, prior = shard.relaxed_update(st, code, ones)
            hit = (prior + rank[0]) >= self.depth
            return high.index_add_(0, pos // w, hit.to(torch.int32)), st
        stream = sorted_occurrence_stream(code, ones)
        st, observed = shard.count_and_update(st, stream, seed=seed)
        if seed:
            return high, st
        if self.relaxed:
            observed = observed - stream.rank + rank[0][stream.src]
        hit = (observed >= self.depth).to(torch.int32)
        return high.index_add_(0, pos[stream.src] // w, hit), st


def _padded_rows(x, lo: int, hi: int, device) -> torch.Tensor:
    """Rows lo..hi of `x` (numpy or tensor) on `device`, zero rows past its
    end (records of length 0, which count nothing)."""
    part = _on(x[lo:min(hi, x.shape[0])], device)
    if part.shape[0] < hi - lo:
        part = torch.cat([part, part.new_zeros((hi - lo - part.shape[0],)
                                               + tuple(part.shape[1:]))])
    return part
