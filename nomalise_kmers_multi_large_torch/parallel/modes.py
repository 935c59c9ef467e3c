"""Multi-device steps: Mode A (a table per device) and Mode B on the bucket
table (one exact table, row-range-sharded over the devices).

Port of nomalise_kmers_multi_large_tpu/parallel/modes.py::ModeAStep and
::ModeBBucketStep. One process drives every device (parallel/mesh.py); a
device here is a torch.device, and a list may repeat one.

Mode A: each device holds its own table, a copy of the seeded one; each
batch is cut into D contiguous record slices and slice d runs the one-device
step on device d's table at depth // D, the reference's independent threads
(README.md:68). The engine (parallel/engine.py) dispatches and retires each
slice as a shard of its own, so a table that overflows grows and replays
alone.

Mode B: ONE exact bucket table whose rows are cut into D equal ranges,
range d on device d (RowShardedBucketTable). A code's owner is the top
log2 D bits of its key (k <= 15) or of w1 (k = 16..31), so a row shard is a
bucket table of its own over keys rebased by d * span, with the whole
table's fingerprint width, and a doubling (row r -> 2r + b) never moves a
code to another shard. Per batch (ModeBBucketStep), on each device:

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

Every element sees its code's count before the batch plus its rank in the
whole batch's (code, read id) order, so decisions and the table equal a
one-device exact run at full depth, byte for byte.
"""
from __future__ import annotations

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
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
from nomalise_kmers_multi_large_torch.table.base import CountTable, TableState
from nomalise_kmers_multi_large_torch.table.bucket import (
    BucketTable, _split_rows,
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
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if n < 1 or n & (n - 1):
            raise ConfigError(f"--sharding global --table bucket needs a "
                              f"power-of-two device count, got {n}")
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

        def scalar():
            return torch.zeros((), dtype=torch.int32, device=self.device)

        return TableState(counts=planes(), keys=planes(), used=scalar(),
                          overflow=scalar(),
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


class ModeBBucketStep(BatchStep):
    """BatchStep's interface (step, step_many, seed_step) over a
    RowShardedBucketTable: the Mode B step of the module docstring. The
    batch must hold at most MAX_READS reads (rows) once padded to a
    multiple of D records (the scan kernel refuses more); stride 1 only."""

    def __init__(self, table: RowShardedBucketTable, **kw):
        super().__init__(table, **kw)
        if self.stride != 1:
            raise ValueError("Mode B routes every window: stride must be 1")

    def _routed_upsert(self, state: TableState, bases, lengths, seed: bool):
        """Encode, route and count one batch. Returns (state', high int32
        [R'], total int32 [R']) on the first device, R' the rows padded to
        a multiple of D records."""
        t: RowShardedBucketTable = self.table
        devs, n = t.devices, len(t.devices)
        rpr = 2 if self.paired else 1
        rows = bases.shape[0]
        per = -(-rows // (rpr * n)) * rpr   # rows per device
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


def _padded_rows(x, lo: int, hi: int, device) -> torch.Tensor:
    """Rows lo..hi of `x` (numpy or tensor) on `device`, zero rows past its
    end (records of length 0, which count nothing)."""
    part = _on(x[lo:min(hi, x.shape[0])], device)
    if part.shape[0] < hi - lo:
        part = torch.cat([part, part.new_zeros((hi - lo - part.shape[0],)
                                               + tuple(part.shape[1:]))])
    return part
