"""The streaming normalization engine on one device.

Port of nomalise_kmers_multi_large_tpu/engine/pipeline.py::Normalizer for
every table (bucket, k <= 15 and the wide one at k = 16..31; direct; hashed):
seed the table(s), from the inputs or from a k-mer TSV (``--seed-table``),
open per-shard outputs, stream each input file (pair) in record batches
through the batch step, and write the kept records. ``-p N`` gives N logical
shards on the one device, each with its own table, outputs and ``depth //
N`` threshold. The direct table cannot show a seeded code (count 0), so its
seeds are a host set, ``seeded_lo``, that occupancy and -P dumps read.

CUDA work is asynchronous: a dispatch enqueues the batch step and returns,
and the previous dispatch retires (keep mask to the host, records written)
while the device runs. Around that loop:

- growth (bucket and hashed tables): each shard's live occupancy
  (``state.used``, counted in-kernel) is mirrored to the host at every
  retire, and the table doubles when it crosses the headroom;
- overflow grow-and-replay: a retire that sees new dropped inserts (a full
  bucket row, a code that found no free slot in 64 probes) discards the
  dispatch's results, grows the table from a copy taken before that
  dispatch, and replays the batches on it;
- checkpoints (``--checkpoint-every``, ``--resume``): a snapshot is taken
  only after a drain, when nothing is staged or in flight, so the table
  describes exactly the records counted and no replay snapshot is pending;
- the debug tiers: per-record PRINTED/SKIPPED lines (> 1), per-upsert lines
  from a host shadow table (> 2), the batch round-trip self-check (>= 3)
  and the raw record dump (> 3; above 4 as 4).

parallel/engine.py::MeshNormalizer runs this loop over several devices
through the hooks the JAX mesh engine overrides, under the port's names:
``_shard_tables`` (each shard's descriptor and so its device), ``_deal``
(which shard gets which records of a batch), ``_retire_flush`` (the order
of a flush's retires), ``_install_resumed_states`` /
``_states_for_checkpoint`` (the checkpoint layouts) and ``step_class``
(the batch functions of a shard).
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.config import Config, port_config
from nomalise_kmers_multi_large_torch.engine.checkpoint import (
    CheckpointManager,
)
from nomalise_kmers_multi_large_torch.engine.debug_shadow import UpsertShadow
from nomalise_kmers_multi_large_torch.engine.report import (
    RunReport,
    ShardCounters,
)
from nomalise_kmers_multi_large_torch.engine.step import (
    BatchStep, ReadTallies, StepStats,
)
from nomalise_kmers_multi_large_torch.io.pack import LUT, pack_batch
from nomalise_kmers_multi_large_torch.io.reader import (
    FastxFile,
    RecordBatch,
    batch_iterator,
    paired_batch_iterator,
)
from nomalise_kmers_multi_large_torch.io.writer import (
    ShardWriter,
    output_filename,
)
from nomalise_kmers_multi_large_torch.ops import codec
from nomalise_kmers_multi_large_torch.ops.codec import decode_codes
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys, encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.ops.mix import (
    feistel_words_np, mix32_np,
)
from nomalise_kmers_multi_large_torch.table import TableState, make_table
from nomalise_kmers_multi_large_torch.utils.prefetch import PrefetchIterator
from nomalise_kmers_multi_large_torch.utils.profiling import (
    StageTimer, device_trace,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _copy(state: TableState, device=None) -> TableState:
    """A copy of every plane, on `device` if given; an absent plane (keys2 =
    None) stays None, and a plane held as a tuple of row shards (Mode B,
    parallel/modes.py) is copied shard by shard on their own devices."""
    def copy(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(p.clone() for p in x)
        return x.to(device or x.device, copy=True)

    return TableState(*(copy(x) for x in state))


def _slice_batch(batch: RecordBatch, lo: int, hi: int) -> RecordBatch:
    return RecordBatch(
        fwd_file=batch.fwd_file, fwd=batch.fwd.slice(lo, hi),
        rev_file=batch.rev_file,
        rev=batch.rev.slice(lo, hi) if batch.rev is not None else None)


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device must exist (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


class Normalizer:
    """Single-device engine (N logical shards); parallel/engine.py's
    MeshNormalizer runs it over several devices."""

    #: the batch functions of a shard (a Mode B run swaps in its own)
    step_class = BatchStep

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg = port_config(cfg)
        self.device = resolve_device(device)
        self.tables = self._shard_tables(make_table(cfg, self.device))
        self.states = [t.init() for t in self.tables]
        self.counters = [ShardCounters(s) for s in range(cfg.shards)]
        self.report = RunReport()
        self.writers: Optional[list[ShardWriter]] = None
        #: direct table: the host set of seeded codes (uint32), else None
        self.seeded_lo: Optional[np.ndarray] = None
        self._pad = 0  # adaptive padded read length
        self._warned_long_reads = False
        self._steps_cache: dict = {}
        #: host mirror of each shard's live occupancy (state.used), refreshed
        #: at every retire; growth is gated on it (_maybe_grow)
        self._used_bound = [0.0] * cfg.shards
        #: windows dispatched since the last live fetch (seed pass only)
        self._unseen = [0.0] * cfg.shards
        self._in_seed = False
        #: host mirror of each shard's state.overflow at the last retire: a
        #: retire that sees it grow triggers _grow_and_replay
        self._overflow_seen = [0] * cfg.shards
        #: shards rewound and regrown by a replay during the current flush
        self._replayed_shards: set[int] = set()
        #: --debug > 2: one exact host shadow table per shard
        self._shadows = ([UpsertShadow(cfg.ksize, cfg.canonical)
                          for _ in range(cfg.shards)]
                         if cfg.debug > 2 else None)
        self.timer = StageTimer()

    def _shard_tables(self, t0) -> list:
        """Each shard's table descriptor: shards share one until one grows."""
        return [t0 for _ in range(self.cfg.shards)]

    @staticmethod
    def _record_seq(file, cols, i: int) -> bytes:
        s0, sl = int(cols.seq_start[i]), int(cols.seq_len[i])
        return bytes(file.data[s0:s0 + sl])

    # ------------------------------------------------------------------
    def _get_step(self, shard: int, paired: bool) -> BatchStep:
        # keyed by descriptor: growth swaps in a new one => a new step
        key = (paired, id(self.tables[shard]))
        step = self._steps_cache.get(key)
        if step is None:
            step = self.step_class(
                self.tables[shard],
                k=self.cfg.ksize,
                depth_per_shard=self.cfg.depth_per_shard,
                coverage=self.cfg.coverage,
                canonical=self.cfg.canonical,
                paired=paired,
                mode=self.cfg.mode,
                pair_rule=self.cfg.pair_rule,
                stride=self.cfg.stride,
            )
            self._steps_cache[key] = step
        return step

    # ------------------------------------------------------------------
    def _maybe_grow(self, shard: int, inflow: int):
        """Grow a shard's table while its live occupancy exceeds the
        headroom. The mirror is at most one dispatch stale; a row that fills
        inside that window is recovered by _grow_and_replay. During the seed
        pass nothing retires, so the mirror is refreshed by a live fetch
        whenever the windows dispatched since the last one could have crossed
        the budget."""
        t = self.tables[shard]
        if t.grow_headroom is None:
            return  # the direct table never grows
        budget = t.grow_headroom * t.capacity
        if self._in_seed:
            self._unseen[shard] += inflow
            if self._used_bound[shard] + self._unseen[shard] > budget:
                self._used_bound[shard] = float(int(self.states[shard].used))
                self._unseen[shard] = 0.0
        if self._used_bound[shard] <= budget:
            return
        used = int(self._used_bound[shard])
        grew = False
        while t.can_grow and used > t.grow_headroom * t.capacity:
            if self.cfg.verbose or self.cfg.debug:
                print(
                    f"Thread {shard}: Local hash table expansion triggered, "
                    f"from {t.capacity:,} to {t.capacity * 2:,}"
                )
            t, st = t.grown(self.states[shard])
            self.tables[shard] = t
            self.states[shard] = st
            grew = True
        if grew and (self.cfg.verbose or self.cfg.debug):
            print(
                f"Thread {shard}: Local hash table expansion completed "
                f"successfully, using {used:,} of {t.capacity:,} new capacity"
            )
        if not t.can_grow and used > t.capacity * 0.9:
            print(
                f"Warning: Thread {shard}: Local hash table is still over 90% "
                f"full after expansion ({used:,})", file=sys.stderr,
            )

    def _pad_for(self, max_len: int) -> int:
        k = self.cfg.ksize
        need = max(int(max_len), k)
        if need > self.cfg.max_read_len and not self._warned_long_reads:
            self._warned_long_reads = True
            print(
                f"Warning: reads longer than {self.cfg.max_read_len} bp "
                f"found (up to {need}); only the first "
                f"{self.cfg.max_read_len} bases of each read are counted "
                "(records are still written in full)", file=sys.stderr,
            )
        if self.cfg.pad_read_len:
            return self.cfg.pad_read_len
        if need > self._pad:
            # pad the window count to a multiple of 8 only: every padded
            # window is a sentinel the sort and kernels still carry
            self._pad = _round_up(need + 1 - k, 8) + k - 1
        return self._pad

    # ------------------------------------------------------------------
    def _pack(self, batch: RecordBatch, min_len: int):
        """Pack a RecordBatch into host arrays in reference stream order."""
        cfg = self.cfg
        if batch.rev is not None:
            pad = self._pad_for(max(batch.fwd.seq_len.max(initial=0),
                                    batch.rev.seq_len.max(initial=0)))
            fb, fl = pack_batch(
                batch.fwd_file.data, batch.fwd.seq_start, batch.fwd.seq_len,
                pad, min_len, threads=cfg.io_threads,
            )
            rb, rl = pack_batch(
                batch.rev_file.data, batch.rev.seq_start, batch.rev.seq_len,
                pad, min_len, threads=cfg.io_threads,
            )
            # the reference drops the whole pair if EITHER mate is short
            rec_valid = (fl > 0) & (rl > 0)
            fl = np.where(rec_valid, fl, 0)
            rl = np.where(rec_valid, rl, 0)
            n = fb.shape[0]
            bases = np.empty((2 * n, pad), np.uint8)
            bases[0::2] = fb
            bases[1::2] = rb
            lengths = np.empty(2 * n, np.int32)
            lengths[0::2] = fl
            lengths[1::2] = rl
            return bases, lengths, rec_valid
        pad = self._pad_for(batch.fwd.seq_len.max(initial=0))
        fb, fl = pack_batch(
            batch.fwd_file.data, batch.fwd.seq_start, batch.fwd.seq_len,
            pad, min_len, threads=cfg.io_threads,
        )
        return fb, fl, fl > 0

    # ------------------------------------------------------------------
    def seed(self):
        """Sequential pre-pass (reference seed_kmer_hash): insert the k-mers
        of the first records_to_seed records of EVERY input file, or of the
        --seed-table TSV, with count 0, then copy the seeded table to every
        shard."""
        self._in_seed = True
        try:
            if self.cfg.seed_table:
                self._seed_from_tsv(self.cfg.seed_table)
            else:
                self._seed_files()
        finally:
            self._in_seed = False

    @property
    def _direct(self) -> bool:
        return self.tables[0].seeds_on_host

    def _seed_files(self):
        cfg = self.cfg
        n_seed = cfg.records_to_seed
        files = []
        for i, f in enumerate(cfg.forward_files):
            files.append(f)
            if i < len(cfg.reverse_files):
                files.append(cfg.reverse_files[i])
        # direct table: the seeded codes, marked on the device
        present = self._seed_marks() if self._direct else None
        for path in files:
            fx = FastxFile(path, cfg.is_input_fastq, cfg.io_threads)
            remaining = n_seed
            for batch in batch_iterator(fx, min(cfg.batch_reads, n_seed)):
                take = min(len(batch), remaining)
                if take < len(batch):
                    batch = RecordBatch(fwd_file=batch.fwd_file,
                                        fwd=batch.fwd.slice(0, take))
                if self._shadows is not None:
                    # the reference prints its debug > 2 upsert lines in the
                    # seed pass too
                    for i in range(len(batch)):
                        self._shadows[0].seed_seq(
                            self._record_seq(batch.fwd_file, batch.fwd, i),
                            sys.stdout)
                # seeding uses the strictly-greater length rule (len > k)
                with self.timer.stage("seed"):
                    bases, lengths, _ = self._pack(batch, cfg.ksize + 1)
                    if present is not None:
                        self._mark_seeds(present, bases, lengths)
                    else:
                        self._maybe_grow(0, bases.shape[0]
                                         * (bases.shape[1] - cfg.ksize + 1))
                        self._seed_checked(bases, lengths)
                remaining -= take
                if remaining <= 0:
                    break
        if present is not None:
            # the device states stay zero: nothing to replicate
            self.seeded_lo = self._seed_set(present)
        else:
            self._replicate_seeded_state()
        if self._shadows is not None:
            for s in range(1, len(self._shadows)):
                self._shadows[s] = self._shadows[0].copy()

    def _replicate_seeded_state(self):
        """Prime shard 0's occupancy mirror from its seeded state, then copy
        the table to every shard (reference copy_hash_table :908-927), each
        on its shard's device."""
        with self.timer.stage("seed"):
            # waits for the seed dispatches
            self._used_bound[0] = float(int(self.states[0].used))
        for s in range(1, len(self.states)):
            dev = self.tables[s].device
            self.tables[s] = self.tables[0].on(dev)
            self._used_bound[s] = self._used_bound[0]
            self.states[s] = _copy(self.states[0], dev)

    def _seed_from_tsv(self, path: str):
        """Seed from a k-mer TSV (one k-mer per line, any count column
        ignored; lines of another length skipped), for example a -P dump:
        the reference's planned feature (nk.c:74-77)."""
        cfg = self.cfg
        with open(path, "rb") as f:
            kmers = [km for km in (line.split(b"\t", 1)[0].strip()
                                   for line in f) if len(km) == cfg.ksize]
        if not kmers:
            self.seeded_lo = np.empty(0, np.uint32)
            return
        arr = LUT[np.frombuffer(b"".join(kmers), np.uint8)].reshape(
            len(kmers), cfg.ksize)
        if (arr == 255).any():
            raise ValueError(f"non-ACGTN kmer in seed table {path}")
        lengths = np.full(len(kmers), cfg.ksize, np.int32)
        if self._direct:
            present = self._seed_marks()
            self._mark_seeds(present, arr, lengths)
            self.seeded_lo = self._seed_set(present)
            return
        for i in range(0, len(arr), cfg.batch_reads):
            chunk = arr[i:i + cfg.batch_reads]
            self._maybe_grow(0, chunk.shape[0])
            self._seed_checked(chunk, lengths[i:i + cfg.batch_reads])
        self._replicate_seeded_state()

    # the direct table's seed set: a count array cannot hold a count-0
    # code, so the codes are marked in a bool [4^k] on the device and kept
    # on the host as seeded_lo

    def _seed_marks(self) -> torch.Tensor:
        return torch.zeros(self.cfg.direct_capacity, dtype=torch.bool,
                           device=self.device)

    def _mark_seeds(self, present: torch.Tensor, bases: np.ndarray,
                    lengths: np.ndarray):
        """Mark the codes of a packed batch's valid windows, every window
        (no stride, as the JAX package seeds the direct table)."""
        k = self.cfg.ksize
        code = codec.window_codes(torch.from_numpy(bases).to(self.device), k,
                                  self.cfg.canonical)
        valid = codec.code_validity(
            torch.from_numpy(lengths).to(self.device), code, k)
        # an invalid window marks code 0, which is never a seed
        present[torch.where(valid, code, 0)] = True

    @staticmethod
    def _seed_set(present: torch.Tensor) -> np.ndarray:
        """The marked codes, ascending, as uint32 on the host."""
        present[0] = False
        return torch.nonzero(present).squeeze(1).cpu().numpy().astype(
            np.uint32)

    def _seed_checked(self, bases, lengths):
        """One seed batch, replayed on a grown table if it dropped inserts.

        The live-occupancy mirror can let one batch bring more new codes
        than the rows hold (the first seed batch of a large file does, into
        the default table); the reference package keeps those drops. The
        port recovers them as the stream does (_grow_and_replay), at the
        cost of one sync per seed batch."""
        def dispatch():
            # growth swaps the descriptor; re-resolve the step
            step = self._get_step(0, paired=False)
            self.states[0] = step.seed_step(self.states[0], bases, lengths)

        table, pre = self.tables[0], self._replay_snapshot(0)
        dispatch()
        if pre is None:
            return
        of = int(self.states[0].overflow)
        if of > self._overflow_seen[0]:
            self._grow_and_replay(0, table, pre, of, dispatch)

    # ------------------------------------------------------------------
    def run(self) -> RunReport:
        """The whole run; with --profile inside a torch.profiler trace."""
        try:
            with device_trace(self.cfg.profile_dir,
                              cuda=self.device.type == "cuda"):
                return self._run()
        finally:
            # on any exit: an interrupted run too leaves its output files
            # flushed (a resume truncates them to the checkpoint's sizes)
            for w in self.writers or ():
                w.close()

    def _run(self) -> RunReport:
        cfg = self.cfg
        ckpt = (CheckpointManager(cfg)
                if cfg.checkpoint_every or cfg.resume else None)
        resume = self._resume(ckpt) if cfg.resume else None
        if resume is None:
            self.seed()
            if cfg.print_table:
                self._dump_seed_table()
        # drops already in the seeded or resumed states cannot be replayed
        self._overflow_seen = [int(st.overflow) for st in self.states]
        self.writers = [
            ShardWriter(cfg, s,
                        resume_sizes=resume.output_sizes if resume else None)
            for s in range(cfg.shards)]

        rr = resume.rr if resume else 0  # round-robin shard cursor
        n_rev = len(cfg.reverse_files)
        since_ckpt = 0  # batches queued since the last checkpoint
        for fi, fpath in enumerate(cfg.forward_files):
            if resume and fi < resume.file_index:
                continue
            paired = fi < n_rev
            if paired:
                print(
                    f"Processing file pair {fi + 1} of {len(cfg.forward_files)}: "
                    f"{fpath} and {cfg.reverse_files[fi]}"
                )
                fx = FastxFile(fpath, cfg.is_input_fastq, cfg.io_threads)
                rx = FastxFile(cfg.reverse_files[fi], cfg.is_input_fastq,
                               cfg.io_threads)
                it = paired_batch_iterator(fx, rx, cfg.batch_reads)
            else:
                print(
                    f"Processing single-ended file {fi + 1} of "
                    f"{len(cfg.forward_files)}: {fpath}"
                )
                fx = FastxFile(fpath, cfg.is_input_fastq, cfg.io_threads)
                it = batch_iterator(fx, cfg.batch_reads)
            sys.stdout.flush()
            skip = 0
            if resume and fi == resume.file_index:
                skip, resume = resume.records_done, None
            rr, since_ckpt = self._stream_file(it, paired, rr, fi, skip, ckpt,
                                               since_ckpt)

            with self.timer.stage("report"):
                self._refresh_unique_counts()
            self.report.absorb(self.counters)
            print(
                "Cumulative file statistics: "
                f"Processed {self.report.total_processed:,}, "
                f"Printed {self.report.total_printed:,}, "
                f"Skipped {self.report.total_skipped:,}, "
                f"Cumulative Max Unique Kmers in a thread: "
                f"{self.report.max_total_kmers:,}"
            )
            if ckpt and cfg.checkpoint_every:
                self._checkpoint(ckpt, fi + 1, 0, rr)

        if self.report.files_processed == 0:
            # a resume that found every file done: the restored counters
            # still hold the run's totals
            self._refresh_unique_counts()
            self.report.absorb(self.counters)
        for c in self.counters:
            c.maybe_report(cfg.verbose, force=True)
        if cfg.print_table:
            self._dump_tables()
        if cfg.verbose or cfg.debug:
            rep = self.timer.report()
            if rep:
                print(rep)
        self.report.final(paired=n_rev > 0)
        return self.report

    def _stream_file(self, it, paired: bool, rr: int, fi: int, skip: int,
                     ckpt, since_ckpt: int) -> tuple[int, int]:
        """Stream one file (pair) through dispatch and retire, after skipping
        its first `skip` records (a resume). Returns the round-robin cursor
        and the batches queued since the last checkpoint."""
        cfg = self.cfg
        # records of this file retired (or skipped), for the checkpoints
        records_done = 0
        # the dispatches of the last flush, retired at the next one
        pending: list = []
        # per-shard staging queues for --dispatch-group
        groups: dict[int, list] = {}

        def flush(shards) -> int:
            """Dispatch the staged groups of `shards`, then retire the
            previous flush's dispatches. Returns the records retired."""
            nonlocal pending
            entries = []
            for shard in shards:
                q = groups.pop(shard, None)
                if not q:
                    continue
                w = q[0][1].shape[1] - cfg.ksize + 1
                with self.timer.stage("grow_check"):
                    self._maybe_grow(shard, sum(x[1].shape[0] for x in q) * w)
                entries.append(self._dispatch(shard, q, paired))
            done = self._retire_flush(pending, paired)
            replayed, self._replayed_shards = self._replayed_shards, set()
            # a dispatch above consumed a state that a replay has just
            # replaced: redo it on the replayed table
            pending = [self._dispatch(e[1], e[0], paired) if e[1] in replayed
                       else e for e in entries]
            return done

        def drain() -> int:
            """Flush every staged queue and retire everything in flight."""
            return flush(list(groups)) + flush(())

        def produce(it=it):
            """frame + pack, on the prefetch worker when cfg.prefetch > 0"""
            for batch in it:
                with self.timer.stage("pack"):
                    packed = self._pack(batch, cfg.ksize)
                yield batch, packed

        pit = (PrefetchIterator(produce(), depth=cfg.prefetch)
               if cfg.prefetch > 0 else produce())
        try:
            src = iter(pit)
            while True:
                try:
                    with self.timer.stage("produce_wait"):
                        batch, (bases, lengths, rec_valid) = next(src)
                except StopIteration:
                    break
                if skip:
                    n = len(batch)
                    take = min(skip, n)
                    skip -= take
                    records_done += take
                    if take == n:
                        continue
                    # the resume point falls inside this batch: re-pack the
                    # rest of it
                    batch = _slice_batch(batch, take, n)
                    bases, lengths, rec_valid = self._pack(batch, cfg.ksize)
                # checkpoint only when nothing is staged or in flight: the
                # states then describe exactly the records_done records
                if ckpt and cfg.checkpoint_every \
                        and since_ckpt >= cfg.checkpoint_every:
                    records_done += drain()
                    self._checkpoint(ckpt, fi, records_done, rr)
                    since_ckpt = 0
                if cfg.debug >= 3:
                    self._debug_roundtrip(bases, lengths)
                full = []
                for shard, item in self._deal(rr, batch, bases, lengths,
                                              rec_valid):
                    q = groups.setdefault(shard, [])
                    if q and q[0][1].shape != item[1].shape:
                        # the adaptive padding changed the batch shape: a
                        # group must be shape-homogeneous
                        records_done += flush((shard,))
                        q = groups.setdefault(shard, [])
                    q.append(item)
                    if len(q) >= cfg.dispatch_group:
                        full.append(shard)
                rr += 1
                since_ckpt += 1
                if full:
                    records_done += flush(full)
        finally:
            if isinstance(pit, PrefetchIterator):
                pit.close()
        drain()
        return rr, since_ckpt

    def _deal(self, rr: int, batch, bases, lengths, rec_valid) -> list:
        """[(shard, (batch, bases, lengths, rec_valid))] of the rr-th
        batch: the whole batch to shard rr mod N (round robin). Mode A
        cuts it among the devices instead (parallel/engine.py)."""
        return [(rr % self.cfg.shards, (batch, bases, lengths, rec_valid))]

    def _dispatch(self, shard: int, q: list, paired: bool):
        """One staged-group dispatch, bracketed by what the overflow
        grow-and-replay protocol needs: the descriptor and a copy of the
        state before it, and the overflow/used counters after."""
        table = self.tables[shard]
        pre = self._replay_snapshot(shard)
        with self.timer.stage("dispatch"):
            result = self._dispatch_queue(shard, q, paired)
        post = self.states[shard]
        return (q, shard, result, table, pre, post.overflow, post.used)

    # ------------------------------------------------------------------
    def _resume(self, ckpt: CheckpointManager):
        """Load the checkpoint, if one exists, into the engine: states,
        table descriptors of their shapes, the occupancy mirrors, counters
        and the debug > 2 shadows. Returns its ResumePoint, or None."""
        loaded = ckpt.load(self.device)
        if not loaded:
            return None
        states, resume = loaded
        self._install_resumed_states(states)
        self.seeded_lo = resume.seeded_lo
        self._rebuild_tables_from_states()
        self._reseed_used_bounds()
        for c, saved in zip(self.counters, resume.counters):
            c.processed = saved["processed"]
            c.printed = saved["printed"]
            c.skipped = saved["skipped"]
            c.unique_kmers = saved["unique_kmers"]
        print(f"Resuming from checkpoint: file {resume.file_index + 1}, "
              f"{resume.records_done:,} records done")
        if self._shadows is not None:
            if resume.shadows is not None:
                # upsert counts stay absolute across the resume
                for sh, counts in zip(self._shadows, resume.shadows):
                    sh.counts = counts
            else:
                print(
                    "Warning: --debug>2 upsert lines after a resume "
                    "count from the resume point (this checkpoint "
                    "predates shadow snapshots)", file=sys.stderr,
                )
        return resume

    def _install_resumed_states(self, states: list):
        """The checkpoint's states (on self.device), as the engine keeps
        them; a mesh engine places them on its devices."""
        self.states = states

    def _states_for_checkpoint(self) -> list:
        """One state per checkpoint file (shard{N}.npz)."""
        return self.states

    def _rebuild_tables_from_states(self):
        """Descriptors of the loaded states' shapes (a checkpoint may hold
        a grown table)."""
        self.tables = [t.for_state(st)
                       for t, st in zip(self.tables, self.states)]

    def _reseed_used_bounds(self):
        """Prime each growing shard's occupancy mirror, and its live
        ``used`` counter, from the loaded table's real occupancy: growth
        then triggers where it would have in the run that wrote the
        checkpoint."""
        for s, st in enumerate(self.states):
            if self.tables[s].grow_headroom is None:
                continue
            used = self.tables[s].used_count(st)
            self.states[s] = st._replace(used=torch.tensor(
                used, dtype=torch.int32, device=st.used.device))
            self._used_bound[s] = float(used)

    def _checkpoint(self, ckpt: CheckpointManager, file_index: int,
                    records_done: int, rr: int):
        for w in self.writers:
            w.flush()
        self._refresh_unique_counts()
        paths = [p for w in self.writers for p in w.paths()]
        ckpt.save(self._states_for_checkpoint(), self.counters, file_index,
                  records_done, paths, rr, seeded_lo=self.seeded_lo,
                  shadows=self._shadows)

    # ------------------------------------------------------------------
    def _replay_snapshot(self, shard: int) -> Optional[TableState]:
        """Copy of the shard state before a dispatch, the replay source: the
        step updates the planes in place. Skipped when the table cannot
        grow, since no replay could then apply."""
        if not self.tables[shard].can_grow:
            return None
        return _copy(self.states[shard])

    def _retire_flush(self, entries: list, paired: bool) -> int:
        """Retire a flush's dispatches, one after another. Returns the
        records retired."""
        return sum(self._retire(*part) for e in entries
                   for part in self._checked(e, paired))

    def _checked(self, entry, paired: bool) -> list:
        """One dispatch's results, after checking its overflow counter
        against the host mirror: growth there means a row filled and the
        kernel dropped inserts, so the results are discarded and the group
        replayed on a grown table (_grow_and_replay). Returns the arguments
        of _retire for each of its batches."""
        q, shard, result, table, pre, post_of, post_used = entry
        with self.timer.stage("device_wait"):
            # first sync on this dispatch
            of_post = int(post_of)
        if pre is not None and of_post > self._overflow_seen[shard]:
            result = self._grow_and_replay(
                shard, table, pre, of_post,
                lambda: self._dispatch_queue(shard, q, paired))
            # the dispatch in flight consumed the state just replaced
            self._replayed_shards.add(shard)
        else:
            self._overflow_seen[shard] = of_post
            self._used_bound[shard] = float(int(post_used))
        return self._group_parts([x[0] for x in q], shard, *result)

    def _grow_and_replay(self, shard: int, table, pre_state: TableState,
                         of_post: int, dispatch):
        """A dispatch dropped inserts. Its results are discarded,
        the table grows from the state before the dispatch, and
        `dispatch()` replays the same batches on it, growing again from
        that state until the replay drops nothing or the table cannot grow.
        Returns the replay's result.

        `table` is the descriptor the dispatch ran on: growth between the
        dispatch and this retire may already have swapped a grown descriptor
        into self.tables, and growing the pre-dispatch state with that one
        would split rows on the wrong fingerprint bit."""
        of_base = self._overflow_seen[shard]
        print(
            f"Thread {shard}: table row overflow "
            f"({of_post - of_base:,} dropped inserts): growing from "
            f"{table.capacity:,} slots and replaying the batch group",
            file=sys.stderr,
        )
        # the overflowed state is discarded: free its planes before the
        # grown ones exist (the peak of the last doubling, PERF.md)
        self.states[shard] = None
        cur_t, cur_pre = table.grown(pre_state)
        while True:
            self.tables[shard] = cur_t
            # the replay updates its state in place: keep cur_pre intact
            # for a further doubling
            self.states[shard] = _copy(cur_pre)
            with self.timer.stage("dispatch"):
                result = dispatch()
            of_new = int(self.states[shard].overflow)
            if of_new <= of_base or not cur_t.can_grow:
                break
            self.states[shard] = None
            cur_t, cur_pre = cur_t.grown(cur_pre)
        self._overflow_seen[shard] = of_new
        self._used_bound[shard] = float(int(self.states[shard].used))
        return result

    def _dispatch_queue(self, shard: int, q: list, paired: bool):
        """(keep, StepStats, ReadTallies) of a staged group, on the device;
        a group of G > 1 batches gives them a leading G axis."""
        step = self._get_step(shard, paired)
        if len(q) == 1:
            _, bases, lengths, rv = q[0]
            self.states[shard], *result = step.step(
                self.states[shard], bases, lengths, rv)
        else:
            self.states[shard], *result = step.step_many(
                self.states[shard], np.stack([x[1] for x in q]),
                np.stack([x[2] for x in q]), np.stack([x[3] for x in q]))
        return result

    def _group_parts(self, batches, shard, keep_dev, stats_dev,
                     tallies_dev) -> list:
        """The _retire arguments of each batch of one dispatch: a single
        batch, or a step_many group whose outputs carry a leading G axis.
        The per-read tallies reach the host only for the --debug > 1
        lines."""
        if len(batches) == 1:
            return [(batches[0], shard, keep_dev, stats_dev, tallies_dev)]
        with self.timer.stage("device_wait"):
            keep = keep_dev.cpu().numpy()
            stats = StepStats(*(x.cpu().numpy() for x in stats_dev))
            if self.cfg.debug > 1:
                tallies_dev = ReadTallies(*(x.cpu().numpy()
                                            for x in tallies_dev))
        return [(b, shard, keep[g], StepStats(*(x[g] for x in stats)),
                 ReadTallies(*(x[g] for x in tallies_dev)))
                for g, b in enumerate(batches)]

    def _retire(self, batch, shard, keep_dev, stats_dev, tallies_dev) -> int:
        with self.timer.stage("device_wait"):
            keep = (keep_dev.cpu().numpy() if torch.is_tensor(keep_dev)
                    else keep_dev)
        with self.timer.stage("write"):
            self.writers[shard].write_kept(batch, keep)
        c = self.counters[shard]
        prev_processed = c.processed
        c.processed += int(stats_dev.processed)
        c.printed += int(stats_dev.printed)
        c.skipped += int(stats_dev.skipped)
        if self.cfg.debug > 1:
            self._debug_records(batch, shard, keep, tallies_dev,
                                prev_processed)
        if c.due():
            # live occupancy for the 60 s verbose line
            c.unique_kmers = self.tables[shard].used_count(
                self.states[shard], self.seeded_lo)
        c.maybe_report(self.cfg.verbose)
        return len(batch)

    # ------------------------------------------------------------------
    # the debug tiers (reference nk.c:944-1051, :1677-1696)

    def _debug_records(self, batch, shard, keep, tallies, base_count):
        """Per-record PRINTED/SKIPPED lines (debug > 1), each after the
        record's per-upsert lines (debug > 2) and before its raw dump
        (debug > 3)."""
        high, total = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                       for x in tallies)
        paired = batch.rev is not None
        d = self.cfg.depth_per_shard
        seq_no = base_count
        for i in range(len(batch)):
            if paired:
                hf, tf = int(high[2 * i]), int(total[2 * i])
                hr, tr = int(high[2 * i + 1]), int(total[2 * i + 1])
                if tf == 0 and tr == 0 and not keep[i]:
                    continue  # invalid record: the reference skips silently
                if self._shadows is not None:
                    # fwd mate then rev, as the reference's store_kmer calls
                    sh = self._shadows[shard]
                    sh.process_seq(
                        self._record_seq(batch.fwd_file, batch.fwd, i),
                        sys.stdout)
                    sh.process_seq(
                        self._record_seq(batch.rev_file, batch.rev, i),
                        sys.stdout)
                seq_no += 1
                verdict = "PRINTED" if keep[i] else "SKIPPED"
                rf = hf / tf if tf else 0.0
                rv = hr / tr if tr else 0.0
                print(
                    f"Thread {shard} - Sequence pair {seq_no:,} {verdict}: "
                    f"High ({d}) count kmers: F:{hf};R:{hr}, "
                    f"Total kmers: F:{tf};R:{tr} "
                    f"High count ratio: F:{rf:.2f};R:{rv:.2f}"
                )
            else:
                h, t = int(high[i]), int(total[i])
                if t == 0 and not keep[i]:
                    continue
                if self._shadows is not None:
                    self._shadows[shard].process_seq(
                        self._record_seq(batch.fwd_file, batch.fwd, i),
                        sys.stdout)
                seq_no += 1
                verdict = "PRINTED" if keep[i] else "SKIPPED"
                r = h / t if t else 0.0
                print(
                    f"Thread {shard} - Sequence {seq_no:,} {verdict}: "
                    f"High ({d}) count kmers: F:{h}, Total kmers: F:{t} "
                    f"High count ratio: F:{r:.2f}"
                )
            if self.cfg.debug > 3:
                self._debug_dump_seq(batch, i)

    @staticmethod
    def _debug_dump_seq(batch, i: int):
        """The raw record dump of debug > 3 (reference nk.c:1694-1695)."""

        def seq(file, cols):
            h0 = int(cols.hdr_start[i])
            s0, sl = int(cols.seq_start[i]), int(cols.seq_len[i])
            hdr = bytes(file.data[h0:int(cols.hdr_len[i]) + h0]).decode(
                "ascii", "replace")
            sq = bytes(file.data[s0:s0 + sl]).decode("ascii", "replace")
            return hdr, sq

        fh, fs = seq(batch.fwd_file, batch.fwd)
        if batch.rev is not None:
            rh, rs = seq(batch.rev_file, batch.rev)
            print(f"FWD seq: {fh}\n{fs}\nREV seq: {rh}\n{rs}")
        else:
            print(f"FWD seq: {fh}\n{fs}")

    def _debug_roundtrip(self, bases: np.ndarray, lengths: np.ndarray):
        """The debug >= 3 self-check of one packed batch (reference
        nk.c:950-960, 976-991, which cross-checks decode(encode(kmer)) and
        exits on a mismatch): every valid window's code from the codec
        (ops/codec.py, on the host) is decoded to a string and re-encoded
        independently; then, on a bucket table, the run's encode kernel, on
        the engine's device, is held against the codec plus mix32_np /
        feistel_words_np (the direct and hashed tables encode with the
        codec itself)."""
        cfg = self.cfg
        k = cfg.ksize
        hi, lo = codec.encode_windows_canonical(torch.from_numpy(bases), k,
                                                cfg.canonical)
        valid = codec.window_validity(torch.from_numpy(lengths), hi, lo,
                                      k).numpy()
        hi = hi.numpy().astype(np.uint32)
        lo = lo.numpy().astype(np.uint32)
        vhi, vlo = hi[valid], lo[valid]
        if vhi.size:
            kmers = decode_codes(vhi, vlo, k)
            arr = LUT[np.frombuffer("".join(kmers).encode(), np.uint8)
                      ].reshape(len(kmers), k).astype(np.uint64)
            code2 = np.zeros(len(kmers), np.uint64)
            for j in range(k):
                code2 = (code2 << np.uint64(2)) | arr[:, j]
            bad = ((code2 & np.uint64(0xFFFFFFFF)).astype(np.uint32) != vlo) \
                | ((code2 >> np.uint64(32)).astype(np.uint32) != vhi)
            if bad.any():
                i = int(np.argmax(bad))
                raise SystemExit(
                    f"FATAL: kmers do not match hash: {kmers[i]} vs "
                    f"{(int(vhi[i]) << 32) | int(vlo[i])}"
                )
        if cfg.stride != 1 or not self.tables[0].bucket:
            return
        b = torch.from_numpy(bases).to(self.device)
        ln = torch.from_numpy(lengths).to(self.device)
        if self.tables[0].wide:
            w1, w2 = encode_keys_wide(b, ln, k, cfg.canonical)
            key = w1.cpu().numpy().view(np.uint32).astype(np.uint64) \
                << np.uint64(32)
            key |= w2.cpu().numpy().view(np.uint32)
            code = (hi.astype(np.uint64) << np.uint64(32)) | lo
            e1, e2 = feistel_words_np(code[valid], 2 * k)
            expect = np.full(key.shape, 0xFFFFFFFFFFFFFFFF, np.uint64)
            expect[valid] = (e1.astype(np.uint64) << np.uint64(32)) | e2
        else:
            key = encode_keys(b, ln, k, cfg.canonical).cpu().numpy() \
                .view(np.uint32)
            expect = np.full(key.shape, 0xFFFFFFFF, np.uint32)
            expect[valid] = mix32_np(lo[valid], 2 * k)
        if (key != expect).any():
            r, w = np.argwhere(key != expect)[0]
            raise SystemExit(
                f"FATAL: fused encode kernel disagrees with codec at "
                f"read {r} window {w}: {key[r, w]:#x} vs {expect[r, w]:#x}"
            )

    def _refresh_unique_counts(self):
        for s in range(self.cfg.shards):
            st = self.states[s]
            self.counters[s].unique_kmers = self.tables[s].used_count(
                st, self.seeded_lo)
            self.counters[s].overflow = int(st.overflow)

    # ------------------------------------------------------------------
    def _dump_seed_table(self):
        """-P seed dump: output_kmer_seeds.k{k}_norm{d}.tsv, counts 0."""
        cfg = self.cfg
        path = os.path.join(cfg.out_dir, output_filename(
            "output_kmer_seeds", cfg.ksize, cfg.depth_per_shard, -1, "tsv"))
        if self.seeded_lo is not None:
            hi, lo = np.zeros_like(self.seeded_lo), self.seeded_lo
        else:
            hi, lo, _ = self.tables[0].export(self.states[0])
        with open(path, "w") as f:
            for km in decode_codes(hi, lo, cfg.ksize):
                f.write(f"{km}\t0\n")

    def _dump_tables(self):
        cfg = self.cfg
        for s in range(cfg.shards):
            hi, lo, counts = self.tables[s].export(self.states[s],
                                                   self.seeded_lo)
            path = os.path.join(cfg.out_dir, output_filename(
                "output_kmer", cfg.ksize, cfg.depth_per_shard, s, "tsv"))
            with open(path, "w") as f:
                for km, c in zip(decode_codes(hi, lo, cfg.ksize), counts):
                    f.write(f"{km}\t{c}\n")
