"""The streaming normalization engine on one device.

Port of nomalise_kmers_multi_large_tpu/engine/pipeline.py::Normalizer for
the bucket paths (k <= 15, and the wide table at k = 16..31): seed the
table(s), open per-shard outputs, stream each input file (pair) in record
batches through the batch step, and write the kept records. ``-p N`` gives
N logical shards on the one device, each with its own table, outputs and
``depth // N`` threshold.

CUDA work is asynchronous: a dispatch enqueues the batch step and returns,
and the previous dispatch retires (keep mask to the host, records written)
while the device runs. Around that loop:

- growth: each shard's live occupancy (``state.used``, counted in-kernel) is
  mirrored to the host at every retire, and the table doubles when it
  crosses the headroom;
- overflow grow-and-replay: a retire that sees new dropped inserts discards
  the dispatch's results, grows the table from a copy taken before that
  dispatch, and replays the batches on it.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.config import Config, port_config
from nomalise_kmers_multi_large_torch.engine.report import (
    RunReport,
    ShardCounters,
)
from nomalise_kmers_multi_large_torch.engine.step import BatchStep, StepStats
from nomalise_kmers_multi_large_torch.io.pack import pack_batch
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
from nomalise_kmers_multi_large_torch.table import TableState, make_table
from nomalise_kmers_multi_large_torch.utils.prefetch import PrefetchIterator
from nomalise_kmers_multi_large_torch.utils.profiling import StageTimer

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_codes(hi: np.ndarray, lo: np.ndarray, k: int) -> list[str]:
    """k-mer strings of 2-bit codes given as (hi, lo) 32-bit words (first
    base most significant)."""
    code = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    out = np.empty((code.shape[0], k), dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[:, i] = _BASES[(code & np.uint64(3)).astype(np.int64)]
        code >>= np.uint64(2)
    return [bytes(row).decode() for row in out]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _copy(state: TableState) -> TableState:
    """A copy of every plane; an absent plane (keys2 = None) stays None."""
    return TableState(*(None if x is None else x.clone() for x in state))


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device must exist (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


class Normalizer:
    """Single-device engine (N logical shards)."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg = port_config(cfg)
        self.device = resolve_device(device)
        t0 = make_table(cfg, self.device)
        # shards share one descriptor until one grows
        self.tables = [t0 for _ in range(cfg.shards)]
        self.states = [t.init() for t in self.tables]
        self.counters = [ShardCounters(s) for s in range(cfg.shards)]
        self.report = RunReport()
        self.writers: Optional[list[ShardWriter]] = None
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
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def _get_step(self, shard: int, paired: bool) -> BatchStep:
        # keyed by descriptor: growth swaps in a new one => a new step
        key = (paired, id(self.tables[shard]))
        step = self._steps_cache.get(key)
        if step is None:
            step = BatchStep(
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
        of the first records_to_seed records of EVERY input file with count
        0, then copy the seeded table to every shard."""
        self._in_seed = True
        try:
            self._seed_files()
        finally:
            self._in_seed = False

    def _seed_files(self):
        cfg = self.cfg
        n_seed = cfg.records_to_seed
        files = []
        for i, f in enumerate(cfg.forward_files):
            files.append(f)
            if i < len(cfg.reverse_files):
                files.append(cfg.reverse_files[i])
        for path in files:
            fx = FastxFile(path, cfg.is_input_fastq, cfg.io_threads)
            remaining = n_seed
            for batch in batch_iterator(fx, min(cfg.batch_reads, n_seed)):
                take = min(len(batch), remaining)
                if take < len(batch):
                    batch = RecordBatch(fwd_file=batch.fwd_file,
                                        fwd=batch.fwd.slice(0, take))
                # seeding uses the strictly-greater length rule (len > k)
                with self.timer.stage("seed"):
                    bases, lengths, _ = self._pack(batch, cfg.ksize + 1)
                    self._maybe_grow(
                        0, bases.shape[0] * (bases.shape[1] - cfg.ksize + 1))
                    self._seed_checked(bases, lengths)
                remaining -= take
                if remaining <= 0:
                    break
        with self.timer.stage("seed"):
            # waits for the seed dispatches; primes the occupancy mirror
            self._used_bound[0] = float(int(self.states[0].used))
        for s in range(1, len(self.states)):
            self.tables[s] = self.tables[0]
            self._used_bound[s] = self._used_bound[0]
            self.states[s] = _copy(self.states[0])

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
        cfg = self.cfg
        self.seed()
        if cfg.print_table:
            self._dump_seed_table()
        # drops already in the seeded states cannot be replayed
        self._overflow_seen = [int(st.overflow) for st in self.states]
        self.writers = [ShardWriter(cfg, s) for s in range(cfg.shards)]

        rr = 0  # round-robin shard cursor
        n_rev = len(cfg.reverse_files)
        for fi, fpath in enumerate(cfg.forward_files):
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
            rr = self._stream_file(it, paired, rr)

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

        for c in self.counters:
            c.maybe_report(cfg.verbose, force=True)
        for w in self.writers:
            w.close()
        if cfg.print_table:
            self._dump_tables()
        if cfg.verbose or cfg.debug:
            rep = self.timer.report()
            if rep:
                print(rep)
        self.report.final(paired=n_rev > 0)
        return self.report

    def _stream_file(self, it, paired: bool, rr: int) -> int:
        """Stream one file (pair) through dispatch and retire; returns the
        round-robin cursor."""
        cfg = self.cfg
        # the dispatch in flight, retired one dispatch later
        pending = None
        # per-shard staging queues for --dispatch-group
        groups: dict[int, list] = {}

        def dispatch(shard: int, q: list):
            """One staged-group dispatch, bracketed by what the overflow
            grow-and-replay protocol needs: the descriptor and a copy of
            the state before it, and the overflow/used counters after."""
            table = self.tables[shard]
            pre = self._replay_snapshot(shard)
            with self.timer.stage("dispatch"):
                keep, stats = self._dispatch_queue(shard, q, paired)
            post = self.states[shard]
            return (q, shard, keep, stats, table, pre, post.overflow,
                    post.used)

        def flush_shard(shard: int):
            """Dispatch shard's staged batches; retire the previous
            dispatch."""
            nonlocal pending
            q = groups.pop(shard, None)
            if not q:
                return
            w = q[0][1].shape[1] - cfg.ksize + 1
            with self.timer.stage("grow_check"):
                self._maybe_grow(shard, sum(x[1].shape[0] for x in q) * w)
            entry = dispatch(shard, q)
            if pending is not None:
                self._retire_checked(pending, paired)
                replayed, self._replayed_shards = self._replayed_shards, set()
                if shard in replayed:
                    # the dispatch above consumed a state the replay has
                    # just replaced: redo it on the replayed table
                    entry = dispatch(shard, q)
            pending = entry

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
                shard = rr % cfg.shards
                rr += 1
                q = groups.setdefault(shard, [])
                if q and q[0][1].shape != bases.shape:
                    # the adaptive padding changed the batch shape: a group
                    # must be shape-homogeneous
                    flush_shard(shard)
                    q = groups.setdefault(shard, [])
                q.append((batch, bases, lengths, rec_valid))
                if len(q) >= cfg.dispatch_group:
                    flush_shard(shard)
        finally:
            if isinstance(pit, PrefetchIterator):
                pit.close()
        for s in list(groups):
            flush_shard(s)
        if pending is not None:
            self._retire_checked(pending, paired)
            self._replayed_shards.clear()
        return rr

    # ------------------------------------------------------------------
    def _replay_snapshot(self, shard: int) -> Optional[TableState]:
        """Copy of the shard state before a dispatch, the replay source: the
        step updates the planes in place. Skipped when the table cannot
        grow, since no replay could then apply."""
        if not self.tables[shard].can_grow:
            return None
        return _copy(self.states[shard])

    def _retire_checked(self, entry, paired: bool):
        """Retire one dispatch, first checking its overflow counter against
        the host mirror: growth there means a row filled and the kernel
        dropped inserts, so the results are discarded and the group replayed
        on a grown table (_grow_and_replay)."""
        q, shard, keep, stats, table, pre, post_of, post_used = entry
        with self.timer.stage("device_wait"):
            # first sync on this dispatch
            of_post = int(post_of)
        if pre is not None and of_post > self._overflow_seen[shard]:
            keep, stats = self._grow_and_replay(
                shard, table, pre, of_post,
                lambda: self._dispatch_queue(shard, q, paired))
            # the dispatch in flight consumed the state just replaced
            self._replayed_shards.add(shard)
        else:
            self._overflow_seen[shard] = of_post
            self._used_bound[shard] = float(int(post_used))
        self._retire_group([x[0] for x in q], shard, keep, stats)

    def _grow_and_replay(self, shard: int, table, pre_state: TableState,
                         of_post: int, dispatch):
        """A dispatch overflowed a bucket row. Its results are discarded,
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
            cur_t, cur_pre = cur_t.grown(cur_pre)
        self._overflow_seen[shard] = of_new
        self._used_bound[shard] = float(int(self.states[shard].used))
        return result

    def _dispatch_queue(self, shard: int, q: list, paired: bool):
        step = self._get_step(shard, paired)
        if len(q) == 1:
            _, bases, lengths, rv = q[0]
            self.states[shard], keep, stats, _ = step.step(
                self.states[shard], bases, lengths, rv)
        else:
            self.states[shard], keep, stats, _ = step.step_many(
                self.states[shard], np.stack([x[1] for x in q]),
                np.stack([x[2] for x in q]), np.stack([x[3] for x in q]))
        return keep, stats

    def _retire_group(self, batches, shard, keep_dev, stats_dev):
        """Retire one dispatch: a single batch, or a step_many group whose
        outputs carry a leading G axis."""
        if len(batches) == 1:
            self._retire(batches[0], shard, keep_dev, stats_dev)
            return
        with self.timer.stage("device_wait"):
            keep = keep_dev.cpu().numpy()
            stats = StepStats(*(x.cpu().numpy() for x in stats_dev))
        for g, b in enumerate(batches):
            self._retire(b, shard, keep[g],
                         StepStats(*(x[g] for x in stats)))

    def _retire(self, batch, shard, keep_dev, stats_dev):
        with self.timer.stage("device_wait"):
            keep = (keep_dev.cpu().numpy() if torch.is_tensor(keep_dev)
                    else keep_dev)
        with self.timer.stage("write"):
            self.writers[shard].write_kept(batch, keep)
        c = self.counters[shard]
        c.processed += int(stats_dev.processed)
        c.printed += int(stats_dev.printed)
        c.skipped += int(stats_dev.skipped)
        if c.due():
            # live occupancy for the 60 s verbose line
            c.unique_kmers = self.tables[shard].used_count(self.states[shard])
        c.maybe_report(self.cfg.verbose)

    def _refresh_unique_counts(self):
        for s in range(self.cfg.shards):
            st = self.states[s]
            self.counters[s].unique_kmers = self.tables[s].used_count(st)
            self.counters[s].overflow = int(st.overflow)

    # ------------------------------------------------------------------
    def _dump_seed_table(self):
        """-P seed dump: output_kmer_seeds.k{k}_norm{d}.tsv, counts 0."""
        cfg = self.cfg
        path = os.path.join(cfg.out_dir, output_filename(
            "output_kmer_seeds", cfg.ksize, cfg.depth_per_shard, -1, "tsv"))
        hi, lo, _ = self.tables[0].export(self.states[0])
        with open(path, "w") as f:
            for km in decode_codes(hi, lo, cfg.ksize):
                f.write(f"{km}\t0\n")

    def _dump_tables(self):
        cfg = self.cfg
        for s in range(cfg.shards):
            hi, lo, counts = self.tables[s].export(self.states[s])
            path = os.path.join(cfg.out_dir, output_filename(
                "output_kmer", cfg.ksize, cfg.depth_per_shard, s, "tsv"))
            with open(path, "w") as f:
                for km, c in zip(decode_codes(hi, lo, cfg.ksize), counts):
                    f.write(f"{km}\t{c}\n")
