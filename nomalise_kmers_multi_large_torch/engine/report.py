"""Progress and final reporting.

Mirrors the reference's three reporting tiers (SURVEY.md section 5.5): always-on
per-file and final reports (normalise_kmers_multi_large.c:1896-1912, :2415-2453),
--verbose 60-second per-thread rate lines (:1699-1732), and --debug per-record
PRINTED/SKIPPED lines (:1677-1696). Numbers use thousands separators like the
reference's setlocale+%' (:2225).
"""
from __future__ import annotations

import dataclasses
import re
import sys
import time

REPORTING_INTERVAL = 60.0

#: the stdout lines that carry wall-clock readings: the verbose rate line,
#: the final report's runtime and rate, and the stage timer's report
#: (utils/profiling.py); two runs of one config print the same lines else
CLOCK_LINE = re.compile(r"Thread \d+ - Processing rate: |Total runtime: "
                        r"|Overall processing rate: "
                        r"|--- Host stage timing ---$"
                        r"|\w+: [\d.]+s \([\d.]+%\), \d+ calls, ")


def without_clock_lines(text: str) -> list[str]:
    """The lines of `text` (a run's stdout) but its CLOCK_LINE lines."""
    return [ln for ln in text.splitlines() if not CLOCK_LINE.match(ln)]


def _p(msg: str):
    print(msg)
    sys.stdout.flush()


@dataclasses.dataclass
class ShardCounters:
    """Per-shard cumulative counters (reference thread_data_t :174-194)."""

    shard: int
    processed: int = 0
    printed: int = 0
    skipped: int = 0
    unique_kmers: int = 0
    overflow: int = 0  # inserts dropped by a full table (0 once growth is on)
    # deltas for the verbose rate line
    last_report_time: float = dataclasses.field(default_factory=time.time)
    last_report_processed: int = 0
    prev_printed: int = 0
    prev_skipped: int = 0
    prev_rate: float = 0.0
    prev_kmers: int = 0

    def due(self) -> bool:
        """True when the 60 s reporting window has elapsed — callers refresh
        live table occupancy before maybe_report so the verbose line shows
        current unique k-mers (the reference reads ht->used live,
        nk.c:1715-1723), not a stale per-file snapshot."""
        return time.time() - self.last_report_time >= REPORTING_INTERVAL

    def maybe_report(self, verbose: bool, force: bool = False):
        now = time.time()
        if not force and now - self.last_report_time < REPORTING_INTERVAL:
            return
        elapsed = max(now - self.last_report_time, 1e-9)
        rate = (self.processed - self.last_report_processed) / elapsed

        def imp(new, old):
            return 0.0 if old == 0 else (new - old) / old * 100.0

        if verbose or force:
            _p(
                f"Thread {self.shard} - Processing rate: {rate:,.0f} "
                f"({imp(rate, self.prev_rate):+.2f}%) sequences/s, "
                f"processed {self.processed:,} pairs, "
                f"printed: {self.printed:,} ({imp(self.printed, self.prev_printed):+.2f}%), "
                f"skipped: {self.skipped:,} ({imp(self.skipped, self.prev_skipped):+.2f}%), "
                f"Unique kmers (all sequences; this thread): {self.unique_kmers:,} "
                f"({imp(self.unique_kmers, self.prev_kmers):+.2f}%)"
            )
        self.prev_rate = rate
        self.prev_printed = self.printed
        self.prev_skipped = self.skipped
        self.prev_kmers = self.unique_kmers
        self.last_report_time = now
        self.last_report_processed = self.processed


@dataclasses.dataclass
class RunReport:
    """Global cumulative stats (reference struct reporting_t :198-205)."""

    total_processed: int = 0
    total_printed: int = 0
    total_skipped: int = 0
    max_total_kmers: int = 0
    files_processed: int = 0
    start_time: float = dataclasses.field(default_factory=time.time)

    def absorb(self, shards: list[ShardCounters]):
        """Reference :1896-1912: totals are ASSIGNED from (cumulative) per-thread
        counters after each file, so they are cumulative across files."""
        self.total_processed = sum(s.processed for s in shards)
        self.total_printed = sum(s.printed for s in shards)
        self.total_skipped = sum(s.skipped for s in shards)
        self.max_total_kmers = max(
            [self.max_total_kmers] + [s.unique_kmers for s in shards]
        )
        self.files_processed += 1
        for s in shards:
            if s.overflow:
                # analogue of the reference's saturation warning
                # (expand_local_hash_table nk.c:1099-1102): the reference never
                # silently loses an insert, so neither may we
                _p(
                    f"WARNING: Thread {s.shard} k-mer table dropped "
                    f"{s.overflow:,} inserts (table full); counts may be "
                    "underestimated — increase --memory_start"
                )

    def final(self, paired: bool):
        _p("\n--- Final Report ---")
        _p(f"Processed Records: {self.total_processed:,}")
        _p(f"Printed Records: {self.total_printed:,}")
        _p(f"Skipped Records: {self.total_skipped:,}")
        _p(f"Cumulative Max unique kmers in any thread: {self.max_total_kmers:,}")
        runtime = time.time() - self.start_time
        _p(f"Total runtime: {runtime:.2f} seconds")
        if self.total_processed > 0:
            rate = self.total_processed / max(runtime, 1e-9)
            unit = "sequence pairs" if paired else "sequences"
            _p(f"Overall processing rate: {rate:,.0f} {unit} per second")
        else:
            _p("No data processed")
