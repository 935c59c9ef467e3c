#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile | --kernels]
                          (from the root of a checkout; one card)

Phases, each of which fails the run on error:

1. The card's name and power limit; build every kernel from
   nomalise_kmers_multi_large_torch/csrc with nvcc (sm_90a), and print
   what ptxas reports for each kernel: registers, shared memory, spills.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (8192 read pairs = 16384 reads x 150 bp, a table of 2^21
   rows pre-filled by a seed pass): exact equality, and each one's time
   beside its bound (the bytes its work needs over 3.35 TB/s) and the
   plain version's. A kernel's time is device time only (time_ms): the
   host enqueues ten calls behind a device-side hold (torch.cuda._sleep,
   sized from a host-clock run of the same loop), each call between its
   own pair of CUDA events, with its setup outside the pair: the table
   planes reset for K4/K5, a 64 MiB write that flushes the 50 MB L2 for
   the others. One synchronise, then the mean of the pairs. A run whose
   hold ran out before the last call was enqueued (a host stall) is timed
   again behind a longer hold; the script fails after three such runs.
   Then the same ten calls, with their setup, run once under
   torch.profiler: `kernel_ms` is the mean duration of the kernel's own
   device events (KERNEL_FUNCTIONS), without the launch gaps and the
   setup's write-backs that the event windows also hold, and
   `kernel_share` is the bound over it. A profile that holds fewer of the
   kernel's events than calls is taken again; the script fails after three
   such, or if a kernel reads faster than its bound (`share` or
   `kernel_share` above 1). For the flushed kernels (K1-K3w) `copy_ms` is
   the device duration of a device-to-device copy that moves the same
   bytes after the same flush: what moving them costs the card in that L2
   state, a floor for `kernel_ms`. `host_ms` is the host clock around each
   call of the wrapper (no synchronise): what the host-bound main path
   pays per call. Plain versions, which may synchronise, are timed per
   call with a synchronise, host enqueue included. The bucket kernels'
   bytes depend on the data and are counted on the card from the batch
   (touched rows, their occupied lanes, matched and inserted codes).
   The k <= 15 kernels (K1, K3, K4) at k = 15; the wide kernels (K2, K3w,
   K5) timed at k = 25, and checked for equality at k = 16 (no plane B)
   and k = 31 on a 2^18-row table. K1 and K2 are checked with canonical
   off and on, K2 at k = 25 also at the main path's padded width (152 bp,
   W = 128). K4 and K5 are checked and timed twice:
   after a 4-batch seed pass (~3 lanes per row) and again after fresh
   batches fill at least 40M slots (~19 lanes per row, near the end of
   phase 4's stream). K3 and K3w also run once on a stream of 20.2M
   elements in which one code repeats 200,000 times (its rank saturates
   through the scan's look-back), equal to the plain version exactly.
   For K3 and K3w it also prints how far back their look-back must reach
   on the timed batch. Past the old 2^21-row ceiling of the wide table, K3w
   and K5 are checked for equality (not timed) at row_shift 10 (2^22 rows)
   and 8 (2^24 rows, 12 GiB of planes) on one k = 25 batch into a table
   seeded by three. The gate of a table that can grow (the engine's
   all-or-nothing replay protocol): the check kernels
   (bucket_overflow_check, k <= 15, and bucket_overflow_check_wide) against
   their plain versions at k = 15 and 25 on the main path's batch, on a
   2^21-row table after a 4-batch seed pass (the batch fits: the gate
   stays open, and K4/K5 gated behind it equal the ungated plain version;
   the check timed there beside its bound, the stream's words plus a count
   and one lane of each touched row, and the occupied lanes of the rows
   that may overflow), then on a 2^14-row table seeded by one batch (the
   batch overflows: both close the gate with its ticket, gated K4/K5 leave
   every plane bit-identical with zero stats while the ungated plain
   version drops inserts), and behind a closed gate (a later batch that
   fits changes nothing, and the ticket stays). K4 and K5 are also checked
   (not timed) on a Mode B
   row shard: the last of 4 row shards of a 2^21-row table (2^19 rows, the
   whole table's fingerprint width), fed the shard's routed part of four
   seed batches and a count batch at k = 15 and 25, with 1,000 sentinels
   after it whose rows lie past the shard's.
3. Golden parity: the port's CLI on tests/data/{a1,b1}.fasta -t fa -o fa
   -d 4 --device cuda is byte-identical to tests/golden/fasta_in_paired_k15
   at -k 15 and to tests/golden/fasta_in_paired_k25_jax (made by the JAX
   package) at -k 25.
4. The main path at a size users run: 1,000,000 read pairs of 2 x 150 bp
   FASTQ from a synthetic transcriptome (20,000 transcripts x 1.5 kb,
   log-normal abundance, 0.2% substitutions), normalised with the
   reference defaults (-k 15 -d 100 -g 0.9 -p 1 --batch-reads 8192) through
   Normalizer.run(). Kernel launch counts are zeroed just before and read
   just after; every kernel of the path, the check pass of the gate
   included, must have launched. It prints the run's peak device memory
   (torch.cuda.max_memory_allocated(), reset just before, and what was
   allocated before the run). The first 20,000 pairs also run through the
   CPU plain path, whose output must be byte-identical.
5. The wide path on the same files at -k 25 (otherwise as phase 4): the
   same checks, and the table must have grown from its 2^14 rows.
6. Only with --profile: phases 4 and 5 again on the same files, each one
   whole run under torch.profiler (CPU and CUDA activities), whose totals
   must equal theirs and whose device events must hold every launch of the
   path's kernels that phases 4 and 5 counted (a profile that lost events
   is taken again, three times at most). For each it prints the wall
   time, the device busy time (the union of the intervals of device
   events), the idle share and the device time by kernel or copy name (the
   15 largest, and each kernel of the path). The profiler slows the host,
   so an idle share from this phase is an upper bound.
7. The ceiling: a second 1,000,000-pair file pair from its own generator,
   and -k 25 on both pairs (-f r1 s1 -r r2 s2, 2,000,000 pairs, otherwise
   as phase 5). The wide table must end above 2^21 rows with no dropped
   insert and every pair processed; it prints the rows, the distinct
   k-mers, the plane bytes, the peak device memory and the wall time.
8. Relaxed mode: phase 4's input at -k 15 and -k 25 with --mode relaxed.
   The table planes must equal the exact runs' (phases 4 and 5) lane for
   lane, and processed and distinct k-mers theirs; at most 1 % of the
   pairs may change their keep decision. Also the sort of one main-path
   batch in both modes (torch.sort; not a kernel of the port).
9. Checkpoints: the first 20,000 pairs at -k 15 and -k 25, -d 5 (so that
   the decisions depend on the counts carried across the resume), with
   --checkpoint-every 1 (--batch-reads 2048), interrupted after the third
   retire, then resumed: byte-identical to an uninterrupted cuda run; the
   same checkpoint resumed with --device cpu gives the same bytes.
10. The debug tiers: tests/data/{a1,b1}.fasta -t fa -o fa -k 15 -d 4
   --debug 4 on cuda and on cpu: stdout equal line for line but for the
   wall-clock lines, the batch round-trip passing on every batch.
11. The fallback tables (direct, k <= 15; hashed, any k). First (with
   --kernels, right after phase 2), in a process of its own, the hashed
   table's find-or-insert kernel against its plain version, as phase 2
   checks and times the others: one k = 25 batch (16384 reads x 150 bp)
   into a table of 2^27 slots after a 4-batch seed pass, and again after
   random codes fill it to 0.45 load. Equal sets of (code, count), new
   and unresolved codes, and observed counts; its bytes are counted on the
   card from the probes the kernel made. Also, not timed, on a Mode B slot
   shard: the last of 4 shards (2^25 slots) of a 2^27-slot table, fed only
   the codes it owns of the same seed and count batches, equal to the
   plain version. Then both goldens on cuda with
   --table direct -k 15 and --table hashed -k 25; phase 4's 1,000,000
   pairs with --table direct -k 15 (a dense 4^15 x 4 B table) and
   --table hashed -k 25 -m 1 (2^26 slots, which must grow): outputs
   byte-identical to phases 4 and 5, spectra equal to theirs, no dropped
   insert, every state tensor on the card, the hashed kernel launched on
   the hashed path and none of K1-K5 on either; each prints its wall time,
   peak device memory, table bytes, doublings and the device time of its
   replay snapshots. The first 20,000 pairs of each also run on the cpu
   (bytes equal), and -d 70000 through --table auto must resolve to
   direct (k = 15) and hashed (k = 25), equal on cuda and cpu.
12. Several devices and processes (the shards share the one card, so this
   checks correctness and the exchange's cost, not NVLink or scaling):
   prints torch.cuda.device_count() and the devices of --devices 0. Mode B
   (--sharding global) on 4 shards of the card, phase 4's pairs at -k 15
   and -k 25: outputs byte-identical to phases 4/5, totals equal, overflow
   0, the global table grown, every row shard on the card, K1-K5 launched,
   its wall time beside phase 4/5's; on a machine with >= 4 cards, again
   on 4 distinct cards. Mode B on the fallback tables, 4 shards of the
   card, phase 4's pairs as phase 11 runs them (--table direct -k 15;
   --table hashed -k 25 -m 1, 4 shards of 2^24 slots, which must grow):
   outputs byte-identical to phases 4/5, spectra equal, totals equal,
   overflow 0, every shard on the card, the hashed kernel launched on the
   hashed run and none of K1-K5 on either; wall time, peak device memory
   and doublings beside phase 11's one-device walls; then the whole table
   gathered onto the card (the hashed one through its kernel) and split
   back, each timed, its contents kept. Mode B under full skew (20,000
   copies of one pair,
   every window of a batch in a few row shards): byte-identical to the
   one-device run. Mode A on 4 shards, phase 4's pairs at -k 15: four
   thread files of each mate named norm25, totals, every state on the
   card; then the first 20,000 pairs at -k 15 and -k 25 on 4 cuda shards
   and 4 cpu devices: every file byte-identical. --profile on the k = 15
   golden: one trace file whose device kernel events name K1, K3 and K4.
   Two host processes (gloo, torchrun's variables) on the card, each on
   one of two 20,000-pair file pairs: the aggregated totals equal the sums
   of single-process runs.
13. The bench (python3 -m nomalise_kmers_multi_large_torch.bench, in a
   process of its own) on both cells at 20,000 pairs and one timed run: it
   must exit 0 and print the card line, then one JSON line per cell, each
   parseable, with correct true (its own gate: the golden, the plain
   reference, the witness table), its metrics (pairs/s, peak device
   memory, host stages), every kernel of the cell's path launched, and the
   traced run's device breakdown with each operation and gap labelled by
   its host stage.

The synthetic reads come from the bench's generator
(nomalise_kmers_multi_large_torch/bench/data.py) and phase 6's device-time
summary from its trace module, so this script and the bench draw the same
bytes from a seed and read a profile one way.

Every phase prints "phase N: start" first and "phase N: done in S s" at its
end; a phase that fails prints its name and the traceback on standard
output, and the script exits non-zero.
Phases 7 to 10 and 12 each zero the kernel launch counts before their runs
and fail if a kernel of their path was never launched.

Standard output ends with one JSON line of per-kernel results, then
{"ok": true, "device": {...}} as the last line. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.

With --kernels it runs phases 1, 2 and 11's kernel check only and ends
with the per-kernel line (no launches, no "ok" line). To time one version
of the kernels against another in turns on one card, copy this script into
a checkout of each version and run them one after another on that card,
for example old, new, new, old: each builds and times its own checkout's
kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.bench.cells import output_digests
from nomalise_kmers_multi_large_torch.bench.data import (
    synth_pairs, write_pairs,
)
from nomalise_kmers_multi_large_torch.bench.measure import card_line
from nomalise_kmers_multi_large_torch.bench.trace import (
    DEVICE_FUNCTIONS, busy_us, by_name,
)

#: each kernel's device function as a profile names it ("::<name>("): the
#: bench's, and the check passes of the gate, which the bench does not
#: count
KERNEL_FUNCTIONS = {
    **DEVICE_FUNCTIONS,
    "bucket_overflow_check": "bucket_overflow_check_kernel",
    "bucket_overflow_check_wide": "bucket_overflow_check_wide_kernel",
}

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_work")
SEED = 20240823
PAIRS = 1_000_000         # phase 4 read pairs
CHECK_PAIRS = 20_000      # phase 4 pairs also run on the CPU plain path
BATCH_READS = 16384       # phase 2 batch: 8192 pairs, the CLI default
TABLE_ROWS = 1 << 21      # phase 2 table: the size phase 4 grows to
FULL_FILL_SLOTS = 40_000_000  # phase 2's fuller fill (phase 4 ends at 43.7M)
MAX_FILL_BATCHES = 200
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
L2_FLUSH_BYTES = 64 << 20  # > the H100's 50 MB L2
HOLD_CALIBRATION_CYCLES = 1 << 21  # torch.cuda._sleep cycles timed once
HOLD_ATTEMPTS = 3         # time_ms runs whose hold may run out
PROFILE_ATTEMPTS = 3      # profiles that may lose events
LONG_SCAN = 20_000_000    # phase 2's long scan stream (~4,900 tiles)
LONG_RUN = 200_000        # one code repeated across ~49 tiles in it
LARGE_ROW_SHIFTS = (10, 8)  # phase 2's wide tables of 2^22 and 2^24 rows
GATE_ROWS = 1 << 14       # phase 2's table that one batch overflows
OLD_CEILING_ROWS = 1 << 21  # phase 7's table must grow past it
RELAXED_MAX_DELTA = 0.01  # phase 8: largest share of changed decisions
CKPT_BATCH_PAIRS = 2048   # phase 9: 10 batches of the 20,000 pairs
CKPT_DEPTH = 5            # phase 9: low enough that pairs are skipped
CKPT_STOP_AFTER = 3       # phase 9: retires before the interrupt
HASH_SLOTS = 1 << 27      # phase 11: the hashed kernel's table
HASH_LOAD = 0.45          # phase 11: its fuller fill
AUTO_DEPTH = 70000        # phase 11: above the bucket table's 65535
HASHED_KERNEL_FLAG = "--hashed-kernel"  # phase 11's kernel check, apart
MESH_SHARDS = 4           # phase 12: shards of Modes A and B (and phase 2's
                          # row-shard check)
SKEW_PAIRS = 20_000       # phase 12: copies of one pair
BENCH_PAIRS = 20_000      # phase 13: the pairs a bench cell streams
#: phases 11 and 12: the fallback tables' 1M-pair runs (table, k, options)
FALLBACK_RUNS = (("direct", 15, []), ("hashed", 25, ["-m", "1"]))

REPLACES = {  # kernel -> the TPU kernel's pallas_call it replaces
    "encode_keys": "nomalise_kmers_multi_large_tpu/ops/encode_kernel.py:289",
    "rank_cand_scan": "nomalise_kmers_multi_large_tpu/ops/segscan.py:194",
    "bucket_batch": "nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py:549",
    # the check passes hold K4/K5's drop rule (the TPU kernels' overflow
    # count) ahead of the write: part of the same pallas_calls' port
    "bucket_overflow_check":
        "nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py:549",
    "bucket_overflow_check_wide":
        "nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py:1127",
    "encode_keys_wide":
        "nomalise_kmers_multi_large_tpu/ops/encode_kernel.py:236",
    "rank_cand_scan_wide": "nomalise_kmers_multi_large_tpu/ops/segscan.py:194",
    "bucket_batch_wide":
        "nomalise_kmers_multi_large_tpu/ops/bucket_kernel.py:1127",
    "hashed_insert":
        "nomalise_kmers_multi_large_tpu/table/hashed.py:57 (XLA, not Pallas)",
}
#: the kernels each path runs; a path's run must launch every one of them
PATH_KERNELS = {
    15: ("encode_keys", "rank_cand_scan", "bucket_overflow_check",
         "bucket_batch"),
    25: ("encode_keys_wide", "rank_cand_scan_wide",
         "bucket_overflow_check_wide", "bucket_batch_wide"),
}
#: the gate's check pass of each path: a one-device table that can grow
#: runs it, Mode B's row-sharded table never does
GATE_KERNELS = {15: "bucket_overflow_check", 25: "bucket_overflow_check_wide"}
#: K1-K5 and the check passes, which the direct and hashed paths must not
#: launch
BUCKET_KERNELS = PATH_KERNELS[15] + PATH_KERNELS[25]


# ----------------------------------------------------------------------

def time_ms(fn, setup=None, iters=10, warmup=2) -> tuple[float, float]:
    """(device ms, host ms) of fn(), a kernel's wrapper.

    The host enqueues all `iters` calls behind a device-side hold
    (torch.cuda._sleep, sized from a host-clock measurement of the same
    enqueue loop); each call has its own CUDA event pair around it, and
    setup() runs before each, outside the pair. After one synchronise the
    device time is the mean of the pairs: the host's enqueue is in no
    window. If the hold ran out before the host had enqueued the last call
    (the host stalled), the times are discarded and the calls run again
    behind a hold sized from the stalled enqueue, at the cycle rate of the
    hold that ran out if that is higher than the calibrated one; it fails
    after HOLD_ATTEMPTS such runs. The host time is the host clock around
    each call of the wrapper (no synchronise), what a host-bound caller
    pays per call."""
    def call():
        if setup:
            setup()
        fn()

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    c0, c1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    c0.record()
    torch.cuda._sleep(HOLD_CALIBRATION_CYCLES)
    c1.record()
    c1.synchronize()
    cycles_per_ms = HOLD_CALIBRATION_CYCLES / c0.elapsed_time(c1)
    hold_ms = 3 * enqueue_ms + 2.0
    for _ in range(HOLD_ATTEMPTS):
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  for _ in range(iters + 1)]
        host_s = 0.0
        t0 = time.perf_counter()
        events[0][0].record()
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        events[0][1].record()
        for a, b in events[1:]:
            if setup:
                setup()
            a.record()
            t = time.perf_counter()
            fn()
            host_s += time.perf_counter() - t
            b.record()
        enqueued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        held_ms = events[0][0].elapsed_time(events[0][1])
        if enqueued_ms < held_ms:
            device_ms = sum(a.elapsed_time(b) for a, b in events[1:]) / iters
            return device_ms, host_s * 1e3 / iters
        print(f"time_ms: the device hold ({held_ms:.3f} ms) ran out before "
              f"the host had enqueued {iters} calls ({enqueued_ms:.3f} ms); "
              "timing again")
        # a host stall between the calibration's first event and its sleep
        # widens that window, so its cycle rate can read low and every hold
        # then runs short: the hold just measured gives the rate as well
        cycles_per_ms = max(cycles_per_ms, int(hold_ms * cycles_per_ms)
                            / max(held_ms, 1e-3))
        hold_ms = 3 * enqueued_ms + 2.0
    raise AssertionError(f"the device hold ran out before the host had "
                         f"enqueued {iters} calls in {HOLD_ATTEMPTS} runs")


def profiled_ms(tag: str, fn, setup=None, iters=10) -> float:
    """Mean duration of the device events whose name holds `tag` over
    `iters` calls of fn(), each after setup(), under torch.profiler. A
    profile that holds fewer such events than calls is taken again; it
    fails after PROFILE_ATTEMPTS such profiles."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                if setup:
                    setup()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and tag in e.name]
        if len(us) >= iters:
            return sum(us) / len(us) / 1e3
        print(f"profiled_ms: the profile holds {len(us)} events {tag!r} "
              f"for {iters} calls; profiling again")
    raise AssertionError(f"{PROFILE_ATTEMPTS} profiles lost events {tag!r}")


def kernel_ms(name: str, fn, setup=None) -> float:
    """Kernel `name`'s own device duration per call (its KERNEL_FUNCTIONS
    events), without the launch gaps and the setup's write-backs that
    time_ms's event windows also hold."""
    return profiled_ms(f"::{KERNEL_FUNCTIONS[name]}(", fn, setup)


def copy_ms(work_bytes: int, setup) -> float:
    """Device duration of a device-to-device copy of work_bytes / 2 bytes
    (work_bytes moved in all) after setup(): what moving a kernel's bytes
    costs the card in the same L2 state, a floor for its kernel_ms."""
    src = torch.empty(work_bytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return profiled_ms("Memcpy DtoD", lambda: dst.copy_(src), setup)


def time_synced_ms(fn, setup=None, iters=3, warmup=1) -> float:
    """Mean time of fn() between CUDA events with a synchronise after each
    call, host enqueue included: for plain versions and torch calls, which
    may synchronise themselves and so cannot run behind a hold."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    total = 0.0
    for _ in range(iters):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def l2_flush(dev):
    """setup() for a kernel whose inputs the previous call left in the
    50 MB L2: writes L2_FLUSH_BYTES."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    return lambda: buf.fill_(0)


def max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def batch_stream(rng, dev):
    """Endless batches of BATCH_READS x 150 bp synthetic reads from one
    synthetic transcriptome (mates interleaved, as the engine packs pairs),
    on the card."""
    reads = BATCH_READS
    for m1, m2 in synth_pairs(rng, 1 << 40, chunk=reads // 2):
        b = np.empty((reads, 150), np.uint8)
        b[0::2], b[1::2] = m1, m2
        yield torch.from_numpy(b).to(dev)


def read_batches(rng, dev, n_batches: int):
    """The first n_batches of batch_stream (the same draws from rng as a
    synth_pairs call for n_batches batches)."""
    return list(itertools.islice(batch_stream(rng, dev), n_batches))


def report(out: dict, label: str):
    for name, r in out.items():
        print(f"{label}: {name}: max_abs_err {r['max_abs_err']}, kernel "
              f"{r['ms']:.4f} ms (its own duration {r['kernel_ms']:.4f} ms, "
              f"host enqueue {r['host_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['work_bytes']:,} bytes), share {r['share']:.3f}, "
              f"kernel_share {r['kernel_share']:.3f}"
              + ("" if r["copy_ms"] is None else
                 f"; a copy of its bytes after the flush {r['copy_ms']:.4f}"
                 " ms"))
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
        if r["share"] > 1 or r["kernel_share"] > 1:
            raise AssertionError(f"{name}: faster than its bound; the "
                                 "timing is wrong")


def timed(name: str, fn, plain, work_bytes: int, err: int, setup=None,
          flushed=False) -> dict:
    """Kernel `name`'s row of the kernels line: its time (event window and
    its own duration) and its plain version's on the same inputs, and its
    bound, the bytes its work needs (each input read once, each output
    written once) over the card's memory rate. With flushed (setup is an
    L2 flush), also copy_ms, a copy of the same bytes after the flush."""
    ms, host_ms = time_ms(fn, setup=setup)
    own_ms = kernel_ms(name, fn, setup=setup)
    bound = work_bytes / HBM_BYTES_PER_MS
    return dict(max_abs_err=err, ms=ms, kernel_ms=own_ms, host_ms=host_ms,
                plain_ms=time_synced_ms(plain, setup=setup),
                bound_ms=bound, bound_by="bytes", share=bound / ms,
                kernel_share=bound / own_ms, library_ms=None,
                copy_ms=copy_ms(work_bytes, setup) if flushed else None,
                work_bytes=work_bytes)


def upsert_work(rows, codes, fp_planes, stats, n_elems: int,
                stream_words: int, n_reads: int) -> tuple[int, str]:
    """Bytes a count-mode upsert of one batch needs, from its data: the
    stream words in and the per-read tallies out; the occupied fingerprint
    lanes of each distinct touched row (pre-batch planes); one count read
    per matched code and one count written per matched or inserted code;
    the fingerprint planes of the inserts. `rows`, `codes`: the row and code
    of every valid element; `stats`: the kernel's (dropped, inserted)."""
    touched = torch.unique(rows)
    occupied = int((fp_planes[0][touched] != 0).sum())
    distinct = int(torch.unique(codes).numel())
    dropped, inserted = int(stats[0]), int(stats[1])
    matched = distinct - dropped - inserted
    n_fp = len(fp_planes)
    total = (4 * stream_words * n_elems + 4 * n_reads
             + 4 * n_fp * occupied + 4 * (2 * matched + inserted)
             + 4 * n_fp * inserted)
    return total, (f"{touched.numel():,} rows touched, {occupied:,} occupied "
                   f"lanes in them, {distinct:,} distinct codes ({matched:,} "
                   f"matched, {inserted:,} inserted, {dropped:,} dropped)")


def check_and_time_upsert(name, label, planes, kernel, plain,
                          work) -> dict:
    """An upsert kernel against its plain version in seed and count mode
    (planes and outputs equal), then both timed in count mode from the same
    starting planes. planes: the tensors the upsert updates in place (None
    for an absent plane); kernel(planes, seed) and plain(planes, seed)
    return (high, stats); work(start_planes, stats) -> (bytes, detail)."""
    start = [None if x is None else x.clone() for x in planes]
    twins = [None if x is None else x.clone() for x in planes]

    def reset():
        for t, src in zip(planes + twins, start + start):
            if t is not None:
                t.copy_(src)

    errs = []
    for seed in (True, False):
        reset()
        got = kernel(planes, seed)
        want = plain(twins, seed)
        errs.append(max_abs_err([
            *((a, b) for a, b in zip(planes, twins) if a is not None),
            *zip(got, want)]))
    nbytes, detail = work(start, got[1])
    print(f"{label}: inserted {int(got[1][1]):,}, dropped "
          f"{int(got[1][0]):,}, high windows {int(got[0].sum()):,}; "
          f"work: {detail}")
    out = timed(name, lambda: kernel(planes, False),
                lambda: plain(planes, False), nbytes, max(errs), setup=reset)
    del start, twins
    return out


def fill_table(planes, seed_batch, batches, label: str) -> int:
    """Seed fresh batches into the table until FULL_FILL_SLOTS slots are
    filled; returns the slots filled."""
    filled = int((planes[0] != 0).sum())
    n = 0
    while filled < FULL_FILL_SLOTS:
        if n == MAX_FILL_BATCHES:
            raise AssertionError(f"{label}: {filled:,} slots after {n} "
                                 "fill batches")
        seed_batch(next(batches))
        n += 1
        filled = int((planes[0] != 0).sum())
    rows, lanes = planes[0].shape
    print(f"{label}: {n} more seed batches filled {filled:,} slots "
          f"({filled / rows:.1f} lanes per row of {lanes})")
    return filled


def phase_kernels(rng, dev) -> dict:
    """Each k <= 15 kernel vs its plain version at the main path's shapes;
    K4 also at a fuller fill of the same table."""
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        bucket_upsert, bucket_upsert_plain, sort_stream,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        encode_keys, encode_keys_plain,
    )
    from nomalise_kmers_multi_large_torch.ops.segscan import (
        rank_cand_scan, rank_cand_scan_plain,
    )
    from nomalise_kmers_multi_large_torch.table.bucket import BucketTable

    k, reads, depth = 15, BATCH_READS, 100
    batches = read_batches(rng, dev, 5)
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    table = BucketTable(k, rows=TABLE_ROWS, device=dev)
    state = table.init()
    planes = [state.keys, state.counts]
    kw = dict(fp_bits=table.fp_bits, depth=depth, n_reads=reads)

    def stream(bases):
        key = encode_keys(bases, lengths, k, False)
        rid = torch.arange(key.numel(), device=dev) // key.shape[1]
        skey, srid = sort_stream(key.reshape(-1), rid)
        p2, p3 = rank_cand_scan(skey, srid, fp_bits=table.fp_bits,
                                n_reads=reads)
        return key, skey, srid, p2, p3

    def seed_batch(bases):
        _, skey, _, p2, p3 = stream(bases)
        bucket_upsert(*planes, skey, p2, p3, seed=True, **kw)

    for bases in batches[:4]:  # seed pass: fill the table
        seed_batch(bases)
    bases = batches[4]
    key, skey, srid, p2, p3 = stream(bases)
    torch.cuda.synchronize()
    occupied = int((state.keys != 0).sum())
    print(f"phase 2: table {table.rows:,} rows x {table.lanes} lanes, "
          f"{occupied:,} slots filled by a 4-batch seed pass; batch "
          f"{reads:,} reads x 150 bp -> {skey.numel():,} windows")

    out = {}
    n = skey.numel()
    flush = l2_flush(dev)
    err = max_abs_err([(encode_keys(bases, lengths, k, c),
                        encode_keys_plain(bases, lengths, k, c))
                       for c in (False, True)])
    out["encode_keys"] = timed(
        "encode_keys", lambda: encode_keys(bases, lengths, k, False),
        lambda: encode_keys_plain(bases, lengths, k, False),
        bases.numel() + 4 * reads + 4 * key.numel(), err, setup=flush,
        flushed=True)
    skw = dict(fp_bits=table.fp_bits, n_reads=reads)
    err = max_abs_err(zip(rank_cand_scan(skey, srid, **skw),
                          rank_cand_scan_plain(skey, srid, **skw)))
    out["rank_cand_scan"] = timed(
        "rank_cand_scan", lambda: rank_cand_scan(skey, srid, **skw),
        lambda: rank_cand_scan_plain(skey, srid, **skw), 16 * n, err,
        setup=flush, flushed=True)
    del flush
    print(f"phase 2: rank_cand_scan look-back depth on the batch: "
          f"{lookback_depth(skey, table.fp_bits)}")

    def bucket_out(skey, p2, p3, label):
        ukey = skey.to(torch.int64) & 0xFFFFFFFF
        valid = ukey[(ukey != 0xFFFFFFFF)
                     & ((ukey >> table.fp_bits) < table.rows)]
        return check_and_time_upsert(
            "bucket_batch", label, planes,
            lambda pl, seed: bucket_upsert(*pl, skey, p2, p3, seed=seed,
                                           **kw),
            lambda pl, seed: bucket_upsert_plain(*pl, skey, p2, p3,
                                                 seed=seed, **kw),
            lambda start, stats: upsert_work(
                valid >> table.fp_bits, valid, start[:1], stats, n, 3,
                reads))

    out["bucket_batch"] = bucket_out(skey, p2, p3, "phase 2 (4-batch fill)")
    # the fuller fill: fresh batches, then one more batch of the same source
    fill = batch_stream(np.random.default_rng(SEED + 2), dev)
    slots = fill_table(planes, seed_batch, fill, "phase 2 (fuller fill)")
    _, skey, _, p2, p3 = stream(next(fill))
    full = bucket_out(skey, p2, p3, "phase 2 (fuller fill)")
    out["bucket_batch"]["full_fill"] = dict(slots=slots, **full)
    report(out, "phase 2")
    report({"bucket_batch": full}, f"phase 2 (fuller fill, {slots:,} slots)")
    del state, planes, batches, fill
    torch.cuda.empty_cache()
    return out


def phase_kernels_wide(rng, dev) -> dict:
    """K2, K3w and K5 vs their plain versions: timed at k = 25 on a 2^21-row
    table pre-filled by a 4-batch seed pass, K5 also at a fuller fill;
    equality only at k = 16 and k = 31 on a 2^18-row table."""
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        bucket_upsert_wide, bucket_upsert_wide_plain, sort_stream_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        encode_keys_wide, encode_keys_wide_plain,
    )
    from nomalise_kmers_multi_large_torch.ops.segscan import (
        rank_cand_scan, rank_cand_scan_plain,
    )
    from nomalise_kmers_multi_large_torch.table.bucket import BucketTableWide

    reads, depth = BATCH_READS, 100
    batches = read_batches(rng, dev, 5)
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    pad_gen = torch.Generator(device=dev)
    pad_gen.manual_seed(SEED + 5)
    out = {}
    for k in (25, 16, 31):
        timed_k = k == 25
        table = BucketTableWide(k, rows=TABLE_ROWS if timed_k else 1 << 18,
                                device=dev)
        state = table.init()
        scan_kw = dict(fp_bits=0, n_reads=reads, row_shift=table.row_shift)

        def stream(bases):
            words = encode_keys_wide(bases, lengths, k, False)
            sk1, sk2, srid = sort_stream_wide(
                words[0].reshape(-1), words[1].reshape(-1), words[0].shape[1])
            p2, p3 = rank_cand_scan(sk1, srid, skey2=sk2, **scan_kw)
            return words, (sk1, sk2, srid), (p2, p3)

        planes = [state.keys, state.keys2, state.counts]
        kw = dict(row_shift=table.row_shift, depth=depth, n_reads=reads)

        def seed_batch(bases):
            _, (sk1, sk2, _), (p2, p3) = stream(bases)
            bucket_upsert_wide(*planes, sk1, sk2, p2, p3, seed=True, **kw)

        for bases in batches[:4]:  # seed pass: fill the table
            seed_batch(bases)
        bases = batches[4]
        words, (sk1, sk2, srid), scan = stream(bases)
        torch.cuda.synchronize()
        n = sk1.numel()
        print(f"phase 2 (k={k}): table {table.rows:,} rows x {table.lanes} "
              f"lanes, {int((state.keys != 0).sum()):,} slots filled by a "
              f"4-batch seed pass; batch {reads:,} reads x 150 bp -> "
              f"{n:,} windows")

        def bucket_out(sk1, sk2, scan, label):
            w1 = sk1.to(torch.int64) & 0xFFFFFFFF
            w2 = sk2.to(torch.int64) & 0xFFFFFFFF
            ok = w2 != 0xFFFFFFFF
            w1, w2 = w1[ok], w2[ok]
            n_fp = 1 if planes[1] is None else 2
            return check_and_time_upsert(
                "bucket_batch_wide", label, planes,
                lambda pl, seed: bucket_upsert_wide(*pl, sk1, sk2, *scan,
                                                    seed=seed, **kw),
                lambda pl, seed: bucket_upsert_wide_plain(
                    *pl, sk1, sk2, *scan, seed=seed, **kw),
                lambda start, stats: upsert_work(
                    w1 >> table.row_shift, (w1 << 32) | w2,
                    [start[0], start[1]][:n_fp], stats, n, 4, reads))

        widths = [bases]
        if timed_k:  # the main path's width at k = 25: 152 bp, W = 128
            pad = torch.randint(0, 4, (reads, 2), dtype=torch.uint8,
                                device=dev, generator=pad_gen)
            widths.append(torch.cat([bases, pad], 1))
        pairs = []
        for b, c in itertools.product(widths, (False, True)):
            pairs += zip(encode_keys_wide(b, lengths, k, c),
                         encode_keys_wide_plain(b, lengths, k, c))
        res = {"encode_keys_wide": max_abs_err(pairs)}
        res["rank_cand_scan_wide"] = max_abs_err(zip(
            scan, rank_cand_scan_plain(sk1, srid, skey2=sk2, **scan_kw)))
        bucket = bucket_out(sk1, sk2, scan, f"phase 2 (k={k}, 4-batch fill)")
        res["bucket_batch_wide"] = bucket["max_abs_err"]
        print(f"phase 2 (k={k}): max_abs_err {res}")
        if any(res.values()):
            raise AssertionError(f"k={k}: a wide kernel disagrees with its "
                                 f"plain version: {res}")
        if not timed_k:
            del state, planes
            torch.cuda.empty_cache()
            continue
        w = words[0].shape[1]
        flush = l2_flush(dev)
        out["encode_keys_wide"] = timed(
            "encode_keys_wide",
            lambda: encode_keys_wide(bases, lengths, k, False),
            lambda: encode_keys_wide_plain(bases, lengths, k, False),
            bases.numel() + 4 * reads + 8 * reads * w, 0, setup=flush,
            flushed=True)
        out["rank_cand_scan_wide"] = timed(
            "rank_cand_scan_wide",
            lambda: rank_cand_scan(sk1, srid, skey2=sk2, **scan_kw),
            lambda: rank_cand_scan_plain(sk1, srid, skey2=sk2, **scan_kw),
            20 * n, 0, setup=flush, flushed=True)
        del flush
        print(f"phase 2 (k=25): rank_cand_scan_wide look-back depth on the "
              f"batch: {lookback_depth(sk1, table.row_shift)}")
        out["bucket_batch_wide"] = bucket
        w1f, w2f = words[0].reshape(-1), words[1].reshape(-1)
        sort_ms = time_synced_ms(lambda: sort_stream_wide(w1f, w2f, w))
        print(f"phase 2 (k=25): sort_stream_wide (torch.sort, not a kernel "
              f"of the port) {sort_ms:.4f} ms, host enqueue included")
        fill = batch_stream(np.random.default_rng(SEED + 3), dev)
        slots = fill_table(planes, seed_batch, fill,
                           "phase 2 (k=25, fuller fill)")
        _, (sk1, sk2, _), scan = stream(next(fill))
        full = bucket_out(sk1, sk2, scan, "phase 2 (k=25, fuller fill)")
        out["bucket_batch_wide"]["full_fill"] = dict(slots=slots, **full)
        report(out, "phase 2 (k=25)")
        report({"bucket_batch_wide": full},
               f"phase 2 (k=25, fuller fill, {slots:,} slots)")
        del state, planes, fill
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()
    return out


def lookback_depth(skey, shift: int) -> str:
    """How far back the scan's look-back must reach on a sorted stream:
    for each tile after the first, the distance to the nearest earlier tile
    that holds a row change (a look-back stops there at the latest)."""
    from nomalise_kmers_multi_large_torch.ops.segscan import _TILE

    row = (skey.to(torch.int64) & 0xFFFFFFFF) >> shift
    n_tiles = -(-row.numel() // _TILE)
    rch = torch.zeros(n_tiles * _TILE, dtype=torch.bool, device=row.device)
    rch[0] = True
    rch[1:row.numel()] = row[1:] != row[:-1]
    idx = torch.arange(n_tiles, device=row.device)
    last = torch.cummax(torch.where(rch.view(n_tiles, _TILE).any(1), idx, -1),
                        0).values
    depth = (idx[1:] - last[:-1]).float()
    return (f"mean {float(depth.mean()):.3f}, max {int(depth.max())} tiles "
            f"of {_TILE:,}")


def phase_scan_long(dev):
    """K3 and K3w once each on a stream of LONG_SCAN + LONG_RUN elements
    (far more tiles than the card holds at once) in which one code repeats
    LONG_RUN times, so its rank saturates at 65535 through the look-back:
    equal to the plain version exactly."""
    from nomalise_kmers_multi_large_torch.ops.segscan import (
        _TILE, rank_cand_scan, rank_cand_scan_plain,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    key = torch.randint(0, 1 << 24, (LONG_SCAN,), device=dev, generator=g)
    run = torch.full((LONG_RUN,), 1 << 23, device=dev)
    key2 = torch.randint(0, 3, (LONG_SCAN,), device=dev, generator=g)
    # sort by (key, key2); the repeated code keeps key2 = 0
    packed = torch.sort(torch.cat([(key << 2) | key2, run << 2])).values
    key, key2 = packed >> 2, packed & 3
    key[-1000:], key2[-1000:] = 0xFFFFFFFF, 0xFFFFFFFF  # sentinels
    sk, sk2 = (x.to(torch.int32) for x in (key, key2))
    srid = torch.randint(0, BATCH_READS, (sk.numel(),), device=dev,
                         generator=g, dtype=torch.int32)
    errs = {}
    for name, kw in (("rank_cand_scan", dict(fp_bits=9)),
                     ("rank_cand_scan_wide", dict(fp_bits=0, skey2=sk2,
                                                  row_shift=17))):
        got = rank_cand_scan(sk, srid, n_reads=BATCH_READS, **kw)
        want = rank_cand_scan_plain(sk, srid, n_reads=BATCH_READS, **kw)
        errs[name] = max_abs_err(zip(got, want))
        top = int((got[0] & 0xFFFF).max())
        if errs[name] or top != 65535:
            raise AssertionError(f"{name} on the long stream: max_abs_err "
                                 f"{errs[name]}, highest rank {top}")
    print(f"phase 2 (long stream): {sk.numel():,} elements in "
          f"{-(-sk.numel() // _TILE):,} tiles, one code {LONG_RUN:,} times "
          f"(rank saturates at 65535): max_abs_err {errs}")
    del key, key2, packed, sk, sk2, srid, got, want
    torch.cuda.empty_cache()


def phase_kernels_large(rng, dev):
    """K3w and K5 against their plain versions on wide tables past the old
    2^21-row ceiling (LARGE_ROW_SHIFTS), at k = 25: three batches seeded by
    the kernels, then one batch scanned and upserted (count mode) by the
    kernels and by the plain versions on a copy of the planes. Exact
    equality; no timing."""
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        bucket_upsert_wide, bucket_upsert_wide_plain, sort_stream_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        encode_keys_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.segscan import (
        rank_cand_scan, rank_cand_scan_plain,
    )
    from nomalise_kmers_multi_large_torch.table.bucket import BucketTableWide

    k, reads, depth = 25, BATCH_READS, 100
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    batches = read_batches(rng, dev, 4)
    for row_shift in LARGE_ROW_SHIFTS:
        table = BucketTableWide(k, rows=1 << (32 - row_shift), device=dev)
        state = table.init()
        planes = [state.keys, state.keys2, state.counts]
        kw = dict(row_shift=row_shift, depth=depth, n_reads=reads)
        scan_kw = dict(fp_bits=0, n_reads=reads, row_shift=row_shift)
        for i, bases in enumerate(batches):
            w1, w2 = encode_keys_wide(bases, lengths, k, False)
            sk1, sk2, srid = sort_stream_wide(w1.reshape(-1), w2.reshape(-1),
                                              w1.shape[1])
            scan = rank_cand_scan(sk1, srid, skey2=sk2, **scan_kw)
            if i < 3:
                bucket_upsert_wide(*planes, sk1, sk2, *scan, seed=True, **kw)
        err = {"rank_cand_scan_wide": max_abs_err(zip(
            scan, rank_cand_scan_plain(sk1, srid, skey2=sk2, **scan_kw)))}
        seeded = int((state.keys != 0).sum())
        twins = [x.clone() for x in planes]
        got = bucket_upsert_wide(*planes, sk1, sk2, *scan, seed=False, **kw)
        want = bucket_upsert_wide_plain(*twins, sk1, sk2, *scan, seed=False,
                                        **kw)
        err["bucket_batch_wide"] = max_abs_err([*zip(planes, twins),
                                                *zip(got, want)])
        print(f"phase 2 (row_shift {row_shift}): k={k} table "
              f"{table.rows:,} rows x {table.lanes} lanes "
              f"({3 * 4 * table.capacity:,} bytes of planes), {seeded:,} "
              f"slots seeded by 3 batches; a batch of {reads:,} reads: "
              f"inserted {int(got[1][1]):,}, dropped {int(got[1][0]):,}, "
              f"high windows {int(got[0].sum()):,}; max_abs_err {err}")
        if any(err.values()) or int(got[1][1]) == 0:
            raise AssertionError(f"row_shift {row_shift}: a wide kernel "
                                 f"disagrees with its plain version: {err}")
        del state, planes, twins, got, want
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()


def check_work(code_rows: torch.Tensor, fp_planes, stream_words: int,
               n_elems: int) -> tuple[int, str]:
    """Bytes the check pass of one batch needs, from its data: every
    element's sort words (to find the rows' ends); the count (p3) and one
    lane of plane A of each touched row (lane lanes - d is empty, d the
    row's distinct codes, exactly when occupancy + d <= lanes); and, for a
    row where it is occupied, its occupied lanes of each plane.
    `code_rows`: the row of each distinct code of the batch; `fp_planes`:
    the fingerprint planes before the batch."""
    lanes = fp_planes[0].shape[1]
    touched, d = torch.unique(code_rows, return_counts=True)
    occ = (fp_planes[0][touched] != 0).sum(1)
    slow = occ + d > lanes
    total = (4 * stream_words * n_elems + 8 * touched.numel()
             + 4 * len(fp_planes) * int(occ[slow].sum()))
    return total, (f"{touched.numel():,} rows touched, {int(slow.sum()):,} "
                   f"of them with lane lanes - d occupied")


def phase_gate(rng, dev) -> dict:
    """The check kernels against their plain versions, and K4/K5 behind
    the gate, at k = 15 and 25 on main-path batches (the module
    docstring's phase 2); the check timed on the batch that fits."""
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        Gate, bucket_overflow_check, bucket_overflow_check_plain,
        bucket_overflow_check_wide, bucket_overflow_check_wide_plain,
        bucket_upsert, bucket_upsert_plain, bucket_upsert_wide,
        bucket_upsert_wide_plain, sort_stream, sort_stream_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        encode_keys, encode_keys_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
    from nomalise_kmers_multi_large_torch.table.bucket import (
        BucketTable, BucketTableWide,
    )

    reads = BATCH_READS
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    batches = read_batches(rng, dev, 6)
    out = {}
    for k in (15, 25):
        wide = k > 15
        name = GATE_KERNELS[k]
        check, check_plain = (
            (bucket_overflow_check_wide, bucket_overflow_check_wide_plain)
            if wide else (bucket_overflow_check, bucket_overflow_check_plain))
        upsert, upsert_plain = ((bucket_upsert_wide, bucket_upsert_wide_plain)
                                if wide else
                                (bucket_upsert, bucket_upsert_plain))

        def make(rows):
            table = (BucketTableWide if wide else BucketTable)(
                k, rows=rows, device=dev)
            st = table.init()
            planes = [st.keys, st.keys2, st.counts] if wide else \
                [st.keys, st.counts]
            return table, planes

        def shift(table):
            return ({"row_shift": table.row_shift} if wide
                    else {"fp_bits": table.fp_bits})

        def stream(table, bases):
            if wide:
                w1, w2 = encode_keys_wide(bases, lengths, k, False)
                sk1, sk2, srid = sort_stream_wide(
                    w1.reshape(-1), w2.reshape(-1), w1.shape[1])
                return (sk1, sk2), rank_cand_scan(
                    sk1, srid, fp_bits=0, n_reads=reads, skey2=sk2,
                    row_shift=table.row_shift)
            key = encode_keys(bases, lengths, k, False)
            rid = torch.arange(key.numel(), device=dev) // key.shape[1]
            skey, srid = sort_stream(key.reshape(-1), rid)
            return (skey,), rank_cand_scan(skey, srid, fp_bits=table.fp_bits,
                                           n_reads=reads)

        def run_check(fn, table, planes, words, scan, flag, ticket):
            fn(*planes[:len(planes) - 1], *words, *scan, Gate(flag, ticket),
               **shift(table))

        def run_upsert(fn, table, planes, words, scan, seed, flag=None):
            return fn(*planes, *words, *scan, depth=100, seed=seed,
                      n_reads=reads, gate=flag, **shift(table))

        def flags(table, planes, words, scan, start, ticket):
            """(kernel's, plain version's) gate after the check from an
            open (start 0) or closed gate."""
            got = []
            for fn in (check, check_plain):
                flag = torch.full((1,), start, dtype=torch.int32, device=dev)
                run_check(fn, table, planes, words, scan, flag, ticket)
                got.append(int(flag))
            return got

        def code_rows(table, words):
            """The row of each distinct code of a sorted stream."""
            w = [x.to(torch.int64) & 0xFFFFFFFF for x in words]
            if wide:
                ok = w[1] != 0xFFFFFFFF
                codes = torch.unique((w[0][ok] << 32) | w[1][ok])
                return codes >> (32 + table.row_shift)
            ok = (w[0] != 0xFFFFFFFF) & ((w[0] >> table.fp_bits) < table.rows)
            return torch.unique(w[0][ok]) >> table.fp_bits

        # fits: the phase 2 table after a 4-batch seed pass
        table, planes = make(TABLE_ROWS)
        for bases in batches[:4]:
            run_upsert(upsert, table, planes, *stream(table, bases), True)
        words, scan = stream(table, batches[4])
        fits = flags(table, planes, words, scan, 0, 5)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        flush = l2_flush(dev)

        def setup():
            flush()
            flag.zero_()

        fp_planes = planes[:2] if wide else planes[:1]
        nbytes, detail = check_work(code_rows(table, words), fp_planes,
                                    len(words), words[0].numel())
        row = timed(name,
                    lambda: run_check(check, table, planes, words, scan,
                                      flag, 5),
                    lambda: run_check(check_plain, table, planes, words,
                                      scan, flag, 5),
                    nbytes, 0, setup=setup, flushed=True)
        twins = [None if x is None else x.clone() for x in planes]
        flag.zero_()
        got = run_upsert(upsert, table, planes, words, scan, False, flag)
        want = run_upsert(upsert_plain, table, twins, words, scan, False)
        fits_err = max_abs_err([*((a, b) for a, b in zip(planes, twins)
                                  if a is not None), *zip(got, want)])
        # sticky: a later batch behind a gate closed with ticket 3
        words, scan = stream(table, batches[5])
        sticky = flags(table, planes, words, scan, 3, 9)
        start = [None if x is None else x.clone() for x in planes]
        flag.fill_(3)
        got = run_upsert(upsert, table, planes, words, scan, False, flag)
        sticky_err = max_abs_err([*((a, b) for a, b in zip(planes, start)
                                    if a is not None), (got[1], 0 * got[1])])
        del table, planes, twins, start
        torch.cuda.empty_cache()

        # overflows: a GATE_ROWS-row table seeded by one batch
        table, planes = make(GATE_ROWS)
        run_upsert(upsert, table, planes, *stream(table, batches[0]), True)
        words, scan = stream(table, batches[4])
        over = flags(table, planes, words, scan, 0, 7)
        start = [None if x is None else x.clone() for x in planes]
        flag.fill_(7)
        got = run_upsert(upsert, table, planes, words, scan, False, flag)
        over_err = max_abs_err([*((a, b) for a, b in zip(planes, start)
                                  if a is not None),
                                (got[0], 0 * got[0]), (got[1], 0 * got[1])])
        dropped = int(run_upsert(upsert_plain, table, start, words, scan,
                                 False)[1][0])
        del table, planes, start
        torch.cuda.empty_cache()

        row["max_abs_err"] = err = max(
            abs(a - b) for a, b in (fits, sticky, over))
        print(f"phase 2 (gate, k={k}): {name}: gate after the check "
              f"(kernel, plain): batch that fits {fits}, behind a closed "
              f"gate {sticky}, batch that overflows a {GATE_ROWS:,}-row table "
              f"{over} (the ungated plain version drops {dropped:,} "
              f"inserts there); K4/K5 behind the gate: open equal to "
              f"ungated plain {fits_err}, closed unchanged {sticky_err} "
              f"and {over_err} (max_abs_err); work: {detail}")
        if err or fits != [0, 0] or sticky != [3, 3] or over != [7, 7] \
                or dropped == 0 or fits_err or sticky_err or over_err:
            raise AssertionError(f"{name}: the gate disagrees with the "
                                 "plain version")
        out[name] = row
        report({name: row}, f"phase 2 (gate, k={k})")
    del batches
    torch.cuda.empty_cache()
    return out


def phase_golden(k: int, case: str, table: str = "auto"):
    from nomalise_kmers_multi_large_torch import cli

    out = os.path.join(WORK, f"golden_{case}_{table}")
    data = os.path.join(ROOT, "tests", "data")
    rc = cli.main(["-f", os.path.join(data, "a1.fasta"),
                   "-r", os.path.join(data, "b1.fasta"), "-t", "fa", "-o",
                   "fa", "-k", str(k), "-d", "4", "--table", table,
                   "--device", "cuda", "--devices", "1", "--out-dir", out])
    if rc != 0:
        raise AssertionError(f"golden CLI run exited {rc}")
    gold = os.path.join(ROOT, "tests", "golden", case)
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm4_thread0.fastq"
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(gold, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"golden mismatch: {case}/{name}")
    print(f"phase {3 if table == 'auto' else 11}: golden {case} "
          f"(--table {table}) byte-identical on cuda")
    shutil.rmtree(out)


def write_inputs(rng):
    f1, f2 = os.path.join(WORK, "r1.fq"), os.path.join(WORK, "r2.fq")
    t0 = time.perf_counter()
    write_pairs(rng, PAIRS, f1, f2)
    print(f"phase 4: wrote {PAIRS:,} pairs of 2 x 150 bp FASTQ "
          f"({os.path.getsize(f1) * 2 / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; size cuts: none")
    # the first pairs, for the CPU plain path
    sub = []
    for src, name in ((f1, "c1.fq"), (f2, "c2.fq")):
        dst = os.path.join(WORK, name)
        with open(src, "rb") as a, open(dst, "wb") as b:
            b.write(a.read(CHECK_PAIRS * 315))   # 315-byte records
        sub.append(dst)
    return (f1, f2), tuple(sub)


def run_engine(k: int, device, files, sub: str, extra=(), run=True,
               devices=None):
    """Normalizer.run() at -k `k` with the reference defaults on `files`
    (forward, reverse; either may be a list of files) and the options
    `extra`, writing under WORK; returns (normalizer, report, out dir, the
    table's first descriptor). With run=False the normalizer is returned
    unrun (report None). With `devices` (a list), the MeshNormalizer on
    them instead (phase 12)."""
    from nomalise_kmers_multi_large_torch.cli import config_from_args
    from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
    from nomalise_kmers_multi_large_torch.parallel.engine import (
        MeshNormalizer,
    )

    fwd, rev = ([f] if isinstance(f, str) else list(f) for f in files)
    out = os.path.join(WORK, f"k{k}_{sub}")
    cfg, _ = config_from_args(["-f", *fwd, "-r", *rev, "-k", str(k),
                               "-d", "100", "-g", "0.9", "-p", "1",
                               "--batch-reads", "8192", "-e",
                               "--out-dir", out, *extra])
    norm = (Normalizer(cfg, device) if devices is None
            else MeshNormalizer(cfg, devices))
    t0 = norm.tables[0]
    rep = norm.run() if run else None
    return norm, rep, out, t0


def spectrum_of(norm):
    """(distinct, total, histogram) of shard 0's table."""
    from nomalise_kmers_multi_large_torch.models.spectrum import spectrum

    sp = spectrum(norm.tables[0], norm.states[0])
    return sp.distinct_kmers, sp.total_kmers, sp.histogram.tolist()


def kept_ids(out: str, k: int) -> np.ndarray:
    """Pair ids of the kept forward records of a run on this script's
    FASTQ (fixed 315-byte records @p<7-digit id>/1)."""
    path = os.path.join(out, f"output_forward.k{k}_norm100_thread0.fastq")
    rec = np.fromfile(path, np.uint8).reshape(-1, 315)
    return (rec[:, 1:8].astype(np.int64) - 48) @ 10 ** np.arange(6, -1, -1)


def require_launches(label: str, k: int, gated: bool = True) -> dict:
    """The launch counts since the last reset; fails unless every kernel of
    the k path launched. Not `gated` (Mode B's row-sharded table): the
    check pass must not have launched, and the others must."""
    from nomalise_kmers_multi_large_torch import backend

    launches = backend.launches()
    kk = 15 if k <= 15 else 25
    path = PATH_KERNELS[kk]
    gate = GATE_KERNELS[kk]
    missing = [n for n in path if launches[n] == 0 and (gated or n != gate)]
    if missing or (not gated and launches[gate]):
        raise AssertionError(f"{label}: kernels never launched on the k={k} "
                             f"path: {missing}; check passes {launches[gate]}"
                             f" ({'gated' if gated else 'ungated'})")
    return {n: launches[n] for n in path}


def totals(rep) -> tuple[int, int, int]:
    return rep.total_processed, rep.total_printed, rep.max_total_kmers


def phase_main(dev, k: int, files, check_files, label: str):
    """The engine at -k `k` on the phase-4 files; returns the launches of
    the run, its totals (processed, printed, distinct k-mers) and, for
    phase 8, its final table planes and kept pair ids."""
    from nomalise_kmers_multi_large_torch import backend

    backend.reset_launches()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    norm, rep, out, first = run_engine(k, dev, files, "main")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rows0 = first.rows
    launches = require_launches(label, k)
    t = norm.tables[0]
    st = norm.states[0]
    slot_bytes = 12 if k > 16 else 8
    print(f"{label}: k={k}: {rep.total_processed:,} pairs in {wall:.2f} s = "
          f"{rep.total_processed / wall:,.0f} pairs/s "
          f"({2 * rep.total_processed / wall:,.0f} reads/s), seed pass "
          f"included; processed {rep.total_processed:,}, printed "
          f"{rep.total_printed:,}, skipped {rep.total_skipped:,}; "
          f"unique k-mers {rep.max_total_kmers:,}; table grew from "
          f"{rows0:,} to {t.rows:,} rows x {t.lanes} lanes = "
          f"{t.rows * t.lanes * slot_bytes:,} bytes of fingerprint and count "
          f"planes; launches {launches}")
    print(f"{label}: k={k}: peak device memory of the run "
          f"(torch.cuda.max_memory_allocated()) {peak:,} bytes = "
          f"{peak / 2 ** 30:.3f} GiB, of which {before:,} bytes were "
          f"allocated before it")
    if rep.total_processed != PAIRS or \
            rep.total_printed + rep.total_skipped != PAIRS:
        raise AssertionError(f"{label} totals do not add up")
    if int(st.overflow) != 0 or rep.max_total_kmers <= 0:
        raise AssertionError(f"{label} table dropped inserts or is empty")
    if t.rows <= rows0:
        raise AssertionError(f"{label} table never grew from {rows0} rows")
    name = f"output_forward.k{k}_norm100_thread0.fastq"
    with open(os.path.join(out, name), "rb") as f:
        lines = sum(buf.count(b"\n") for buf in iter(lambda: f.read(1 << 24),
                                                      b""))
    if lines != 4 * rep.total_printed:
        raise AssertionError(f"{lines} output lines for "
                             f"{rep.total_printed} printed pairs")
    # phase 11 holds the fallback tables to these outputs and this spectrum
    exact = dict(state=st, rows=t.rows, kept=kept_ids(out, k),
                 digests=output_digests(out), spectrum=spectrum_of(norm),
                 wall=wall)

    # the same engine on the CPU plain path, on the first pairs
    outs = [run_engine(k, d, check_files, f"check_{d}")[2]
            for d in ("cuda", "cpu")]
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm100_thread0.fastq"
        a, b = (open(os.path.join(o, name), "rb").read() for o in outs)
        if a != b:
            raise AssertionError(f"cuda and cpu outputs differ: {name}")
    print(f"{label}: k={k}: first {CHECK_PAIRS:,} pairs: cuda and cpu plain "
          "path outputs byte-identical")
    for o in outs + [out]:
        shutil.rmtree(o)
    return launches, totals(rep), exact


def phase_profile(dev, k: int, files, want: tuple, launches: dict,
                  label: str):
    """One whole run of the engine at -k `k` on the phase-4 files under
    torch.profiler; its totals must equal `want`, the unprofiled run's, and
    the profile must hold every launch of the path's kernels that the
    unprofiled run counted (`launches`), or it lost device events: then
    the run is profiled again, PROFILE_ATTEMPTS times at most."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, rep, out, _ = run_engine(k, dev, files, "profile")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        shutil.rmtree(out)
        if totals(rep) != want:
            raise AssertionError(f"{label}: profiled totals {totals(rep)} "
                                 f"!= the unprofiled run's {want}")
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {name: sum(f"::{KERNEL_FUNCTIONS[name]}(" in e[0]
                          for e in events) for name in launches}
        if seen == launches:
            break
        print(f"{label}: k={k}: the profile holds {seen} of the launches "
              f"{launches}: it lost device events; profiling again")
    else:
        raise AssertionError(f"{label}: {PROFILE_ATTEMPTS} profiles lost "
                             "device events")
    busy = busy_us([(a, b) for _, a, b in events]) / 1e6
    print(f"{label}: k={k}: profiled run, totals and launches as "
          f"unprofiled {want}: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"idle {1 - busy / wall:.1%} ({len(events):,} device events)")
    ranked = by_name(events)
    tags = [f"::{KERNEL_FUNCTIONS[n]}(" for n in launches]
    for name, us, count in ranked[:15] + [
            x for x in ranked[15:] if any(t in x[0] for t in tags)]:
        print(f"{label}:   {us / 1e3:9.3f} ms  {count:6d} x "
              f"{us / 1e3 / count:8.4f} ms  {name[:90]}")


def phase_ceiling(dev, files):
    """-k 25 on phase 4's file pair and a second one of PAIRS pairs from its
    own generator: the wide table must grow past OLD_CEILING_ROWS and drop
    nothing."""
    from nomalise_kmers_multi_large_torch import backend

    f3, f4 = (os.path.join(WORK, name) for name in ("s1.fq", "s2.fq"))
    t0 = time.perf_counter()
    write_pairs(np.random.default_rng(SEED + 2), PAIRS, f3, f4)
    print(f"phase 7: wrote a second {PAIRS:,}-pair file pair in "
          f"{time.perf_counter() - t0:.1f} s")
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    norm, rep, out, first = run_engine(25, dev, ([files[0], f3],
                                                 [files[1], f4]), "ceiling")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows0 = first.rows
    launches = require_launches("phase 7", 25)
    t, st = norm.tables[0], norm.states[0]
    print(f"phase 7: k=25: {rep.total_processed:,} pairs in {wall:.2f} s "
          f"({rep.total_processed / wall:,.0f} pairs/s), seed pass "
          f"included; printed {rep.total_printed:,}, skipped "
          f"{rep.total_skipped:,}; distinct k-mers {rep.max_total_kmers:,}; "
          f"table grew from {rows0:,} to {t.rows:,} rows x {t.lanes} lanes = "
          f"{12 * t.capacity:,} bytes of planes; overflow "
          f"{int(st.overflow)}; peak device memory "
          f"{torch.cuda.max_memory_allocated():,} bytes; launches {launches}")
    if t.rows <= OLD_CEILING_ROWS:
        raise AssertionError(f"phase 7: the table stayed at {t.rows:,} rows")
    if int(st.overflow) != 0:
        raise AssertionError(f"phase 7: {int(st.overflow):,} inserts dropped")
    if not rep.total_processed == rep.total_printed + rep.total_skipped \
            == 2 * PAIRS:
        raise AssertionError("phase 7: totals do not add up")
    del norm, st
    for path in (out, f3, f4):
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    torch.cuda.empty_cache()


def phase_relaxed(dev, files, exact: dict, want: dict):
    """--mode relaxed on phase 4's input at k = 15 and 25: the planes equal
    the exact runs' lane for lane, and the decisions change for at most
    RELAXED_MAX_DELTA of the pairs. Then the sort of one main-path batch
    in both modes."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        sort_stream, sort_stream_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        encode_keys, encode_keys_wide,
    )

    for k in (15, 25):
        backend.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        norm, rep, out, _ = run_engine(k, dev, files, "relaxed",
                                       ["--mode", "relaxed"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = require_launches("phase 8", k)
        st, ex = norm.states[0], exact[k]
        same = norm.tables[0].rows == ex["rows"] and all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(st[:2] + st[4:], ex["state"][:2]
                            + ex["state"][4:]))
        delta = int(np.setxor1d(kept_ids(out, k), ex["kept"]).size)
        print(f"phase 8: k={k} relaxed: {rep.total_processed:,} pairs in "
              f"{wall:.2f} s; printed {rep.total_printed:,} (exact "
              f"{want[k][1]:,}), decision delta {delta:,} pairs "
              f"({delta / PAIRS:.4%}); distinct k-mers "
              f"{rep.max_total_kmers:,} (exact {want[k][2]:,}); planes "
              f"equal to the exact run's: {same}; launches {launches}")
        shutil.rmtree(out)
        if not same:
            raise AssertionError(f"phase 8: k={k}: relaxed planes differ")
        if (rep.total_processed, rep.max_total_kmers) != \
                (want[k][0], want[k][2]):
            raise AssertionError(f"phase 8: k={k}: totals differ")
        if delta > RELAXED_MAX_DELTA * PAIRS:
            raise AssertionError(f"phase 8: k={k}: {delta} decisions changed")
        del norm, st
        torch.cuda.empty_cache()

    reads = BATCH_READS
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    bases = read_batches(np.random.default_rng(SEED + 6), dev, 1)[0]
    key = encode_keys(bases, lengths, 15, False)
    rid = torch.arange(key.numel(), device=dev) // key.shape[1]
    w1, w2 = encode_keys_wide(bases, lengths, 25, False)
    sorts = {
        "sort_stream": [time_synced_ms(lambda r=r: sort_stream(
            key.reshape(-1), rid, r), iters=10) for r in (False, True)],
        "sort_stream_wide": [time_synced_ms(lambda r=r: sort_stream_wide(
            w1.reshape(-1), w2.reshape(-1), w1.shape[1], r), iters=10)
            for r in (False, True)],
    }
    for name, (ems, rms) in sorts.items():
        print(f"phase 8: {name} on one batch of {reads:,} reads "
              f"(torch.sort, not a kernel of the port; host enqueue "
              f"included): exact {ems:.4f} ms, relaxed {rms:.4f} ms")


def phase_checkpoint(dev, check_files):
    """The first CHECK_PAIRS pairs at k = 15 and 25 with checkpoints after
    every batch, interrupted after CKPT_STOP_AFTER retires and resumed on
    cuda, and from the same checkpoint on the cpu: both byte-identical to
    an uninterrupted cuda run."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer

    batch = ["--batch-reads", str(CKPT_BATCH_PAIRS), "-d", str(CKPT_DEPTH)]
    for k in (15, 25):
        ckpt = os.path.join(WORK, f"ckpt{k}")
        extra = batch + ["--checkpoint-every", "1", "--checkpoint-dir", ckpt]
        names = [f"{b}.k{k}_norm{CKPT_DEPTH}_thread0.fastq"
                 for b in ("output_forward", "output_reverse")]

        def outputs(out):
            return [open(os.path.join(out, n), "rb").read() for n in names]

        backend.reset_launches()
        _, full_rep, full_out, _ = run_engine(k, dev, check_files, "ck_full",
                                              batch)
        want = outputs(full_out)
        norm, _, part_out, _ = run_engine(k, dev, check_files, "ck_part",
                                          extra, run=False)
        calls, orig = [0], Normalizer._retire

        def bomb(self, *a):
            r = orig(self, *a)
            calls[0] += 1
            if calls[0] == CKPT_STOP_AFTER:
                raise KeyboardInterrupt
            return r

        Normalizer._retire = bomb
        try:
            norm.run()
            raise AssertionError("phase 9: the run was not interrupted")
        except KeyboardInterrupt:
            pass
        finally:
            Normalizer._retire = orig
        del norm
        with open(os.path.join(ckpt, "manifest.json")) as f:
            done = json.load(f)["records_done"]
        saved = os.path.join(WORK, f"ckpt{k}_saved")
        shutil.copytree(ckpt, os.path.join(saved, "ckpt"))
        shutil.copytree(part_out, os.path.join(saved, "out"))
        got = {}
        for device in ("cuda", "cpu"):
            if device == "cpu":  # the checkpoint and outputs as interrupted
                for src, dst in (("ckpt", ckpt), ("out", part_out)):
                    shutil.rmtree(dst)
                    shutil.copytree(os.path.join(saved, src), dst)
            rep = run_engine(k, device, check_files, "ck_part",
                             extra + ["--resume"])[1]
            got[device] = (outputs(part_out), totals(rep))
        launches = require_launches("phase 9", k)
        ok = {d: g == (want, totals(full_rep)) for d, g in got.items()}
        print(f"phase 9: k={k} -d {CKPT_DEPTH}: uninterrupted: printed "
              f"{full_rep.total_printed:,}, skipped {full_rep.total_skipped:,};"
              f" interrupted after {CKPT_STOP_AFTER} retires, checkpoint at "
              f"{done:,} pairs; resumed on cuda and on cpu from it, outputs "
              f"and totals equal to the uninterrupted cuda run's: {ok}; "
              f"launches {launches}")
        if not all(ok.values()) or not 0 < done < CHECK_PAIRS \
                or not full_rep.total_skipped:
            raise AssertionError(f"phase 9: k={k}: resume differs: {ok}")
        for path in (ckpt, saved, full_out, part_out):
            shutil.rmtree(path)


def phase_debug(dev):
    """--debug 4 on tests/data/{a1,b1}.fasta at -k 15 -d 4, on cuda and on
    cpu: the same stdout but for the wall-clock lines; the round-trip holds
    the CUDA encode kernel against the codec on every batch."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.cli import config_from_args
    from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
    from nomalise_kmers_multi_large_torch.engine.report import (
        without_clock_lines,
    )

    data = os.path.join(ROOT, "tests", "data")
    lines = {}
    for device in ("cuda", "cpu"):
        cfg, _ = config_from_args([
            "-f", os.path.join(data, "a1.fasta"), "-r",
            os.path.join(data, "b1.fasta"), "-t", "fa", "-o", "fa", "-k",
            "15", "-d", "4", "--debug", "4",
            "--out-dir", os.path.join(WORK, f"debug_{device}")])
        backend.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            Normalizer(cfg, device).run()
        wall = time.perf_counter() - t0
        if device == "cuda":
            launches = require_launches("phase 10", 15)
        lines[device] = without_clock_lines(buf.getvalue())
        print(f"phase 10: --debug 4 on {device}: {len(lines[device]):,} "
              f"stdout lines in {wall:.2f} s")
    same = lines["cuda"] == lines["cpu"]
    upserts = sum(ln.startswith("DEBUG: ") for ln in lines["cuda"])
    print(f"phase 10: cuda and cpu stdout equal line for line: {same} "
          f"({upserts:,} per-upsert lines); round-trip passed on every "
          f"batch; cuda launches {launches}")
    if not same or not upserts:
        raise AssertionError("phase 10: cuda and cpu debug output differ")


def phase_hashed_kernel(rng, dev) -> dict:
    """The hashed table's find-or-insert kernel against its plain version
    on one k = 25 batch into a HASH_SLOTS table, after a 4-batch seed pass
    and again at HASH_LOAD: the same (code, count) sets, new and unresolved
    codes and observed counts; then both timed from the same planes. Also
    (not timed) on Mode B's slot shard: the last of MESH_SHARDS shards of
    HASH_SLOTS slots, fed the codes of the same batches that it owns."""
    from nomalise_kmers_multi_large_torch.ops import codec
    from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
        hashed_insert, hashed_insert_plain,
    )
    from nomalise_kmers_multi_large_torch.ops.streamrank import (
        sorted_occurrence_stream,
    )
    from nomalise_kmers_multi_large_torch.parallel.modes import (
        SlotShardedHashedTable,
    )
    from nomalise_kmers_multi_large_torch.table import HashedTable

    k, reads = 25, BATCH_READS
    batches = read_batches(rng, dev, 5)
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)

    def stream(bases):
        code = codec.window_codes(bases, k, False)
        valid = codec.code_validity(lengths, code, k)
        return sorted_occurrence_stream(code.reshape(-1), valid.reshape(-1))

    keys = torch.zeros(HASH_SLOTS, dtype=torch.int64, device=dev)
    counts = torch.zeros(HASH_SLOTS, dtype=torch.int32, device=dev)
    for bases in batches[:4]:  # seed pass: count-0 inserts of the heads
        s = stream(bases)
        hashed_insert(keys, torch.where(s.boundary, s.code, 0),
                      outputs=False)
    s = stream(batches[4])
    heads = torch.where(s.boundary, s.code, 0)
    n = heads.numel()
    pos = torch.arange(n, device=dev)

    def observed(out):
        # a run's head sits rank - 1 places before each of its occurrences
        return torch.where(s.valid, out.prior[pos - s.rank + 1] + s.rank, 0)

    def table(kp, cp):
        occ = kp != 0
        code, order = torch.sort(kp[occ])
        return code, cp[occ][order]

    def check(label) -> dict:
        start = (keys.clone(), counts.clone())
        twins = (keys.clone(), counts.clone())

        def reset():
            keys.copy_(start[0])
            counts.copy_(start[1])

        used = int((keys != 0).sum())
        got = hashed_insert(keys, heads, s.mult, counts)
        want = hashed_insert_plain(twins[0], heads, s.mult, twins[1])
        err = max_abs_err([*zip(table(keys, counts), table(*twins)),
                           (got.stats[:2], want.stats[:2]),
                           (observed(got), observed(want))])
        new, over, probes = (int(x) for x in got.stats)
        n_heads = int(s.boundary.sum())
        # streamed: code (8 B) and mult (4 B) in, slot and prior (4 B
        # each) out, every element; random 32 B sectors: one per probe of
        # keys, and a resolved head's count sector read and written back
        nbytes = 20 * n + 32 * probes + 64 * (n_heads - over)
        print(f"{label}: {used:,} of {HASH_SLOTS:,} slots used "
              f"({used / HASH_SLOTS:.3f} load); a batch of {reads:,} reads: "
              f"{n:,} windows, {n_heads:,} distinct codes, {new:,} new, "
              f"{over:,} unresolved, {probes:,} probes "
              f"({probes / max(n_heads, 1):.3f} a code); {nbytes:,} bytes "
              f"of work; max_abs_err {err}")
        del twins, want
        out = timed("hashed_insert",
                    lambda: hashed_insert(keys, heads, s.mult, counts),
                    lambda: hashed_insert_plain(keys, heads, s.mult, counts),
                    nbytes, err, setup=reset)
        reset()
        del start
        out.update(load=used / HASH_SLOTS, probes=probes, distinct=n_heads)
        return out

    out = {"hashed_insert": check("phase 11 (kernel, 4-batch fill)")}

    # Mode B's slot shard: the last of MESH_SHARDS shards of a HASH_SLOTS
    # table, fed only the codes it owns (the top bits of their slot hash)
    whole = SlotShardedHashedTable(HashedTable(k, HASH_SLOTS),
                                   [dev] * MESH_SHARDS)
    j = MESH_SHARDS - 1
    shard = whole.shards[j].init()
    for bases in batches[:4]:
        sb = stream(bases)
        hashed_insert(shard.keys, torch.where(
            sb.boundary & (whole.owner(sb.code) == j), sb.code, 0),
            outputs=False)
    mine = whole.owner(heads) == j
    own_heads = torch.where(mine, heads, 0)
    own_mult = torch.where(mine, s.mult, 0)
    twins = (shard.keys.clone(), shard.counts.clone())
    got = hashed_insert(shard.keys, own_heads, own_mult, shard.counts)
    want = hashed_insert_plain(twins[0], own_heads, own_mult, twins[1])
    err = max_abs_err([*zip(table(shard.keys, shard.counts), table(*twins)),
                       (got.stats[:2], want.stats[:2]),
                       (observed(got), observed(want))])
    held = shard.keys[shard.keys != 0]
    print(f"phase 11 (kernel, slot shard): shard {j} of {MESH_SHARDS} "
          f"({shard.keys.numel():,} slots of {HASH_SLOTS:,}): "
          f"{int(held.numel()):,} codes held, all its own: "
          f"{bool((whole.owner(held) == j).all())}; a batch's "
          f"{int((own_heads != 0).sum()):,} owned distinct codes, "
          f"{int(got.stats[0]):,} new, {int(got.stats[1]):,} unresolved; "
          f"max_abs_err {err}")
    if err or not bool((whole.owner(held) == j).all()):
        raise AssertionError("phase 11: the kernel on a slot shard differs "
                             "from its plain version")
    del shard, twins, got, want, held

    # the fuller fill: random distinct nonzero 50-bit codes (k = 25 codes)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    need = int(HASH_LOAD * HASH_SLOTS) - int((keys != 0).sum())
    fill = torch.unique(torch.randint(1, 1 << 50, (need,), device=dev,
                                      generator=g))
    hashed_insert(keys, fill, outputs=False)
    del fill
    full = check(f"phase 11 (kernel, {HASH_LOAD} load)")
    out["hashed_insert"]["full_fill"] = full
    report(out, "phase 11 (kernel)")
    report({"hashed_insert": full}, f"phase 11 (kernel, {HASH_LOAD} load)")
    del keys, counts, batches
    torch.cuda.empty_cache()
    return out


def phase_hashed_kernel_apart() -> dict:
    """phase_hashed_kernel in a process of its own (this script with
    HASHED_KERNEL_FLAG), whose printed lines it passes on and whose last
    line is the result. Run after phase 10 in the main process, its
    profiles held fewer of the kernel's events than calls, every time; run
    apart, no earlier phase shapes its timing or its profiles."""
    got = subprocess.run([sys.executable, os.path.abspath(__file__),
                          HASHED_KERNEL_FLAG], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    lines = got.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    if got.returncode != 0 or not lines:
        print(got.stdout[-2000:] + got.stderr[-4000:])
        raise AssertionError(f"the kernel check exited {got.returncode}")
    return json.loads(lines[-1])


def phase_fallback(dev, files, check_files, ref: dict):
    """The direct and hashed tables end to end: goldens, phase 4's pairs
    held to phases 4/5 (`ref`: k -> (output digests, spectrum)), the first
    pairs on cuda and cpu, and --table auto above depth 65535. Returns the
    hashed run's launches, and the wall time of each table's 1M-pair run
    (phase 12 prints Mode B's beside it)."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer

    phase_golden(15, "fasta_in_paired_k15", "direct")
    phase_golden(25, "fasta_in_paired_k25_jax", "hashed")

    snaps = []
    orig = Normalizer._replay_snapshot

    def timed_snapshot(self, shard):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        copy = orig(self, shard)
        b.record()
        if copy is not None:
            snaps.append((a, b))
        return copy

    launches, walls = {}, {}
    for table, k, extra in FALLBACK_RUNS:
        opts = ["--table", table, *extra]
        snaps.clear()
        backend.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Normalizer._replay_snapshot = timed_snapshot
        try:
            t0 = time.perf_counter()
            norm, rep, out, first = run_engine(k, dev, files, table, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            Normalizer._replay_snapshot = orig
        peak = torch.cuda.max_memory_allocated()
        got = backend.launches()
        t, st = norm.tables[0], norm.states[0]
        doublings = (t.capacity // first.capacity).bit_length() - 1
        snap_ms = sum(a.elapsed_time(b) for a, b in snaps)
        slot_bytes = 4 if table == "direct" else 12
        same = output_digests(out) == ref[k][0]
        spec = spectrum_of(norm)
        on_card = all(x.device == dev for x in st if x is not None)
        print(f"phase 11: --table {table} -k {k}: {rep.total_processed:,} "
              f"pairs in {wall:.2f} s ({rep.total_processed / wall:,.0f} "
              f"pairs/s), seed pass included; printed {rep.total_printed:,}"
              f"; distinct k-mers {rep.max_total_kmers:,}; table "
              f"{first.capacity:,} -> {t.capacity:,} slots "
              f"({t.capacity * slot_bytes:,} bytes), {doublings} doublings;"
              f" overflow {int(st.overflow)}; peak device memory "
              f"{peak:,} bytes; replay "
              f"snapshots {len(snaps)} x, {snap_ms:.1f} ms of device time; "
              f"outputs equal to phase {4 if k == 15 else 5}'s: {same}; "
              f"spectrum (distinct {spec[0]:,}, total {spec[1]:,}) equal: "
              f"{spec == ref[k][1]}; states on the card: {on_card}; "
              f"launches {got}")
        bucket = [n for n in BUCKET_KERNELS if got[n]]
        if bucket or (got["hashed_insert"] > 0) != (table == "hashed"):
            raise AssertionError(f"phase 11: {table}: launches {got}")
        if not same or spec != ref[k][1] or not on_card:
            raise AssertionError(f"phase 11: {table}: differs from the "
                                 "bucket run, or a state left the card")
        if int(st.overflow) or (table == "hashed" and doublings < 1):
            raise AssertionError(f"phase 11: {table}: overflow "
                                 f"{int(st.overflow)}, {doublings} doublings")
        if table == "hashed":
            launches["hashed_insert"] = got["hashed_insert"]
        walls[table] = wall
        del norm, st
        shutil.rmtree(out)
        torch.cuda.empty_cache()

        outs = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            o = run_engine(k, d, check_files, f"{table}_check_{d}", opts)[2]
            outs[d] = (output_digests(o), time.perf_counter() - t0)
            shutil.rmtree(o)
        same = outs["cuda"][0] == outs["cpu"][0]
        print(f"phase 11: --table {table} -k {k}: first {CHECK_PAIRS:,} "
              f"pairs: cuda ({outs['cuda'][1]:.2f} s) and cpu "
              f"({outs['cpu'][1]:.2f} s) outputs byte-identical: {same}")
        if not same:
            raise AssertionError(f"phase 11: {table}: cuda and cpu differ")

    for k, kind in ((15, "direct"), (25, "hashed")):
        outs = {}
        for d in ("cuda", "cpu"):
            norm, rep, o, _ = run_engine(k, d, check_files, f"auto_{d}",
                                         ["-d", str(AUTO_DEPTH)])
            outs[d] = (norm.cfg.table, output_digests(o), totals(rep))
            shutil.rmtree(o)
            del norm
        ok = outs["cuda"] == outs["cpu"] and outs["cuda"][0] == kind
        print(f"phase 11: --table auto -k {k} -d {AUTO_DEPTH}: resolved to "
              f"{outs['cuda'][0]} (cuda) and {outs['cpu'][0]} (cpu); "
              f"totals {outs['cuda'][2]}; outputs equal: {ok}")
        if not ok:
            raise AssertionError(f"phase 11: auto at k={k}: {outs}")
    return launches, walls


def phase_kernels_row_shard(rng, dev):
    """K4 and K5 on the last row shard of a TABLE_ROWS-row table cut
    MESH_SHARDS ways (TABLE_ROWS / 4 rows with the whole table's
    fingerprint width), as Mode B runs them: the shard's part of four seed
    batches, then of one count batch (BATCH_READS reads x 150 bp, k = 15
    and 25), routed, rebased and sorted by parallel/modes.py, with 1,000
    sentinels after it (whose rows lie past the shard's). Each call equal
    to the plain version on a copy of the planes; no timing."""
    from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
        MAX_READS, bucket_upsert, bucket_upsert_plain, bucket_upsert_wide,
        bucket_upsert_wide_plain, sort_stream, sort_stream_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
        as_int32, encode_keys, encode_keys_wide,
    )
    from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
    from nomalise_kmers_multi_large_torch.parallel.modes import (
        RowShardedBucketTable, owner_edges_narrow, owner_edges_wide,
    )
    from nomalise_kmers_multi_large_torch.table.bucket import (
        BucketTable, BucketTableWide,
    )

    reads, j = BATCH_READS, MESH_SHARDS - 1
    lengths = torch.full((reads,), 150, dtype=torch.int32, device=dev)
    batches = read_batches(rng, dev, 5)
    sent = torch.full((1000,), -1, dtype=torch.int32, device=dev)
    for k, wide in ((15, False), (25, True)):
        whole = (BucketTableWide if wide else BucketTable)(
            k, rows=TABLE_ROWS, device=dev)
        t = RowShardedBucketTable(whole, [dev] * MESH_SHARDS)
        rid = torch.arange(reads, device=dev).repeat_interleave(150 - k + 1)
        pad_rid = torch.zeros(1000, dtype=torch.int64, device=dev)

        def shard_stream(bases):
            base = j * t.span
            if wide:
                w1, w2 = encode_keys_wide(bases, lengths, k, False)
                (sk1, sk2, srid), e = owner_edges_wide(
                    w1.reshape(-1), w2.reshape(-1), rid, MESH_SHARDS, t.span)
                lo, hi = e[j:j + 2].tolist()
                s1 = as_int32((sk1[lo:hi].to(torch.int64) & 0xFFFFFFFF)
                              - base)
                sk1, sk2, srid = sort_stream_wide(
                    torch.cat([s1, sent]), torch.cat([sk2[lo:hi], sent]), 1,
                    rid_flat=torch.cat([srid[lo:hi].to(torch.int64),
                                        pad_rid]))
                return (sk1, sk2, *rank_cand_scan(
                    sk1, srid, fp_bits=0, n_reads=reads, skey2=sk2,
                    row_shift=t.shift))
            key = encode_keys(bases, lengths, k, False)
            packed, e = owner_edges_narrow(key.reshape(-1), rid, MESH_SHARDS,
                                           t.span)
            lo, hi = e[j:j + 2].tolist()
            seg = packed[lo:hi]
            skey, srid = sort_stream(
                torch.cat([as_int32((seg >> 14) - base), sent]),
                torch.cat([seg & (MAX_READS - 1), pad_rid]))
            return (skey, *rank_cand_scan(skey, srid, fp_bits=t.shift,
                                          n_reads=reads))

        st = t.init()
        planes = [st.keys[j]] + ([st.keys2[j]] if wide else []) + \
            [st.counts[j]]
        twins = [x.clone() for x in planes]
        kernel, plain = ((bucket_upsert_wide, bucket_upsert_wide_plain)
                         if wide else (bucket_upsert, bucket_upsert_plain))
        kw = dict(depth=100, n_reads=reads,
                  **({"row_shift": t.shift} if wide else
                     {"fp_bits": t.shift}))
        errs, n_elems = [], 0
        for i, bases in enumerate(batches):
            stream = shard_stream(bases)
            n_elems = stream[0].numel() - 1000
            got = kernel(*planes, *stream, seed=i < 4, **kw)
            want = plain(*twins, *stream, seed=i < 4, **kw)
            errs.append(max_abs_err([*zip(planes, twins), *zip(got, want)]))
        name = "bucket_batch_wide" if wide else "bucket_batch"
        print(f"phase 2 (row shards): {name} k={k} on row shard {j} of "
              f"{MESH_SHARDS} ({t.shard_rows:,} rows of {t.rows:,}, shift "
              f"{t.shift}): {int((planes[0] != 0).sum()):,} slots filled; "
              f"the count batch's {n_elems:,} routed windows + 1,000 "
              f"sentinels: inserted {int(got[1][1]):,}, dropped "
              f"{int(got[1][0]):,}, high {int(got[0].sum()):,}; max_abs_err "
              f"per call {errs}")
        if any(errs) or int(got[1][1]) == 0:
            raise AssertionError(f"{name} on a row shard disagrees with its "
                                 f"plain version: {errs}")
        del st, planes, twins
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()


def _on_card(state) -> bool:
    """Every tensor of a shard state (a plane may be a tuple of row shards)
    on a CUDA device."""
    return all(p.device.type == "cuda" for x in state if x is not None
               for p in (x if isinstance(x, tuple) else (x,)))


def phase_mesh(dev, files, check_files, ref: dict, want: dict, walls: dict,
               fallback_walls: dict):
    """Modes A and B on MESH_SHARDS shards of the one card, --profile and
    two host processes (gloo) on it. `ref`: k -> (output digests, spectrum)
    of phases 4/5; `want`: their totals; `walls`: their wall times;
    `fallback_walls`: phase 11's one-device walls by table."""
    from nomalise_kmers_multi_large_torch import backend, cli
    from nomalise_kmers_multi_large_torch.parallel.mesh import data_devices

    shards = [dev] * MESH_SHARDS
    cards = data_devices(0, "cuda")
    print(f"phase 12: torch.cuda.device_count() {torch.cuda.device_count()}; "
          f"--devices 0 takes {[str(d) for d in cards]}; Modes A and B on "
          f"{MESH_SHARDS} shards of {dev}, one card: this checks the modes "
          "and the exchange's cost on one card, not NVLink or scaling")

    def mode_b(k, devices, files, sub):
        backend.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        norm, rep, out, first = run_engine(k, dev, files, sub,
                                           ["--sharding", "global"],
                                           devices=devices)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = require_launches(f"phase 12 (Mode B, {sub})", k,
                                    gated=False)
        t, st = norm.tables[0], norm.states[0]
        digests, on_card = output_digests(out), _on_card(st)
        shutil.rmtree(out)
        return rep, wall, launches, t, st, first, digests, on_card

    for k in (15, 25):
        runs = [("one card", shards)]
        if len(cards) >= MESH_SHARDS:
            runs.append(("distinct cards", cards[:MESH_SHARDS]))
        for label, devices in runs:
            rep, wall, launches, t, st, first, digests, on_card = mode_b(
                k, devices, files, "mode_b")
            same = digests == ref[k][0]
            print(f"phase 12: Mode B -k {k} on {MESH_SHARDS} shards "
                  f"({label}): {rep.total_processed:,} pairs in {wall:.2f} s "
                  f"(phase {4 if k == 15 else 5}, one device: "
                  f"{walls[k]:.2f} s), seed pass included; printed "
                  f"{rep.total_printed:,}; distinct k-mers "
                  f"{rep.max_total_kmers:,}; the global table grew from "
                  f"{first.rows:,} to {t.rows:,} rows, {MESH_SHARDS} row "
                  f"shards of {t.shard_rows:,}; overflow {int(st.overflow)};"
                  f" outputs equal to phase {4 if k == 15 else 5}'s: {same};"
                  f" totals equal: {totals(rep) == want[k]}; states on the "
                  f"card: {on_card}; launches {launches}")
            if not same or totals(rep) != want[k] or int(st.overflow) \
                    or t.rows <= first.rows or not on_card:
                raise AssertionError(f"phase 12: Mode B -k {k} ({label}) "
                                     "differs from the one-device run")
            del st
            torch.cuda.empty_cache()

    phase_mode_b_fallback(dev, shards, files, ref, want, fallback_walls)

    # full skew: every window of every batch one pair's
    skew = [os.path.join(WORK, f"skew{m}.fq") for m in (1, 2)]
    for src, dst in zip(files, skew):
        with open(src, "rb") as a, open(dst, "wb") as b:
            b.write(a.read(315) * SKEW_PAIRS)
    for k in (15, 25):
        _, one, o1, _ = run_engine(k, dev, skew, "skew_one")
        rep, wall, _, _, st, _, digests, _ = mode_b(k, shards, skew,
                                                    "skew_b")
        same = digests == output_digests(o1) and totals(rep) == totals(one)
        shutil.rmtree(o1)
        print(f"phase 12: Mode B -k {k} under full skew ({SKEW_PAIRS:,} "
              f"copies of one pair): totals {totals(rep)}, overflow "
              f"{int(st.overflow)}, equal to the one-device run: {same} "
              f"({wall:.2f} s)")
        if not same or int(st.overflow):
            raise AssertionError(f"phase 12: Mode B -k {k} under skew")

    # Mode A
    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    norm, rep, out, _ = run_engine(15, dev, files, "mode_a", devices=shards)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = require_launches("phase 12 (Mode A)", 15)
    names = sorted(os.listdir(out))
    want_names = sorted(f"{b}.k15_norm{100 // MESH_SHARDS}_thread{s}.fastq"
                        for b in ("output_forward", "output_reverse")
                        for s in range(MESH_SHARDS))
    on_card = all(_on_card(st) for st in norm.states)
    print(f"phase 12: Mode A -k 15 on {MESH_SHARDS} shards: "
          f"{rep.total_processed:,} pairs in {wall:.2f} s (phase 4: "
          f"{walls[15]:.2f} s); printed {rep.total_printed:,}; distinct "
          f"k-mers in the fullest shard {rep.max_total_kmers:,}; files "
          f"{names}; states on the card: {on_card}; launches {launches}")
    shutil.rmtree(out)
    if names != want_names or not on_card or rep.total_processed != PAIRS \
            or rep.total_printed + rep.total_skipped != PAIRS:
        raise AssertionError("phase 12: Mode A on 1M pairs")
    del norm
    torch.cuda.empty_cache()
    for k in (15, 25):
        outs = {}
        for d in ("cuda", "cpu"):
            devs = [torch.device(d)] * MESH_SHARDS
            o = run_engine(k, d, check_files, f"mode_a_{d}", devices=devs)[2]
            outs[d] = output_digests(o)
            shutil.rmtree(o)
        same = outs["cuda"] == outs["cpu"] and len(outs["cuda"]) == \
            2 * MESH_SHARDS
        print(f"phase 12: Mode A -k {k}, first {CHECK_PAIRS:,} pairs: "
              f"{len(outs['cuda'])} files byte-identical on cuda and cpu: "
              f"{same}")
        if not same:
            raise AssertionError(f"phase 12: Mode A -k {k}: cuda and cpu")

    # --profile on the k = 15 golden
    trace = os.path.join(WORK, "trace")
    out = os.path.join(WORK, "profile_golden")
    data = os.path.join(ROOT, "tests", "data")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-f", os.path.join(data, "a1.fasta"), "-r",
                       os.path.join(data, "b1.fasta"), "-t", "fa", "-o", "fa",
                       "-k", "15", "-d", "4", "--device", "cuda",
                       "--devices", "1", "--profile", trace,
                       "--out-dir", out])
    traces = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    with open(os.path.join(trace, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    seen = {n: sum(f"::{KERNEL_FUNCTIONS[n]}(" in e for e in kernels)
            for n in PATH_KERNELS[15]}
    gold = os.path.join(ROOT, "tests", "golden", "fasta_in_paired_k15")
    same = all(open(os.path.join(out, n), "rb").read()
               == open(os.path.join(gold, n), "rb").read()
               for n in os.listdir(gold) if n.startswith("output_"))
    print(f"phase 12: --profile on the k=15 golden: exit {rc}, trace files "
          f"{traces} ({os.path.getsize(os.path.join(trace, traces[0])):,} "
          f"bytes, {len(kernels):,} device kernel events; per path kernel "
          f"{seen}); golden byte-identical: {same}")
    if rc or len(traces) != 1 or not all(seen.values()) or not same:
        raise AssertionError("phase 12: --profile")
    shutil.rmtree(trace)
    shutil.rmtree(out)

    # two host processes on the one card, gloo
    second = [os.path.join(WORK, f"m{m}.fq") for m in (1, 2)]
    for src, dst in zip(files, second):
        with open(src, "rb") as a, open(dst, "wb") as b:
            a.seek(CHECK_PAIRS * 315)
            b.write(a.read(CHECK_PAIRS * 315))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(WORK, "multihost")
    args = ["-m", "nomalise_kmers_multi_large_torch.cli", "-f",
            check_files[0], second[0], "-r", check_files[1], second[1],
            "-k", "15", "-d", "100", "-g", "0.9", "-p", "1",
            "--batch-reads", "8192", "--device", "cuda", "--devices", "1"]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, *args, "--out-dir", f"{out}{r}"], cwd=ROOT,
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        print("\n".join(log[-3000:] for log in logs))
        raise AssertionError(f"phase 12: the host processes exited "
                             f"{[p.returncode for p in procs]}")
    m = re.search(r"Aggregated over 2 processes: Processed ([\d,]+), "
                  r"Printed ([\d,]+), Skipped ([\d,]+), Max unique kmers in "
                  r"a process: ([\d,]+)", logs[0])
    got = tuple(int(x.replace(",", "")) for x in m.groups())
    solo = [run_engine(15, dev, pair, f"solo{i}")
            for i, pair in enumerate((check_files, second))]
    sums = (sum(r[1].total_processed for r in solo),
            sum(r[1].total_printed for r in solo),
            sum(r[1].total_skipped for r in solo),
            max(r[1].max_total_kmers for r in solo))
    for r in range(2):
        shutil.rmtree(f"{out}{r}")
    for r in solo:
        shutil.rmtree(r[2])
    print(f"phase 12: two processes (gloo, one card), each on a "
          f"{CHECK_PAIRS:,}-pair file pair, in {wall:.2f} s: aggregated "
          f"{got}; the sum of single-process runs {sums}")
    if got != sums:
        raise AssertionError("phase 12: aggregated totals differ")


def phase_mode_b_fallback(dev, shards, files, ref: dict, want: dict,
                          walls: dict):
    """Mode B on the direct and hashed tables, `shards` (MESH_SHARDS shards
    of the card), phase 4's pairs as phase 11 runs them: outputs and
    spectra equal to phases 4/5's, totals equal, overflow 0, every shard on
    the card, the hashed kernel launched on the hashed run and none of
    K1-K5 on either; then the whole table gathered onto the card and split
    back, each timed."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.models.spectrum import spectrum

    for table, k, extra in FALLBACK_RUNS:
        backend.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        norm, rep, out, first = run_engine(
            k, dev, files, f"mode_b_{table}",
            ["--sharding", "global", "--table", table, *extra],
            devices=shards)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = backend.launches()
        t, st = norm.tables[0], norm.states[0]
        doublings = (t.capacity // first.capacity).bit_length() - 1
        same = output_digests(out) == ref[k][0]
        spec = spectrum_of(norm)
        on_card = _on_card(st)
        shutil.rmtree(out)
        # the checkpoint's conversions at this size: gather (on the card;
        # the hashed table through its kernel, shard by shard) and split
        t1 = time.perf_counter()
        whole = t.gather(st, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        back = t.split(whole)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        sp = spectrum(None, whole)
        kept = (int(whole.used), int(whole.overflow), int(back.used),
                int(back.overflow)) == (int(st.used), 0, int(st.used), 0) \
            and (sp.distinct_kmers, sp.total_kmers,
                 sp.histogram.tolist()) == spec
        del whole, back
        print(f"phase 12: Mode B --table {table} -k {k} on {MESH_SHARDS} "
              f"shards: {rep.total_processed:,} pairs in {wall:.2f} s "
              f"(phase 11, one device: {walls[table]:.2f} s), seed pass "
              f"included; printed {rep.total_printed:,}; distinct k-mers "
              f"{rep.max_total_kmers:,}; table {first.capacity:,} -> "
              f"{t.capacity:,} slots in {MESH_SHARDS} shards, {doublings} "
              f"doublings; overflow {int(st.overflow)}; peak device memory "
              f"{peak:,} bytes; outputs equal to phase "
              f"{4 if k == 15 else 5}'s: {same}; spectrum equal: "
              f"{spec == ref[k][1]}; totals equal: {totals(rep) == want[k]}"
              f"; shards on the card: {on_card}; launches {got}; gather "
              f"{t2 - t1:.3f} s and split {t3 - t2:.3f} s of the whole "
              f"table, contents kept: {kept}")
        bucket = [n for n in BUCKET_KERNELS if got[n]]
        if bucket or (got["hashed_insert"] > 0) != (table == "hashed"):
            raise AssertionError(f"phase 12: Mode B {table}: launches {got}")
        if not same or spec != ref[k][1] or totals(rep) != want[k] \
                or int(st.overflow) or not on_card or not kept:
            raise AssertionError(f"phase 12: Mode B {table} differs from "
                                 "the one-device run, or a shard left the "
                                 "card")
        del norm, st
        torch.cuda.empty_cache()


def phase_bench():
    """The bench on both cells at BENCH_PAIRS pairs and one timed run, in a
    process of its own: exit 0, the card line, then one JSON line per cell
    with correct true, its metrics, every path kernel launched and the
    traced run's breakdown labelled by host stage."""
    from nomalise_kmers_multi_large_torch.bench.cells import load_cells

    cells = load_cells()
    cmd = [sys.executable, "-m", "nomalise_kmers_multi_large_torch.bench",
           "--pairs", str(BENCH_PAIRS), "--runs", "1",
           "--work", os.path.join(WORK, "bench")]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    out = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(out) != 1 + len(cells) \
            or out[0] != card_line():
        raise AssertionError(f"phase 13: the bench exited {proc.returncode} "
                             f"with {len(out)} lines:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    print(f"phase 13: {out[0]}")
    for cell, text in zip(cells, out[1:]):
        line = json.loads(text)
        missing = [k for k in ("pairs_per_s", "peak_device_gib", "stage_s",
                               "device_trace") if k not in line]
        dt = line.get("device_trace", {})
        labelled = [x.get("stage") for x in dt.get("top_ops", [])
                    + dt.get("idle_gaps", [])]
        launches = line.get("run", {}).get("launches", {})
        if line.get("cell") != cell.name or line.get("correct") is not True \
                or missing or not labelled or not all(labelled) \
                or sorted(launches) != sorted(cell.kernels) \
                or not all(launches.values()):
            raise AssertionError(f"phase 13: {cell.name}: {text[:3000]}")
        print(f"phase 13: {cell.name}: correct; {BENCH_PAIRS:,} pairs at "
              f"{line['pairs_per_s']['median']:,.0f} pairs/s (one run), peak "
              f"{line['peak_device_gib']['value']:.3f} GiB, launches "
              f"{launches}; traced: device busy {dt['busy_ms']:.1f} of "
              f"{dt['wall_ms']:.1f} ms, idle {dt['idle_share']:.1%}, by "
              f"category {dt['category_ms']}")


def ptxas_usage(log: str) -> list[str]:
    """One line per kernel of a `nvcc -Xptxas -v` log: its registers,
    shared memory and spill stores."""
    out, entry, spills = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{entry}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} B shared memory, "
                       f"{spills} B spill stores")
            entry = None
    if shutil.which("c++filt") and out:  # demangle; keep the bare name
        out = subprocess.run(["c++filt", "-p"], input="\n".join(out),
                             text=True, capture_output=True, check=True,
                             timeout=60).stdout.splitlines()
        out = [re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", line)
               for line in out]
    return out


def phase(name: str, fn, *args):
    """Run one phase: "phase <name>: start" first; on a failure, its name
    and the traceback on standard output (so a lost stderr cannot hide
    which phase failed), and the exception goes on."""
    print(f"phase {name}: start", flush=True)
    t0 = time.perf_counter()
    try:
        out = fn(*args)
        print(f"phase {name}: done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out
    except BaseException:
        print(f"phase {name}: FAILED", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        raise


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="also run phase 6, the device-time profile")
    mode.add_argument("--kernels", action="store_true",
                      help="run phases 1, 2 and the kernel check of 11 only")
    mode.add_argument(HASHED_KERNEL_FLAG, action="store_true",
                      help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from nomalise_kmers_multi_large_torch import backend

    dev = torch.device("cuda", 0)
    if args.hashed_kernel:  # the process phase_hashed_kernel_apart starts
        backend.build()
        print(json.dumps(phase_hashed_kernel(np.random.default_rng(SEED + 9),
                                             dev)))
        return 0
    print(card_line())

    def build():
        t0 = time.perf_counter()
        backend.build()
        print(f"phase 1: built {sorted(backend.KERNEL_SOURCES)} with nvcc "
              f"{' '.join(backend.NVCC_FLAGS)} in "
              f"{time.perf_counter() - t0:.1f} s")
        for src in sorted(set(backend.KERNEL_SOURCES.values())):
            for line in ptxas_usage(backend.build_log(src)):
                print(f"phase 1: {src}: {line}")

    phase("1", build)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        rng = np.random.default_rng(SEED)
        timing = phase("2", phase_kernels, rng, dev)
        # its own generator, so phase 4's input stays as earlier versions
        # of this script wrote it
        timing.update(phase("2 (wide)", phase_kernels_wide,
                            np.random.default_rng(SEED + 1), dev))
        phase("2 (long stream)", phase_scan_long, dev)
        phase("2 (large tables)", phase_kernels_large,
              np.random.default_rng(SEED + 7), dev)
        phase("2 (row shards)", phase_kernels_row_shard,
              np.random.default_rng(SEED + 10), dev)
        timing.update(phase("2 (gate)", phase_gate,
                            np.random.default_rng(SEED + 11), dev))

        def hashed_kernel():
            timing.update(phase("11 (kernel)", phase_hashed_kernel_apart))

        if args.kernels:
            hashed_kernel()
            print(json.dumps({"kernels": [
                {"name": name, "source": src, **timing[name]}
                for name, src in backend.KERNEL_SOURCES.items()]}))
            return 0
        phase("3", phase_golden, 15, "fasta_in_paired_k15")
        phase("3", phase_golden, 25, "fasta_in_paired_k25_jax")
        files, check_files = phase("4 (inputs)", write_inputs, rng)
        launches, want, exact = {}, {}, {}
        for k, label in ((15, "phase 4"), (25, "phase 5")):
            got, want[k], exact[k] = phase(label[6:], phase_main, dev, k,
                                           files, check_files, label)
            launches.update(got)
        if args.profile:
            for k in (15, 25):
                phase("6", phase_profile, dev, k, files, want[k],
                      {n: launches[n] for n in PATH_KERNELS[k]}, "phase 6")
        phase("7", phase_ceiling, dev, files)
        phase("8", phase_relaxed, dev, files, exact, want)
        ref = {k: (exact[k]["digests"], exact[k]["spectrum"]) for k in exact}
        walls = {k: exact[k]["wall"] for k in exact}
        del exact
        phase("9", phase_checkpoint, dev, check_files)
        phase("10", phase_debug, dev)
        hashed_kernel()
        got, fallback_walls = phase("11", phase_fallback, dev, files,
                                    check_files, ref)
        launches.update(got)
        phase("12", phase_mesh, dev, files, check_files, ref, want, walls,
              fallback_walls)
        phase("13", phase_bench)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nomalise_kmers_multi_large_torch/csrc/{src}",
         "replaces": REPLACES[name], "launches": launches[name],
         **timing[name]}
        for name, src in backend.KERNEL_SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
