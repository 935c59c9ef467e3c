"""Several host processes.

Port of nomalise_kmers_multi_large_tpu/parallel/multihost.py. Each process
runs the streaming engine over ITS OWN share of the input files (file-level
data parallelism, exact for Mode A's per-shard semantics); only the run's
counters cross processes, over torch.distributed with the gloo backend
(host integers, so one card, or none, is enough).

Launch: torchrun, or the same command on every host with torchrun's
variables set by hand: ``RANK`` (the JAX package's JAX_PROCESS_ID),
``WORLD_SIZE`` (JAX_NUM_PROCESSES), ``MASTER_ADDR`` and ``MASTER_PORT``
(together JAX_COORDINATOR_ADDRESS). Without ``WORLD_SIZE`` > 1 every call
here is a no-op, so a single process runs the same code path.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize() -> tuple[int, int]:
    """Join the process group when torchrun's variables say there are
    several processes. Returns (process index, process count)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    if not _joined():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(
            "gloo", init_method=f"tcp://{addr}:{port}", world_size=world,
            rank=int(os.environ["RANK"]))
    return dist.get_rank(), dist.get_world_size()


def shutdown():
    """Leave the process group, if this process joined one."""
    if _joined():
        dist.destroy_process_group()


def assign_files(
    forward: tuple[str, ...],
    reverse: tuple[str, ...],
    process_index: int,
    process_count: int,
) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Deal input file (pairs) round-robin across host processes.

    Pairing is preserved: file i keeps its mate. Unmatched single-end tails
    (the --single mixed mode) ride with their forward file.
    """
    if process_count <= 1:
        return forward, reverse
    fwd = tuple(f for i, f in enumerate(forward)
                if i % process_count == process_index)
    rev = tuple(r for i, r in enumerate(reverse)
                if i % process_count == process_index)
    return fwd, rev


def aggregate_report(report, paired: bool):
    """Sum processed / printed / skipped over the processes and take the
    largest unique-k-mer count (the reference's per-thread aggregation,
    nk.c:1896-1912, lifted to processes). Counters travel as int64: the
    reference's flagship run processed 2,987,923,777 records, past 2^31.
    A single process returns the report unchanged."""
    if not _joined() or dist.get_world_size() <= 1:
        return report
    mine = torch.tensor([report.total_processed, report.total_printed,
                         report.total_skipped, report.max_total_kmers],
                        dtype=torch.int64)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    got = torch.stack(every)
    report.total_processed = int(got[:, 0].sum())
    report.total_printed = int(got[:, 1].sum())
    report.total_skipped = int(got[:, 2].sum())
    report.max_total_kmers = int(got[:, 3].max())
    return report
