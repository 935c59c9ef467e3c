"""Command-line interface of the port.

``python -m nomalise_kmers_multi_large_torch.cli [reference flags] --device cuda``

Reuses the reference package's parser (the reference binary's flags plus
the engine's extensions) and adds ``--device`` (default ``cuda``; a run on
a machine without CUDA fails rather than moving to the CPU).
"""
from __future__ import annotations

import argparse
import os
import sys

from nomalise_kmers_multi_large_tpu import VERSION
from nomalise_kmers_multi_large_tpu.cli import _readable, build_parser as _base

from nomalise_kmers_multi_large_torch.config import (
    Config, ConfigError, port_config,
)


def build_parser() -> argparse.ArgumentParser:
    p = _base()
    p.prog = "python -m nomalise_kmers_multi_large_torch.cli"
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (def. cuda)")
    return p


def config_from_args(argv=None) -> tuple[Config, str]:
    """(validated Config, device) from the command line."""
    args = build_parser().parse_args(argv)
    if args.version:
        print(VERSION)
        raise SystemExit(0)
    cfg = Config(
        forward_files=_readable(args.forward, "forward"),
        reverse_files=_readable(args.reverse, "reverse"),
        ksize=args.ksize,
        depth=args.depth,
        coverage=args.coverage,
        canonical=args.canonical,
        informat=args.filetype,
        outformat=args.outformat,
        shards=args.cpu,
        memory_gb=args.memory_start,
        verbose=args.verbose,
        debug=args.debug,
        single=args.single,
        print_table=args.print_table,
        batch_reads=args.batch_reads,
        dispatch_group=args.dispatch_group,
        prefetch=args.prefetch,
        io_threads=args.io_threads,
        mode=args.mode,
        table=args.table,
        out_dir=args.out_dir,
        stride=args.stride,
        seed_table=args.seed_table,
        pair_rule=args.pair_rule,
        sharding=args.sharding,
        n_devices=args.devices,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        spectrum=args.spectrum,
        profile_dir=args.profile,
    )
    return port_config(cfg), args.device


def main(argv=None) -> int:
    try:
        cfg, device = config_from_args(argv)
    except ConfigError as e:
        print(f"Error: {e}", file=sys.stderr)
        build_parser().print_usage(sys.stderr)
        return 1

    from nomalise_kmers_multi_large_torch.engine.pipeline import (
        Normalizer, resolve_device,
    )

    os.makedirs(cfg.out_dir, exist_ok=True)
    norm = Normalizer(cfg, resolve_device(device))
    # startup table report (reference parse_arguments :686): fingerprint
    # and count planes of int32, plus the wide table's w2 plane at k > 16
    cap = norm.tables[0].capacity
    bytes_per_slot = 12 if cfg.ksize > 16 else 8
    print(
        f"{cfg.table} count table: {cap:,} slots per shard "
        f"(maximum for k={cfg.ksize} is {4 ** cfg.ksize:,}); "
        f"{cap * bytes_per_slot:,} bytes of {norm.device.type} memory for "
        f"each of {cfg.shards} shards\n"
    )
    norm.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
