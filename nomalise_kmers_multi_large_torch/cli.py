"""Command-line interface of the port.

``python -m nomalise_kmers_multi_large_torch.cli [reference flags] --device cuda``

The reference binary's flags (normalise_kmers_multi_large.c :492-518
print_usage, :543-560 long_options), including the multi-value -f/-r and the
skip-unreadable-files-with-warning behaviour (:763, :782), plus the engine's
extensions: the port's copy of nomalise_kmers_multi_large_tpu/cli.py's
parser. It adds ``--device`` (default ``cuda``; a run on a machine without
CUDA fails rather than moving to the CPU). ``--devices N`` runs on N
devices of that type (0: every local one; parallel/mesh.py), in Mode A or,
with ``--sharding global``, Mode B (parallel/engine.py). Under torchrun's
variables each process takes its share of the input files and the totals
are summed over the processes (parallel/multihost.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from nomalise_kmers_multi_large_torch import VERSION
from nomalise_kmers_multi_large_torch.config import (
    Config, ConfigError, port_config,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nomalise_kmers_multi_large_torch.cli",
        description=(
            "Digital normalization of FASTQ/FASTA reads on one GPU "
            "(drop-in capabilities of normalise_kmers_multi_large)"
        ),
    )
    p.add_argument("--forward", "-f", nargs="+", default=[], metavar="FILE",
                   help="List of forward (read1) sequence files")
    p.add_argument("--reverse", "-r", nargs="+", default=[], metavar="FILE",
                   help="List of reverse (read2) sequence files")
    p.add_argument("--single", "-s", action="store_true",
                   help="data are single ended; unmatched --forward files are single-end")
    p.add_argument("--ksize", "-k", type=int, default=15,
                   help="kmer size (5-31; def. 15)")
    p.add_argument("--depth", "-d", type=int, default=100,
                   help="count at which a kmer is tagged high coverage (def. 100)")
    p.add_argument("--coverage", "-g", type=float, default=0.9,
                   help="proportion (0-1) of sequence covered by high-coverage kmers "
                        "before tagging as redundant (def. 0.9)")
    p.add_argument("--canonical", "-c", action="store_true",
                   help="merge kmers with their reverse complements")
    p.add_argument("--filetype", "-t", default="fq", help="input format fq|fa (def. fq)")
    p.add_argument("--outformat", "-o", default="fq", help="output format fq|fa (def. fq)")
    p.add_argument("--memory_start", "-m", type=int, default=0,
                   help="initial table memory in Gb across all shards")
    p.add_argument("--cpu", "-p", type=int, default=1,
                   help="number of independent shards (reference: threads)")
    p.add_argument("--verbose", "-e", action="store_true", help="entertain the user")
    p.add_argument("--debug", "-b", type=int, default=0, help="annoy the developer")
    p.add_argument("--print", "-P", dest="print_table", action="store_true",
                   help="print tab-delimited kmer count tables")
    p.add_argument("--version", "-v", action="store_true", help="print version and exit")

    ext = p.add_argument_group("engine options")
    ext.add_argument("--batch-reads", type=int, default=8192,
                     help="reads (or pairs) per device batch")
    ext.add_argument("--dispatch-group", type=int, default=1,
                     help="batches per device dispatch")
    ext.add_argument("--prefetch", type=int, default=2,
                     help="host batches framed+packed ahead on a worker "
                          "thread, overlapping device compute (0 = inline)")
    ext.add_argument("--io-threads", type=int, default=0,
                     help="threads in the native frame/pack pool "
                          "(io/_fastx.c); 0 = all cores")
    ext.add_argument("--mode", choices=["exact", "relaxed"], default="exact",
                     help="exact = reference-sequential semantics via sort-based "
                          "ranks; relaxed = pair-local ranks (batch-order independent)")
    ext.add_argument(
        "--table", choices=["auto", "bucket", "direct", "hashed"], default="auto"
    )
    ext.add_argument("--out-dir", default=".", help="output directory")
    ext.add_argument("--stride", type=int, default=1,
                     help="sample every s-th k-mer window (1 = reference semantics; "
                          "larger = faster, slightly different decisions; the "
                          "reference's own proposed optimization)")
    ext.add_argument("--pair-rule", choices=["and", "avg"], default="and",
                     help="pair keep rule: per-mate AND (reference) or pooled average")
    ext.add_argument("--sharding", choices=["local", "global"], default="local",
                     help="multi-device mode: local per-device tables (Mode A) or a "
                          "globally sharded exact table (Mode B)")
    ext.add_argument("--devices", type=int, default=0,
                     help="number of devices to use (0 = all local devices)")
    ext.add_argument("--seed-table", default="",
                     help="TSV of kmers (e.g. a previous -P dump) to use as the "
                          "seed set instead of scanning input files (the "
                          "reference's planned feature)")
    ext.add_argument("--checkpoint-every", type=int, default=0,
                     help="checkpoint the table + stream position every N batches")
    ext.add_argument("--checkpoint-dir", default=".checkpoints")
    ext.add_argument("--resume", action="store_true",
                     help="resume from the latest checkpoint")
    ext.add_argument("--spectrum", action="store_true",
                     help="print a k-mer spectrum report at the end")
    ext.add_argument("--profile", default="", metavar="DIR",
                     help="write a device trace to DIR")
    ext.add_argument("--device", default="cuda",
                     help="torch device to run on (def. cuda)")
    return p


def _readable(files, what: str) -> tuple[str, ...]:
    """Reference behaviour: unreadable files are skipped with a warning
    (:763,:782), not fatal."""
    keep = []
    for f in files:
        if os.access(f, os.R_OK):
            keep.append(f)
        else:
            print(f"Warning: cannot read {what} file {f}, skipping", file=sys.stderr)
    return tuple(keep)


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

    from nomalise_kmers_multi_large_torch.parallel import multihost
    from nomalise_kmers_multi_large_torch.parallel.engine import (
        make_normalizer,
    )

    os.makedirs(cfg.out_dir, exist_ok=True)
    pidx, pcount = multihost.maybe_initialize()
    try:
        if pcount > 1:
            fwd, rev = multihost.assign_files(
                cfg.forward_files, cfg.reverse_files, pidx, pcount)
            cfg = dataclasses.replace(cfg, forward_files=fwd,
                                      reverse_files=rev)
        try:
            norm = make_normalizer(cfg, device)
        except ConfigError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        _run(norm)
        report = multihost.aggregate_report(norm.report,
                                            paired=bool(cfg.reverse_files))
        if pcount > 1 and pidx == 0:
            print(f"Aggregated over {pcount} processes: Processed "
                  f"{report.total_processed:,}, Printed "
                  f"{report.total_printed:,}, Skipped "
                  f"{report.total_skipped:,}, Max unique kmers in a "
                  f"process: {report.max_total_kmers:,}")
    finally:
        multihost.shutdown()
    return 0


def _run(norm):
    """The startup line, the run, and the --spectrum blocks."""
    cfg = norm.cfg
    # startup table report (reference parse_arguments :686): an int32 count
    # per slot, beside an int64 code (hashed), or int32 fingerprint planes,
    # two of them on the wide bucket table at k > 16 (bucket)
    cap = norm.tables[0].capacity
    if cfg.table == "bucket":
        bytes_per_slot = 12 if cfg.ksize > 16 else 8
    else:
        bytes_per_slot = 4 if cfg.table == "direct" else 12
    print(
        f"{cfg.table} count table: {cap:,} slots per shard "
        f"(maximum for k={cfg.ksize} is {4 ** cfg.ksize:,}); "
        f"{cap * bytes_per_slot:,} bytes of {norm.device.type} memory for "
        f"each of {cfg.shards} shards\n"
    )
    norm.run()
    if cfg.spectrum:
        _print_spectra(norm)


def _print_spectra(norm):
    """One spectrum block per shard, as the JAX CLI prints them (with -p N
    or Mode A each shard counted ~1/N of the stream, and tables cannot be
    pooled: one k-mer holds a slot in every shard; Mode B has one table)."""
    from nomalise_kmers_multi_large_torch.models.spectrum import spectrum

    n = len(norm.states)
    for s in range(n):
        sp = spectrum(norm.tables[s], norm.states[s])
        if n == 1:
            print("\n--- Kmer Spectrum ---")
        else:
            print(f"\n--- Kmer Spectrum (shard {s} of {n}; each "
                  f"shard counts ~1/{n} of the stream) ---")
        print(f"Distinct kmers: {sp.distinct_kmers:,}")
        print(f"Total kmer instances: {sp.total_kmers:,}")
        print(f"Coverage peak: {sp.coverage_peak:,}")
        print(f"Genome size estimate: {sp.genome_size_estimate:,}")
        head = sp.histogram[:32]
        print("Histogram (multiplicity: kmers): "
              + ", ".join(f"{i}:{int(v):,}" for i, v in enumerate(head)
                          if v))


if __name__ == "__main__":
    raise SystemExit(main())
