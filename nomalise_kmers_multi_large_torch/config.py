"""Run configuration, and the port's table-choice rule.

``Config`` is the port's copy of nomalise_kmers_multi_large_tpu/config.py
(the reference's ``struct config_t cfg`` and its validation rules,
normalise_kmers_multi_large.c:208-231, parse_arguments :520-745, plus the
engine's extensions). ``port_config`` resolves ``auto`` to a table kind
before ``validate``, so ``validate`` keeps only the rules that can still
fire there; the port runs every combination the JAX package runs. The
device count is checked where the devices are known
(parallel/mesh.py::data_devices, and a Mode B table's power-of-two rule in
parallel/modes.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["Config", "ConfigError", "port_config"]

#: reference INITIAL_CAPACITY (normalise_kmers_multi_large.c:137): the
#: hashed table's default slot count before rounding to a power of two
INITIAL_CAPACITY = 67_108_879
BYTES_PER_SLOT = 16  # reference kmer_t size; the --memory_start contract
MAX_K = 31
MIN_K = 5
MAX_SHARDS = 256  # reference MAX_THREADS (normalise_kmers_multi_large.c:142)
SEED_NUMBER = 3_000_000  # reference SEED_NUMBER (:146)
MAX_BUCKET_DEPTH = 65535  # the bucket table's exact counting range


class ConfigError(ValueError):
    """Invalid configuration (reference exits with the analogous stderr message)."""


def _normalize_format(fmt: str, what: str) -> str:
    f = fmt.lower()
    if f in ("fa", "fasta", "fsa", "fas"):
        return "fa"
    if f in ("fq", "fastq", "fsq"):
        return "fq"
    raise ConfigError(f"{what} file format must be either fa or fq, not {fmt}")


@dataclasses.dataclass(frozen=True)
class Config:
    """Everything a run needs."""

    # --- reference flags (normalise_kmers_multi_large.c:543-560) ---
    forward_files: tuple[str, ...] = ()
    reverse_files: tuple[str, ...] = ()
    ksize: int = 15                      # --ksize|-k
    depth: int = 100                     # --depth|-d
    coverage: float = 0.9                # --coverage|-g
    canonical: bool = False              # --canonical|-c
    informat: str = "fq"                 # --filetype|-t
    outformat: str = "fq"                # --outformat|-o
    shards: int = 1                      # --cpu|-p : reference threads -> table shards
    memory_gb: int = 0                   # --memory_start|-m (0 => default rows)
    verbose: bool = False                # --verbose|-e
    debug: int = 0                       # --debug|-b
    single: bool = False                 # --single|-s
    print_table: bool = False            # --print|-P

    # --- engine extensions ---
    out_dir: str = "."
    batch_reads: int = 8192              # reads (or pairs) per device batch
    mode: Literal["exact", "relaxed"] = "exact"
    #: 'bucket' = the bucket table; 'direct' (dense 4^k, k <= 15) and
    #: 'hashed' (open addressing) are the fallbacks; 'auto' picks
    table: Literal["auto", "bucket", "direct", "hashed"] = "auto"
    max_read_len: int = 1023             # reference MAX_LINE_LENGTH-1 (:139)
    pad_read_len: int = 0                # 0 => derived from data
    seed_records: int = 0                # 0 => reference formula 1 + 3e6/n_fwd_files
    seed_table: str = ""                 # k-mer TSV to use as the seed set, the
                                         # reference's planned feature (nk.c:74-77)
    checkpoint_every: int = 0            # batches; 0 => no checkpointing
    checkpoint_dir: str = ".checkpoints"
    resume: bool = False
    pair_rule: Literal["and", "avg"] = "and"   # reference keeps 'and' (:1646); 'avg'
                                               # is its commented-out alternative (:1638)
    stride: int = 1                      # sample every s-th window; 1 = reference
                                         # semantics; >1 per nk.c:30-33's own TODO
    dispatch_group: int = 1              # batches per device dispatch
    prefetch: int = 2                    # host frame+pack batches prepared
                                         # ahead on a worker thread
                                         # (utils/prefetch.py); 0 = inline
    io_threads: int = 0                  # native frame/pack pthread pool
                                         # width (io/_fastx.c); 0 = all
                                         # cores (NKMT_IO_THREADS overrides)
    n_devices: int = 0                   # 0 => all local devices
    sharding: Literal["local", "global"] = "local"  # Mode A vs Mode B
    spectrum: bool = False               # print k-mer spectrum stats at the end
    profile_dir: str = ""                # write a device trace here

    # ------------------------------------------------------------------
    @property
    def depth_per_shard(self) -> int:
        """Reference depth_per_cpu = depth / cpus, INTEGER division (:674).

        The effective high-coverage threshold depends on shard count, and output
        filenames embed this value (``norm{depth_per_cpu}``, :2286).
        """
        return self.depth // self.shards

    @property
    def is_input_fastq(self) -> bool:
        return _normalize_format(self.informat, "Input") == "fq"

    @property
    def is_output_fastq(self) -> bool:
        return _normalize_format(self.outformat, "Output") == "fq"

    @property
    def direct_capacity(self) -> int:
        return 4 ** self.ksize

    @property
    def initial_hash_capacity(self) -> int:
        """The hashed table's initial slots per shard: --memory_start GB
        across the shards at 16 B a slot (or INITIAL_CAPACITY), at most
        4^k (parse_arguments :676-684), rounded up to a power of two, at
        least 1024."""
        if self.memory_gb > 0:
            slots = int(self.memory_gb * (1 << 30) / BYTES_PER_SLOT
                        / self.shards)
        else:
            slots = INITIAL_CAPACITY
        slots = min(slots, 4 ** self.ksize)
        return 1 << max(10, math.ceil(math.log2(max(2, slots))))

    @property
    def records_to_seed(self) -> int:
        """Reference: 1 + SEED_NUMBER / forward_file_count (main :2242)."""
        if self.seed_records > 0:
            return self.seed_records
        n = max(1, len(self.forward_files))
        return 1 + int(SEED_NUMBER / n)

    # ------------------------------------------------------------------
    def validate(self) -> "Config":
        """Reference validation rules, same order/meaning (:704-743)."""
        _normalize_format(self.informat, "Input")
        _normalize_format(self.outformat, "Output")
        if self.memory_gb < 0:
            raise ConfigError(f"Memory cannot be less than 1 Gb {self.memory_gb}")
        if not self.forward_files or (not self.reverse_files and not self.single):
            raise ConfigError(
                f"no fwd ({len(self.forward_files)}) or reverse "
                f"({len(self.reverse_files)}) files provided"
            )
        if not self.is_input_fastq and self.is_output_fastq:
            raise ConfigError("cannot request an output format of FASTQ when input is FASTA")
        if not self.single and len(self.forward_files) != len(self.reverse_files):
            raise ConfigError(
                f"Number of forward ({len(self.forward_files)}) and reverse files "
                f"({len(self.reverse_files)}) must match"
            )
        if self.shards <= 0 or self.shards > MAX_SHARDS:
            raise ConfigError(
                f"CPU count ({self.shards}) must be a positive integer and up to {MAX_SHARDS}"
            )
        if self.ksize < MIN_K or self.ksize > MAX_K:
            raise ConfigError(f"Only kmer sizes ({self.ksize}) of 5 to 31 are supported")
        if self.coverage > 1 or self.coverage < 0.001:
            raise ConfigError(
                f"Coverage ({self.coverage}) is the proportion of the sequence covered "
                "by high kmers and must be between 0 and 1"
            )
        if self.depth < 2:
            raise ConfigError(
                f"Depth ({self.depth}) is the number of times a kmer needs to be found "
                "before being flagged as high coverage, it must be above 1"
            )
        if self.depth_per_shard < 2:
            raise ConfigError(
                f"Depth ({self.depth}) must be at least 2 x number of CPUs"
            )
        if self.mode not in ("exact", "relaxed"):
            raise ConfigError(f"mode must be exact or relaxed, not {self.mode}")
        if self.table not in ("auto", "bucket", "direct", "hashed"):
            raise ConfigError(
                f"table must be auto, bucket, direct or hashed, not {self.table}"
            )
        if self.table == "direct" and self.ksize > 15:
            raise ConfigError("direct table supports k<=15 (4^k int32 slots); use hashed")
        if self.table == "bucket" and self.depth_per_shard > MAX_BUCKET_DEPTH:
            raise ConfigError(
                f"Depth per shard ({self.depth_per_shard}) exceeds 65535, the "
                "bucket table's exact counting range; use --table direct or hashed"
            )
        if self.batch_reads < 1:
            raise ConfigError(f"batch-reads ({self.batch_reads}) must be >= 1")
        if self.table == "bucket":
            # per-read tallies are packed with 14-bit read ids: at most
            # 16384 read rows per batch (ops/bucket_kernel.py MAX_READS)
            rpr = 2 if self.reverse_files else 1
            if self.batch_reads * rpr > 16384:
                raise ConfigError(
                    f"batch-reads ({self.batch_reads}) "
                    f"{'pairs' if rpr == 2 else 'reads'} exceeds the bucket "
                    f"table's 16384 read-rows-per-batch cap; use "
                    f"--batch-reads <= {16384 // rpr} or --table "
                    "direct/hashed"
                )
        if self.stride < 1 or self.stride > self.ksize:
            raise ConfigError(f"stride ({self.stride}) must be in [1, k]")
        if self.sharding == "global" and self.stride != 1 \
                and self.table == "bucket":
            # Mode B routes every window of the batch to its row shard
            raise ConfigError(
                f"--stride {self.stride} is not supported with --sharding "
                "global on the bucket table; use --sharding local or "
                "--stride 1"
            )
        if self.dispatch_group < 1:
            raise ConfigError(
                f"dispatch-group ({self.dispatch_group}) must be >= 1")
        if self.prefetch < 0:
            raise ConfigError(f"prefetch ({self.prefetch}) must be >= 0")
        return self


def port_config(cfg: Config) -> Config:
    """Resolve ``table="auto"``, then validate.

    ``auto`` is the bucket table (the wide one at k = 16..31) while the
    depth per shard fits its exact counting range (<= 65535), and above
    that the direct table (k <= 15) or the hashed table: the JAX package's
    rule on an accelerator backend, kept on every device and in both
    sharding modes. ``--debug`` above 4 runs as 4, as in the JAX engine
    (the reference's probe traces have no analogue on these tables)."""
    if cfg.table == "auto":
        table = "bucket"
        if cfg.depth_per_shard > MAX_BUCKET_DEPTH:
            table = "direct" if cfg.ksize <= 15 else "hashed"
        cfg = dataclasses.replace(cfg, table=table)
    return cfg.validate()
