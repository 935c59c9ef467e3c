"""The port's table-choice rule, applied to the reference's ``Config``.

``Config`` itself is reused from nomalise_kmers_multi_large_tpu/config.py.
Its ``table_kind`` asks JAX for its backend when ``table == "auto"``, and
``validate()`` reads ``table_kind``; so ``port_config`` resolves ``auto``
first, with ``dataclasses.replace``, and only then validates. It rejects,
with a ConfigError, every table and option the port does not run yet.
"""
from __future__ import annotations

import dataclasses

from nomalise_kmers_multi_large_tpu.config import Config, ConfigError

__all__ = ["Config", "ConfigError", "port_config"]


def port_config(cfg: Config) -> Config:
    """Resolve ``table="auto"`` to the bucket table (depth per shard <=
    65535; the wide bucket table at k = 16..31), reject what is not ported,
    and validate."""
    if cfg.table == "auto":
        if cfg.depth_per_shard > 65535:
            raise ConfigError(
                f"depth per shard {cfg.depth_per_shard} > 65535 needs the "
                "direct or hashed table, which are not ported yet")
        cfg = dataclasses.replace(cfg, table="bucket")
    if cfg.table != "bucket":
        raise ConfigError(f"--table {cfg.table} is not ported yet; only the "
                          "bucket table runs")
    unported = [
        (cfg.mode != "exact", f"--mode {cfg.mode}"),
        (bool(cfg.checkpoint_every) or cfg.resume,
         "checkpoints (--checkpoint-every, --resume)"),
        (cfg.debug > 1, f"--debug {cfg.debug} (only 0 and 1 run)"),
        (cfg.spectrum, "--spectrum"),
        (bool(cfg.seed_table), "--seed-table"),
        (cfg.n_devices > 1, f"--devices {cfg.n_devices} (one device only)"),
        (cfg.sharding == "global", "--sharding global"),
        (bool(cfg.profile_dir), "--profile"),
    ]
    for bad, what in unported:
        if bad:
            raise ConfigError(f"{what} is not ported yet")
    return cfg.validate()
