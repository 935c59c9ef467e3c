from nomalise_kmers_multi_large_torch.table.base import TableState  # noqa: F401
from nomalise_kmers_multi_large_torch.table.bucket import (  # noqa: F401
    BucketTable, default_rows,
)


def make_table(cfg, device) -> BucketTable:
    """The table of a config: the bucket table is the only one ported; the
    config rule (config.py) rejects every other choice before this."""
    mem = cfg.memory_gb * (1 << 30) if cfg.memory_gb else None
    return BucketTable(k=cfg.ksize, rows=default_rows(cfg.ksize, mem),
                       device=device)
