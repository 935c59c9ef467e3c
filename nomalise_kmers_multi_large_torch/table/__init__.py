from nomalise_kmers_multi_large_torch.table.base import TableState  # noqa: F401
from nomalise_kmers_multi_large_torch.table.bucket import (  # noqa: F401
    BucketTable, BucketTableWide, default_rows, default_rows_wide,
)


def make_table(cfg, device) -> BucketTable:
    """The table of a config: the bucket table (k <= 15) or the wide bucket
    table (k = 16..31); the config rule (config.py) rejects every other
    choice before this."""
    mem = cfg.memory_gb * (1 << 30) if cfg.memory_gb else None
    if cfg.ksize > 15:
        return BucketTableWide(k=cfg.ksize,
                               rows=default_rows_wide(cfg.ksize, mem),
                               device=device)
    return BucketTable(k=cfg.ksize, rows=default_rows(cfg.ksize, mem),
                       device=device)
