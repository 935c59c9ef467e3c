from nomalise_kmers_multi_large_torch.table.base import (  # noqa: F401
    CountTable, TableState, state_from_numpy, state_to_numpy,
)
from nomalise_kmers_multi_large_torch.table.bucket import (  # noqa: F401
    BucketTable, BucketTableWide, default_rows, default_rows_wide,
)
from nomalise_kmers_multi_large_torch.table.direct import (  # noqa: F401
    DirectTable,
)
from nomalise_kmers_multi_large_torch.table.hashed import (  # noqa: F401
    HashedTable,
)


def make_table(cfg, device) -> CountTable:
    """The table of a config whose ``table`` port_config has resolved:

    - "bucket": the bucket table (k <= 15), or the wide bucket table
      (k = 16..31);
    - "direct": the dense 4^k count array (k <= 15);
    - "hashed": open addressing with growth, from cfg.initial_hash_capacity.
    """
    if cfg.table == "direct":
        return DirectTable(cfg.ksize, device=device)
    if cfg.table == "hashed":
        return HashedTable(cfg.ksize, cfg.initial_hash_capacity,
                           device=device)
    mem = cfg.memory_gb * (1 << 30) if cfg.memory_gb else None
    if cfg.ksize > 15:
        return BucketTableWide(k=cfg.ksize,
                               rows=default_rows_wide(cfg.ksize, mem),
                               device=device)
    return BucketTable(k=cfg.ksize, rows=default_rows(cfg.ksize, mem),
                       device=device)
