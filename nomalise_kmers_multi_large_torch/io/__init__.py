"""Host input and output: mmap record framing, 2-bit packing, per-shard
writers, and the native C fast path (``_fastx.c``). The port's own copy of
nomalise_kmers_multi_large_tpu/io/, so it loads nothing of the JAX
package."""
from nomalise_kmers_multi_large_torch.io.reader import (  # noqa: F401
    FastxFile,
    RecordBatch,
    batch_iterator,
    paired_batch_iterator,
)
from nomalise_kmers_multi_large_torch.io.writer import ShardWriter  # noqa: F401
