"""PyTorch/CUDA port of the diginorm engine, for one NVIDIA H100.

The JAX package ``nomalise_kmers_multi_large_tpu`` is the reference: the same
inputs give the same keep/skip decisions, tallies, output files and, on the
bucket path, the same table planes lane for lane. This package imports
neither JAX nor the JAX package: it keeps its own copies of the host modules
it needs (``io/`` with the native ``_fastx.c``, ``engine/report.py``,
``utils/prefetch.py``, ``utils/profiling.StageTimer``, ``Config`` and the
CLI parser). Only the tests import both.

Layout mirrors the reference:

- ``backend``  builds the CUDA kernels in ``csrc/`` with nvcc and counts
               their launches.
- ``io``       mmap record framing, 2-bit packing, per-shard writers.
- ``ops``      the kernels (encode, rank/cand scan, bucket upsert; narrow and
               wide), each beside its plain PyTorch version.
- ``table``    the bucket count tables on torch tensors.
- ``models``   the keep/skip decision rules.
- ``engine``   the batch step, the streaming ``Normalizer`` and reporting.
- ``utils``    the prefetch worker and the stage timer.
- ``cli``      ``python -m nomalise_kmers_multi_large_torch.cli``.
"""

VERSION = 20260817
REFERENCE_VERSION = 20240823


def _tune_host_allocator():
    """Keep large host buffers on the reused heap instead of fresh mmaps.

    The streaming engine allocates multi-MB staging buffers (packed batches,
    frame columns, emit blobs) every batch. glibc serves such allocations
    from fresh mmap regions by default, so every batch pays first-touch page
    faults, which are expensive on virtualized hosts with on-demand paging.
    Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes glibc recycle warm heap
    pages instead. No-op where unavailable (musl, macOS).
    """
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        m_trim_threshold, m_mmap_threshold = -1, -3
        libc.mallopt(m_mmap_threshold, 1 << 30)
        libc.mallopt(m_trim_threshold, 1 << 30)
    except (OSError, AttributeError):
        pass


_tune_host_allocator()
