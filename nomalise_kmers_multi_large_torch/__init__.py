"""PyTorch/CUDA port of the diginorm engine, for one NVIDIA H100.

The JAX package ``nomalise_kmers_multi_large_tpu`` is the reference: the same
inputs give the same keep/skip decisions, tallies, output files and, on the
bucket path, the same table planes lane for lane. This package reuses the
reference's host-only modules (``io/``, ``engine/report.py``,
``utils/prefetch.py``, ``utils/profiling.StageTimer``, the ``Config``
dataclass and ``cli.build_parser``), none of which loads JAX, and never
imports JAX itself.

Layout mirrors the reference:

- ``backend``  builds the CUDA kernels in ``csrc/`` with nvcc and counts
               their launches.
- ``ops``      the three kernels of the k <= 15 bucket path (encode, rank/cand
               scan, bucket upsert), each beside its plain PyTorch version.
- ``table``    the bucket count table on torch tensors.
- ``models``   the keep/skip decision rules.
- ``engine``   the batch step and the streaming ``Normalizer``.
- ``cli``      ``python -m nomalise_kmers_multi_large_torch.cli``.
"""
