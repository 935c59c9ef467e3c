"""K-mer spectrum of a table: the count-of-counts histogram and its estimates.

Port of nomalise_kmers_multi_large_tpu/models/spectrum.py (the reference
wishes for it, normalise_kmers_multi_large.c:85-90, and never implements
it): a histogram of the table's counts, taken with torch.bincount on the
state's device (only the histogram comes to the host), and from it the
distinct and total k-mers, the coverage peak past the error valley and a
genome-size estimate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SpectrumReport(NamedTuple):
    histogram: np.ndarray     # [max_count+1] count-of-counts; index = multiplicity
    distinct_kmers: int
    total_kmers: int          # sum of counts
    coverage_peak: int        # multiplicity of the non-error spectrum peak
    genome_size_estimate: int  # total_kmers / coverage_peak (0 if no peak)


def _histogram(counts, keys, max_count: int) -> np.ndarray:
    occupied = counts != 0 if keys is None else keys != 0
    return torch.bincount(counts[occupied].clamp(0, max_count),
                          minlength=max_count + 1).cpu().numpy()


def spectrum(table, state, max_count: int = 1024) -> SpectrumReport:
    """The spectrum of one shard's table: direct (keys None: a slot is its
    code, a zero count an unseen k-mer), hashed, bucket or wide bucket (a
    slot is occupied where ``keys`` is nonzero, and bin 0 counts the
    occupied slots still at count 0: seeds never seen since). Only the
    counts of occupied slots are binned, clamped to max_count. A Mode B
    state, whose planes are tuples of shards (parallel/modes.py), is binned
    shard by shard on each shard's device, and the histograms summed."""
    counts = state.counts if isinstance(state.counts, tuple) \
        else (state.counts,)
    keys = state.keys if isinstance(state.keys, tuple) \
        else (state.keys,) * len(counts)
    hist = sum(_histogram(c, k, max_count) for c, k in zip(counts, keys))

    distinct = int(hist[1:].sum())
    total = int((hist * np.arange(hist.shape[0], dtype=np.int64)).sum())
    # non-error peak: the largest multiplicity >= 2 past the error valley
    # (the standard k-mer spectrum heuristic)
    peak = 0
    if hist[2:].any():
        h = hist[1:].astype(np.float64)
        valley = 1
        while valley + 1 < h.shape[0] and h[valley] > h[valley + 1]:
            valley += 1
        if valley + 1 < h.shape[0]:
            peak = int(np.argmax(h[valley:]) + valley + 1)
    genome = int(total // peak) if peak else 0
    return SpectrumReport(histogram=hist, distinct_kmers=distinct,
                          total_kmers=total, coverage_peak=peak,
                          genome_size_estimate=genome)
