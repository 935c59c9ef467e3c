"""The digital-normalization decision model (torch).

Port of nomalise_kmers_multi_large_tpu/models/diginorm.py: per-read
(high, total) window tallies map to keep/skip decisions.

- ratio = high / total in float32, and 0 when total == 0;
- a single read is kept iff ratio < coverage (strict);
- a pair is kept iff both mates' ratios are < coverage (rule "and"), or,
  with rule "avg", iff the pooled ratio (hf + hr) / (tf + tr) is.
"""
from __future__ import annotations

import numpy as np
import torch


def coverage_ratios(high: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    h = high.to(torch.float32)
    t = total.to(torch.float32)
    return torch.where(total > 0, h / t.clamp(min=1.0), 0.0)


def _cov32(coverage: float) -> float:
    """The float32 value of `coverage`, compared in float32 as JAX does."""
    return float(np.float32(coverage))


def keep_mask_single(high, total, coverage: float) -> torch.Tensor:
    return coverage_ratios(high, total) < _cov32(coverage)


def keep_mask_paired(high_f, total_f, high_r, total_r, coverage: float,
                     rule: str = "and") -> torch.Tensor:
    if rule == "avg":
        return keep_mask_single(high_f + high_r, total_f + total_r, coverage)
    cov = _cov32(coverage)
    return ((coverage_ratios(high_f, total_f) < cov)
            & (coverage_ratios(high_r, total_r) < cov))
