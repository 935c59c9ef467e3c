"""Host stage timers for the streaming loop (frame/pack/dispatch/write), and
the --profile device trace.

The port's copy of nomalise_kmers_multi_large_tpu/utils/profiling.py:
``StageTimer`` as it is; ``device_trace`` writes a torch.profiler trace
where the JAX package writes a ``jax.profiler`` one.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall time per pipeline stage; ~100ns overhead per use."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        if not self.totals:
            return ""
        total = sum(self.totals.values())
        lines = ["--- Host stage timing ---"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}: {t:.3f}s ({t / max(total, 1e-12) * 100:.1f}%), "
                f"{self.counts[name]} calls, {t / max(self.counts[name], 1) * 1e3:.2f} ms/call"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: str | None, cuda: bool):
    """torch.profiler over the block (CPU activity, and CUDA with `cuda`);
    at its end one TensorBoard-readable Chrome trace,
    ``<host>_<pid>.<ms>.pt.trace.json``, is written into trace_dir. Without
    a trace_dir the block runs unprofiled."""
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    handler = torch.profiler.tensorboard_trace_handler(trace_dir)
    with torch.profiler.profile(activities=acts, on_trace_ready=handler):
        yield
