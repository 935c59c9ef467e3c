"""Checkpoint / resume.

Port of nomalise_kmers_multi_large_tpu/engine/checkpoint.py: periodic
snapshots of (table state, stream position, counters, output file sizes)
that let a run resume exactly. The files are the JAX package's, so a
checkpoint written by either package loads in the other:

  manifest.json   config fingerprint + stream position + counters + sizes
  shard{N}.npz    table planes of shard N: counts, keys, keys2 (wide table
                  at k > 16), used, overflow; int32, as the JAX package
                  writes a TableState
  shadow{N}.npz   the --debug > 2 shadow of shard N (codes, vals)

Arrays are numpy on disk and torch tensors on the engine's device on load.
Each file is written to a temporary name and renamed into place, so a crash
mid-save keeps the previous snapshot.

One repair of the JAX package's loader: it restores ``shadow*.npz`` files
whenever they exist, so a directory reused by a run without ``--debug`` > 2
hands a later resume another run's stale shadows. The port's manifest
records whether shadows were saved (``"shadows"``), and the loader reads
them only then; a manifest without the key (one the JAX package wrote)
reads as "no shadows".
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from nomalise_kmers_multi_large_torch.table.base import TableState


def _fingerprint(cfg) -> dict:
    """The JAX package's fingerprint; ``table`` is the resolved kind, which
    the port's config rule has made "bucket"."""
    return {
        "forward_files": list(cfg.forward_files),
        "reverse_files": list(cfg.reverse_files),
        "ksize": cfg.ksize,
        "depth": cfg.depth,
        "coverage": cfg.coverage,
        "canonical": cfg.canonical,
        "shards": cfg.shards,
        "mode": cfg.mode,
        "stride": cfg.stride,
        "table": cfg.table,
        "single": cfg.single,
        "informat": cfg.informat,
        "outformat": cfg.outformat,
        "pair_rule": cfg.pair_rule,
    }


@dataclasses.dataclass
class ResumePoint:
    file_index: int
    records_done: int          # records consumed of the current file (pair)
    counters: list[dict]       # per-shard processed/printed/skipped
    output_sizes: dict         # path -> byte size at snapshot
    rr: int                    # round-robin cursor
    shadows: Optional[list] = None  # per-shard debug>2 shadow counts


class CheckpointManager:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dir = cfg.checkpoint_dir

    def _manifest_path(self):
        return os.path.join(self.dir, "manifest.json")

    def _save_npz(self, name: str, **arrays):
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(self.dir, name))

    # ------------------------------------------------------------------
    def save(self, states, counters, file_index: int, records_done: int,
             output_paths: list[str], rr: int, shadows=None):
        os.makedirs(self.dir, exist_ok=True)
        if shadows is not None:
            for s, sh in enumerate(shadows):
                self._save_npz(
                    f"shadow{s}.npz",
                    codes=np.fromiter(sh.counts.keys(), np.uint64,
                                      len(sh.counts)),
                    vals=np.fromiter(sh.counts.values(), np.int64,
                                     len(sh.counts)))
        for s, state in enumerate(states):
            arrays = {name: getattr(state, name).cpu().numpy()
                      for name in ("counts", "used", "overflow", "keys",
                                   "keys2")
                      if getattr(state, name) is not None}
            self._save_npz(f"shard{s}.npz", **arrays)
        manifest = {
            "config": _fingerprint(self.cfg),
            "file_index": file_index,
            "records_done": records_done,
            "counters": [
                {"processed": c.processed, "printed": c.printed,
                 "skipped": c.skipped, "unique_kmers": c.unique_kmers}
                for c in counters
            ],
            "output_sizes": {
                p: (os.path.getsize(p) if os.path.exists(p) else 0)
                for p in output_paths
            },
            "rr": rr,
            "shadows": shadows is not None,
        }
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, self._manifest_path())

    # ------------------------------------------------------------------
    def load(self, device) -> Optional[tuple[list, ResumePoint]]:
        """(states on `device`, ResumePoint), or None if no checkpoint
        exists."""
        if not os.path.exists(self._manifest_path()):
            return None
        with open(self._manifest_path()) as f:
            manifest = json.load(f)
        want = _fingerprint(self.cfg)
        if manifest["config"] != want:
            raise ValueError(
                "checkpoint config mismatch: "
                f"saved {manifest['config']} vs current {want}"
            )

        def tensor(z, name):
            if name not in z:
                return None
            return torch.from_numpy(
                np.ascontiguousarray(z[name], dtype=np.int32)).to(device)

        states = []
        for s in range(self.cfg.shards):
            with np.load(os.path.join(self.dir, f"shard{s}.npz")) as z:
                states.append(TableState(
                    *(tensor(z, name) for name in TableState._fields)))
        shadows = None
        if manifest.get("shadows", False):
            shadows = []
            for s in range(self.cfg.shards):
                with np.load(os.path.join(self.dir, f"shadow{s}.npz")) as z:
                    shadows.append(dict(zip(z["codes"].tolist(),
                                            z["vals"].tolist())))
        rp = ResumePoint(
            file_index=manifest["file_index"],
            records_done=manifest["records_done"],
            counters=manifest["counters"],
            output_sizes=manifest["output_sizes"],
            rr=manifest.get("rr", 0),
            shadows=shadows,
        )
        return states, rp
