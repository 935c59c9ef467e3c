"""Checkpoint / resume.

Port of nomalise_kmers_multi_large_tpu/engine/checkpoint.py: periodic
snapshots of (table state, stream position, counters, output file sizes)
that let a run resume exactly. The files are the JAX package's, so a
checkpoint written by either package loads in the other:

  manifest.json   config fingerprint + stream position + counters + sizes
  shard{N}.npz    table planes of shard N: counts, keys (none on the
                  direct table), keys2 (wide table at k > 16), used,
                  overflow; int32, and the hashed table's keys as uint32
                  (hi, lo) planes [2, C], as the JAX package writes a
                  TableState (table/base.py state_to_numpy)
  seeded_lo.npy   the direct table's seeded codes (uint32)
  shadow{N}.npz   the --debug > 2 shadow of shard N (codes, vals)

Arrays are numpy on disk and torch tensors on the engine's device on load.
Each file is written to a temporary name and renamed into place, so a crash
mid-save keeps the previous snapshot.

One repair of the JAX package's loader: it restores ``shadow*.npz`` and
``seeded_lo.npy`` whenever they exist, so a directory reused by another run
hands a later resume that run's stale files. The port's manifest records
whether each was saved (``"shadows"``, ``"seeded_lo"``), and the loader
reads them only then. A manifest the JAX package wrote has neither key: it
reads as "no shadows", and as "seeded_lo.npy saved" exactly when its table
is the direct one, for which the JAX package always writes the file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np

from nomalise_kmers_multi_large_torch.table.base import (
    TableState, state_from_numpy, state_to_numpy,
)


def _fingerprint(cfg) -> dict:
    """The JAX package's fingerprint; ``table`` is the resolved kind."""
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
    seeded_lo: Optional[np.ndarray] = None  # the direct table's seeds
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
             output_paths: list[str], rr: int, seeded_lo=None, shadows=None):
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
            st = state_to_numpy(state)
            arrays = {name: getattr(st, name)
                      for name in ("counts", "used", "overflow", "keys",
                                   "keys2")
                      if getattr(st, name) is not None}
            self._save_npz(f"shard{s}.npz", **arrays)
        if seeded_lo is not None:
            np.save(os.path.join(self.dir, "seeded_lo.npy"), seeded_lo)
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
            "seeded_lo": seeded_lo is not None,
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

        states = []
        for s in range(self.cfg.shards):
            with np.load(os.path.join(self.dir, f"shard{s}.npz")) as z:
                states.append(state_from_numpy(
                    [z[name] if name in z else None
                     for name in TableState._fields], device))
        seeded = None
        if manifest.get("seeded_lo", want["table"] == "direct"):
            seeded = np.load(os.path.join(self.dir, "seeded_lo.npy"))
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
            seeded_lo=seeded,
            shadows=shadows,
        )
        return states, rp
