"""--debug > 2 per-upsert lines: host shadow of a shard's count table.

The port's copy of nomalise_kmers_multi_large_tpu/engine/debug_shadow.py.
The reference prints two line kinds inside ``store_kmer``
(normalise_kmers_multi_large.c:944-945 and :1050-1051):

  DEBUG: Kmer hash: %lu, Count: %d        (always; count BEFORE the upsert)
  DEBUG: New Kmer hash: %lu, Count: %d    (only when an EXISTING entry was
                                           incremented; brand-new inserts and
                                           seed re-encounters early-return
                                           before it, :970/:1001)

A batched device kernel has no per-upsert program point, so this tier is
served by an exact host-side shadow table replayed per record at retire
time (and per seed record during the seed pass). In the collision-free
regime the reference's printed "hash" IS the 2-bit k-mer code, so the lines
are the reference binary's. Cost is O(windows) of Python per record: a
diagnostic tier, like the reference's own.

The shadow's counts ride the checkpoint (engine/checkpoint.py
``shadow{N}.npz``), so upsert counts stay absolute across ``--resume``.
"""
from __future__ import annotations

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_MAP = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T


class UpsertShadow:
    """Exact sequential shadow of one shard's table for the debug>2 tier."""

    def __init__(self, k: int, canonical: bool):
        self.k = k
        self.canonical = canonical
        self.counts: dict[int, int] = {}

    def copy(self) -> "UpsertShadow":
        s = UpsertShadow(self.k, self.canonical)
        s.counts = dict(self.counts)
        return s

    def _codes(self, seq: bytes):
        """2-bit codes of every window, reference order and rules: N->A
        rewrite (:1406), canonical = min(kmer, revcomp) as strings (:1175),
        poly-A code 0 dropped (:1483). Windows containing other letters are
        skipped (the reference exits fatally there; the engine records them
        as invalid windows instead — documented divergence)."""
        seq = seq.upper().replace(b"N", b"A")
        k = self.k
        for i in range(len(seq) - k + 1):
            km = seq[i:i + k]
            if self.canonical:
                rc = km.translate(_COMP)[::-1]
                if rc < km:
                    km = rc
            code = 0
            try:
                for ch in km:
                    code = (code << 2) | _MAP[ch]
            except KeyError:
                continue
            if code == 0:
                continue
            yield code

    def seed_seq(self, seq: bytes, out) -> None:
        """Seed-pass replay (store_kmer do_init=true): before-line only —
        both the new-insert and the seed-match branches early-return before
        the after-line; counts stay 0."""
        if len(seq) <= self.k:  # strictly-greater seed rule (:1347)
            return
        for code in self._codes(seq):
            out.write(f"DEBUG: Kmer hash: {code}, Count: "
                      f"{self.counts.get(code, 0)}\n")
            self.counts.setdefault(code, 0)

    def process_seq(self, seq: bytes, out) -> None:
        """Main-pass replay: before-line always; after-line only when an
        existing entry is incremented (:1003 -> :1050)."""
        if len(seq) < self.k:
            return
        for code in self._codes(seq):
            before = self.counts.get(code)
            out.write(f"DEBUG: Kmer hash: {code}, Count: {before or 0}\n")
            if before is None:
                self.counts[code] = 1  # new insert: early return, no line
            else:
                self.counts[code] = before + 1
                out.write(f"DEBUG: New Kmer hash: {code}, "
                          f"Count: {before + 1}\n")
