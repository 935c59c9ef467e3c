"""Host-side 2-bit packing of sequence bytes.

Replaces the reference's per-record string pipeline: ``replacestr(seq,"N","A")``
(normalise_kmers_multi_large.c:475-486,:1406) then ``valid_dna`` (ATCG only, fatal
otherwise, :1144-1158) then per-kmer ``strncpy``+encode. Here a single 256-entry
LUT maps bytes to base codes with N folded to A, and one vectorized gather packs a
whole batch.
"""
from __future__ import annotations

import numpy as np

#: byte -> 2-bit code; N -> A (the reference rewrites N to A BEFORE validating);
#: anything else (including lowercase: the reference's base_map/valid_dna assume
#: uppercase, :150-154) -> 255 = invalid.
LUT = np.full(256, 255, np.uint8)
LUT[ord("A")] = 0
LUT[ord("C")] = 1
LUT[ord("G")] = 2
LUT[ord("T")] = 3
LUT[ord("N")] = 0  # replacestr(seq, "N", "A")


class InvalidSequenceError(ValueError):
    """Reference: FATAL: ... sequence does not appear to be a DNA sequence."""


def pack_batch(
    data: np.ndarray,
    seq_starts: np.ndarray,
    seq_lens: np.ndarray,
    pad_len: int,
    min_len: int,
    threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gather+encode sequences into a fixed-width base-code matrix.

    Args:
      data: uint8 file buffer (np.memmap or array).
      seq_starts: int64 [R] byte offset of each sequence line.
      seq_lens: int64 [R] sequence line length.
      pad_len: output width (>= max len).
      min_len: reads shorter than this get length 0 (the reference silently drops
        records shorter than k without counting them, :1408-1415; seeding uses the
        strictly-greater rule so callers pass k+1 there, :1347).

    Returns:
      bases: uint8 [R, pad_len] base codes (padding = 0).
      lengths: int32 [R] effective lengths (0 for too-short reads).

    Raises:
      InvalidSequenceError: if any in-range byte is not A/C/G/T/N — matching the
      reference's fatal exit (:1418-1419,:1447-1453).
    """
    r = seq_starts.shape[0]
    if r == 0:
        return np.zeros((0, pad_len), np.uint8), np.zeros((0,), np.int32)

    from nomalise_kmers_multi_large_torch.io import native

    got = native.pack(data, seq_starts, seq_lens, pad_len, min_len,
                      threads=threads)
    if got is not None:
        return got

    lens = np.minimum(seq_lens, pad_len).astype(np.int64)
    idx = seq_starts[:, None] + np.arange(pad_len, dtype=np.int64)[None, :]
    np.clip(idx, 0, data.shape[0] - 1, out=idx)
    raw = data[idx]
    codes = LUT[raw]
    mask = np.arange(pad_len, dtype=np.int64)[None, :] < lens[:, None]
    bad = (codes == 255) & mask
    if bad.any():
        row = int(np.argmax(bad.any(axis=1)))
        seq = bytes(data[seq_starts[row]: seq_starts[row] + seq_lens[row]])
        raise InvalidSequenceError(
            f"FATAL: sequence does not appear to be a DNA sequence\n{seq.decode(errors='replace')}"
        )
    bases = np.where(mask, codes, 0).astype(np.uint8)
    lengths = np.where(lens >= min_len, lens, 0).astype(np.int32)
    return bases, lengths
