"""k-mer codec: window codes, their validity, and decoding back to strings.

Port of nomalise_kmers_multi_large_tpu/ops/codec.py (the reference's
``encode_kmer_plain`` normalise_kmers_multi_large.c:1118-1126,
``get_canonical_kmer`` :1175-1180 and the ``sequence_to_hash`` window loop
:1459-1499), as plain torch on int64 words. A base is a 2-bit code (A=0,
C=1, G=2, T=3) and a k-mer's code is the big-endian concatenation of its
bases, so comparing codes compares the strings and canonical = min(code,
reverse-complement code) is the reference's string ``strcmp`` rule. A code
of k <= 31 bases (<= 62 bits) fits one int64; it is returned as the JAX
codec's (hi, lo) 32-bit words, each held in an int64 tensor (torch on the
CPU has no uint32 arithmetic).

The direct and hashed tables' step takes its codes from here
(``window_codes``, ``code_validity``: one int64 code per window). The bucket
path does not: its encode kernels (ops/encode_kernel.py) fuse the same
rules with the mix, and the ``--debug`` >= 3 self-check holds them against
this codec (engine/pipeline.py ``_debug_roundtrip``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "encode_windows",
    "encode_windows_canonical",
    "window_codes",
    "window_validity",
    "code_validity",
    "decode_codes",
]

_MASK32 = 0xFFFFFFFF


def _split(code: torch.Tensor):
    return code >> 32, code & _MASK32


def _codes(bases: torch.Tensor, k: int, rc: bool) -> torch.Tensor:
    """int64 [R, W] codes of every k-window (of its reverse complement with
    rc): base j of a window lands at 2-bit position 2*(k-1-j), or complemented
    (b ^ 3) at position 2*j."""
    R, L = bases.shape
    W = L - k + 1
    b = bases.to(torch.int64)
    code = torch.zeros((R, W), dtype=torch.int64, device=bases.device)
    for j in range(k):
        col = b[:, j:j + W]
        if rc:
            code |= (col ^ 3) << (2 * j)
        else:
            code = (code << 2) | col
    return code


def encode_windows(bases: torch.Tensor, k: int):
    """(hi, lo) int64 [R, L - k + 1] words of every k-window's code, the
    window's first base most significant. `bases` holds 2-bit codes 0..3
    (padding may hold any of them: mask with window_validity)."""
    return _split(_codes(bases, k, rc=False))


def window_codes(bases: torch.Tensor, k: int, canonical: bool):
    """int64 [R, L - k + 1] code of every k-window, optionally canonicalized
    to min(code, revcomp code)."""
    code = _codes(bases, k, rc=False)
    if canonical:
        code = torch.minimum(code, _codes(bases, k, rc=True))
    return code


def encode_windows_canonical(bases: torch.Tensor, k: int, canonical: bool):
    """encode_windows, optionally canonicalized to min(code, revcomp code)."""
    return _split(window_codes(bases, k, canonical))


def code_validity(lengths: torch.Tensor, code: torch.Tensor,
                  k: int) -> torch.Tensor:
    """bool [R, W]: the windows the reference counts. Window i of a read of
    length len is real iff i <= len - k (:1464), and the all-A code 0 is
    dropped (:1483-1484); a read of length 0 has none."""
    win = torch.arange(code.shape[-1], device=code.device)
    in_read = win <= lengths.to(torch.int64)[..., None] - k
    return in_read & (code != 0)


def window_validity(lengths: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                    k: int) -> torch.Tensor:
    """code_validity of a code given as its (hi, lo) words."""
    return code_validity(lengths, hi | lo, k)


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_codes(hi, lo, k: int) -> list[str]:
    """k-mer strings of 2-bit codes given as host (hi, lo) 32-bit words
    (reference decode_kmer_plain :1128-1136); for the -P dumps and the
    --debug >= 3 self-check."""
    code = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    out = np.empty((code.shape[0], k), dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[:, i] = _BASES[(code & np.uint64(3)).astype(np.int64)]
        code >>= np.uint64(2)
    return [bytes(row).decode() for row in out]
