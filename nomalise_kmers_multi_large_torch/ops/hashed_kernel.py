"""Hashed-table find-or-insert with the count update fused in.

The hashed table's one kernel (csrc/hashed.cu). It ports no Pallas kernel:
it replaces the XLA probe loop ``_insert`` of
nomalise_kmers_multi_large_tpu/table/hashed.py:57-107 and the count gather
and scatter after it (:140-149). Open addressing over ``keys`` (int64 [C],
a code per slot, 0 = empty; C a power of two) with the JAX table's slot hash
(murmur3 fmix32 over both 32-bit halves of the code) and triangular probe
``(h + r(r+1)/2) & (C - 1)``, at most 64 rounds.

``hashed_insert`` launches the kernel for CUDA tensors and runs
``hashed_insert_plain`` for CPU tensors. Both resolve every distinct
nonzero code of ``codes`` to a slot (found, or claimed if empty), and with
``counts`` read each one's prior count and, with ``mult``, add its
multiplicity. Where codes compete for one empty slot, the kernel's winner
is whichever CAS lands first; the plain version lets the lowest stream
position win each round, so it is deterministic (``index_put_`` with
duplicate indices is not). Slot placement therefore differs between the
two and from the JAX table; the set of codes, their counts, the number of
new and unresolved codes and each code's prior do not, while no code is
left unresolved by an order-dependent race (a table far from full).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from nomalise_kmers_multi_large_torch import backend

MAX_PROBE = 64               # table/hashed.py _MAX_PROBE
_MASK32 = 0xFFFFFFFF

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                           ctypes.c_void_p]


class InsertOut(NamedTuple):
    slot: Optional[torch.Tensor]   # int32 [n]: the code's slot, -1 if none
    prior: Optional[torch.Tensor]  # int32 [n]: counts[slot] before the add
    stats: torch.Tensor            # int64 [3]: new slots, unresolved codes,
                                   #            probes made


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def slot_hash(code: torch.Tensor) -> torch.Tensor:
    """The JAX table's ``_slot_hash(hi, lo)`` of int64 codes, as int64
    values in [0, 2^32)."""
    hi, lo = code >> 32, code & _MASK32
    return _fmix32(lo ^ _fmix32(hi ^ 0x9E3779B9))


def _check(keys, codes, mult, counts):
    cap = keys.numel()
    if keys.dim() != 1 or codes.dim() != 1 or cap < 2 or cap & (cap - 1) \
            or cap > 1 << 31:
        raise ValueError(f"hashed_insert: keys must be [C], C a power of two "
                         f"up to 2^31, and codes [n]; got {tuple(keys.shape)}"
                         f", {tuple(codes.shape)}")
    if keys.dtype != torch.int64 or codes.dtype != torch.int64:
        raise TypeError("hashed_insert: keys and codes must be int64")
    if mult is not None and (counts is None or mult.shape != codes.shape
                             or mult.dtype != torch.int32):
        raise ValueError("hashed_insert: mult needs counts and must be "
                         "int32 [n]")
    if counts is not None and (counts.shape != keys.shape
                               or counts.dtype != torch.int32):
        raise ValueError("hashed_insert: counts must be int32 [C]")


def hashed_insert_plain(keys, codes, mult=None, counts=None) -> InsertOut:
    """Plain PyTorch version of the kernel, on any device: the JAX table's
    probe rounds, in which the lowest stream position wins each contested
    empty slot. Updates keys (and counts) in place."""
    _check(keys, codes, mult, counts)
    dev = codes.device
    n, mask = codes.numel(), keys.numel() - 1
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    idx = torch.nonzero(codes).squeeze(1)      # pending stream positions
    q = codes[idx]
    h = slot_hash(q)
    n_new = probes = 0
    for r in range(MAX_PROBE):
        if idx.numel() == 0:
            break
        probes += idx.numel()
        cand = (h + r * (r + 1) // 2) & mask
        cur = keys[cand]
        # claims: the lowest pending position of each empty candidate slot
        empty = torch.nonzero(cur == 0).squeeze(1)
        uniq, inv = torch.unique(cand[empty], return_inverse=True)
        first = torch.full((uniq.numel(),), n, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, inv, idx[empty],
                                                       "amin")
        won = torch.zeros_like(cur, dtype=torch.bool)
        won[empty] = idx[empty] == first[inv]
        keys[cand[won]] = q[won]
        n_new += int(won.sum())
        done = won | (cur == q)
        slot[idx[done]] = cand[done]
        idx, q, h = idx[~done], q[~done], h[~done]
    prior = torch.zeros(n, dtype=torch.int32, device=dev)
    hit = torch.nonzero(slot >= 0).squeeze(1)
    if counts is not None:
        prior[hit] = counts[slot[hit]]
        if mult is not None:
            counts[slot[hit]] += mult[hit]
    stats = torch.tensor([n_new, idx.numel(), probes], dtype=torch.int64,
                         device=dev)
    return InsertOut(slot.to(torch.int32), prior, stats)


def hashed_insert(keys, codes, mult=None, counts=None, *,
                  outputs: bool = True) -> InsertOut:
    """Find-or-insert the nonzero (distinct) codes of `codes` into `keys`.

    Args:
      keys: int64 [C] slot codes (0 = empty), C a power of two; updated in
        place.
      codes: int64 [n]; 0 marks a position that carries no code.
      mult: int32 [n] or None: added to each resolved code's count.
      counts: int32 [C] or None: read for the prior (and, with mult,
        updated in place).
      outputs: False skips the slot and prior outputs (the kernel's grow
        pass needs neither); the plain version always returns them.

    Returns InsertOut(slot, prior, stats).
    """
    if keys.device.type == "cpu":
        return hashed_insert_plain(keys, codes, mult, counts)
    _check(keys, codes, mult, counts)
    backend.require_cuda("hashed_insert", keys, codes,
                         *(t for t in (mult, counts) if t is not None))
    n = codes.numel()
    slot = prior = None
    if outputs:
        slot = torch.empty(n, dtype=torch.int32, device=keys.device)
        prior = torch.empty(n, dtype=torch.int32, device=keys.device)
    stats = torch.zeros(3, dtype=torch.int64, device=keys.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = backend.function("hashed_insert", "nkm_hashed_insert", _ARGTYPES)
    backend.launch("hashed_insert", fn, codes.data_ptr(), n, keys.data_ptr(),
                   keys.numel(), ptr(mult), ptr(counts), ptr(slot),
                   ptr(prior), stats.data_ptr(), keys.device.index or 0,
                   backend.stream_of(keys))
    return InsertOut(slot, prior, stats)
