"""Port rank_cand_scan (K3, narrow) vs the reference's Pallas kernel in
interpret mode, on the cases of tests/test_segscan.py; a run longer than
65535 is checked against that file's numpy oracle. Exact (tolerance 0); the
reference leaves padded sentinels as don't-care values, so they are
compared only against the oracle. Below them, a model of the CUDA kernel's
arithmetic (packed tile states, the saturating combine, the look-back and
its early stop) is held to the plain version and the reference on random
tilings."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.segscan import (
    BLOCK, rank_cand_scan as ref_scan,
)
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
from test_segscan import SENT, _oracle


def _port(skey, rid, fp_bits, n_reads):
    p2, p3 = rank_cand_scan(torch.from_numpy(skey.view(np.int32)),
                            torch.from_numpy(rid), fp_bits=fp_bits,
                            n_reads=n_reads)
    return p2.numpy(), p3.numpy()


def _check(skey, rid, fp_bits, n_reads):
    w2, w3 = ref_scan(jnp.asarray(skey), jnp.asarray(rid), fp_bits=fp_bits,
                      w=1, n_reads=n_reads, interpret=True)
    g2, g3 = _port(skey, rid, fp_bits, n_reads)
    real = skey != SENT
    np.testing.assert_array_equal(g2[real], np.asarray(w2)[real])
    np.testing.assert_array_equal(g3[real], np.asarray(w3)[real])
    o2, o3 = _oracle(skey, rid, fp_bits, n_reads)
    np.testing.assert_array_equal(g2, o2)
    np.testing.assert_array_equal(g3, o3)


def test_random_sorted_stream_matches_reference():
    rng = np.random.default_rng(7)
    n = BLOCK * 2
    key = np.sort(rng.integers(0, 5000, size=n - 777, dtype=np.uint32))
    key = np.concatenate([key, np.full(777, SENT, np.uint32)])
    rid = (rng.permutation(n) // 36).astype(np.int32)
    _check(key, rid, fp_bits=7, n_reads=n // 36)


def test_all_distinct_block_matches_reference():
    rng = np.random.default_rng(1)
    key = np.sort(rng.choice(1 << 20, size=BLOCK, replace=False)
                  ).astype(np.uint32)
    rid = (np.arange(BLOCK, dtype=np.int32) // 100)
    _check(key, rid, fp_bits=3, n_reads=BLOCK // 100)


def test_run_spanning_block_boundary_matches_reference():
    n = BLOCK * 2
    key = np.full(n, 42, np.uint32)
    rid = (np.arange(n, dtype=np.int32) // 64)
    _check(key, rid, fp_bits=4, n_reads=n // 64)


def test_rank_and_cand_clamps_match_oracle():
    # one run of 70000 (rank clamps at 65535), then 200 distinct keys of one
    # row (cand clamps at 128), then sentinels; unpadded length
    key = np.concatenate([
        np.full(70000, 5, np.uint32),
        (np.uint32(1 << 12) + np.arange(200, dtype=np.uint32)),
        np.full(33, SENT, np.uint32),
    ])
    rid = (np.arange(key.size, dtype=np.int32) // 150)
    n_reads = 400  # ids above it clamp to n_reads - 1
    g2, g3 = _port(key, rid, fp_bits=10, n_reads=n_reads)
    o2, o3 = _oracle(key, rid, 10, n_reads)
    np.testing.assert_array_equal(g2, o2)
    np.testing.assert_array_equal(g3, o3)
    assert (g2[65534:70000] & 0xFFFF == 65535).all()
    assert g3[70000 + 199] == 128


# ----------------------------------------------------------------------
# A model of csrc/segscan.cu's arithmetic, kept here because the kernel
# runs only on a card: threads of ITEMS elements reduce their code-change
# and row-change bit masks to one 32-bit in-tile carry; a tile publishes
# one 64-bit state (values saturating at 65535, two reset flags, a 2-bit
# status); a tile's exclusive prefix folds the states before it in windows
# of `window` tiles, right to left, and stops at the first inclusive prefix
# or where the fold holds both reset flags.

ITEMS = 16
R_FLAG, C_FLAG = 1 << 16, 1 << 48
AGGREGATE, PREFIX, STATUS = 1 << 62, 2 << 62, 3 << 62
VALUES = 0x0001FFFF0001FFFF


def _combine32(a, b):
    """In-tile carry (rank value 0..14, flag 15; cand 16..30, flag 31)."""
    lo = (b & 0xFFFF) if b & 0x8000 else (a + b) & 0xFFFF
    hi = (b & 0xFFFF0000) if b & 0x80000000 else \
        ((a & 0xFFFF0000) + (b & 0xFFFF0000)) & 0xFFFFFFFF
    return hi | lo


def _half(a, b):
    return b if b & 0x10000 else \
        (a & 0x10000) | min((a & 0xFFFF) + (b & 0xFFFF), 0xFFFF)


def _combine64(a, b):
    """Tile states (rank value 0..15, flag 16; cand 32..47, flag 48)."""
    return _half(a & 0x1FFFF, b & 0x1FFFF) | \
        _half(a >> 32 & 0x1FFFF, b >> 32 & 0x1FFFF) << 32


def _widen(c):
    return (c & 0x7FFF) | (c >> 15 & 1) << 16 | (c >> 16 & 0x7FFF) << 32 | \
        (c >> 31) << 48


def _thread_aggregate(ch, rch, valid):
    """From the bit masks: rank counts from the last code change, cand
    counts the code changes from the last row change."""
    rank = 0x8000 | (valid - (ch.bit_length() - 1)) if ch else valid
    cand = 0x8000 | bin(ch >> (rch.bit_length() - 1)).count("1") if rch \
        else bin(ch).count("1")
    return rank | cand << 16


def _look_back(states, t, window):
    """(exclusive prefix of tile t, states read)."""
    acc, pred, read = 0, t - 1, 0
    while True:
        lanes = [states[pred - i] if pred >= i else PREFIX
                 for i in range(window)]
        assert all(s & STATUS for s in lanes)  # the model publishes first
        stop, seen = window, acc & (R_FLAG | C_FLAG)
        for i, s in enumerate(lanes):
            seen |= s & (R_FLAG | C_FLAG)
            if s & STATUS == PREFIX or seen == R_FLAG | C_FLAG:
                stop = i
                break
        fold = 0
        for s in reversed(lanes[:stop + 1]):  # the earliest first
            fold = _combine64(fold, s & VALUES)
        acc = _combine64(fold, acc)
        read += min(stop + 1, window)
        if stop < window:
            return acc, read
        pred -= window


def _model_scan(key, key2, rid, shift, n_reads, tiles, window, rng):
    """p2, p3 by the kernel's arithmetic over tiles of the given lengths;
    each tile's successors see its inclusive prefix with probability 0.3,
    else its aggregate. Returns them and the most states a look-back
    read."""
    n = key.size
    ch = np.ones(n, bool)
    ch[1:] = key[1:] != key[:-1]
    if key2 is not None:
        ch[1:] |= key2[1:] != key2[:-1]
    rch = np.ones(n, bool)
    rch[1:] = (key[1:] >> shift) != (key[:-1] >> shift)
    p2, p3 = np.empty(n, np.int64), np.empty(n, np.int64)
    states, deepest, lo = [], 0, 0
    for t, size in enumerate(tiles):
        starts = range(lo, lo + size, ITEMS)
        masks = []
        for a in starts:
            valid = min(ITEMS, lo + size - a)
            bits = 1 << np.arange(valid)
            masks.append((int(bits[ch[a:a + valid]].sum()),
                          int(bits[rch[a:a + valid]].sum()), valid))
        excl, run = [], 0
        for m in masks:
            excl.append(run)
            run = _combine32(run, _thread_aggregate(*m))
        agg = _widen(run)
        prefix = 0
        if t:
            prefix, read = _look_back(states, t, window)
            deepest = max(deepest, read)
        states.append(_combine64(prefix, agg) | PREFIX
                      if t == 0 or rng.random() < 0.3 else agg | AGGREGATE)
        for a, x, (cm, rm, valid) in zip(starts, excl, masks):
            r = (x & 0x7FFF) + (0 if x & 0x8000 else prefix & 0xFFFF)
            c = (x >> 16 & 0x7FFF) + (0 if x & 0x80000000
                                      else prefix >> 32 & 0xFFFF)
            for j in range(valid):
                cj, rj = cm >> j & 1, rm >> j & 1
                r = 1 if cj else r + 1
                c = cj if rj else c + cj
                p2[a + j] = min(int(rid[a + j]), n_reads - 1) << 16 | \
                    min(r, 65535)
                p3[a + j] = min(c - 1, 128)
        lo += size
    assert lo == n
    return p2.astype(np.int32), p3.astype(np.int32), deepest


def _model_stream(rng, n, wide, shift, long_run):
    """Sorted keys (and second words): random codes with repeats, a row of
    300 distinct codes, a row of 100 codes x 100 over several tiles (its
    look-backs pass tiles with code changes and no row change), optionally
    one code `long_run` times."""
    rows = 1 << shift
    parts = [rng.integers(0, 1 << 24, size=n), 7 * rows +
             rng.integers(0, 300, size=3000), np.arange(300) + 9 * rows,
             np.repeat(np.arange(100) + 13 * rows, 100)]
    if long_run:
        parts.append(np.full(long_run, 11 * rows + 5))
    key = np.concatenate(parts).astype(np.uint32)
    key2 = rng.integers(0, 3, size=key.size).astype(np.uint32) \
        if wide else None
    if wide:
        key2[key == 11 * rows + 5] = 0
        order = np.lexsort((key2, key))
        key, key2 = key[order], key2[order]
    else:
        key.sort()
    rid = rng.integers(0, 1100, size=key.size).astype(np.int32)
    return key, key2, rid


def _tiling(rng, n, kind):
    if kind == "kernel":
        return [4096] * (n // 4096) + ([n % 4096] if n % 4096 else [])
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, 4097)))
    sizes[-1] -= sum(sizes) - n
    return [s for s in sizes if s]


def _plain(key, key2, rid, shift, n_reads):
    t = [None if x is None else torch.from_numpy(x.view(np.int32))
         for x in (key, key2)]
    p2, p3 = rank_cand_scan(t[0], torch.from_numpy(rid), fp_bits=shift,
                            n_reads=n_reads, skey2=t[1], row_shift=shift)
    return p2.numpy(), p3.numpy()


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("tiles,window", [("kernel", 32), ("random", 32),
                                          ("random", 3)])
def test_lookback_model_matches_plain(wide, tiles, window):
    """Random tilings of a sorted stream with a run of 70,000 (rank
    saturates through the look-back), a row of 300 codes (cand clamps at
    128) and a row of 100 codes over several tiles: the model equals
    rank_cand_scan_plain exactly, and its look-backs walk past the nearest
    tile."""
    rng = np.random.default_rng(11 + 2 * wide + window)
    shift = 13 if wide else 9
    key, key2, rid = _model_stream(rng, 30_000, wide, shift, 70_000)
    got = _model_scan(key, key2, rid, shift, 1000,
                      _tiling(rng, key.size, tiles), window, rng)
    want = _plain(key, key2, rid, shift, 1000)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] & 0xFFFF).max() == 65535 and got[1].max() == 128
    assert got[2] > 1


@pytest.mark.parametrize("wide", [False, True])
def test_lookback_model_matches_reference(wide):
    """The model on one reference block (interpret mode), random tiles."""
    rng = np.random.default_rng(5 + wide)
    shift = 13 if wide else 9
    key, key2, rid = _model_stream(rng, BLOCK - 13_300, wide, shift, 0)
    n_reads = 1100
    got = _model_scan(key, key2, rid, shift, n_reads,
                      _tiling(rng, key.size, "random"), 32, rng)
    kw = dict(skey2=jnp.asarray(key2), row_shift=shift) if wide else {}
    w2, w3 = ref_scan(jnp.asarray(key), jnp.asarray(rid), fp_bits=shift,
                      w=1, n_reads=n_reads, interpret=True, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(w2))
    np.testing.assert_array_equal(got[1], np.asarray(w3))
    np.testing.assert_array_equal(got[:2], _plain(key, key2, rid, shift,
                                                  n_reads))


def test_state_combine_is_associative_and_stops():
    """The saturating combine is associative on states and on in-tile
    carries (widened), and a fold that holds both flags ignores anything
    earlier."""
    rng = np.random.default_rng(2)

    def state():
        v = rng.integers(0, 1 << 16, size=2)
        v[rng.random(2) < 0.3] = 65535
        f = rng.random(2) < 0.4
        return int(v[0]) | int(f[0]) << 16 | int(v[1]) << 32 | int(f[1]) << 48

    def carry():
        v = rng.integers(0, 4096, size=2)
        f = rng.random(2) < 0.4
        return int(v[0]) | int(f[0]) << 15 | int(v[1]) << 16 | int(f[1]) << 31

    for _ in range(2000):
        a, b, c = state(), state(), state()
        assert _combine64(_combine64(a, b), c) == \
            _combine64(a, _combine64(b, c))
        if a & R_FLAG and a & C_FLAG:
            assert _combine64(b, a) == a
        x, y = carry(), carry()  # sums stay below 2^15
        assert _widen(_combine32(x, y)) == _combine64(_widen(x), _widen(y))
