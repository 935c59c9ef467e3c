"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere (a
CUDA kernel has no CPU mode). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Every output is an integer, so every comparison is exact (tolerance 0).
"""
import pathlib

import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    bucket_batch, bucket_batch_wide, bucket_upsert, bucket_upsert_plain,
    bucket_upsert_wide, bucket_upsert_wide_plain, sort_stream,
    sort_stream_wide,
)
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys, encode_keys_plain, encode_keys_wide, encode_keys_wide_plain,
)
from nomalise_kmers_multi_large_torch.ops.mix import feistel_words_np
from nomalise_kmers_multi_large_torch.ops.segscan import (
    _TILE, rank_cand_scan, rank_cand_scan_plain,
)
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, BucketTableWide, state_to_numpy,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _reads(rng, n, length, pool=None):
    pool = pool or max(2, n // 8)
    seqs = rng.integers(0, 4, size=(pool, length), dtype=np.uint8)
    bases = seqs[rng.integers(0, pool, size=n)]
    sub = rng.random(bases.shape) < 0.01
    bases[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
    lengths = np.full(n, length, np.int32)
    lengths[::5] = rng.integers(0, length + 1, size=lengths[::5].size)
    return bases, lengths


ENCODE_LS = ["k", 37, 100, 150, 152, 1100]  # W = 1; L not a multiple of
# 4 or 16; the main path's 150 and 152 (W a multiple of 8); L > 1023


def _encode_on_card(dev, k, canonical, bases, lengths, offset=0):
    """The kernel and the plain version on the same tensors; bases as a
    contiguous view `offset` bytes into its storage."""
    R, L = bases.shape
    store = torch.zeros(R * L + offset, dtype=torch.uint8, device=dev)
    store[offset:] = torch.from_numpy(bases.reshape(-1)).to(dev)
    b = store[offset:].view(R, L)
    assert b.data_ptr() % 16 == offset % 16 and b.is_contiguous()
    ln = torch.from_numpy(lengths).to(dev)
    if k <= 15:
        got, want = (encode_keys(b, ln, k, canonical),), \
            (encode_keys_plain(b, ln, k, canonical),)
    else:
        got = encode_keys_wide(b, ln, k, canonical)
        want = encode_keys_wide_plain(b, ln, k, canonical)
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert a.shape == (R, L - k + 1) and torch.equal(a, c)
    return got[-1]


def _encode_reads(rng, k, L, R=1000):
    """Reads as _reads, with rows of length 0, k - 1 and 5000 (clipped to
    1023), poly-A and poly-T rows."""
    bases, lengths = _reads(rng, R, L)
    lengths[:3] = [0, k - 1, 5000]
    bases[3], lengths[3] = 0, L
    bases[4], lengths[4] = 3, L
    return bases, lengths


def _check_encode(dev, k, canonical):
    for L in ENCODE_LS:
        L = k if L == "k" else L
        bases, lengths = _encode_reads(np.random.default_rng(k * L), k, L)
        last = _encode_on_card(dev, k, canonical, bases, lengths)
        assert (last[:2] == -1).all() and (last[3] == -1).all()
        assert bool((last[4] == -1).all()) == canonical
        if L > 1023:  # length 5000 clips to 1023
            assert (last[2, 1024 - k:] == -1).all()


@pytest.mark.parametrize("k", range(5, 16))
@pytest.mark.parametrize("canonical", [False, True])
def test_encode_kernel_matches_plain(dev, k, canonical):
    """Every k of the narrow path at every width of ENCODE_LS."""
    _check_encode(dev, k, canonical)


@pytest.mark.parametrize("k", [5, 8, 15, 16, 17, 25, 31])
def test_encode_kernels_rows_and_views(dev, k):
    """R = 0 (no launch), R = 1, R = 997 (a prime: no rows per block
    divides it), and bases views that start 1, 3 and 9 bytes into their
    storage (16-byte loads over an unaligned span)."""
    rng = np.random.default_rng(k)
    for R, offset in ((0, 0), (1, 0), (997, 0), (997, 1), (1, 3), (64, 9)):
        for L in (k, 37, 152, 1100):
            bases, lengths = _reads(rng, max(R, 1), L)
            bases, lengths = bases[:R], lengths[:R]
            _encode_on_card(dev, k, True, bases, lengths, offset)


def test_scan_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    key = np.sort(rng.integers(0, 1 << 20, size=300_000)).astype(np.uint32)
    key = np.concatenate([key, np.full(70_000, 77 << 20, np.uint32),
                          np.full(1234, 0xFFFFFFFF, np.uint32)])
    key.sort()
    rid = rng.integers(0, 16384, size=key.size).astype(np.int32)
    sk = torch.from_numpy(key.view(np.int32)).to(dev)
    sr = torch.from_numpy(rid).to(dev)
    for fp_bits in (1, 9, 16):
        got = rank_cand_scan(sk, sr, fp_bits=fp_bits, n_reads=9000)
        want = rank_cand_scan_plain(sk, sr, fp_bits=fp_bits, n_reads=9000)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


T = _TILE
SENT = 0xFFFFFFFF
SCAN_CASES = ["empty", "one", "tile-1", "tile", "tile+1", "run-3-tiles",
              "run-over-65535", "row-over-128", "row-3-tiles",
              "key2-at-boundary", "over-20M"]


def _sorted_keys(rng, n, hi=1 << 22):
    return np.sort(rng.integers(0, hi, size=n)).astype(np.uint32)


def _scan_case(case, wide, rng):
    """A sorted stream (key, key2 or None, rid) for one of SCAN_CASES, and
    the row shift: fp_bits 9 narrow, row_shift 17 wide."""
    shift = 17 if wide else 9
    rows = 1 << shift  # keys per row
    if case == "empty":
        key = np.zeros(0, np.uint32)
    elif case == "one":
        key = np.array([12345], np.uint32)
    elif case.startswith("tile"):
        n = T + {"tile-1": -1, "tile": 0, "tile+1": 1}[case]
        key = _sorted_keys(rng, n, 1 << 30)
    elif case == "run-3-tiles":  # one code, no reset, from mid tile 0 to 4
        key = np.concatenate([
            _sorted_keys(rng, T // 2, 5 * rows),
            np.full(3 * T + 100, 5 * rows + 7, np.uint32),
            _sorted_keys(rng, T, 1 << 30) | np.uint32(1 << 30)])
    elif case == "run-over-65535":  # rank saturates through the look-back
        key = np.concatenate([
            _sorted_keys(rng, 1500, 3 * rows),
            np.full(70_000, 3 * rows + 1, np.uint32),
            _sorted_keys(rng, 9000, 1 << 30) | np.uint32(1 << 30)])
    elif case == "row-over-128":  # 300 codes of one row across a boundary
        key = np.concatenate([
            _sorted_keys(rng, T - 700, 2 * rows),
            np.repeat(2 * rows + np.arange(300, dtype=np.uint32), 5),
            _sorted_keys(rng, 3000, 1 << 30) | np.uint32(1 << 30)])
    elif case == "row-3-tiles":  # 100 codes of one row over 3 tiles
        key = np.concatenate([
            _sorted_keys(rng, T // 2, 2 * rows),
            np.repeat(2 * rows + np.arange(100, dtype=np.uint32), 130),
            _sorted_keys(rng, 3000, 1 << 30) | np.uint32(1 << 30)])
    elif case == "key2-at-boundary":  # key constant over 2 tiles
        key = np.concatenate([_sorted_keys(rng, T - 100, rows),
                              np.full(2 * T, rows + 3, np.uint32),
                              _sorted_keys(rng, 5000, 1 << 30)
                              | np.uint32(1 << 30)])
    else:  # over-20M: far more tiles than can be resident at once
        key = np.concatenate([_sorted_keys(rng, 20_000_000, 1 << 24),
                              np.full(200_000, (1 << 24) + 5, np.uint32)])
    n = key.size
    key2 = None
    if wide:
        key2 = rng.integers(0, 3, size=n).astype(np.uint32)
        vals, counts = np.unique(key, return_counts=True)
        key2[np.isin(key, vals[counts >= 1000])] = 0  # the long runs stay
        if case == "key2-at-boundary":  # only key2 changes, exactly there
            at = T - 100
            key2[at:at + 2 * T] = 0
            key2[T:at + 2 * T] = 1
        order = np.lexsort((key2, key))
        key, key2 = key[order], key2[order]
    if case not in ("empty", "one"):
        tail = min(77, n // 10)
        key[n - tail:] = SENT
        if wide:
            key2[n - tail:] = SENT
    rid = rng.integers(0, 16384 + 100, size=n).astype(np.int32)
    return key, key2, rid, shift


def _scan_on_card(dev, key, key2, rid, shift, offset=0):
    """The kernel and the plain version on the same tensors (views that
    start `offset` elements in)."""
    t = [None if x is None else
         torch.from_numpy(x.view(np.int32)).to(dev)[offset:]
         for x in (key, key2, rid)]
    kw = dict(fp_bits=shift, n_reads=16384) if key2 is None else \
        dict(fp_bits=0, n_reads=16384, skey2=t[1], row_shift=shift)
    got = rank_cand_scan(t[0], t[2], **kw)
    want = rank_cand_scan_plain(t[0], t[2], **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case,wide", [
    (c, w) for c in SCAN_CASES for w in (False, True)
    if w or c != "key2-at-boundary"])  # key2 exists on the wide path only
def test_scan_tiles_match_plain(dev, case, wide):
    """The single-pass scan at and around the tile size, across look-backs
    that walk past the nearest tile (and past 32 tiles), saturating ranks,
    rows over 128 codes or over 3 tiles, a key2-only change at a tile
    boundary and > 20M elements."""
    key, key2, rid, shift = _scan_case(case, wide, np.random.default_rng(
        SCAN_CASES.index(case) + 50 * wide))
    got, want = _scan_on_card(dev, key, key2, rid, shift)
    assert got[0].shape == (key.size,)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "run-over-65535":
        assert int((got[0] & 0xFFFF).max()) == 65535
    if case == "row-over-128":
        assert int(got[1].max()) == 128


@pytest.mark.parametrize("wide", [False, True])
def test_scan_back_to_back_and_unaligned(dev, wide):
    """Calls in a row each start from fresh tile states (a long stream, a
    short one, the long one again), and views that are not 16-byte aligned
    take the scalar loads."""
    rng = np.random.default_rng(9 + wide)
    long_case = _scan_case("run-over-65535", wide, rng)
    short_case = _scan_case("tile+1", wide, rng)
    for case in (long_case, short_case, long_case):
        got, want = _scan_on_card(dev, *case)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for offset in (1, 3):
        got, want = _scan_on_card(dev, *long_case, offset=offset)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _crafted_rows(rng, rows, lanes, fa_bits, plane_b):
    """Pre-filled planes and a batch of codes that reach every path of the
    bucket kernels: rows 0..5 pre-filled to occupancy 0, 31, 32, 33, 64 and
    `lanes` (others 0..5), each row given a few matched and new codes; row 6
    one code 70 times and a pre-filled one 40 times (runs longer than 32);
    row 7 40 new codes (a row across slices, inserts across groups); rows
    100..163 one new code each (a slice that starts 32 rows). With plane B,
    two slots of a row share fpA. Returns (fpA, fpB or None, counts) and the
    codes' (row, fa, fb) per element, unsorted."""
    occ = rng.integers(0, 6, size=rows)
    occ[:6] = np.minimum([0, 31, 32, 33, 64, lanes], lanes)
    fpa = np.zeros((rows, lanes), np.int64)
    fpb = np.zeros((rows, lanes), np.int64)
    counts = rng.integers(0, 6, size=(rows, lanes)) * (
        np.arange(lanes)[None, :] < occ[:, None])
    for r in range(rows):
        fa = rng.permutation(np.unique(rng.integers(
            1, (1 << fa_bits) + 1, size=3 * lanes)))[:occ[r]]
        if plane_b and occ[r] > 1:
            fa[1] = fa[0]  # same fpA, another fpB
        fpa[r, :occ[r]] = fa
        if plane_b:
            fpb[r, :occ[r]] = rng.integers(0, 1 << 30, size=occ[r])

    def new_code(r, same_fa=False):
        """A code not in row r; with same_fa (plane B only), one that shares
        fpA with lanes 0 and 1 but not their fpB."""
        while True:
            fa = int(rng.integers(1, (1 << fa_bits) + 1))
            fb = int(rng.integers(0, 1 << 30)) if plane_b else 0
            if same_fa and plane_b and occ[r]:
                if fb not in fpb[r, :2]:
                    return int(fpa[r, 0]), fb
            elif fa not in fpa[r, :occ[r]]:
                return fa, fb

    codes = []  # (row, fa, fb, multiplicity)
    for r in range(rows):
        if 100 <= r < 164:
            codes.append((r, *new_code(r), 1))
            continue
        if r == 6:
            codes.append((r, *new_code(r), 70))
            if occ[r]:
                codes.append((r, fpa[r, 0], fpb[r, 0], 40))
            continue
        if r == 7:
            codes += [(r, *new_code(r), 1) for _ in range(40)]
            continue
        picks = rng.permutation(occ[r])[:rng.integers(0, 4)].tolist()
        if occ[r] > 32:
            picks.append(32)  # a code past the first 32 lanes
        codes += [(r, fpa[r, j], fpb[r, j], int(rng.integers(1, 4)))
                  for j in set(picks)]
        codes += [(r, *new_code(r, same_fa=i == 0), int(rng.integers(1, 4)))
                  for i in range(int(rng.integers(0, 4)) + (r < 6))]
    elems = np.array([c[:3] for c in codes for _ in range(c[3])], np.int64)
    elems = elems[rng.permutation(len(elems))]
    planes = (fpa, fpb if plane_b else None, counts)
    return planes, elems


def _to_dev(dev, *arrays):
    return [None if x is None else
            torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)
                             .astype(np.uint32).view(np.int32)).to(dev)
            for x in arrays]


def _narrow_stream(dev, case, lanes, rng):
    """(fp, counts, skey, p2, p3, n_reads, fp_bits) on the card: a k = 11
    table of 256 rows pre-filled by two seed batches and a third batch
    ("batches"), or the crafted rows and codes of _crafted_rows."""
    table = BucketTable(11, rows=256, lanes=lanes, device=dev)
    state = table.init()
    if case == "batches":
        stream = []
        for _ in range(3):
            bases, lengths = _reads(rng, 512, 100)
            key = encode_keys(torch.from_numpy(bases).to(dev),
                              torch.from_numpy(lengths).to(dev), 11, False)
            rid = torch.arange(key.numel(), device=dev) // key.shape[1]
            skey, srid = sort_stream(key.reshape(-1), rid)
            p2, p3 = rank_cand_scan(skey, srid, fp_bits=table.fp_bits,
                                    n_reads=key.shape[0])
            stream.append((skey, p2, p3, key.shape[0]))
        for skey, p2, p3, n in stream[:2]:
            bucket_upsert(state.keys, state.counts, skey, p2, p3,
                          fp_bits=table.fp_bits, depth=4, seed=True,
                          n_reads=n)
        skey, p2, p3, n = stream[2]
        return state.keys, state.counts, skey, p2, p3, n, table.fp_bits
    (fpa, _, counts), elems = _crafted_rows(rng, 256, lanes, table.fp_bits,
                                            False)
    fp, cnt = _to_dev(dev, fpa, counts)
    n_reads = 512
    key = (elems[:, 0] << table.fp_bits) | (elems[:, 1] - 1)
    key = np.concatenate([key, np.full(77, 0xFFFFFFFF)])
    skey_in, = _to_dev(dev, key)
    rid = torch.from_numpy(rng.integers(0, n_reads, size=key.size)).to(dev)
    skey, srid = sort_stream(skey_in, rid)
    p2, p3 = rank_cand_scan(skey, srid, fp_bits=table.fp_bits,
                            n_reads=n_reads)
    return fp, cnt, skey, p2, p3, n_reads, table.fp_bits


@pytest.mark.parametrize("case", ["batches", "crafted"])
@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("seed", [False, True])
def test_bucket_kernel_matches_plain(dev, lanes, seed, case):
    """A batch on a pre-filled table whose rows partly overflow: planes,
    tallies and stats equal. "batches": two seed batches then a third;
    "crafted": rows at occupancy 0, 31, 32, 33, 64 and full, runs and rows
    longer than 32 elements, a slice of 32 row starts (_crafted_rows)."""
    rng = np.random.default_rng(lanes + seed + (case == "crafted") * 7)
    fp, counts, skey, p2, p3, n, fp_bits = _narrow_stream(dev, case, lanes,
                                                          rng)
    fp2, c2 = fp.clone(), counts.clone()
    kw = dict(fp_bits=fp_bits, depth=3 if case == "crafted" else 4,
              seed=seed, n_reads=n)
    high, stats = bucket_upsert(fp, counts, skey, p2, p3, **kw)
    phigh, pstats = bucket_upsert_plain(fp2, c2, skey, p2, p3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fp, fp2) and torch.equal(counts, c2)
    assert torch.equal(high, phigh) and torch.equal(stats, pstats)
    assert int(stats[0]) > 0 and int(stats[1]) > 0
    if not seed:
        assert int(high.sum()) > 0


# ----------------------------------------------------------------------
# wide kernels (k = 16..31): K2, K3w, K5

@pytest.mark.parametrize("k", range(16, 32))
@pytest.mark.parametrize("canonical", [False, True])
def test_encode_wide_kernel_matches_plain(dev, k, canonical):
    """Every k of the wide path at every width of ENCODE_LS."""
    _check_encode(dev, k, canonical)


def _wide_stream(dev, k, n=300_000, seed=0):
    """Sorted wide stream: codes from a pool (long runs, some crossing scan
    tiles), one run of 70,000, codes sharing w1 with other w2, sentinels."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 1 << (2 * k), size=20_000, dtype=np.uint64)
    codes = np.concatenate([pool[rng.integers(0, pool.size, size=n)],
                            np.full(70_000, pool[0], np.uint64)])
    w1, w2 = feistel_words_np(codes, 2 * k)
    if k > 16:  # same w1, another w2: a new code in the same run of w1
        w2[: n // 10] ^= np.uint32(1)
    w1 = np.concatenate([w1, np.full(5000, 0xFFFFFFFF, np.uint32)])
    w2 = np.concatenate([w2, np.full(5000, 0xFFFFFFFF, np.uint32)])
    t = [torch.from_numpy(x.view(np.int32)).to(dev) for x in (w1, w2)]
    return sort_stream_wide(*t, 150)


@pytest.mark.parametrize("k", [16, 25, 31])
def test_scan_wide_kernel_matches_plain(dev, k):
    sk1, sk2, srid = _wide_stream(dev, k)
    n_reads = int(srid.max()) + 1
    for row_shift in (8, 10, 11, 17, 23):
        kw = dict(fp_bits=0, n_reads=n_reads, skey2=sk2, row_shift=row_shift)
        got = rank_cand_scan(sk1, srid, **kw)
        want = rank_cand_scan_plain(sk1, srid, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _wide_batches(dev, table, rng, n_batches=3):
    out = []
    for _ in range(n_batches):
        bases, lengths = _reads(rng, 1024, 100)
        w1, w2 = encode_keys_wide(torch.from_numpy(bases).to(dev),
                                  torch.from_numpy(lengths).to(dev),
                                  table.k, False)
        sk1, sk2, srid = sort_stream_wide(w1.reshape(-1), w2.reshape(-1),
                                          w1.shape[1])
        p2, p3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=w1.shape[0],
                                skey2=sk2, row_shift=table.row_shift)
        out.append((sk1, sk2, p2, p3, w1.shape[0]))
    return out


def _check_wide_upsert(table, state, stream, seed, depth=4):
    planes = (state.keys, state.keys2, state.counts)
    copies = [None if x is None else x.clone() for x in planes]
    sk1, sk2, p2, p3, n = stream
    kw = dict(row_shift=table.row_shift, depth=depth, seed=seed, n_reads=n)
    high, stats = bucket_upsert_wide(*planes, sk1, sk2, p2, p3, **kw)
    phigh, pstats = bucket_upsert_wide_plain(*copies, sk1, sk2, p2, p3, **kw)
    torch.cuda.synchronize()
    for a, b in zip(planes, copies):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(high, phigh) and torch.equal(stats, pstats)
    return stats


def _crafted_wide_stream(dev, table, rng):
    """The rows and codes of _crafted_rows on a wide table: planes on the
    card and the sorted, scanned stream (150 windows per read)."""
    rows, lanes = table.rows, table.lanes
    planes, elems = _crafted_rows(rng, rows, lanes, table.row_shift,
                                  table.k > 16)
    w = 150
    w1 = (elems[:, 0] << table.row_shift) | (elems[:, 1] - 1)
    w2 = elems[:, 2]
    pad = -len(w1) % w + 2 * w
    w1 = np.concatenate([w1, np.full(pad, 0xFFFFFFFF)])
    w2 = np.concatenate([w2, np.full(pad, 0xFFFFFFFF)])
    sk1, sk2, srid = sort_stream_wide(*_to_dev(dev, w1, w2), w)
    n_reads = len(w1) // w
    p2, p3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=n_reads,
                            skey2=sk2, row_shift=table.row_shift)
    return _to_dev(dev, *planes), (sk1, sk2, p2, p3, n_reads)


@pytest.mark.parametrize("case", ["batches", "crafted"])
@pytest.mark.parametrize("k", [16, 25, 31])
@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("seed", [False, True])
def test_bucket_wide_kernel_matches_plain(dev, k, lanes, seed, case):
    """A batch on a 512-row table whose rows partly overflow: planes, tallies
    and stats equal. "batches": two seed batches then a third; "crafted": the
    rows and codes of _crafted_rows."""
    rng = np.random.default_rng(k + lanes + seed + (case == "crafted") * 7)
    table = BucketTableWide(k, rows=512, lanes=lanes, device=dev)
    state = table.init()
    assert (state.keys2 is None) == (k == 16)
    if case == "batches":
        stream = _wide_batches(dev, table, rng)
        for s in stream[:2]:
            _check_wide_upsert(table, state, s, seed=True)
        stats = _check_wide_upsert(table, state, stream[2], seed=seed)
    else:
        (fpa, fpb, counts), stream = _crafted_wide_stream(dev, table, rng)
        state = state._replace(keys=fpa, keys2=fpb, counts=counts)
        stats = _check_wide_upsert(table, state, stream, seed=seed, depth=3)
    assert int(stats[0]) > 0 and int(stats[1]) > 0


@pytest.mark.parametrize("k", [16, 25])
def test_bucket_wide_kernel_last_row_beside_sentinels(dev, k):
    """Real codes with w1 = 0xFFFFFFFF and w1 in row rows - 1, followed by
    sentinel pairs whose w1 maps to the same row: only the real codes
    count."""
    table = BucketTableWide(k, rows=1024, device=dev)
    state = table.init()
    n_real = 40
    w1 = np.full(n_real + 60, 0xFFFFFFFF, np.uint32)
    w1[: n_real // 2] = 0xFFFFFFFF - np.arange(n_real // 2, dtype=np.uint32)
    w2 = np.full(n_real + 60, 0xFFFFFFFF, np.uint32)
    w2[:n_real] = 0 if k == 16 else np.arange(n_real) % 7
    t = [torch.from_numpy(x.view(np.int32)).to(dev) for x in (w1, w2)]
    sk1, sk2, srid = sort_stream_wide(*t, 10)
    p2, p3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=10, skey2=sk2,
                            row_shift=table.row_shift)
    stats = _check_wide_upsert(table, state, (sk1, sk2, p2, p3, 10),
                               seed=False, depth=2)
    assert int(stats[1]) == int((state.keys[-1] != 0).sum()) > 0
    assert int(state.counts.sum()) == n_real


@pytest.mark.parametrize("row_shift", [10, 8])
def test_bucket_wide_kernel_on_2_22_and_2_24_rows(dev, row_shift):
    """K5 on the tables past the old 2^21-row ceiling: 2^22 rows (row_shift
    10) and 2^24 rows (row_shift 8, 12 GiB of planes, and as much again
    for the plain version's copy), seeded by two batches, then a third in
    count mode."""
    table = BucketTableWide(25, rows=1 << (32 - row_shift), device=dev)
    assert table.row_shift == row_shift
    state = table.init()
    stream = _wide_batches(dev, table, np.random.default_rng(row_shift))
    for s in stream[:2]:
        _check_wide_upsert(table, state, s, seed=True)
    stats = _check_wide_upsert(table, state, stream[2], seed=False)
    assert int(stats[1]) > 0 and int(stats[0]) == 0
    del state
    torch.cuda.empty_cache()


def test_wide_table_grows_past_2_21_rows_on_the_card(dev):
    """A 2^21-row table filled by the kernels grows to 2^22 rows on the
    card, equal lane for lane to the same growth on the CPU, and the grown
    table takes a batch as the plain version does."""
    table = BucketTableWide(25, rows=1 << 21, device=dev)
    assert table.can_grow
    state = table.init()
    rng = np.random.default_rng(21)
    for s in _wide_batches(dev, table, rng, n_batches=2):
        _check_wide_upsert(table, state, s, seed=True)
    cpu_table = BucketTableWide(25, rows=1 << 21)
    cpu_state = type(state)(*(None if x is None else x.cpu() for x in state))
    grown_t, grown = table.grown(state)
    cpu_t, cpu_grown = cpu_table.grown(cpu_state)
    del state, cpu_state
    assert grown_t.rows == cpu_t.rows == 1 << 22
    got, want = state_to_numpy(grown), state_to_numpy(cpu_grown)
    for name in ("keys", "keys2", "counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    del cpu_grown
    stream = _wide_batches(dev, grown_t, rng, n_batches=1)[0]
    stats = _check_wide_upsert(grown_t, grown, stream, seed=False)
    assert int(stats[0]) == 0 and int(stats[1]) > 0


@pytest.mark.parametrize("k", [15, 25])
def test_relaxed_sort_gives_exact_planes(dev, k):
    """Three batches through the whole batch path (sort, scan, upsert) in
    relaxed and in exact mode: the planes are equal lane for lane, and so
    are each batch's sum of high windows and the stats."""
    rng = np.random.default_rng(k)
    wide = k > 15
    tables = [(BucketTableWide if wide else BucketTable)(
        k, rows=1 << 14 if wide else 1 << 16, device=dev) for _ in range(2)]
    states = [t.init() for t in tables]
    for i in range(3):
        bases, lengths = _reads(rng, 4096, 150)
        b = torch.from_numpy(bases).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        highs = []
        for t, st, relaxed in zip(tables, states, (False, True)):
            if wide:
                w1, w2 = encode_keys_wide(b, ln, k, False)
                out = bucket_batch_wide(
                    st.keys, st.keys2, st.counts, w1.reshape(-1),
                    w2.reshape(-1), windows_per_read=w1.shape[1],
                    row_shift=t.row_shift, depth=3, seed=i == 0,
                    relaxed=relaxed)
            else:
                key = encode_keys(b, ln, k, False)
                rid = torch.arange(key.numel(), device=dev) // key.shape[1]
                out = bucket_batch(st.keys, st.counts, key.reshape(-1), rid,
                                   fp_bits=t.fp_bits, depth=3,
                                   n_reads=key.shape[0], seed=i == 0,
                                   relaxed=relaxed)
            highs.append((int(out.high_per_read.sum()), int(out.overflow),
                          int(out.inserted)))
        assert highs[0] == highs[1]
        for a, c in zip(*states):
            assert (a is None and c is None) or torch.equal(a, c)
    assert highs[0][0] > 0


@pytest.mark.parametrize("k", [15, 25])
def test_debug3_roundtrip_on_the_card(dev, tmp_path, k):
    """--debug 3 on cuda: the round-trip holds the CUDA encode kernel
    against the codec on every batch and passes; stdout equals the CPU
    run's but for the wall-clock lines."""
    import contextlib
    import io

    from nomalise_kmers_multi_large_torch.config import Config
    from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
    from nomalise_kmers_multi_large_torch.engine.report import (
        without_clock_lines,
    )

    data = pathlib.Path(__file__).resolve().parent / "data"
    files = []
    for name in ("a1", "b1"):  # the first 200 pairs
        text = (data / f"{name}.fasta").read_text().splitlines(True)
        files.append(tmp_path / f"{name}.fa")
        files[-1].write_text("".join(text[:400]))
    lines = {}
    for device in ("cuda", "cpu"):
        cfg = Config(forward_files=(str(files[0]),),
                     reverse_files=(str(files[1]),), informat="fa",
                     outformat="fa", ksize=k, depth=2, debug=3,
                     batch_reads=64, out_dir=str(tmp_path / device))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            Normalizer(cfg, device=device).run()
        lines[device] = without_clock_lines(buf.getvalue())
    assert lines["cuda"] == lines["cpu"]
    assert any(ln.startswith("DEBUG: New Kmer hash") for ln in lines["cuda"])


# ----------------------------------------------------------------------
# the fallback tables: the hashed find-or-insert kernel, and the direct and
# hashed steps on the card

def _hashed_codes(rng, n, k=25):
    """n distinct nonzero k-mer codes (int64), ascending as a run head
    stream is."""
    codes = np.unique(rng.integers(1, 1 << (2 * k), size=2 * n,
                                   dtype=np.int64))
    return np.sort(rng.permutation(codes)[:n])


def _colliding_codes(rng, n, capacity, k=25):
    """n distinct codes whose slot hash sends them all to slot 0 of a table
    of `capacity` slots."""
    from nomalise_kmers_multi_large_torch.ops.hashed_kernel import slot_hash

    got = []
    while len(got) < n:
        c = torch.from_numpy(rng.integers(1, 1 << (2 * k), size=1 << 20,
                                          dtype=np.int64))
        got += c[(slot_hash(c) & (capacity - 1)) == 0].tolist()
    return np.unique(np.array(got[:n], np.int64))


def _check_hashed(dev, keys0, counts0, codes, mult=None, seed=False):
    """The kernel and the plain version from the same planes: equal sets of
    (code, count), stats (new, unresolved) and per-position priors; every
    resolved slot of the kernel holds its code."""
    from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
        hashed_insert, hashed_insert_plain,
    )

    planes = {}
    outs = {}
    for name, fn in (("kernel", hashed_insert),
                     ("plain", hashed_insert_plain)):
        keys, counts = keys0.clone().to(dev), counts0.clone().to(dev)
        c = torch.from_numpy(codes).to(dev)
        m = None if seed else torch.from_numpy(mult).to(dev)
        outs[name] = fn(keys, c, m, None if seed else counts)
        planes[name] = (keys, counts)
    torch.cuda.synchronize()
    (kk, kc), (pk, pc) = planes["kernel"], planes["plain"]
    ko, po = outs["kernel"], outs["plain"]

    def table(keys, counts):
        occ = keys != 0
        code, order = torch.sort(keys[occ])
        return code.cpu(), counts[occ][order].cpu()

    for a, b in zip(table(kk, kc), table(pk, pc)):
        assert torch.equal(a, b)
    assert torch.equal(ko.stats[:2].cpu(), po.stats[:2].cpu())
    assert torch.equal(ko.prior.cpu(), po.prior.cpu())
    hit = ko.slot >= 0
    c = torch.from_numpy(codes).to(dev)
    assert torch.equal(kk[ko.slot[hit].long()], c[hit])
    assert torch.equal(hit, po.slot >= 0)
    return ko.stats.cpu()


@pytest.mark.parametrize("case", ["batches", "colliding", "full"])
def test_hashed_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(7)
    cap = 1 << 12 if case != "batches" else 1 << 16
    keys = torch.zeros(cap, dtype=torch.int64)
    counts = torch.zeros(cap, dtype=torch.int32)
    if case == "batches":
        # a seed batch, then a count batch that meets half of it again
        first = _hashed_codes(rng, 20000)
        _check_hashed(dev, keys, counts, first, seed=True)
        from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
            hashed_insert_plain,
        )
        hashed_insert_plain(keys, torch.from_numpy(first))
        codes = np.unique(np.concatenate([first[::2],
                                          _hashed_codes(rng, 10000)]))
    elif case == "colliding":
        # 24 codes on one home slot (the triangular probe visits 64
        # distinct slots) among random ones, at ~10 % load: all resolve
        codes = np.unique(np.concatenate([
            _colliding_codes(rng, 24, cap), _hashed_codes(rng, 400)]))
    else:
        # every slot taken: old codes match, new codes are unresolved
        from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
            hashed_insert_plain,
        )
        old = _hashed_codes(rng, 3 * cap)
        out = hashed_insert_plain(keys, torch.from_numpy(old))
        filled = keys[keys != 0].numpy()
        assert filled.size < cap or int(out.stats[1]) > 0
        while (keys == 0).any():  # fill the last holes directly
            keys[keys == 0] = torch.from_numpy(
                _hashed_codes(rng, int((keys == 0).sum())) + (1 << 50))
        counts[:] = torch.from_numpy(rng.integers(1, 9, cap, dtype=np.int32))
        codes = np.unique(np.concatenate([
            rng.choice(filled, 500, replace=False),
            _hashed_codes(rng, 500) + (1 << 51)]))
    codes = np.where(rng.random(codes.size) < 0.2, 0, codes)  # non-heads
    mult = rng.integers(1, 5, codes.size, dtype=np.int32)
    mult[codes == 0] = 0
    stats = _check_hashed(dev, keys, counts, codes, mult)
    if case == "full":
        assert int(stats[0]) == 0 and int(stats[1]) > 0
    else:
        assert int(stats[0]) > 0 and int(stats[1]) == 0


def test_hashed_kernel_launch_failure_raises(dev):
    """The C entry refuses a capacity that is not a power of two: the
    wrapper's launch raises with the CUDA error and counts no launch."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.ops.hashed_kernel import _ARGTYPES

    keys = torch.zeros(3, dtype=torch.int64, device=dev)
    codes = torch.ones(4, dtype=torch.int64, device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    fn = backend.function("hashed_insert", "nkm_hashed_insert", _ARGTYPES)
    before = backend.launches()["hashed_insert"]
    with pytest.raises(RuntimeError, match="hashed_insert: CUDA error"):
        backend.launch("hashed_insert", fn, codes.data_ptr(), 4,
                       keys.data_ptr(), 3, None, None, None, None,
                       stats.data_ptr(), dev.index or 0,
                       backend.stream_of(keys))
    assert backend.launches()["hashed_insert"] == before


@pytest.mark.parametrize("kind,k", [("direct", 13), ("hashed", 25),
                                    ("hashed", 21)])
@pytest.mark.parametrize("mode", ["exact", "relaxed"])
def test_fallback_step_on_the_card_equals_cpu(dev, kind, k, mode):
    """A seed batch and three paired batches (one after a growth on the
    hashed table) through BatchStep on cuda and on the cpu: keep masks,
    stats, tallies, used, overflow and the exported table are equal."""
    from nomalise_kmers_multi_large_torch.engine.step import BatchStep
    from nomalise_kmers_multi_large_torch.table import (
        DirectTable, HashedTable,
    )

    rng = np.random.default_rng(k)
    batches = [_reads(rng, 1024, 150) for _ in range(4)]
    runs = {}
    for device in ("cuda", "cpu"):
        t = DirectTable(k, device=device) if kind == "direct" else \
            HashedTable(k, 1 << 18, device=device)
        st = t.init()
        step = BatchStep(t, k=k, depth_per_shard=3, coverage=0.9,
                         canonical=True, paired=True, mode=mode)
        st = step.seed_step(st, *batches[0])
        got = []
        for i, (bases, lengths) in enumerate(batches[1:]):
            if i == 2 and t.can_grow:
                t, st = t.grown(st)
                step = BatchStep(t, k=k, depth_per_shard=3, coverage=0.9,
                                 canonical=True, paired=True, mode=mode)
            rv = lengths.reshape(-1, 2).min(1) > 0
            st, keep, stats, tallies = step.step(st, bases, lengths, rv)
            got.append([x.cpu() for x in (keep, *stats, *tallies)])
        runs[device] = (got, t.export(st), int(st.used), int(st.overflow))
    (g1, e1, u1, o1), (g2, e2, u2, o2) = runs["cuda"], runs["cpu"]
    for a, b in zip(g1, g2):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for x, y in zip(e1, e2):
        np.testing.assert_array_equal(x, y)
    assert (u1, o1) == (u2, o2) and o1 == 0
    assert 0 < int(g1[-1][2]) < 1024   # printed


# ----------------------------------------------------------------------
# Mode B's row shards and the multi-device engines

def _row_shard_stream(dev, wide, rng, j, n_shards=4):
    """Row shard j's received stream of one batch of 4096 reads (k = 25
    wide, else 15) into a table of 2^21 rows cut n_shards ways: the batch's
    codes that shard j owns, rebased, plus, on the last shard, real codes
    whose w1 is 0xFFFFFFFF, and sentinels; sorted and scanned. Returns the
    shard's descriptor and the kernel arguments."""
    from nomalise_kmers_multi_large_torch.ops.encode_kernel import as_int32
    from nomalise_kmers_multi_large_torch.parallel.modes import (
        RowShardedBucketTable, owner_edges_narrow, owner_edges_wide,
    )

    k, reads = (25, 4096) if wide else (15, 4096)
    whole = (BucketTableWide if wide else BucketTable)(k, rows=1 << 21,
                                                       device=dev)
    t = RowShardedBucketTable(whole, [dev] * n_shards)
    bases, lengths = _reads(rng, reads, 150)
    b = torch.from_numpy(bases).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    rid = torch.arange(reads, device=dev).repeat_interleave(150 - k + 1)
    base = j * t.span
    if wide:
        w1, w2 = encode_keys_wide(b, ln, k, False)
        (sk1, sk2, srid), e = owner_edges_wide(w1.reshape(-1),
                                               w2.reshape(-1), rid,
                                               n_shards, t.span)
        lo, hi = int(e[j]), int(e[j + 1])
        s1 = (sk1[lo:hi].to(torch.int64) & 0xFFFFFFFF) - base
        s2, r = sk2[lo:hi], srid[lo:hi].to(torch.int64)
        extra = 40 if j == n_shards - 1 else 0
        s1 = torch.cat([s1, torch.full((extra,), t.span - 1, device=dev),
                        torch.full((50,), 0xFFFFFFFF, device=dev)])
        s2 = torch.cat([s2, torch.arange(extra, device=dev,
                                         dtype=torch.int32) % 5,
                        torch.full((50,), -1, device=dev,
                                   dtype=torch.int32)])
        r = torch.cat([r, torch.arange(extra + 50, device=dev) % reads])
        sk1, sk2, srid = sort_stream_wide(as_int32(s1), s2, 1,
                                          rid_flat=r)
        p2, p3 = rank_cand_scan(sk1, srid, fp_bits=0, n_reads=reads,
                                skey2=sk2, row_shift=t.shift)
        return t, (sk1, sk2, p2, p3), reads
    key = encode_keys(b, ln, k, False)
    packed, e = owner_edges_narrow(key.reshape(-1), rid, n_shards, t.span)
    seg = packed[int(e[j]):int(e[j + 1])]
    skey = torch.cat([as_int32((seg >> 14) - base),
                      torch.full((50,), -1, device=dev, dtype=torch.int32)])
    r = torch.cat([seg & 16383, torch.arange(50, device=dev)])
    skey, srid = sort_stream(skey, r)
    p2, p3 = rank_cand_scan(skey, srid, fp_bits=t.shift, n_reads=reads)
    return t, (skey, p2, p3), reads


@pytest.mark.parametrize("j", [0, 3])
@pytest.mark.parametrize("wide", [False, True])
def test_bucket_kernels_on_a_row_shard_match_plain(dev, wide, j):
    """K4 / K5 on row shard j of a 2^21-row table cut 4 ways (2^19 rows,
    the whole table's fingerprint width), as Mode B runs them: a seed
    batch, then a count batch, each equal to the plain version (planes,
    high tallies, stats); sentinels beside the shard's last row count
    nothing, and the codes whose w1 is 0xFFFFFFFF land in its last row."""
    rng = np.random.default_rng(40 + j + 2 * wide)
    planes = twins = None
    for seed in (True, False):
        t, stream, reads = _row_shard_stream(dev, wide, rng, j)
        if planes is None:
            st = t.init()
            planes = [st.keys[j], st.keys2[j] if st.keys2 else None,
                      st.counts[j]] if wide else [st.keys[j], st.counts[j]]
            twins = [None if x is None else x.clone() for x in planes]
        kw = dict(depth=3, seed=seed, n_reads=reads)
        if wide:
            kw["row_shift"] = t.shift
            got = bucket_upsert_wide(*planes, *stream, **kw)
            want = bucket_upsert_wide_plain(*twins, *stream, **kw)
        else:
            kw["fp_bits"] = t.shift
            got = bucket_upsert(*planes, *stream, **kw)
            want = bucket_upsert_plain(*twins, *stream, **kw)
        torch.cuda.synchronize()
        for a, b in [*zip(planes, twins), *zip(got, want)]:
            assert (a is None and b is None) or torch.equal(a, b)
        assert int(got[1][1]) > 0 and int(got[1][0]) == 0
    assert planes[0].shape == (1 << 19, 64)
    if wide and j == 3:
        assert int((planes[0][-1] != 0).sum()) >= 5


def _mesh_run(tmp_path, sub, devices, sharding, k, inputs, **kw):
    from nomalise_kmers_multi_large_torch.config import Config
    from nomalise_kmers_multi_large_torch.parallel.engine import (
        MeshNormalizer,
    )

    out = tmp_path / sub
    out.mkdir()
    cfg = Config(**{"informat": "fa", "outformat": "fa", "ksize": k,
                    "depth": 8, "batch_reads": 256, "print_table": True,
                    "out_dir": str(out), "sharding": sharding, **inputs,
                    **kw})
    norm = MeshNormalizer(cfg, devices)
    rep = norm.run()
    files = {p.name: p.read_bytes() for p in out.glob("output_*")}
    return norm, (rep.total_processed, rep.total_printed,
                  rep.max_total_kmers), files


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("sharding,k", [("local", 15), ("local", 25),
                                        ("global", 15), ("global", 25)])
def test_mesh_on_the_card_equals_cpu(dev, tmp_path, sharding, k, skew):
    """Mode A and Mode B with 4 shards on the card (one card repeated) and
    on 4 cpu devices, on 1000 pairs of tests/data or (skew) 2000 copies of
    one pair: output files, -P dumps and totals equal; every state tensor
    on the card."""
    inputs = {}
    for name, key in (("a1", "forward_files"), ("b1", "reverse_files")):
        lines = (pathlib.Path(__file__).parent / "data"
                 / f"{name}.fasta").read_text().splitlines(True)
        text = "".join(lines[:2] * 2000 if skew else lines[:2000])
        (tmp_path / f"{name}.fa").write_text(text)
        inputs[key] = (str(tmp_path / f"{name}.fa"),)
    norm, *card = _mesh_run(tmp_path, "card", [dev] * 4, sharding, k, inputs)
    _, *cpu = _mesh_run(tmp_path, "cpu", [torch.device("cpu")] * 4,
                        sharding, k, inputs)
    assert card == cpu and card[0][0] == (2000 if skew else 1000)
    for st in norm.states:
        for x in st:
            for p in (x if isinstance(x, tuple) else (x,)):
                assert p is None or p.device.type == "cuda"


# ----------------------------------------------------------------------
# Mode B on the direct and hashed tables

def _synthetic_pairs(tmp_path, n_pairs=20000, seed=11):
    """n_pairs 2 x 100 bp FASTA pairs from 300 random 500 bp transcripts
    (the mate is the reverse complement 200 bp on), 0.5 % substitutions."""
    rng = np.random.default_rng(seed)
    tx = rng.integers(0, 4, size=(300, 500), dtype=np.uint8)
    which = rng.integers(0, 300, size=n_pairs)
    start = rng.integers(0, 200, size=n_pairs)
    cols = start[:, None] + np.arange(100)
    fwd = tx[which[:, None], cols]
    rev = 3 - tx[which[:, None], cols + 200][:, ::-1]
    inputs = {}
    for name, key, reads in (("s1", "forward_files", fwd),
                             ("s2", "reverse_files", rev)):
        sub = rng.random(reads.shape) < 0.005
        reads = np.where(sub, rng.integers(0, 4, size=reads.shape), reads)
        seqs = np.frombuffer(b"ACGT", np.uint8)[reads]
        path = tmp_path / f"{name}.fa"
        path.write_bytes(b"".join(b">p%d\n%s\n" % (i, row.tobytes())
                                  for i, row in enumerate(seqs)))
        inputs[key] = (str(path),)
    return inputs


@pytest.mark.parametrize("table,k", [("direct", 15), ("hashed", 25)])
def test_mode_b_fallback_on_the_card_equals_cpu(dev, tmp_path, monkeypatch,
                                                table, k):
    """Mode B on the direct and hashed tables with 4 shards on the card and
    on 4 cpu devices, on 20,000 synthetic pairs (the hashed table from 2^16
    slots, so it grows, every shard at once): every file (reads and -P
    dumps) byte-identical and the totals equal; every shard on the card;
    the hashed kernel launched on the hashed run, and none of K1-K5."""
    from nomalise_kmers_multi_large_torch import backend
    from nomalise_kmers_multi_large_torch.config import Config

    monkeypatch.setattr(Config, "initial_hash_capacity",
                        property(lambda self: 1 << 16))
    inputs = _synthetic_pairs(tmp_path)
    backend.reset_launches()
    norm, *card = _mesh_run(tmp_path, "card", [dev] * 4, "global", k,
                            inputs, table=table, batch_reads=4096)
    launches = backend.launches()
    _, *cpu = _mesh_run(tmp_path, "cpu", [torch.device("cpu")] * 4,
                        "global", k, inputs, table=table, batch_reads=4096)
    assert card == cpu and card[0][0] == 20000 and 0 < card[0][1] < 20000
    assert len(card[1]) == 4 and int(norm.states[0].overflow) == 0
    assert (launches["hashed_insert"] > 0) == (table == "hashed")
    assert not any(launches[n] for n in launches if n != "hashed_insert")
    if table == "hashed":
        assert norm.tables[0].capacity > 1 << 16
    for x in norm.states[0]:
        for p in (x if isinstance(x, tuple) else (x,)):
            assert p is None or p.device.type == "cuda"


@pytest.mark.parametrize("j", [0, 3])
def test_hashed_kernel_on_a_slot_shard_matches_plain(dev, j):
    """The kernel on shard j of a 2^18-slot table cut 4 ways (2^16 slots,
    Mode B's hashed shard), fed a seed batch and then a count batch of
    only the codes the shard owns: equal to the plain version, no code
    unresolved, and every code it holds its own."""
    from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
        hashed_insert_plain,
    )
    from nomalise_kmers_multi_large_torch.parallel.modes import (
        SlotShardedHashedTable,
    )
    from nomalise_kmers_multi_large_torch.table import HashedTable

    t = SlotShardedHashedTable(HashedTable(25, 1 << 18), [dev] * 4)
    rng = np.random.default_rng(50 + j)
    codes = _hashed_codes(rng, 60000)
    own = codes[t.owner(torch.from_numpy(codes)).numpy() == j]
    first, rest = own[:own.size // 2], own[own.size // 2:]
    keys = torch.zeros(1 << 16, dtype=torch.int64)
    counts = torch.zeros(1 << 16, dtype=torch.int32)
    _check_hashed(dev, keys, counts, first, seed=True)
    hashed_insert_plain(keys, torch.from_numpy(first))
    codes = np.unique(np.concatenate([first[::2], rest]))
    codes = np.where(rng.random(codes.size) < 0.2, 0, codes)  # non-heads
    mult = rng.integers(1, 5, codes.size, dtype=np.int32)
    mult[codes == 0] = 0
    stats = _check_hashed(dev, keys, counts, codes, mult)
    assert int(stats[0]) > 0 and int(stats[1]) == 0
    held = keys[keys != 0]
    assert held.numel() == first.size and bool((t.owner(held) == j).all())
