"""The wide table's ceiling: 2^24 rows (row_shift 8), up from 2^21. The
descriptor grows to it, the scan (K3w) and the upsert (K5) take row_shift
8..10 and still refuse what lies outside, and the blockwise row split
equals the JAX package's lane for lane. Exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nomalise_kmers_multi_large_torch.table.bucket as port_bucket
from nomalise_kmers_multi_large_tpu.table.bucket import (
    _split_rows as ref_split_rows,
)
from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    bucket_upsert_wide, sort_stream_wide,
)
from nomalise_kmers_multi_large_torch.ops.segscan import rank_cand_scan
from nomalise_kmers_multi_large_torch.table.bucket import (
    BucketTableWide, _split_rows,
)
from test_torch_wide_ops import BLOCK, SENT, _check_scan, _t


@pytest.mark.parametrize("k", [16, 25, 31])
def test_wide_table_grows_to_2_24_rows(k):
    assert BucketTableWide(k).MAX_ROWS == 1 << 24
    for rows in (1 << 21, 1 << 22, 1 << 23):
        t = BucketTableWide(k, rows=rows)
        assert t.can_grow and t.row_shift == 32 - rows.bit_length() + 1
    last = BucketTableWide(k, rows=1 << 24)
    assert not last.can_grow and last.row_shift == 8
    assert last.capacity == 1 << 30  # a slot index still fits int32
    with pytest.raises(ValueError):
        BucketTableWide(k, rows=1 << 25)


@pytest.mark.parametrize("row_shift", [8, 9, 10])
def test_scan_wide_at_row_shift_8_to_10_matches_reference(row_shift):
    """The plain K3w against the JAX scan (interpret mode) on a stream of
    256 rows of 2^row_shift values of w1 each: a row holds hundreds of
    codes, so cand clamps at 128, and runs cross the block boundary."""
    rng = np.random.default_rng(row_shift)
    n = BLOCK + 5000
    w1 = rng.integers(0, 1 << (row_shift + 8), size=n).astype(np.uint32)
    w2 = rng.integers(0, 4, size=n).astype(np.uint32)
    w1[-500:], w2[-500:] = SENT, SENT
    sk1, sk2, srid = sort_stream_wide(_t(w1), _t(w2), 50)
    g2, g3 = _check_scan(sk1, sk2, srid, row_shift, n // 50)
    assert g3.max() == 128 and (g2 & 0xFFFF).max() > 1


@pytest.mark.parametrize("row_shift", [7, 24])
def test_scan_wide_refuses_row_shift_outside_8_to_23(row_shift):
    key = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="row shift"):
        rank_cand_scan(key, key, fp_bits=0, n_reads=1, skey2=key,
                       row_shift=row_shift)


def _upsert_args(rows, row_shift, device):
    planes = [torch.empty((rows, 64), dtype=torch.int32, device=device)
              for _ in range(3)]
    stream = [torch.zeros(8, dtype=torch.int32, device=device)
              for _ in range(4)]
    return planes, stream, dict(row_shift=row_shift, depth=2, seed=False,
                                n_reads=1)


def test_upsert_wide_guard_takes_row_shift_8():
    """Planes of 2^24 rows on the meta device (shapes, no memory): the
    guard accepts row_shift 8, and the call goes on to the device check
    (the kernel runs on CUDA tensors only)."""
    planes, stream, kw = _upsert_args(1 << 24, 8, "meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        bucket_upsert_wide(*planes, *stream, **kw)


@pytest.mark.parametrize("rows,row_shift", [
    (1 << 23, 8),    # half a table's rows: a row shard of Mode B
    (1 << 25, 7),    # past the ceiling
    (1 << 24, 9),    # planes too large for the shift
])
def test_upsert_wide_guard_refuses_mismatched_planes(rows, row_shift):
    """The guard refuses planes with more rows than the shift addresses,
    and a shift outside 8..23; fewer rows (a row shard) go on to the
    device check."""
    planes, stream, kw = _upsert_args(rows, row_shift, "meta")
    shard = 8 <= row_shift <= 23 and rows << row_shift <= 1 << 32
    match = "one CUDA device" if shard else r"rows <= 2\^\(32 - row_shift\)"
    with pytest.raises(ValueError, match=match):
        bucket_upsert_wide(*planes, *stream, **kw)


def _left_packed(rng, rows, lanes, fb, plane_b):
    """Planes whose rows hold 0..lanes entries, left-packed; rows 0 and 1
    are full with every entry's top fingerprint bit 0 (row 0) or 1 (row 1),
    so one half takes every lane."""
    occ = rng.integers(0, lanes + 1, size=rows)
    occ[:2] = lanes
    lane = np.arange(lanes)[None, :]
    fp = rng.integers(0, 1 << fb, size=(rows, lanes))
    fp[0] &= (1 << (fb - 1)) - 1
    fp[1] |= 1 << (fb - 1)
    keys = np.where(lane < occ[:, None], fp + 1, 0)
    counts = np.where(keys != 0, rng.integers(0, 1000, size=keys.shape), 0)
    keys2 = (np.where(keys != 0, rng.integers(0, 1 << 30, size=keys.shape), 0)
             if plane_b else None)
    return [None if x is None else x.astype(np.int32)
            for x in (keys, counts, keys2)]


@pytest.mark.parametrize("block_rows", [1 << 20, 48])
@pytest.mark.parametrize("fb,plane_b", [(9, True), (12, False), (8, True)])
def test_split_rows_matches_reference(monkeypatch, fb, plane_b, block_rows):
    """Against the JAX package's _split_rows (argsort based) at 256 rows,
    in one block and in blocks of 48 rows (the last one partial)."""
    monkeypatch.setattr(port_bucket, "_SPLIT_BLOCK_ROWS", block_rows)
    rng = np.random.default_rng(fb + 100 * plane_b)
    keys, counts, keys2 = _left_packed(rng, 256, 64, fb, plane_b)
    got = _split_rows(*(torch.from_numpy(x) for x in (keys, counts)), fb,
                      None if keys2 is None else torch.from_numpy(keys2))
    want = ref_split_rows(jnp.asarray(keys), jnp.asarray(counts), fb,
                          None if keys2 is None else jnp.asarray(keys2))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == (512, 64)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[0][0] != 0).all() and (got[0][1] == 0).all()
    assert (got[0][2] == 0).all() and (got[0][3] != 0).all()
