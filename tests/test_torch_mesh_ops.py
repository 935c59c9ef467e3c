"""The pieces of the port's multi-device layer against numpy, tolerance 0:
the device list (parallel/mesh.py), Mode A's cut of a batch, Mode B's
route (a sender's sort, its cut by owner, the owner's rebase), the wide
sort with an explicit read id against np.lexsort on (w1, w2, read id), the
row-sharded table's gather / split / growth against the whole table's, and
the regression of a real k > 16 code whose w1 is 0xFFFFFFFF (it belongs to
the last row of the last shard, and is no sentinel)."""
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_torch.config import ConfigError
from nomalise_kmers_multi_large_torch.engine.step import BatchStep
from nomalise_kmers_multi_large_torch.ops.bucket_kernel import (
    sort_stream_wide,
)
from nomalise_kmers_multi_large_torch.ops.mix import (
    feistel_words_np, unfeistel_np,
)
from nomalise_kmers_multi_large_torch.parallel import mesh
from nomalise_kmers_multi_large_torch.parallel.modes import (
    ModeAStep, ModeBBucketStep, RowShardedBucketTable, owner_edges_narrow,
    owner_edges_wide,
)
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, BucketTableWide,
)
from one_thread import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def test_data_devices(monkeypatch):
    assert mesh.data_devices(0, "cpu") == [CPU]
    assert mesh.data_devices(3, "cpu") == [CPU] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.data_devices(0, "cuda") == [torch.device("cuda", 0),
                                           torch.device("cuda", 1)]
    assert mesh.data_devices(1, "cuda") == [torch.device("cuda", 0)]
    assert mesh.data_devices(0, "cuda:1") == [torch.device("cuda", 1)]
    with pytest.raises(ConfigError, match="more CUDA devices"):
        mesh.data_devices(3, "cuda")


@pytest.mark.parametrize("n_records,n", [(10, 4), (8, 4), (3, 4), (1, 2),
                                         (8192, 8)])
def test_mode_a_cut_is_the_jax_padded_slicing(n_records, n):
    """Device d takes records [d * per, (d + 1) * per) of the batch padded
    to a multiple of n (per = ceil(records / n)), minus the padding."""
    per = -(-n_records // n)
    want = [(d * per, min((d + 1) * per, n_records)) for d in range(n)
            if d * per < n_records]
    assert ModeAStep([CPU] * n).cut(n_records) == want


def _stream(rng, n, wide):
    """Random keys with sentinels, repeats and extreme values."""
    if wide:
        w1 = rng.integers(0, 1 << 32, n, dtype=np.int64)
        w2 = rng.integers(0, 1 << 30, n, dtype=np.int64)
        rep = rng.random(n) < 0.3
        w1[rep], w2[rep] = w1[0], w2[0]
        w1[:3] = [0, 0xFFFFFFFF, 0xFFFFFFFF]
        sent = rng.random(n) < 0.1
        w1[sent] = w2[sent] = 0xFFFFFFFF
        return w1, w2
    key = rng.integers(0, 1 << 30, n, dtype=np.int64)
    key[rng.random(n) < 0.3] = key[0]
    key[rng.random(n) < 0.1] = 0xFFFFFFFF
    return key, None


def _i32(x):
    return torch.from_numpy(np.where(x >= 1 << 31, x - (1 << 32),
                                     x).astype(np.int32))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_route_sort_cut_and_rebase(wide, n_shards):
    rng = np.random.default_rng(n_shards + 10 * wide)
    n = 5000
    key, w2 = _stream(rng, n, wide)
    rid = np.arange(n) // 50 + 7 * 100   # a sender's global read ids
    span = (1 << (32 if wide else 30)) // n_shards
    if wide:
        (sk1, sk2, srid), edges = owner_edges_wide(
            _i32(key), _i32(w2), torch.from_numpy(rid), n_shards, span)
        got_key = sk1.numpy().astype(np.int64) & 0xFFFFFFFF
        got = [got_key, sk2.numpy().astype(np.int64) & 0xFFFFFFFF,
               srid.numpy()]
        valid = w2 != 0xFFFFFFFF
        order = np.lexsort((rid, w2, key))
    else:
        packed, edges = owner_edges_narrow(_i32(key), torch.from_numpy(rid),
                                           n_shards, span)
        got_key = packed.numpy() >> 14
        got = [got_key, packed.numpy() & 16383]
        valid = key != 0xFFFFFFFF
        order = np.lexsort((rid, key))
    order = order[valid[order]]          # the valid prefix, in order
    want = [key[order]] + ([w2[order]] if wide else []) + [rid[order]]
    nv = int(valid.sum())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:nv], w)
    edges = edges.numpy()
    owner = key[order] // span
    np.testing.assert_array_equal(
        np.diff(edges), np.bincount(owner, minlength=n_shards))
    assert edges[0] == 0 and edges[-1] == nv
    for j in range(n_shards):   # the owner's rebase lands in its rows
        seg = got_key[edges[j]:edges[j + 1]] - j * span
        assert seg.size == 0 or (seg.min() >= 0 and seg.max() < span)


def test_wide_sort_with_explicit_read_ids_is_lexsort():
    """Pieces of senders, each sorted on (w1, w2, read id), concatenated in
    sender order: the stable sort with the read id as payload gives the
    order of np.lexsort on (w1, w2, read id)."""
    rng = np.random.default_rng(3)
    pieces = []
    for d in range(4):
        w1 = rng.integers(0, 64, 300) | (0xFFFFFFC0 * (rng.random(300) < .2))
        w2 = rng.integers(0, 4, 300)
        rid = d * 1000 + rng.integers(0, 1000, 300)
        o = np.lexsort((rid, w2, w1))
        pieces.append((w1[o], w2[o], rid[o]))
    w1, w2, rid = (np.concatenate(x) for x in zip(*pieces))
    sk1, sk2, srid = sort_stream_wide(_i32(w1), _i32(w2), 1,
                                      rid_flat=torch.from_numpy(rid))
    o = np.lexsort((rid, w2, w1))
    np.testing.assert_array_equal(sk1.numpy().astype(np.int64) & 0xFFFFFFFF,
                                  w1[o])
    np.testing.assert_array_equal(sk2.numpy(), w2[o])
    np.testing.assert_array_equal(srid.numpy(), rid[o])


@pytest.mark.parametrize("whole", [BucketTable(9, rows=512),
                                   BucketTableWide(25, rows=2048)])
def test_sharded_table_gather_split_and_growth(whole):
    """A filled whole table split into 4 row shards gathers back to itself;
    growing the shards equals splitting the grown whole table."""
    rng = np.random.default_rng(5)
    st = whole.init()
    for plane in (st.keys, st.counts) + ((st.keys2,) if st.keys2 is not None
                                         else ()):
        occ = torch.from_numpy(np.sort(rng.integers(0, 65, whole.rows)))
        vals = torch.from_numpy(rng.integers(1, 1 << 30, plane.shape,
                                             dtype=np.int32))
        lane = torch.arange(whole.lanes)[None, :]
        plane.copy_(torch.where(lane < occ[:, None], vals, 0))
    st = st._replace(keys=torch.where(st.keys != 0, st.keys.abs() % (
        1 << (whole.row_shift if whole.wide else whole.fp_bits)) + 1, 0))
    t = RowShardedBucketTable(whole, [CPU] * 4)
    sh = t.split(st)
    assert len(sh.keys) == 4 and sh.keys[0].shape == (whole.rows // 4, 64)
    back = t.gather(sh, "cpu")
    for a, b in zip(back, st):
        assert (a is None and b is None) or torch.equal(a, b)
    assert t.used_count(sh) == whole.used_count(st)
    t2, sh2 = t.grown(sh)
    w2, st2 = whole.grown(st)
    assert t2.rows == w2.rows == 2 * whole.rows
    for a, b in zip(t2.gather(sh2, "cpu"), st2):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(whole.export(st), t.export(sh)):
        np.testing.assert_array_equal(a, b)


def test_mode_b_counts_a_real_w1_of_all_ones_on_the_last_shard():
    """A k = 19 code whose Feistel w1 is 0xFFFFFFFF, one copy on each of two
    devices: routed to the last row of the last shard, rebased, and counted
    twice in one slot; the first copy is kept (rank 1 < depth 2), the
    second skipped."""
    k, bits = 19, 38
    code = int(unfeistel_np(np.array([0xFFFFFFFF], np.uint32),
                            np.array([5], np.uint32), bits)[0])
    w1, w2 = feistel_words_np(np.array([code], np.uint64), bits)
    assert (int(w1[0]), int(w2[0])) == (0xFFFFFFFF, 5)
    bases = np.zeros((2, 40), np.uint8)
    bases[:, :k] = [(code >> (2 * (k - 1 - i))) & 3 for i in range(k)]
    whole = BucketTableWide(k, rows=16384)
    t = RowShardedBucketTable(whole, [CPU] * 2)
    step = ModeBBucketStep(t, k=k, depth_per_shard=2, coverage=0.9,
                           canonical=False, paired=False)
    st, keep, stats, tallies = step.step(
        t.init(), bases, np.full(2, k, np.int32), np.ones(2, bool))
    hi, lo, cnt = t.export(st)
    codes = (hi.astype(np.uint64) << np.uint64(32)) | lo
    assert codes.tolist() == [code] and cnt.tolist() == [2]
    assert int((st.keys[1][-1] != 0).sum()) == 1   # last row, last shard
    assert keep.tolist() == [True, False]
    assert tallies.high.tolist() == [0, 1]
    assert int(st.overflow) == 0 and int(st.used) == 1
    # and the one-device step agrees
    one = BatchStep(whole, k=k, depth_per_shard=2, coverage=0.9,
                    canonical=False, paired=False)
    _, keep1, _, tallies1 = one.step(whole.init(), bases,
                                     np.full(2, k, np.int32),
                                     np.ones(2, bool))
    assert keep1.tolist() == keep.tolist()
    assert tallies1.high.tolist() == tallies.high.tolist()
