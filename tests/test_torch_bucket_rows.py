"""Port BucketTable vs the reference's Pallas bucket table (interpret mode)
where rows fill: a stream spanning several reference kernel chunks, row
overflow at 64 and 128 lanes, and grown() / export(). Exact (tolerance 0).
Helpers are shared with test_torch_bucket.py."""
import jax
import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.ops.mix import mix32_np
from nomalise_kmers_multi_large_tpu.table import BucketTable as RefTable
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, state_from_numpy, state_to_numpy,
)
from test_torch_bucket import (
    K, _assert_same, _i32, _keys, _port_step, _ref_stepper,
)


def test_batch_spanning_kernel_chunks_matches_reference():
    """512 reads x 72 windows: the reference walks this stream in several
    16384-element chunks of one 128-row tile (counts unflushed between
    them), and rows overflow their 64 lanes."""
    ref = RefTable(K, rows=128, interpret=True)
    port = BucketTable(K, rows=128)
    ref_step = _ref_stepper(ref)
    rs, ps = ref.init(), port.init()
    for i in range(2):
        keys = _keys(512, 80, 10 + i)
        rs, ro = ref_step(rs, keys)
        ps, po = _port_step(port, ps, keys)
        _assert_same(ps, po, rs, ro)
    assert int(rs.overflow) > 0


@pytest.mark.parametrize("lanes", [64, 128])
def test_row_overflow_matches_reference(lanes):
    """200 distinct codes of one bucket row (tests/test_bucket.py's overflow
    case), plus second occurrences of 50 of them: inserts that fit land, the
    rest count as dropped, and later occurrences of a dropped code add
    nothing."""
    k = 8
    ref = RefTable(k, rows=128, lanes=lanes, interpret=True)
    port = BucketTable(k, rows=128, lanes=lanes)
    all_codes = np.arange(1, 4 ** k, dtype=np.uint32)
    row0 = all_codes[(mix32_np(all_codes, 2 * k) >> np.uint32(9)) == 0][:200]
    codes = np.concatenate([row0, row0[150:]])
    np.random.default_rng(5).shuffle(codes)
    keys = mix32_np(codes, 2 * k).reshape(10, 25)
    rs, ro = _ref_stepper(ref, depth=2)(ref.init(), keys)
    ps, po = port.process_batch_mixed(port.init(), _i32(keys), depth=2)
    _assert_same(ps, po, rs, ro)
    assert int(po.overflow) == 200 - lanes
    assert int(po.inserted) == lanes


def test_grown_and_export_match_reference():
    ref = RefTable(K, rows=128, interpret=True)
    port = BucketTable(K, rows=128)
    rs, _ = _ref_stepper(ref)(ref.init(), _keys(128, 40, 30))
    ps = state_from_numpy(jax.tree.map(np.asarray, rs))
    rt2, rs2 = ref.grown(rs)
    pt2, ps2 = port.grown(ps)
    assert pt2.rows == rt2.rows == 256
    got = state_to_numpy(ps2)
    np.testing.assert_array_equal(got.keys, np.asarray(rs2.keys))
    np.testing.assert_array_equal(got.counts, np.asarray(rs2.counts))
    for a, b in zip(pt2.export(ps2), rt2.export(rs2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.export(ps), ref.export(rs)):
        np.testing.assert_array_equal(a, b)
    assert port.used_count(ps) == pt2.used_count(ps2) == ref.used_count(rs)
    # growing a state with a descriptor of another size is refused
    with pytest.raises(ValueError):
        pt2.grown(ps)
