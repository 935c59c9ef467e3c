"""Port BucketTableWide vs the reference's BucketTableWide in interpret
mode where rows fill and grow: a row that overflows, real codes in row
rows - 1 beside sentinels (whose w1 maps to that row too), and grown() /
export(). Exact (tolerance 0). Helpers are shared with
test_torch_wide_bucket.py."""
import jax
import numpy as np
import pytest

from nomalise_kmers_multi_large_torch.table import (
    state_from_numpy, state_to_numpy,
)
from test_torch_wide_bucket import (
    ROWS, SENT, _assert_same, _port_step, _ref_stepper, _tables, _words,
)


def test_row_overflow_matches_reference():
    """200 distinct codes of bucket row 0 plus second occurrences of 50 of
    them: 64 inserts land, the rest count as dropped, and later occurrences
    of a dropped code add nothing."""
    k = 21
    rng = np.random.default_rng(5)
    ref, port = _tables(k)
    w1 = rng.choice(1 << port.row_shift, size=200, replace=False)
    w2 = rng.integers(0, 1 << (2 * k - 32), size=200)
    idx = np.concatenate([np.arange(200), np.arange(150, 200)])
    rng.shuffle(idx)
    w1 = w1[idx].astype(np.uint32).reshape(10, 25)
    w2 = w2[idx].astype(np.uint32).reshape(10, 25)
    rs, ro = _ref_stepper(ref, depth=2)(ref.init(), w1, w2)
    ps, po = _port_step(port, port.init(), w1, w2, depth=2)
    _assert_same(ps, po, rs, ro)
    assert int(po.overflow) == 200 - 64 and int(po.inserted) == 64


@pytest.mark.parametrize("k", [16, 25])
def test_last_row_beside_sentinels_matches_reference(k):
    """Real codes in row rows - 1 (one with w1 = 0xFFFFFFFF), whose w1 row
    the sentinel pairs after them share: only the real codes count."""
    rng = np.random.default_rng(k)
    ref, port = _tables(k)
    p1 = (SENT - rng.integers(0, 1 << 20, size=30)).astype(np.uint32)
    p1[0] = SENT
    p2 = (rng.integers(0, 1 << (2 * k - 32), size=30).astype(np.uint32)
          if k > 16 else np.zeros(30, np.uint32))
    pick = rng.integers(0, 30, size=8 * 30)
    w1, w2 = p1[pick], p2[pick]
    sent = rng.random(w1.size) < 0.3
    w1[sent], w2[sent] = SENT, SENT
    w1, w2 = w1.reshape(8, 30), w2.reshape(8, 30)
    rs, ro = _ref_stepper(ref, depth=2)(ref.init(), w1, w2)
    ps, po = _port_step(port, port.init(), w1, w2, depth=2)
    _assert_same(ps, po, rs, ro)
    assert int(ps.counts[-1].sum()) == int(ps.counts.sum()) == \
        int((~sent).sum())
    assert int(po.inserted) == int((ps.keys[-1] != 0).sum()) == \
        np.unique(pick[~sent.ravel()]).size


def test_grown_and_export_match_reference():
    k = 25
    ref, port = _tables(k)
    rs, _ = _ref_stepper(ref)(ref.init(), *_words(k, 128, 60, 30))
    ps = state_from_numpy(jax.tree.map(np.asarray, rs))
    rt2, rs2 = ref.grown(rs)
    pt2, ps2 = port.grown(ps)
    assert pt2.rows == rt2.rows == 2 * ROWS
    got = state_to_numpy(ps2)
    for name in ("keys", "keys2", "counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(rs2, name)))
    for a, b in zip(pt2.export(ps2), rt2.export(rs2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.export(ps), ref.export(rs)):
        np.testing.assert_array_equal(a, b)
    assert port.used_count(ps) == pt2.used_count(ps2) == ref.used_count(rs)
    # the grown table matches and inserts as the reference's does
    words = _words(k, 128, 60, 31)
    rs3, ro = _ref_stepper(rt2)(rs2, *words)
    ps3, po = _port_step(pt2, ps2, *words)
    _assert_same(ps3, po, rs3, ro)
    # growing a state with a descriptor of another size is refused
    with pytest.raises(ValueError):
        pt2.grown(ps)
