"""Port BatchStep (bucket path) vs the reference's BatchStep over
BucketTable(interpret=True) on tests/test_engine.py::_make_reads: keep
masks, ReadTallies, StepStats and the table planes, batch after batch.
Also the decision rules alone. Exact (tolerance 0): integer tallies and
float32 ratios computed the same way on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.engine.step import BatchStep as RefStep
from nomalise_kmers_multi_large_tpu.models import diginorm as ref_dn
from nomalise_kmers_multi_large_tpu.table import BucketTable as RefTable
from nomalise_kmers_multi_large_torch.engine.step import BatchStep
from nomalise_kmers_multi_large_torch.models import diginorm as port_dn
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, state_to_numpy,
)
from test_engine import COVERAGE, DEPTH, K, _make_reads, _pack


def _batches(paired, n_batches=3, batch=16):
    """Packed batches in reference stream order, with invalid records."""
    rpr = 2 if paired else 1
    reads = _make_reads(n_batches * batch * rpr)
    out = []
    for b in range(n_batches):
        rows = reads[b * batch * rpr:(b + 1) * batch * rpr]
        bases, lengths = _pack(rows, 64, K)
        if paired:
            fl, rl = lengths[0::2], lengths[1::2]
            rec_valid = (fl > 0) & (rl > 0)
            lengths[0::2] = np.where(rec_valid, fl, 0)
            lengths[1::2] = np.where(rec_valid, rl, 0)
        else:
            rec_valid = lengths > 0
        out.append((bases, lengths, rec_valid))
    return out


def _steps(paired, canonical, stride):
    kw = dict(k=K, depth_per_shard=DEPTH, coverage=COVERAGE,
              canonical=canonical, paired=paired, stride=stride)
    ref_t = RefTable(K, rows=128, interpret=True)
    port_t = BucketTable(K, rows=128)
    return (RefStep(ref_t, **kw), ref_t.init(), BatchStep(port_t, **kw),
            port_t.init())


def check_step_matches_reference(paired, canonical, stride):
    """Run three batches through both steps, comparing after each."""
    ref, rs, port, ps = _steps(paired, canonical, stride)
    printed = skipped = 0
    for bases, lengths, rec_valid in _batches(paired):
        rs, rkeep, rstats, rtal = ref.step(
            rs, jnp.asarray(bases), jnp.asarray(lengths),
            jnp.asarray(rec_valid))
        ps, pkeep, pstats, ptal = port.step(ps, bases, lengths, rec_valid)
        np.testing.assert_array_equal(pkeep.numpy(), np.asarray(rkeep))
        for name in ("processed", "printed", "skipped"):
            assert int(getattr(pstats, name)) == int(getattr(rstats, name))
        np.testing.assert_array_equal(ptal.high.numpy(), np.asarray(rtal.high))
        np.testing.assert_array_equal(ptal.total.numpy(),
                                      np.asarray(rtal.total))
        got = state_to_numpy(ps)
        np.testing.assert_array_equal(got.keys, np.asarray(rs.keys))
        np.testing.assert_array_equal(got.counts, np.asarray(rs.counts))
        assert int(got.used) == int(rs.used)
        assert int(got.overflow) == int(rs.overflow)
        printed += int(rstats.printed)
        skipped += int(rstats.skipped)
    assert printed > 0 and skipped > 0


@pytest.mark.parametrize("canonical", [False, True])
def test_single_end_step_matches_reference(canonical):
    check_step_matches_reference(False, canonical, 1)


def test_seed_step_matches_reference():
    ref, rs, port, ps = _steps(False, False, 1)
    bases, lengths, _ = _batches(False, n_batches=1)[0]
    rs = ref.seed_step(rs, jnp.asarray(bases), jnp.asarray(lengths))
    ps = port.seed_step(ps, bases, lengths)
    got = state_to_numpy(ps)
    np.testing.assert_array_equal(got.keys, np.asarray(rs.keys))
    np.testing.assert_array_equal(got.counts, np.asarray(rs.counts))
    assert int(got.used) == int(rs.used) > 0


def check_step_many_equals_steps():
    batches = _batches(True, n_batches=4)
    _, _, one, s1 = _steps(True, False, 1)
    _, _, many, s2 = _steps(True, False, 1)
    keeps, highs = [], []
    for b in batches:
        s1, keep, _, tal = one.step(s1, *b)
        keeps.append(keep)
        highs.append(tal.high)
    s2, keep2, stats2, tal2 = many.step_many(
        s2, *(np.stack([b[i] for b in batches]) for i in range(3)))
    torch.testing.assert_close(keep2, torch.stack(keeps), rtol=0, atol=0)
    torch.testing.assert_close(tal2.high, torch.stack(highs), rtol=0, atol=0)
    assert stats2.processed.shape == (4,)
    torch.testing.assert_close(s2.counts, s1.counts, rtol=0, atol=0)


def test_relaxed_mode_not_ported():
    """Relaxed mode is ported now (tests/test_torch_relaxed.py); a mode
    that is neither exact nor relaxed is refused."""
    kw = dict(k=K, depth_per_shard=DEPTH, coverage=COVERAGE,
              canonical=False, paired=False)
    assert BatchStep(BucketTable(K, rows=128), mode="relaxed", **kw).relaxed
    assert not BatchStep(BucketTable(K, rows=128), **kw).relaxed
    with pytest.raises(ValueError, match="exact or relaxed"):
        BatchStep(BucketTable(K, rows=128), mode="fast", **kw)


@pytest.mark.parametrize("rule", ["and", "avg"])
@pytest.mark.parametrize("coverage", [0.9, 0.5, 1.0, 0.001])
def test_keep_masks_match_reference(rule, coverage):
    rng = np.random.default_rng(int(coverage * 1000))
    total = rng.integers(0, 200, size=(4, 512)).astype(np.int32)
    total[:, :16] = 0                          # total 0 => ratio 0
    high = (total * rng.random((4, 512))).astype(np.int32)
    high[:, 16:32] = total[:, 16:32]           # ratio exactly 1
    jx = [jnp.asarray(x) for x in (high[0], total[0], high[1], total[1])]
    tx = [torch.from_numpy(x) for x in (high[0], total[0], high[1], total[1])]
    np.testing.assert_array_equal(
        port_dn.keep_mask_paired(*tx, coverage, rule).numpy(),
        np.asarray(ref_dn.keep_mask_paired(*jx, coverage, rule)))
    np.testing.assert_array_equal(
        port_dn.keep_mask_single(tx[0], tx[1], coverage).numpy(),
        np.asarray(ref_dn.keep_mask_single(jx[0], jx[1], coverage)))
    r = port_dn.coverage_ratios(tx[0], tx[1])
    assert r.dtype == torch.float32
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(ref_dn.coverage_ratios(jx[0], jx[1])))
