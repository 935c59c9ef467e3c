"""Relaxed mode (``--mode relaxed``) on the bucket paths, narrow (k = 11)
and wide (k = 21): the read id stops being a sort key, so ranks among a
batch's copies of one code reach reads in arbitrary order.

What holds whichever order the sort leaves equal codes in, and so what is
tested: the table planes equal exact mode's and the JAX package's relaxed
step's lane for lane; per batch the sum of high windows, the per-read
totals and the processed count are equal. Keep decisions may differ; the
engine's decision delta on 1,000 pairs of a1/b1 is bounded. Exact
(tolerance 0)."""
import collections
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.engine.step import BatchStep as RefStep
from nomalise_kmers_multi_large_tpu.table.bucket import (
    BucketTable as RefTable, BucketTableWide as RefTableWide,
)
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.engine.step import BatchStep
from nomalise_kmers_multi_large_torch.ops import bucket_kernel
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, BucketTableWide, state_to_numpy,
)

DATA = pathlib.Path(__file__).resolve().parent / "data"
DEPTH, COVERAGE = 3, 0.6


def _batches(k, n_batches=3, pairs=24, length=60, seed=0):
    """Packed paired batches from a small pool of sequences with a few
    substitutions each, so codes repeat within and across reads."""
    rng = np.random.default_rng(seed + k)
    pool = rng.integers(0, 4, size=(12, length), dtype=np.uint8)
    out = []
    for _ in range(n_batches):
        bases = pool[rng.integers(0, len(pool), size=2 * pairs)].copy()
        sub = rng.random(bases.shape) < 0.02
        bases[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
        lengths = np.full(2 * pairs, length, np.int32)
        lengths[5::9] = rng.integers(0, length, size=lengths[5::9].size)
        lengths[lengths < k] = 0
        rec_valid = (lengths[0::2] > 0) & (lengths[1::2] > 0)
        lengths[0::2] = np.where(rec_valid, lengths[0::2], 0)
        lengths[1::2] = np.where(rec_valid, lengths[1::2], 0)
        out.append((bases, lengths, rec_valid))
    return out


def _tables(k):
    if k > 15:
        return RefTableWide(k, rows=512, interpret=True), \
            BucketTableWide(k, rows=512), BucketTableWide(k, rows=512)
    return RefTable(k, rows=128, interpret=True), BucketTable(k, rows=128), \
        BucketTable(k, rows=128)


@pytest.mark.parametrize("k", [11, 21])
def test_relaxed_step_planes_and_tallies(k):
    ref_t, relaxed_t, exact_t = _tables(k)
    kw = dict(k=k, depth_per_shard=DEPTH, coverage=COVERAGE,
              canonical=False, paired=True)
    ref = RefStep(ref_t, mode="relaxed", **kw)
    relaxed = BatchStep(relaxed_t, mode="relaxed", **kw)
    exact = BatchStep(exact_t, mode="exact", **kw)
    rs, ps, es = ref_t.init(), relaxed_t.init(), exact_t.init()
    highs = 0
    for bases, lengths, rec_valid in _batches(k):
        rs, _, rstats, rtal = ref.step(rs, jnp.asarray(bases),
                                       jnp.asarray(lengths),
                                       jnp.asarray(rec_valid))
        ps, pkeep, pstats, ptal = relaxed.step(ps, bases, lengths, rec_valid)
        es, _, estats, etal = exact.step(es, bases, lengths, rec_valid)
        got, want = state_to_numpy(ps), state_to_numpy(es)
        for name in ("keys", "keys2", "counts"):
            a, b, c = (getattr(x, name) for x in (got, want, rs))
            if c is None:
                assert a is None and b is None
                continue
            np.testing.assert_array_equal(a, np.asarray(c))
            np.testing.assert_array_equal(a, b)
        assert int(got.used) == int(want.used) == int(rs.used)
        assert int(got.overflow) == int(want.overflow) == int(rs.overflow)
        high = int(ptal.high.sum())
        assert high == int(etal.high.sum()) == int(np.asarray(rtal.high).sum())
        np.testing.assert_array_equal(ptal.total.numpy(), etal.total.numpy())
        np.testing.assert_array_equal(ptal.total.numpy(),
                                      np.asarray(rtal.total))
        assert int(pstats.processed) == int(estats.processed) == \
            int(rstats.processed)
        assert int(pstats.printed) + int(pstats.skipped) == \
            int(pstats.processed) == int(rec_valid.sum())
        assert int(pkeep.sum()) == int(pstats.printed)
        highs += high
    assert highs > 0 and int(got.used) > 0


def _head(src, dst, records):
    lines = pathlib.Path(src).read_text().splitlines(True)
    pathlib.Path(dst).write_text("".join(lines[:2 * records]))
    return str(dst)


def _engine(tmp_path, sub, k, mode, pairs):
    out = tmp_path / sub
    out.mkdir()
    fa = _head(DATA / "a1.fasta", tmp_path / f"{sub}_a.fa", pairs)
    fb = _head(DATA / "b1.fasta", tmp_path / f"{sub}_b.fa", pairs)
    cfg = Config(forward_files=(fa,), reverse_files=(fb,), informat="fa",
                 outformat="fa", ksize=k, depth=4, mode=mode,
                 print_table=True, batch_reads=256, out_dir=str(out))
    rep = Normalizer(cfg, device="cpu").run()
    return rep, out


@pytest.mark.parametrize("k", [11, 21])
def test_relaxed_flag_reaches_the_sort(tmp_path, monkeypatch, k):
    """A spy on the sort of the table's path: the engine in relaxed mode
    passes relaxed=True, in exact mode False."""
    name = "sort_stream_wide" if k > 15 else "sort_stream"
    real = getattr(bucket_kernel, name)
    seen = []

    def spy(*a):
        seen.append(a[-1])
        return real(*a)

    monkeypatch.setattr(bucket_kernel, name, spy)
    _engine(tmp_path, "relaxed", k, "relaxed", 100)
    assert seen and all(x is True for x in seen)
    seen.clear()
    _engine(tmp_path, "exact", k, "exact", 100)
    assert seen and all(x is False for x in seen)


def _kept(out) -> collections.Counter:
    """The kept forward records (header and sequence) with their counts:
    a1 repeats some headers."""
    lines = next(out.glob("output_forward.*")).read_text().splitlines()
    return collections.Counter(zip(lines[0::2], lines[1::2]))


@pytest.mark.parametrize("k", [15, 25])
def test_relaxed_engine_dumps_equal_and_decisions_close(tmp_path, k):
    """The first 1,000 pairs of a1/b1 at -d 4: the -P dumps (seed table and
    final table) are exact mode's byte for byte, the totals but printed and
    skipped are equal, and at most 2 % of the pairs change their decision
    (zero when the sort keeps equal codes in stream order)."""
    pairs = 1000
    exact, eout = _engine(tmp_path, "exact", k, "exact", pairs)
    relaxed, rout = _engine(tmp_path, "relaxed", k, "relaxed", pairs)
    assert relaxed.total_processed == exact.total_processed == pairs
    assert relaxed.max_total_kmers == exact.max_total_kmers > 0
    dumps = sorted(p.name for p in eout.glob("*.tsv"))
    assert len(dumps) == 2
    for name in dumps:
        assert (rout / name).read_bytes() == (eout / name).read_bytes()
    kept_e, kept_r = _kept(eout), _kept(rout)
    assert kept_e.total() == exact.total_printed < pairs
    assert kept_r.total() == relaxed.total_printed
    assert (kept_e - kept_r).total() + (kept_r - kept_e).total() \
        <= 0.02 * pairs
