"""The port's DirectTable against the JAX package's on random batches,
tolerance 0: ``count_and_update`` (observed counts and the count array,
batch after batch), the seed mode (a no-op on the device), the sort-free
``relaxed_update``, and ``used_count`` / ``export`` with a host set of
seeded codes, some of them counted since and some not."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.streamrank import (
    sorted_occurrence_stream as ref_stream,
)
from nomalise_kmers_multi_large_tpu.table import DirectTable as RefTable
from nomalise_kmers_multi_large_torch.ops.streamrank import (
    sorted_occurrence_stream,
)
from nomalise_kmers_multi_large_torch.table import DirectTable

K = 9


def _batch(rng, n=4000):
    pool = rng.integers(1, 4 ** K, size=600, dtype=np.int64)
    codes = pool[rng.integers(0, pool.size, size=n)]
    valid = (rng.random(n) > 0.1) & (codes != 0)
    return codes, valid


def _streams(codes, valid):
    lo = codes.astype(np.uint32)
    ref = ref_stream(jnp.zeros_like(jnp.asarray(lo)), jnp.asarray(lo),
                     jnp.asarray(valid), hi_is_zero=True)
    return ref, sorted_occurrence_stream(torch.from_numpy(codes),
                                         torch.from_numpy(valid))


def test_count_and_update_equals_jax_table():
    rng = np.random.default_rng(1)
    ref_t, port_t = RefTable(K), DirectTable(K)
    rs, ps = ref_t.init(), port_t.init()
    for i in range(4):
        codes, valid = _batch(rng)
        ref, got = _streams(codes, valid)
        seed = i == 0
        rs, robs = ref_t.count_and_update(rs, ref, seed=seed)
        ps, pobs = port_t.count_and_update(ps, got, seed=seed)
        v = got.valid.numpy()
        np.testing.assert_array_equal(pobs.numpy()[v], np.asarray(robs)[v])
        np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(rs.counts))
        assert ps.keys is None and int(ps.used) == int(rs.used) == 0
    assert int(ps.counts.max()) > 3 and port_t.capacity == 4 ** K


def test_relaxed_update_equals_jax_table():
    rng = np.random.default_rng(2)
    ref_t, port_t = RefTable(K), DirectTable(K)
    rs, ps = ref_t.init(), port_t.init()
    for _ in range(3):
        codes, valid = _batch(rng)
        rs, rprior = ref_t.relaxed_update(
            rs, jnp.asarray(codes.astype(np.uint32)), jnp.asarray(valid))
        ps, pprior = port_t.relaxed_update(ps, torch.from_numpy(codes),
                                           torch.from_numpy(valid))
        np.testing.assert_array_equal(pprior.numpy(), np.asarray(rprior))
        np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(rs.counts))


@pytest.mark.parametrize("with_seeds", [False, True])
def test_used_count_and_export_with_seeded_codes(with_seeds):
    rng = np.random.default_rng(3)
    ref_t, port_t = RefTable(K), DirectTable(K)
    rs, ps = ref_t.init(), port_t.init()
    codes, valid = _batch(rng)
    ref, got = _streams(codes, valid)
    rs, _ = ref_t.count_and_update(rs, ref)
    ps, _ = port_t.count_and_update(ps, got)
    seeded = None
    if with_seeds:
        # half counted since, half never seen
        seen = np.unique(codes[valid])[::2]
        fresh = rng.integers(1, 4 ** K, size=300, dtype=np.int64)
        seeded = np.unique(np.concatenate([seen, fresh])).astype(np.uint32)
    assert port_t.used_count(ps, seeded) == ref_t.used_count(rs, seeded)
    for a, b in zip(port_t.export(ps, seeded), ref_t.export(rs, seeded)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if with_seeds:
        assert port_t.used_count(ps, seeded) > port_t.used_count(ps)


def test_direct_table_rejects_wide_k():
    with pytest.raises(ValueError):
        DirectTable(16)
