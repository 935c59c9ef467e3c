"""The port's HashedTable (its plain find-or-insert, the CPU path) against
the JAX package's on a 2^10-slot table, tolerance 0. Slots may be placed
differently, so states compare by ``export`` (codes ascending, counts),
``used``, ``overflow`` and the observed counts: batch after batch up to
~70 % load, with a seed batch (count 0). Then the two repairs: ``grown``
keeps ``overflow`` (the JAX table resets it), and on a full table an
unresolved code observes only its rank and is not counted (the JAX table
reads and adds to the last slot's count)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.streamrank import (
    sorted_occurrence_stream as ref_stream,
)
from nomalise_kmers_multi_large_tpu.table import HashedTable as RefTable
from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
    hashed_insert_plain, slot_hash,
)
from nomalise_kmers_multi_large_torch.ops.streamrank import (
    sorted_occurrence_stream,
)
from nomalise_kmers_multi_large_torch.table import (
    HashedTable, state_from_numpy, state_to_numpy,
)

K, CAP = 25, 1 << 10


def _batch(rng, n_codes, n=1200):
    pool = rng.integers(1, 1 << (2 * K), size=n_codes, dtype=np.int64)
    codes = pool[rng.integers(0, pool.size, size=n)]
    valid = rng.random(n) > 0.1
    return codes, valid


def _streams(codes, valid):
    u = codes.astype(np.uint64)
    ref = ref_stream(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
                     jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(
                         np.uint32)), jnp.asarray(valid))
    return ref, sorted_occurrence_stream(torch.from_numpy(codes),
                                         torch.from_numpy(valid))


def _same_table(port_t, ps, ref_t, rs):
    for a, b in zip(port_t.export(ps), ref_t.export(rs)):
        np.testing.assert_array_equal(a, b)
    assert (int(ps.used), int(ps.overflow)) == (int(rs.used),
                                                int(rs.overflow))


def test_batches_equal_jax_table_up_to_high_load():
    rng = np.random.default_rng(5)
    ref_t, port_t = RefTable(K, CAP), HashedTable(K, CAP)
    rs, ps = ref_t.init(), port_t.init()
    for i, n_codes in enumerate((250, 200, 200, 150)):
        codes, valid = _batch(rng, n_codes)
        ref, got = _streams(codes, valid)
        seed = i == 0
        rs, robs = ref_t.count_and_update(rs, ref, seed=seed)
        ps, pobs = port_t.count_and_update(ps, got, seed=seed)
        v = got.valid.numpy()
        if not seed:
            np.testing.assert_array_equal(pobs.numpy()[v],
                                          np.asarray(robs)[v])
        _same_table(port_t, ps, ref_t, rs)
    assert int(ps.used) > 0.6 * CAP and int(ps.overflow) == 0
    # the seeded codes that no count batch met are still there, at 0
    assert (port_t.export(ps)[2] == 0).any()


def test_seed_inserts_with_count_zero():
    rng = np.random.default_rng(6)
    t = HashedTable(K, CAP)
    st = t.init()
    codes, valid = _batch(rng, 300)
    st, obs = t.count_and_update(st, _streams(codes, valid)[1], seed=True)
    hi, lo, counts = t.export(st)
    want = np.unique(codes[valid]).astype(np.uint64)
    np.testing.assert_array_equal(
        (hi.astype(np.uint64) << np.uint64(32)) | lo, want)
    assert not counts.any() and not obs.any()
    assert int(st.used) == want.size and int(st.overflow) == 0


def test_grown_keeps_contents_and_overflow():
    """grown() re-inserts every code with its count at twice the capacity
    and keeps `overflow`; the JAX table's grown() resets it to 0, which
    this pins (hashed.py:177 of the JAX package)."""
    rng = np.random.default_rng(7)
    ref_t, port_t = RefTable(K, CAP), HashedTable(K, CAP)
    rs, ps = ref_t.init(), port_t.init()
    codes, valid = _batch(rng, 400)
    ref, got = _streams(codes, valid)
    rs, _ = ref_t.count_and_update(rs, ref)
    ps, _ = port_t.count_and_update(ps, got)
    ps = ps._replace(overflow=torch.tensor(17, dtype=torch.int32))
    rs = rs._replace(overflow=jnp.int32(17))
    g_t, gs = port_t.grown(ps)
    rg_t, rgs = ref_t.grown(rs)
    assert g_t.capacity == rg_t.capacity == 2 * CAP
    for a, b in zip(g_t.export(gs), port_t.export(ps)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(g_t.export(gs), rg_t.export(rgs)):
        np.testing.assert_array_equal(a, b)
    assert int(gs.used) == int(ps.used) == int(rgs.used)
    assert int(gs.overflow) == 17 and int(rgs.overflow) == 0


def test_full_table_leaves_unresolved_codes_uncounted():
    """Every slot holds a code; a batch of old and new codes: the old ones
    count as usual, the new ones are unresolved (overflow), observe their
    rank alone and add nothing. The JAX table, given the same state,
    reports the same overflow but adds the new codes' multiplicity to the
    last slot's count (slot -1 wraps)."""
    rng = np.random.default_rng(8)
    cap = 1 << 6
    port_t, ref_t = HashedTable(K, cap), RefTable(K, cap)
    ps = port_t.init()
    pool = rng.integers(1, 1 << (2 * K), size=4 * cap, dtype=np.int64)
    hashed_insert_plain(ps.keys, torch.from_numpy(np.unique(pool)))
    hole = ps.keys == 0
    ps.keys[hole] = torch.arange(1, int(hole.sum()) + 1) << 52  # fill holes
    findable = [c for c in pool if c in set(ps.keys.tolist())]
    ps = ps._replace(used=torch.tensor(cap, dtype=torch.int32),
                     counts=torch.full((cap,), 2, dtype=torch.int32))
    old = np.array(findable[:5], np.int64)
    new = rng.integers(1 << 40, 1 << 41, size=3, dtype=np.int64)
    codes = np.concatenate([old, old[:2], new, new[:1]])
    valid = np.ones(codes.size, bool)
    ref, got = _streams(codes, valid)
    rs = RefTable.init(ref_t)._replace(
        **{f: jnp.asarray(getattr(state_to_numpy(ps), f))
           for f in ("counts", "keys", "used", "overflow")})
    ps2, obs = port_t.count_and_update(
        state_from_numpy(state_to_numpy(ps)), got)
    rs2, robs = ref_t.count_and_update(rs, ref)
    assert int(ps2.overflow) == int(rs2.overflow) == 3
    by_code = dict(zip(got.code.tolist(), obs.tolist()))
    assert {by_code[c] for c in new} <= {1, 2}       # their rank alone
    assert all(by_code[c] >= 3 for c in old)          # prior 2 + rank
    after = dict(zip(*[x.tolist() for x in (ps2.keys, ps2.counts)]))
    assert [after[c] for c in old[:2]] == [4, 4]
    assert int(ps2.counts.sum()) == 2 * cap + old.size + 2
    # the JAX table added the new codes' 4 occurrences to slot C - 1
    assert int(np.asarray(rs2.counts).sum()) == int(ps2.counts.sum()) + 4


def test_slot_hash_equals_jax():
    from nomalise_kmers_multi_large_tpu.table.hashed import _slot_hash

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 1 << 62, size=5000, dtype=np.int64)
    u = codes.astype(np.uint64)
    want = _slot_hash(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
                      jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(
                          np.uint32)))
    np.testing.assert_array_equal(slot_hash(torch.from_numpy(codes)).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("cap", [1000, 1 << 31, 1])
def test_hashed_table_rejects_bad_capacity(cap):
    with pytest.raises(ValueError):
        HashedTable(K, cap)
