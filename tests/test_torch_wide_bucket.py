"""Port BucketTableWide (wide sort + K3w + K5, plain versions on the CPU) vs
the reference's BucketTableWide in interpret mode at 64 lanes: keys, keys2,
counts, used, overflow and the per-read high tallies, plane for plane and
lane for lane, over consecutive batches and in seed mode; and a state
without plane B (k = 16) through the engine's copies. Rows that fill and
grow are in test_torch_wide_bucket_rows.py. Exact (tolerance 0)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.table import BucketTableWide as RefTable
from nomalise_kmers_multi_large_torch.engine.pipeline import _copy
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.table import (
    BucketTableWide, state_from_numpy, state_to_numpy,
)

DEPTH = 3
ROWS = 512
SENT = np.uint32(0xFFFFFFFF)


def _words(k, n_reads, length, seed):
    """uint32 sort words [R, W] of reads drawn from a pool of n_reads / 8
    sequences with 2% substitutions (codes repeat), some reads short."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(max(2, n_reads // 8), length),
                        dtype=np.uint8)
    bases = pool[rng.integers(0, len(pool), size=n_reads)]
    sub = rng.random(bases.shape) < 0.02
    bases[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
    lengths = np.full(n_reads, length, np.int32)
    lengths[::7] = rng.integers(0, length + 1, size=lengths[::7].size)
    w1, w2 = encode_keys_wide(torch.from_numpy(bases),
                              torch.from_numpy(lengths), k, False)
    return w1.numpy().view(np.uint32), w2.numpy().view(np.uint32)


def _ref_stepper(table, seed=False, depth=DEPTH):
    """The reference's process_batch_keys, jitted as its engine runs it."""
    fn = jax.jit(partial(table.process_batch_keys, depth=depth, keyed=True,
                         seed=seed), static_argnums=(3,),
                 static_argnames=("windows_per_read",))

    def step(state, w1, w2):
        state, out = fn(state, jnp.asarray(w1), jnp.asarray(w2), None,
                        windows_per_read=w1.shape[1])
        return state, jax.tree.map(np.asarray, out)

    return step


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


def _port_step(table, state, w1, w2, seed=False, depth=DEPTH):
    return table.process_batch_keys(state, _i32(w1), _i32(w2), depth=depth,
                                    seed=seed)


def _assert_same(port_state, port_out, ref_state, ref_out):
    ps = state_to_numpy(port_state)
    np.testing.assert_array_equal(ps.keys, np.asarray(ref_state.keys))
    if ref_state.keys2 is None:
        assert ps.keys2 is None
    else:
        np.testing.assert_array_equal(ps.keys2, np.asarray(ref_state.keys2))
    np.testing.assert_array_equal(ps.counts, np.asarray(ref_state.counts))
    assert int(ps.used) == int(ref_state.used)
    assert int(ps.overflow) == int(ref_state.overflow)
    np.testing.assert_array_equal(port_out.high_per_read.numpy(),
                                  ref_out.high_per_read)
    assert int(port_out.overflow) == int(ref_out.overflow)
    assert int(port_out.inserted) == int(ref_out.inserted)


def _tables(k, rows=ROWS):
    return RefTable(k, rows=rows, lanes=64, interpret=True), \
        BucketTableWide(k, rows=rows)


@pytest.mark.parametrize("k", [16, 21, 25, 31])
def test_consecutive_batches_match_reference(k):
    ref, port = _tables(k)
    ref_step = _ref_stepper(ref)
    # shared start state: one reference batch, carried into the port
    rs, _ = ref_step(ref.init(), *_words(k, 64, 60, 0))
    ps = state_from_numpy(jax.tree.map(np.asarray, rs))
    for i in range(3):
        words = _words(k, 64, 60, 1 + i)
        rs, ro = ref_step(rs, *words)
        ps, po = _port_step(port, ps, *words)
        _assert_same(ps, po, rs, ro)
    assert int(rs.used) > 0 and ro.high_per_read.sum() > 0
    assert (ps.keys2 is None) == (k == 16)


def test_seed_mode_matches_reference():
    k = 25
    ref, port = _tables(k)
    ref_step = _ref_stepper(ref, seed=True)
    rs, ps = ref.init(), port.init()
    for i in range(2):
        words = _words(k, 64, 60, 20 + i)
        rs, ro = ref_step(rs, *words)
        ps, po = _port_step(port, ps, *words, seed=True)
        _assert_same(ps, po, rs, ro)
    assert int(ps.used) > 0 and int((ps.counts != 0).sum()) == 0


def test_state_without_plane_b_survives_copies():
    """k = 16 has no keys2: the replay snapshot and the numpy round trip
    keep it None, and copies own their planes."""
    table = BucketTableWide(16, rows=ROWS)
    st, _ = _port_step(table, table.init(), *_words(16, 32, 40, 40))
    assert st.keys2 is None
    snap = _copy(st)
    assert snap.keys2 is None and torch.equal(snap.keys, st.keys)
    assert snap.keys.data_ptr() != st.keys.data_ptr()
    host = state_to_numpy(st)
    assert host.keys2 is None and isinstance(host.keys, np.ndarray)
    back = state_from_numpy(host)
    assert back.keys2 is None and torch.equal(back.counts, st.counts)
    wide = BucketTableWide(17, rows=ROWS).init()
    assert _copy(wide).keys2.shape == wide.keys.shape
