"""Port BucketTable / bucket_batch (sort + K3 + K4) vs the reference's Pallas
bucket table in interpret mode: fp and counts planes lane for lane,
high_per_read, overflow and inserted, over consecutive batches from one
shared start state, and in seed mode. Exact (tolerance 0). Row overflow,
multi-chunk streams and growth are in test_torch_bucket_rows.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.ops.encode_kernel import encode_keys
from nomalise_kmers_multi_large_tpu.table import BucketTable as RefTable
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, state_from_numpy, state_to_numpy,
)

K = 9
DEPTH = 3


def _keys(n_reads, length, seed):
    """uint32 keys [R, W] (reference K1) of reads drawn from a pool of
    n_reads / 8 sequences with 2% substitutions, so codes repeat."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(max(2, n_reads // 8), length),
                        dtype=np.uint8)
    bases = pool[rng.integers(0, len(pool), size=n_reads)]
    sub = rng.random(bases.shape) < 0.02
    bases[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.uint8)
    lengths = np.full(n_reads, length, np.int32)
    lengths[::7] = rng.integers(0, length + 1, size=lengths[::7].size)
    return np.asarray(_encode(jnp.asarray(bases), jnp.asarray(lengths)))


_encode = jax.jit(partial(encode_keys, k=K, canonical=False, interpret=True))


def _ref_stepper(table, seed=False, depth=DEPTH):
    """The reference's process_batch_mixed, jitted as its engine runs it:
    interpret mode then compiles once per shape instead of running
    eagerly."""
    fn = jax.jit(partial(table.process_batch_mixed, depth=depth, keyed=True,
                         seed=seed), static_argnums=(2,),
                 static_argnames=("windows_per_read",))

    def step(state, keys):
        state, out = fn(state, jnp.asarray(keys), None,
                        windows_per_read=keys.shape[1])
        return state, jax.tree.map(np.asarray, out)

    return step


def _i32(keys):
    return torch.from_numpy(keys.astype(np.uint32).view(np.int32).copy())


def _port_step(table, state, keys, seed=False):
    return table.process_batch_mixed(state, _i32(keys), depth=DEPTH,
                                     seed=seed)


def _assert_same(port_state, port_out, ref_state, ref_out):
    ps = state_to_numpy(port_state)
    np.testing.assert_array_equal(ps.keys, np.asarray(ref_state.keys))
    np.testing.assert_array_equal(ps.counts, np.asarray(ref_state.counts))
    assert int(ps.used) == int(ref_state.used)
    assert int(ps.overflow) == int(ref_state.overflow)
    np.testing.assert_array_equal(port_out.high_per_read.numpy(),
                                  ref_out.high_per_read)
    assert int(port_out.overflow) == int(ref_out.overflow)
    assert int(port_out.inserted) == int(ref_out.inserted)


@pytest.mark.parametrize("lanes", [64, 128])
def test_consecutive_batches_match_reference(lanes):
    rows = 128
    ref = RefTable(K, rows=rows, lanes=lanes, interpret=True)
    port = BucketTable(K, rows=rows, lanes=lanes)
    ref_step = _ref_stepper(ref)
    # shared start state: one reference batch, carried into the port
    rs, _ = ref_step(ref.init(), _keys(64, 40, 0))
    ps = state_from_numpy(jax.tree.map(np.asarray, rs))
    for i in range(3):
        keys = _keys(64, 40, 1 + i)
        rs, ro = ref_step(rs, keys)
        ps, po = _port_step(port, ps, keys)
        _assert_same(ps, po, rs, ro)
    assert int(rs.used) > 0 and ro.high_per_read.sum() > 0


def test_seed_mode_matches_reference():
    ref = RefTable(K, rows=128, interpret=True)
    port = BucketTable(K, rows=128)
    ref_step = _ref_stepper(ref, seed=True)
    rs, ps = ref.init(), port.init()
    for i in range(2):
        keys = _keys(64, 40, 20 + i)
        rs, ro = ref_step(rs, keys)
        ps, po = _port_step(port, ps, keys, seed=True)
        _assert_same(ps, po, rs, ro)
    assert int(ps.used) > 0 and int((ps.counts != 0).sum()) == 0
