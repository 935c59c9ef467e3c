"""The all-or-nothing gate of the port's bucket tables (ops/bucket_kernel.py
Gate), plain versions on the CPU, narrow (k = 9) and wide (k = 25):

- against the JAX package's bucket tables in interpret mode, from one
  shared start state: a gated batch that fits equals the JAX step lane for
  lane and leaves the gate open; a batch the JAX step drops inserts on
  leaves keys, keys2, counts, used and overflow bit-identical and closes
  the gate with its ticket; behind the closed gate a batch that fits
  changes nothing either, and once the gate reopens it equals the JAX step
  from the same state;
- with the gate off (a table that cannot grow) or honour-only (ticket 0)
  on an open gate, the drops and planes equal the ungated kernel's and the
  JAX step's;
- the check pass closes the gate exactly when the ungated kernel drops,
  on rows crafted at and one past their lanes and on random batches.

Exact (tolerance 0)."""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.table import BucketTable as RefNarrow
from nomalise_kmers_multi_large_tpu.table import BucketTableWide as RefWide
from nomalise_kmers_multi_large_torch.engine.step import BatchStep
from nomalise_kmers_multi_large_torch.ops.bucket_kernel import Gate
from nomalise_kmers_multi_large_torch.ops.encode_kernel import (
    encode_keys, encode_keys_wide,
)
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, BucketTableWide, state_from_numpy, state_to_numpy,
)
from test_torch_cuda import check_and_drops, gate_stream

K, WIDE_K, DEPTH = 9, 25, 3
# 128 narrow rows (8192 slots), 512 wide rows (32768 slots)
ROWS = {False: 128, True: 512}
READS = {False: 256, True: 512}
LENGTH = 100


def _batch(wide: bool, pool: int, seed: int):
    """uint32 sort words [R, W] of the reads of one batch drawn from `pool`
    sequences (few distinct codes for a small pool); with a pool of at
    least the batch's reads, each sequence once: about 2.9 (narrow) and 1.2
    (wide) times the table's slots in distinct codes, so rows overflow.
    Some reads are short."""
    rng = np.random.default_rng(seed)
    reads = READS[wide]
    seqs = rng.integers(0, 4, size=(pool, LENGTH), dtype=np.uint8)
    bases = seqs[:reads] if pool >= reads else \
        seqs[rng.integers(0, pool, size=reads)]
    lengths = np.full(reads, LENGTH, np.int32)
    lengths[::7] = rng.integers(0, LENGTH + 1, size=lengths[::7].size)
    b, ln = torch.from_numpy(bases), torch.from_numpy(lengths)
    if wide:
        return tuple(w.numpy().view(np.uint32)
                     for w in encode_keys_wide(b, ln, WIDE_K, False))
    return (encode_keys(b, ln, K, False).numpy().view(np.uint32),)


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


@lru_cache(maxsize=None)
def _ref(wide: bool):
    """(JAX table, its step jitted as its engine runs it): interpret mode
    then compiles once per shape."""
    if wide:
        table = RefWide(WIDE_K, rows=ROWS[True], lanes=64, interpret=True)
        fn = jax.jit(partial(table.process_batch_keys, depth=DEPTH,
                             keyed=True), static_argnums=(3,),
                     static_argnames=("windows_per_read",))
    else:
        table = RefNarrow(K, rows=ROWS[False], interpret=True)
        fn = jax.jit(partial(table.process_batch_mixed, depth=DEPTH,
                             keyed=True), static_argnums=(2,),
                     static_argnames=("windows_per_read",))

    def step(state, words):
        state, out = fn(state, *map(jnp.asarray, words), None,
                        windows_per_read=words[0].shape[1])
        return state, jax.tree.map(np.asarray, out)

    return table, step


def _port_table(wide: bool):
    return (BucketTableWide(WIDE_K, rows=ROWS[True]) if wide
            else BucketTable(K, rows=ROWS[False]))


def _port(table, state, words, gate=None):
    fn = table.process_batch_keys if table.wide else table.process_batch_mixed
    return fn(state, *map(_i32, words), depth=DEPTH, gate=gate)


def _planes(state):
    return [None if x is None else x.clone() for x in state]


def _assert_state(state, want):
    """Every field of a port state equal to `want` (a list of tensors)."""
    for got, w in zip(state, want):
        assert (got is None and w is None) or torch.equal(got, w)


def _assert_same(port_state, port_out, ref_state, ref_out):
    ps = state_to_numpy(port_state)
    for name in ("keys", "keys2", "counts", "used", "overflow"):
        a, b = getattr(ps, name), getattr(ref_state, name)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(port_out.high_per_read.numpy(),
                                  ref_out.high_per_read)
    assert int(port_out.overflow) == int(ref_out.overflow)
    assert int(port_out.inserted) == int(ref_out.inserted)


def _start(wide: bool):
    """The shared start: one small batch through the JAX table, its state
    carried into the port."""
    ref, step = _ref(wide)
    rs, _ = step(ref.init(), _batch(wide, 4, 1))
    return rs, state_from_numpy(jax.tree.map(np.asarray, rs))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_gated_batches_against_reference(wide):
    rs0, ps0 = _start(wide)
    _, step = _ref(wide)
    table = _port_table(wide)
    flag = torch.zeros(1, dtype=torch.int32)

    fits = _batch(wide, 4, 2)
    rs1, ro = step(rs0, fits)
    ps1, po = _port(table, ps0, fits, Gate(flag, 5))
    assert int(ro.overflow) == 0 and int(flag) == 0
    _assert_same(ps1, po, rs1, ro)

    over = _batch(wide, READS[wide], 3)
    _, ro = step(rs1, over)
    assert int(ro.overflow) > 0          # the JAX step drops inserts here
    before = _planes(ps1)
    ps2, po = _port(table, ps1, over, Gate(flag, 6))
    assert int(flag) == 6
    _assert_state(ps2, before)
    assert int(po.inserted) == int(po.overflow) == 0
    assert int(po.high_per_read.sum()) == 0

    later = _batch(wide, 4, 4)           # fits, but the gate stays closed
    ps3, po = _port(table, ps2, later, Gate(flag, 7))
    assert int(flag) == 6
    _assert_state(ps3, before)
    assert int(po.inserted) == 0

    flag.zero_()                         # reopened: applies as on the JAX
    rs4, ro = step(rs1, later)
    ps4, po = _port(table, ps3, later, Gate(flag, 8))
    assert int(flag) == 0 and int(po.inserted) > 0
    _assert_same(ps4, po, rs4, ro)


@pytest.mark.parametrize("ticket", [None, 0], ids=["off", "honour_only"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_ungated_drops_equal_reference(wide, ticket):
    """A table that cannot grow runs ungated (or, behind earlier gated
    batches, honour-only on an open gate): it inserts what fits and
    counts the rest in overflow, as the JAX kernel does."""
    rs0, ps0 = _start(wide)
    _, step = _ref(wide)
    over = _batch(wide, READS[wide], 3)
    rs, ro = step(rs0, over)
    gate = None if ticket is None else Gate(
        torch.zeros(1, dtype=torch.int32), ticket)
    ps, po = _port(_port_table(wide), ps0, over, gate)
    assert int(ro.overflow) > 0 and int(ps.overflow) == int(ro.overflow)
    _assert_same(ps, po, rs, ro)
    assert gate is None or int(gate.flag) == 0


# ----------------------------------------------------------------------
# the check pass against the ungated kernel's drops (test_torch_cuda.py
# holds the kernels to the same cases on the card)

@pytest.mark.parametrize("over", [0, 1, 3])
@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_check_closes_exactly_when_rows_overflow(wide, lanes, over):
    """Every row gets exactly its free lanes' worth of new codes: nothing
    drops and the gate stays open; `over` rows one more: the kernel drops
    `over` inserts and the check closes the gate."""
    rng = np.random.default_rng(100 * wide + lanes + over)
    stream = gate_stream(torch.device("cpu"), wide, lanes, over, rng)
    flag, dropped = check_and_drops(*stream)
    assert dropped == over
    assert flag == (9 if over else 0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_check_agrees_with_ungated_drops_on_batches(wide, seed):
    """Seeded tables at several fills, then one count batch: the check
    closes the gate iff the ungated kernel drops."""
    table = _port_table(wide)
    state = table.init()
    for i in range(seed):
        state, _ = _port(table, state, _batch(wide, 64, 10 * seed + i))
    words = _batch(wide, 32 * (seed + 1), 10 * seed + 9)
    flag = torch.zeros(1, dtype=torch.int32)
    before = _planes(state)
    _, want = _port(table, state._replace(**{
        n: x.clone() for n, x in state._asdict().items() if x is not None}),
        words)
    _port(table, state, words, Gate(flag, 3))
    assert (int(flag) == 3) == (int(want.overflow) > 0)
    if int(flag):
        _assert_state(state, before)


@pytest.mark.parametrize("ticket", [0, 10], ids=["honour_only", "gated"])
def test_step_many_tickets(ticket):
    """A group of three batches whose second overflows the table: gated,
    batch g holds ticket + g, so the gate names batch 1, batch 0 stands
    and nothing of batches 1 and 2 lands; honour-only (ticket 0), no batch
    runs a check and the table drops as ungated."""
    table = _port_table(False)
    step = BatchStep(table, k=K, depth_per_shard=DEPTH, coverage=0.9,
                     canonical=False, paired=False)
    rng = np.random.default_rng(6)
    seqs = rng.integers(0, 4, size=(3, READS[False], LENGTH),
                        dtype=np.uint8)
    seqs[0] = seqs[0][rng.integers(0, 2, size=READS[False])]
    seqs[2] = seqs[2][rng.integers(0, 2, size=READS[False])]
    lengths = np.full((3, READS[False]), LENGTH, np.int32)
    valid = np.ones((3, READS[False]), bool)
    flag = torch.zeros(1, dtype=torch.int32)
    one = step.step(table.init(), seqs[0], lengths[0], valid[0])[0]
    state, _, stats, _ = step.step_many(table.init(), seqs, lengths, valid,
                                        gate=Gate(flag, ticket))
    if ticket:
        assert int(flag) == ticket + 1
        _assert_state(state, list(one))
    else:
        assert int(flag) == 0 and int(state.overflow) > 0
    assert stats.processed.tolist() == [READS[False]] * 3


@pytest.mark.parametrize("block_rows", [1, 3, 1 << 18])
def test_used_count_by_blocks(monkeypatch, block_rows):
    """used_count sums its blocks of rows (a whole-table bool sum would
    cast to int64, 8 bytes a slot): any block size gives the occupancy."""
    import nomalise_kmers_multi_large_torch.table.bucket as port_bucket

    monkeypatch.setattr(port_bucket, "_SPLIT_BLOCK_ROWS", block_rows)
    table = _port_table(True)
    state, _ = _port(table, table.init(), _batch(True, 64, 5))
    want = int((state.keys != 0).sum())
    assert want > 0 and table.used_count(state) == want == int(state.used)
