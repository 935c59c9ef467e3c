"""Mode B of the port on the hashed table (--sharding global --table hashed:
D hashed tables of C / D slots on D logical CPU devices, a code owned by
the top log2 D bits of its slot hash, parallel/modes.py::
SlotShardedHashedTable and ModeBStreamStep) against the JAX package and
the port's one-device run, tolerance 0. Slots may be placed differently,
so tables compare by ``export``, ``used`` and ``overflow``:

- the step against the JAX ``ModeBStep`` on conftest's virtual CPU mesh
  (GSPMD's slot-sharded table), exact and relaxed, stride 1 and 2, paired
  and single, canonical;
- the engine against the JAX ``MeshNormalizer(sharding="global")``, whose
  hashed Mode B neither grows nor replays, so it gets a capacity at which
  it never saturates, and against the port's one-device run;
- a start at 1024 slots: the table grows mid-stream, every shard doubling,
  and replays, with the bytes of the one-device run and no code left
  unresolved (the JAX package's Mode B saturates there);
- both goldens through the CLI, -P dumps and --spectrum equal to a
  one-device run, --debug 3 stdout with --dispatch-group 2 equal to it;
- checkpoints crossing Mode B, the one-device port and the JAX loader and
  engine (one whole-table state, the shards inserted anew);
- the descriptor's gather, split, growth and owner bits; a D that is not a
  power of two refused."""
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.table import HashedTable as RefHashed
from nomalise_kmers_multi_large_torch.config import Config, ConfigError
from nomalise_kmers_multi_large_torch.ops.hashed_kernel import (
    hashed_insert_plain, slot_hash,
)
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from nomalise_kmers_multi_large_torch.parallel.modes import (
    SlotShardedHashedTable,
)
from nomalise_kmers_multi_large_torch.table import HashedTable
from test_torch_checkpoint import _outputs, _totals
from test_torch_fallback_checkpoint import _hash_slots
from test_torch_mode_b_direct import (
    CPU, ENGINE_CASES, STEP_CASES, check_against_jax_mesh,
    check_against_one_device, check_checkpoints, check_debug,
    check_dumps_and_spectrum, check_golden, check_golden_without_jax,
    engine_kw, mode_b, one_device, reads_inputs, run_step_pair,
    step_batches, step_pair,
)
from one_thread import one_torch_thread  # noqa: F401

K = 21           # the step tests' k (a wide code: both 32-bit halves)
SLOTS = 1 << 14  # the step tests' table: never near half load


def _same_table(t, state, ref_t, ref_state):
    for a, b in zip(t.export(state), ref_t.export(ref_state)):
        np.testing.assert_array_equal(a, b)
    assert (int(state.used), int(state.overflow)) == (
        int(ref_state.used), int(ref_state.overflow))


@pytest.mark.parametrize("n,paired,mode,stride,canonical", STEP_CASES)
def test_step_equals_jax_mode_b_step(n, paired, mode, stride, canonical):
    t = SlotShardedHashedTable(HashedTable(K, SLOTS), [CPU] * n)
    ref_t = RefHashed(K, SLOTS)
    ref, port = step_pair(ref_t, t, n, k=K, paired=paired, mode=mode,
                          stride=stride, canonical=canonical)
    rs, ps = run_step_pair(ref, port, ref.init_state(), t.init(),
                           step_batches(n + 10 * stride, paired))
    _same_table(t, ps, ref_t, rs)
    assert int(ps.used) > 0 and all(k.shape == (SLOTS // n,)
                                    for k in ps.keys)


@pytest.mark.parametrize("k,n,kind", [(21, 2, "paired"), (21, 4, "single"),
                                      (15, 4, "canonical")])
def test_mode_b_equals_jax_mesh_normalizer(tmp_path, monkeypatch, k, n,
                                           kind):
    _hash_slots(monkeypatch, 1024, 1 << 18)
    check_against_jax_mesh(tmp_path, "hashed", k, n, kind)


@pytest.mark.parametrize("n,paired,extra", ENGINE_CASES)
def test_mode_b_equals_one_device(tmp_path, monkeypatch, n, paired, extra):
    _hash_slots(monkeypatch, 1 << 16)
    norm = check_against_one_device(tmp_path, "hashed", 21, n, paired, extra)
    assert [x.device for x in norm.states[0].keys] == [CPU] * n


@pytest.mark.parametrize("n", [2, 4])
def test_mode_b_grows_and_replays_as_one_device(tmp_path, monkeypatch,
                                                capsys, n):
    """From 1024 slots (shards of 1024 / n) with one seeded record, the
    table doubles mid-stream, every shard at once, and a dispatch that
    left a code unresolved in a full shard is replayed on a grown table:
    outputs, -P dump and totals equal the one-device run from 1024 slots,
    and no code is left unresolved."""
    _hash_slots(monkeypatch, 1024)
    inputs = reads_inputs(tmp_path, True, 900)
    kws = [engine_kw(tmp_path, sub, inputs, "hashed", ksize=13, depth=3,
                     seed_records=1, batch_reads=256, informat="fq",
                     outformat="fq") for sub in ("b", "one")]
    norm, one = mode_b(kws[0], n), one_device(kws[1])
    capsys.readouterr()
    reps = [norm.run(), one.run()]
    err = capsys.readouterr().err
    t = norm.tables[0]
    assert t.capacity == one.tables[0].capacity > 1024
    assert [int(k.shape[0]) for k in norm.states[0].keys] == \
        [t.capacity // n] * n
    assert "and replaying the batch group" in err
    assert int(norm.states[0].overflow) == 0
    assert int(norm.states[0].used) == t.used_count(norm.states[0]) == \
        int(one.states[0].used)
    assert _totals(reps[0]) == _totals(reps[1])
    assert _outputs(kws[0]) == _outputs(kws[1])


@pytest.mark.parametrize("k,golden", [(15, "fasta_in_paired_k15"),
                                      (25, "fasta_in_paired_k25_jax")])
def test_mode_b_cli_reproduces_the_golden(tmp_path, monkeypatch, k, golden):
    _hash_slots(monkeypatch, 1 << 18)
    check_golden(tmp_path, k, golden, "hashed", 2)


def test_mode_b_cli_reproduces_the_golden_importing_no_jax(tmp_path):
    check_golden_without_jax(tmp_path, "hashed")


@pytest.mark.parametrize("n", [2, 4])
def test_mode_b_dumps_and_spectrum_equal_one_device(tmp_path, monkeypatch,
                                                    n, capsys):
    _hash_slots(monkeypatch, 1 << 20)
    check_dumps_and_spectrum(tmp_path, 21, "hashed", n, capsys)


def test_mode_b_debug_3_equals_one_device(tmp_path, monkeypatch, capsys):
    _hash_slots(monkeypatch, 1 << 16)
    check_debug(tmp_path, "hashed", 21, capsys)


def test_mode_b_checkpoints_cross_with_one_device_and_jax(tmp_path,
                                                          monkeypatch):
    """As on the direct table, from 2^16 slots (the JAX engine, which
    resumes the Mode B checkpoint, grows but never replays)."""
    _hash_slots(monkeypatch, 1 << 16, 1 << 16)
    check_checkpoints(tmp_path, "hashed", 21, 1 << 16)


# ----------------------------------------------------------------------
# the descriptor

def _whole_table(rng, k=25, slots=1 << 12, n_codes=1500):
    """A one-device hashed table holding random codes with counts (some
    0, as seeds)."""
    t = HashedTable(k, slots)
    st = t.init()
    codes = torch.from_numpy(np.unique(rng.integers(
        1, 1 << (2 * k), size=n_codes, dtype=np.int64)))
    mult = torch.from_numpy(rng.integers(0, 9, size=codes.numel(),
                                         dtype=np.int32))
    out = hashed_insert_plain(st.keys, codes, mult, st.counts)
    return t, st._replace(used=out.stats[0].to(torch.int32))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_hashed_shards_split_gather_and_grow(n):
    """split puts each code in its owner's shard with its count; gather
    gives back a one-device table of the same contents; a doubling keeps
    every code in its shard; used and overflow count the whole table."""
    rng = np.random.default_rng(n)
    whole_t, whole = _whole_table(rng)
    t = SlotShardedHashedTable(whole_t, [CPU] * n).for_whole(whole)
    st = t.split(whole)
    assert int(st.used) == int(whole.used) and int(st.overflow) == 0
    for j, keys in enumerate(st.keys):
        assert keys.shape == (whole_t.capacity // n,)
        held = keys[keys != 0]
        assert bool((t.owner(held) == j).all())
    back = t.gather(st, "cpu")
    for a, b, c in zip(whole_t.export(back), t.export(st),
                       whole_t.export(whole)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert (int(back.used), int(back.overflow)) == (int(whole.used), 0)
    big, grown = t.grown(st)
    assert big.capacity == 2 * t.capacity and int(grown.used) == int(st.used)
    assert [int(k.shape[0]) for k in grown.keys] == [2 * t.capacity // n] * n
    for j, keys in enumerate(grown.keys):
        assert bool((big.owner(keys[keys != 0]) == j).all())
    for a, b in zip(big.export(grown), t.export(st)):
        np.testing.assert_array_equal(a, b)


def test_owner_bits_are_disjoint_from_the_shard_probe_bits():
    """The owner is the top log2 D bits of the 32-bit slot hash and a
    shard of C / D slots probes from its low log2(C / D) bits: for C up to
    2^30 they never overlap, so a shard's home slots spread evenly."""
    codes = torch.arange(1, 1 << 16, dtype=torch.int64) * 0x9E3779B97F4A7
    h = slot_hash(codes)
    for n in (2, 4, 256):
        t = SlotShardedHashedTable(HashedTable(25, 1 << 30), [CPU] * n)
        assert torch.equal(t.owner(codes), h >> (32 - (n.bit_length() - 1)))
        shard_bits = (t.capacity // n).bit_length() - 1
        assert shard_bits + n.bit_length() - 1 <= 32
        counts = torch.bincount(t.owner(codes), minlength=n)
        assert counts.numel() == n and int(counts.min()) > 0


@pytest.mark.parametrize("table", ["hashed", "auto"])
def test_mode_b_refuses_a_device_count_not_a_power_of_two(table):
    kw = dict(forward_files=("x.fq",), reverse_files=("y.fq",), ksize=25,
              sharding="global", table=table, depth=200000)
    with pytest.raises(ConfigError, match="hashed needs a power-of-two"):
        MeshNormalizer(Config(**kw), [CPU] * 3)
