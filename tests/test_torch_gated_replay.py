"""The engine's gated grow-and-replay on a one-device bucket table, on the
CPU: a batch that would drop inserts is held back with every batch behind
it, the untouched table grows and the batches are replayed, in the seed
pass and mid-stream, at --dispatch-group 1 and 3 (where the batches of a
group before the held one stand), at k = 9 (narrow) and k = 25 (wide).
Each run's output bytes, RunReport totals and final planes, lane for lane,
equal those of a run whose table starts at the final row count, no insert
is dropped, and no copy of the table is ever taken (engine.pipeline._copy
raises on a one-device bucket state). Mode A's shards are such tables too;
Mode B's row-sharded table and the hashed table still take their replay
snapshots."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import nomalise_kmers_multi_large_torch.engine.pipeline as pipeline
import nomalise_kmers_multi_large_torch.table as port_table
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from nomalise_kmers_multi_large_torch.parallel.modes import (
    RowShardedBucketTable,
)
from nomalise_kmers_multi_large_torch.table import (
    BucketTable, BucketTableWide,
)
from one_thread import one_torch_thread  # noqa: F401

LENGTH = 100
#: reads a batch: at k = 9 a random batch (11,500 codes) outgrows the 128
#: rows (8,192 slots) of the default table; at k = 25 one of 512 reads
#: (38,900 codes) the 512-row (32,768 slots) table these tests start from
BATCH = {9: 125, 25: 512}
N_BATCHES = 6


def _write_reads(path, k: int, seed: int):
    """N_BATCHES batches of LENGTH bp random reads, the first batch drawn
    from two sequences only (184 or 152 codes): it fits any table."""
    rng = np.random.default_rng(seed)
    n = BATCH[k] * N_BATCHES
    seqs = rng.integers(0, 4, size=(n, LENGTH))
    seqs[:BATCH[k]] = seqs[rng.integers(0, 2, size=BATCH[k])]
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{''.join('ACGT'[b] for b in s)}\n")
    return str(path)


def _snapshot_guard(monkeypatch):
    """engine.pipeline._copy, raising on a one-device bucket state (a
    replay snapshot; the seeded table's copies to other shards pass a
    device). Returns the list of the kinds of state it copied."""
    copied = []
    orig = pipeline._copy

    def guarded(state, device=None):
        bucket = torch.is_tensor(state.keys) and state.keys.dim() == 2
        if bucket and device is None:
            raise AssertionError("a one-device bucket state was copied")
        copied.append("tuple" if isinstance(state.keys, tuple)
                      else "hashed" if not bucket else "replicate")
        return orig(state, device)

    monkeypatch.setattr(pipeline, "_copy", guarded)
    return copied


def _replays(monkeypatch):
    """Spy on the gated replays: [(in the seed pass, batches replayed)]."""
    calls = []
    orig = Normalizer._regrow_and_replay

    def spy(self, shard, table, n, dispatch):
        calls.append((self._in_seed, n))
        return orig(self, shard, table, n, dispatch)

    monkeypatch.setattr(Normalizer, "_regrow_and_replay", spy)
    return calls


def _config(tmp_path, sub, fa, k, group, seed_records):
    out = tmp_path / sub
    out.mkdir()
    return Config(forward_files=(fa,), single=True, informat="fa",
                  outformat="fa", ksize=k, depth=2, batch_reads=BATCH[k],
                  seed_records=seed_records, dispatch_group=group,
                  out_dir=str(out))


def _run(norm):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rep = norm.run()
    out = norm.cfg.out_dir
    name = f"output_forward.k{norm.cfg.ksize}_norm2_thread0.fastq"
    with open(f"{out}/{name}", "rb") as f:
        data = f.read()
    return rep, data, err.getvalue()


def _totals(rep):
    return (rep.total_processed, rep.total_printed, rep.total_skipped,
            rep.max_total_kmers)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("phase", ["seed", "stream"])
@pytest.mark.parametrize("k", [9, 25])
def test_held_batch_grows_and_replays_like_a_presized_table(
        tmp_path, monkeypatch, k, phase, group):
    monkeypatch.setattr(port_table, "default_rows_wide",
                        lambda k, memory_bytes=None: 512)
    fa = _write_reads(tmp_path / "r.fa", k, seed=k + group)
    # "seed": the first two batches seed (the second is held back);
    # "stream": one record seeds, and the stream's second batch is held
    seed_records = 2 * BATCH[k] if phase == "seed" else 1
    replays = _replays(monkeypatch)
    copied = _snapshot_guard(monkeypatch)
    grown = Normalizer(_config(tmp_path, "grown", fa, k, group,
                               seed_records), device="cpu")
    rows0 = grown.tables[0].rows
    rep, out, err = _run(grown)
    t, st = grown.tables[0], grown.states[0]
    assert "table row overflow" in err
    assert any(seed == (phase == "seed") for seed, _ in replays), replays
    if phase == "stream" and group == 3:
        # batch 0 of the group stands, batches 1 and 2 are replayed
        assert (False, 2) in replays, replays
    assert t.rows > rows0 and int(st.overflow) == 0 and not copied

    cls = BucketTableWide if k > 15 else BucketTable
    fixed = Normalizer(_config(tmp_path, "fixed", fa, k, group,
                               seed_records), device="cpu")
    fixed.tables = [cls(k, rows=t.rows)]
    fixed.states = [fixed.tables[0].init()]
    frep, fout, ferr = _run(fixed)
    assert "table row overflow" not in ferr
    assert fixed.tables[0].rows == t.rows
    assert out == fout and _totals(rep) == _totals(frep)
    fst = fixed.states[0]
    for name in ("keys", "keys2", "counts", "used", "overflow"):
        a, b = getattr(st, name), getattr(fst, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_mode_a_shards_replay_without_snapshots(tmp_path, monkeypatch):
    """Mode A on two CPU devices: each shard's first stream batch outgrows
    its 128 rows; each is held back, grows and replays alone."""
    fa = _write_reads(tmp_path / "r.fa", 9, seed=3)
    replays = _replays(monkeypatch)
    copied = _snapshot_guard(monkeypatch)
    cfg = _config(tmp_path, "mode_a", fa, 9, 1, 1)
    # depth 4: depth 2 in each of the two shards, as the files are named
    cfg = dataclasses.replace(cfg, batch_reads=250, depth=4)
    norm = MeshNormalizer(cfg, [torch.device("cpu")] * 2)
    _, _, err = _run(norm)
    assert "Thread 0: table row overflow" in err
    assert "Thread 1: table row overflow" in err
    assert all(int(st.overflow) == 0 for st in norm.states)
    assert replays and copied == ["replicate"]


@pytest.mark.parametrize("kind", ["mode_b", "hashed"])
def test_mode_b_and_hashed_tables_keep_their_snapshots(tmp_path, monkeypatch,
                                                       kind):
    """Mode B's row-sharded bucket table and the hashed table are not
    gated: they copy the state before each dispatch while they can grow,
    and replay from that copy."""
    fa = _write_reads(tmp_path / "r.fa", 9, seed=5)
    copied = _snapshot_guard(monkeypatch)
    cfg = _config(tmp_path, kind, fa, 9, 1, 1)
    if kind == "hashed":
        monkeypatch.setattr(Config, "initial_hash_capacity",
                            property(lambda self: 1024))
        norm = Normalizer(dataclasses.replace(cfg, table="hashed"),
                          device="cpu")
    else:
        devices = [torch.device("cpu")] * 2
        norm = MeshNormalizer(dataclasses.replace(
            cfg, n_devices=2, sharding="global", memory_gb=1), devices)
        # two row shards of 128 rows: the smallest Mode B table at k = 9
        t = RowShardedBucketTable(BucketTable(9, rows=256), devices)
        norm.tables, norm.states = [t], [t.init()]
    _, _, err = _run(norm)
    assert "table row overflow" in err
    assert int(norm.states[0].overflow) == 0
    assert copied.count("tuple" if kind == "mode_b" else "hashed") \
        >= N_BATCHES
