"""The engine around the direct and hashed tables, on the CPU, against the
JAX package where it has the same behaviour, byte for byte:

- ``--seed-table`` on every table (bucket, wide bucket, direct, hashed),
  seeded from a -P seed dump of the port;
- the hashed table growing mid-stream from 1024 slots, and a batch that
  overflows it, grown and replayed until nothing drops;
- ``--debug 3`` stdout on the direct and hashed tables (per-upsert lines,
  and the batch round-trip, which runs the fused encode kernel only on a
  bucket table).

And the two repairs that have no JAX counterpart: a replay that drops
inserts again still grows (``HashedTable.grown`` keeps ``overflow``; the
JAX table resets it, hashed.py:177), and ``_maybe_grow`` returns on the
direct table, which never grows."""
import contextlib
import io

import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.engine.report import (
    without_clock_lines,
)
from nomalise_kmers_multi_large_torch.table import HashedTable
from test_torch_fallback_pipeline import (
    DATA, head, inputs, run_both, small_hash_tables,
)


@pytest.mark.parametrize("table,k,ref_table", [
    ("bucket", 13, "direct"),
    ("bucket", 21, "hashed"),
    ("direct", 13, "direct"),
    ("hashed", 21, "hashed"),
])
def test_seed_table_from_a_dump_equals_jax(tmp_path, monkeypatch, table, k,
                                           ref_table):
    """The port's -P seed dump of 100 reads of b1 seeds a paired run of
    300 pairs; the JAX package runs the same TSV on its direct (k <= 15)
    or hashed table. The outputs, -P dumps (seed dump included) and totals
    are equal."""
    small_hash_tables(monkeypatch)
    (tmp_path / "dump").mkdir()
    reads = head(DATA / "b1.fasta", tmp_path / "dump" / "b.fa", 100)
    Normalizer(Config(forward_files=(reads,), single=True, informat="fa",
                      outformat="fa", print_table=True, ksize=k, table=table,
                      out_dir=str(tmp_path / "dump")), device="cpu").run()
    tsv = tmp_path / "dump" / f"output_kmer_seeds.k{k}_norm100.tsv"
    assert tsv.stat().st_size > 1000
    port, rep = run_both(tmp_path, table, ref_table, ksize=k, depth=3,
                         batch_reads=128, seed_table=str(tsv),
                         **inputs(tmp_path, 300))
    assert 0 < rep.total_printed < rep.total_processed
    seeds = (tmp_path / "port" / f"output_kmer_seeds.k{k}_norm3.tsv")
    assert seeds.read_bytes() == tsv.read_bytes()


def _hash_slots(monkeypatch, port_slots, ref_slots=1 << 18):
    monkeypatch.setattr(Config, "initial_hash_capacity",
                        property(lambda self: port_slots))
    monkeypatch.setattr(RefConfig, "initial_hash_capacity",
                        property(lambda self: ref_slots))


def test_hashed_table_grows_mid_stream(tmp_path, monkeypatch, capsys):
    """From 1024 slots, with a seed pass of 20 reads a file: the table
    doubles at retires as the stream fills it; the JAX package, on 2^18
    slots that never fill, writes the same bytes."""
    _hash_slots(monkeypatch, 1024)
    port, _ = run_both(tmp_path, "hashed", ksize=21, depth=3, batch_reads=32,
                       seed_records=20, verbose=True, **inputs(tmp_path, 300))
    out = capsys.readouterr()
    assert "expansion triggered" in out.out
    assert port.tables[0].capacity >= 1 << 16
    assert int(port.states[0].overflow) == 0


def test_overflowing_batch_is_grown_and_replayed(tmp_path, monkeypatch,
                                                 capsys):
    """From 1024 slots with a one-read seed pass, the first batch (~17k
    windows) drops inserts: its retire grows the table from the state
    before it and replays it, growing again while the replay drops."""
    _hash_slots(monkeypatch, 1024)
    port, _ = run_both(tmp_path, "hashed", ksize=21, depth=3,
                       batch_reads=64, seed_records=1,
                       **inputs(tmp_path, 300))
    err = capsys.readouterr().err
    assert err.count("table row overflow") >= 1
    assert port.tables[0].capacity >= 1 << 16
    assert int(port.states[0].overflow) == 0


@pytest.mark.parametrize("jax_grown", [False, True])
def test_replay_that_drops_again_still_grows(tmp_path, monkeypatch,
                                             jax_grown):
    """A shard carries 10^6 earlier drops (a replay cannot recover them).
    A batch of 3000 new codes overflows its 1024 slots; grown to 2048 the
    replay drops again, so it grows to 4096, where nothing drops: overflow
    ends at exactly 10^6. With the JAX package's grown(), which resets
    overflow to 0, the replay's new drops (< 10^6) read as none: the loop
    stops at 2048 slots and the drops are lost."""
    if jax_grown:
        orig = HashedTable.grown

        def reset_grown(self, state):
            t, st = orig(self, state)
            return t, st._replace(overflow=torch.zeros_like(st.overflow))

        monkeypatch.setattr(HashedTable, "grown", reset_grown)
    earlier = 10 ** 6
    cfg = Config(forward_files=("x.fa",), single=True, ksize=21, depth=3,
                 table="hashed", out_dir=str(tmp_path))
    norm = Normalizer(cfg, device="cpu")
    table = HashedTable(21, 1024)
    pre = table.init()._replace(overflow=torch.tensor(earlier,
                                                      dtype=torch.int32))
    norm.tables, norm.states = [table], [pre]
    norm._overflow_seen = [earlier]
    rng = np.random.default_rng(4)
    bases = rng.integers(0, 4, size=(30, 120), dtype=np.uint8)
    q = [(None, bases, np.full(30, 120, np.int32), np.ones(30, bool))]
    with contextlib.redirect_stderr(io.StringIO()):
        norm._grow_and_replay(0, table, pre, earlier + 1,
                              lambda: norm._dispatch_queue(0, q, False))
    cap, over = norm.tables[0].capacity, int(norm.states[0].overflow)
    if jax_grown:
        assert cap == 2048 and 0 < over < earlier
    else:
        assert cap == 4096 and over == earlier
        assert int(norm.states[0].used) == 3000


def test_maybe_grow_returns_on_the_direct_table(tmp_path):
    cfg = Config(forward_files=("x.fa",), single=True, ksize=11,
                 table="direct", out_dir=str(tmp_path))
    norm = Normalizer(cfg, device="cpu")
    t = norm.tables[0]
    norm._used_bound[0] = float(t.capacity)
    norm._maybe_grow(0, 10 ** 9)
    assert norm.tables[0] is t and t.grow_headroom is None


@pytest.mark.parametrize("table,k", [("direct", 11), ("hashed", 21)])
def test_debug3_stdout_equals_jax(tmp_path, monkeypatch, table, k):
    """--debug 3 on 150 pairs: per-record and per-upsert lines, and the
    round-trip on every batch, equal to the JAX engine's line for line."""
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    small_hash_tables(monkeypatch)
    kw = dict(informat="fa", outformat="fa", ksize=k, depth=2, debug=3,
              table=table, batch_reads=64, **inputs(tmp_path, 150))
    lines = {}
    for who, cls, make in (("port", Config, lambda c: Normalizer(c, "cpu")),
                           ("ref", RefConfig, RefNormalizer)):
        (tmp_path / who).mkdir()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            make(cls(out_dir=str(tmp_path / who), **kw)).run()
        lines[who] = without_clock_lines(buf.getvalue())
    assert lines["port"] == lines["ref"]
    assert sum(ln.startswith("DEBUG: ") for ln in lines["port"]) > 10000
