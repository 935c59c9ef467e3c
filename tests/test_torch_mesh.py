"""Mode A of the port (parallel/engine.py::MeshNormalizer, --sharding local)
against the JAX package's MeshNormalizer on conftest's virtual CPU devices:
300-record heads of tests/data/{a1,b1}.fasta, D = 2 and 4 shards (the
port's on D logical CPU devices), --table direct at k = 11 and --table
hashed at k = 21, single, paired and canonical, with -P. Every output file
(thread-s reads and k-mer dumps, the seed dump) and the totals are equal,
tolerance 0. Then the port alone: Mode A on the bucket table equals Mode A
on the hashed table (k = 15 and 25) and the direct one (k = 11), and a
shard whose bucket rows fill grows and replays its dispatch alone, where
the JAX mesh engines skip grow-and-replay and lose the inserts
(parallel/engine.py:150 and engine/pipeline.py:673-678 of the JAX
package)."""
import contextlib
import io

import pytest
import torch

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.parallel.engine import (
    MeshNormalizer as RefMesh,
)
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from nomalise_kmers_multi_large_torch.table import BucketTable
from test_torch_checkpoint import _inputs, _kw, _outputs, _totals
from test_torch_fallback_checkpoint import _hash_slots
from one_thread import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RECORDS = 300


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _config(kind: str, n: int, **kw) -> dict:
    """kind: single, paired or canonical (paired); depth 2 per shard."""
    return dict(depth=2 * n, print_table=True, batch_reads=64,
                canonical=kind == "canonical", **kw)


@pytest.mark.parametrize("table,k,n,kind", [
    ("direct", 11, 2, "paired"), ("direct", 11, 4, "single"),
    ("direct", 11, 4, "canonical"), ("hashed", 21, 4, "paired"),
    ("hashed", 21, 2, "single"), ("hashed", 21, 2, "canonical"),
])
def test_mode_a_equals_jax_mesh_normalizer(tmp_path, monkeypatch, table, k,
                                            n, kind):
    _hash_slots(monkeypatch, 1 << 18, 1 << 18)
    inputs = _inputs(tmp_path, RECORDS, kind != "single")
    cfg = _config(kind, n, ksize=k, table=table)
    ref_kw = _kw(tmp_path, "ref", inputs, **cfg)
    port_kw = _kw(tmp_path, "port", inputs, **cfg)
    want = _quiet(lambda: RefMesh(RefConfig(**ref_kw), n_devices=n).run())
    got = _quiet(lambda: MeshNormalizer(Config(**port_kw), [CPU] * n).run())
    assert _totals(got) == _totals(want)
    ref_out, port_out = _outputs(ref_kw), _outputs(port_kw)
    assert port_out == ref_out
    # per shard: the reads (one file, two when paired) and the dump; and
    # the seed dump, all named after depth // n = 2
    assert len(port_out) == n * (2 + (kind != "single")) + 1
    assert all("_norm2" in name for name in port_out)
    assert 0 < want.total_printed < want.total_processed == RECORDS


# (the direct table at k = 15 would be 4 GiB a shard on the CPU)
@pytest.mark.parametrize("k,other", [(15, "hashed"), (25, "hashed"),
                                     (11, "direct")])
def test_mode_a_bucket_equals_mode_a_on_the_fallback_tables(
        tmp_path, monkeypatch, k, other):
    _hash_slots(monkeypatch, 1 << 18, 1 << 18)
    inputs = _inputs(tmp_path, RECORDS, True)
    kws = {t: _kw(tmp_path, t, inputs, **_config("paired", 4, ksize=k,
                                                   table=t))
           for t in ("bucket", other)}
    reps = {t: _quiet(lambda kw=kw: MeshNormalizer(Config(**kw),
                                                   [CPU] * 4).run())
            for t, kw in kws.items()}
    assert _totals(reps["bucket"]) == _totals(reps[other])
    assert _outputs(kws["bucket"]) == _outputs(kws[other])
    assert 0 < reps["bucket"].total_printed < RECORDS


def test_mode_a_shard_grows_and_replays_alone(tmp_path, capsys):
    """Each shard starts on a 128-row bucket table at k = 9 and seeds one
    record, so the first dispatch of every shard fills bucket rows: each
    drops inserts, grows and replays its own group. The outputs equal Mode
    A on the direct table, which never drops, and no drop remains."""
    inputs = _inputs(tmp_path, RECORDS, True)
    cfg = _config("paired", 2, ksize=9, seed_records=1)
    kw = _kw(tmp_path, "bucket", inputs, table="bucket", **cfg)
    norm = MeshNormalizer(Config(**kw), [CPU] * 2)
    norm.tables = [BucketTable(9, rows=128)] * 2
    norm.states = [t.init() for t in norm.tables]
    rep = norm.run()
    err = capsys.readouterr().err
    assert "Thread 0: table row overflow" in err
    assert "Thread 1: table row overflow" in err
    assert all(t.rows > 128 for t in norm.tables)
    assert all(int(st.overflow) == 0 for st in norm.states)
    direct_kw = _kw(tmp_path, "direct", inputs, table="direct", **cfg)
    want = MeshNormalizer(Config(**direct_kw), [CPU] * 2).run()
    assert _totals(rep) == _totals(want)
    assert _outputs(kw) == _outputs(direct_kw)


def _spectra(text: str) -> list[str]:
    lines = text.splitlines()
    first = next(i for i, ln in enumerate(lines)
                 if ln.startswith("\n--- Kmer Spectrum") or
                 ln.startswith("--- Kmer Spectrum"))
    return lines[first:]


def test_spectrum_blocks_per_shard(tmp_path, capsys):
    """--spectrum prints one block per Mode A shard, and one block for
    Mode B's single table, equal to the one-device run's. The JAX CLI on
    its mesh prints shard 0's block alone, headed as if it were the whole
    stream's (its block count follows --cpu, not the devices): the port's
    shard 0 block has its numbers."""
    from nomalise_kmers_multi_large_tpu import cli as ref_cli
    from nomalise_kmers_multi_large_torch import cli

    inputs = _inputs(tmp_path, RECORDS, True)
    args = ["-f", *inputs["forward_files"], "-r", *inputs["reverse_files"],
            "-t", "fa", "-o", "fa", "-k", "11", "-d", "4", "--spectrum",
            "--table", "direct"]
    got = {}
    for name, main, extra in (
            ("jax", ref_cli.main, ["--devices", "2"]),
            ("mode_a", cli.main, ["--devices", "2", "--device", "cpu"]),
            ("one", cli.main, ["--devices", "1", "--device", "cpu",
                               "--table", "bucket"]),
            ("mode_b", cli.main, ["--devices", "2", "--device", "cpu",
                                  "--table", "bucket", "--sharding",
                                  "global", "-m", "1"])):
        assert main(args + extra + ["--out-dir", str(tmp_path / name)]) == 0
        got[name] = _spectra(capsys.readouterr().out)
    assert len(got["jax"]) == 6 and len(got["mode_a"]) == 13
    assert got["mode_a"][0].startswith("--- Kmer Spectrum (shard 0 of 2;")
    assert got["mode_a"][7].startswith("--- Kmer Spectrum (shard 1 of 2;")
    assert got["mode_a"][1:6] == got["jax"][1:]
    assert got["mode_a"][8:] != got["jax"][1:]
    assert got["mode_b"] == got["one"] and len(got["one"]) == 6
