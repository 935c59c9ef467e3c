"""The port's direct and hashed tables end to end on the CPU, against the
JAX package's Normalizer with the same table: output files, -P dumps
(seeds and tables) and totals, byte for byte, for single-end, paired,
canonical, stride 2, relaxed mode, -p 2, --dispatch-group 2 and ``auto`` at
a depth per shard above 65535. Both hashed tables start at 2^16 slots
(the default, 2^26, is slow to allocate here). Also the CLI goldens with
``--table direct -k 15`` (the reference binary's) and ``--table hashed -k
25`` (the JAX package's)."""
import pathlib

import pytest

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from test_torch_pipeline import _totals

DATA = pathlib.Path(__file__).resolve().parent / "data"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
HASH_SLOTS = 1 << 16


def head(src, dst, records):
    """The first `records` FASTA records (two lines each) of src."""
    lines = pathlib.Path(src).read_text().splitlines(True)
    pathlib.Path(dst).write_text("".join(lines[:2 * records]))
    return str(dst)


def inputs(tmp_path, records=300, paired=True):
    fwd = (head(DATA / "a1.fasta", tmp_path / "a.fa", records),)
    if not paired:
        return dict(forward_files=fwd, single=True)
    return dict(forward_files=fwd, reverse_files=(
        head(DATA / "b1.fasta", tmp_path / "b.fa", records),))


def small_hash_tables(monkeypatch, slots=HASH_SLOTS):
    """Both packages' hashed tables start at `slots` slots."""
    for cls in (Config, RefConfig):
        monkeypatch.setattr(cls, "initial_hash_capacity",
                            property(lambda self: slots))


def report_totals(rep):
    return (rep.total_processed, rep.total_printed, rep.total_skipped,
            rep.max_total_kmers)


def run_both(tmp_path, table, ref_table=None, **kw):
    """The port and the JAX Normalizer on one config (`table` for the port,
    `ref_table` or the same for the JAX package); every file they write
    must be equal. Returns the port's Normalizer and report."""
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    def cfg(sub, tbl, cls):
        (tmp_path / sub).mkdir()
        return cls(informat="fa", outformat="fa", print_table=True,
                   out_dir=str(tmp_path / sub), table=tbl, **kw)

    port = Normalizer(cfg("port", table, Config), device="cpu")
    prep = port.run()
    rrep = RefNormalizer(cfg("ref", ref_table or table, RefConfig)).run()
    assert report_totals(prep) == report_totals(rrep)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert sum("kmer" in n for n in names) == 1 + kw.get("shards", 1)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    return port, prep


CASES = {
    "single": dict(single=True),
    "paired": dict(),
    "canonical": dict(canonical=True),
    "stride2": dict(stride=2, depth=2),
    "relaxed": dict(mode="relaxed"),
    "shards2": dict(shards=2),
    "group2": dict(dispatch_group=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("table,k", [("direct", 11), ("hashed", 21)])
def test_fallback_table_matches_jax_normalizer(tmp_path, monkeypatch, case,
                                               table, k):
    small_hash_tables(monkeypatch)
    kw = dict(depth=4, batch_reads=64, ksize=k)
    kw.update(CASES[case])
    single = kw.pop("single", False)
    port, rep = run_both(tmp_path, table,
                         **inputs(tmp_path, paired=not single), **kw)
    assert type(port.tables[0]).__name__.lower().startswith(table)
    assert 0 < rep.total_printed < rep.total_processed
    assert all(int(st.overflow) == 0 for st in port.states)


@pytest.mark.parametrize("k,kind", [(13, "direct"), (21, "hashed")])
def test_auto_above_65535_takes_the_fallback_table(tmp_path, monkeypatch,
                                                   k, kind):
    small_hash_tables(monkeypatch)
    port, rep = run_both(tmp_path, "auto", ksize=k, depth=70000,
                         batch_reads=128, **inputs(tmp_path, 200))
    assert port.cfg.table == kind
    assert rep.total_printed == rep.total_processed == 200


@pytest.mark.parametrize("table,k,golden", [
    ("direct", 15, "fasta_in_paired_k15"),
    ("hashed", 25, "fasta_in_paired_k25_jax"),
])
def test_cli_reproduces_golden_with_fallback_table(tmp_path, capsys, table,
                                                   k, golden):
    assert cli.main([
        "-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"),
        "-t", "fa", "-o", "fa", "-k", str(k), "-d", "4", "--table", table,
        "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert _totals(out) == _totals(
        (GOLDEN / golden / "stdout_stable.txt").read_text())
    slots, per_slot = (4 ** 15, 4) if table == "direct" else (1 << 27, 12)
    assert out.splitlines()[0].startswith(
        f"{table} count table: {slots:,} slots per shard")
    assert f"; {slots * per_slot:,} bytes of cpu memory" in out
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm4_thread0.fastq"
        assert (tmp_path / name).read_bytes() == \
            (GOLDEN / golden / name).read_bytes()
