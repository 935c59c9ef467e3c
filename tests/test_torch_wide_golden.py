"""The k = 25 golden and the port's CLI on the wide path.

tests/golden/fasta_in_paired_k25_jax holds the reference package's output
for ``-f a1.fasta -r b1.fasta -t fa -o fa -k 25 -d 4 --table hashed`` (no
reference-binary golden exists past k = 15: its table takes its collision
path there). One test regenerates it with the reference package and pins it
byte for byte; the port's CLI must reproduce it, with the totals of its
stdout_stable.txt. Also the startup line's bytes per slot, and the config
rule for k = 16..31."""
import pathlib

import pytest

from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import (
    Config, ConfigError, port_config,
)
from test_torch_pipeline import _totals, _write_fasta

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden" / "fasta_in_paired_k25_jax"
ARGS = ["-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"),
        "-t", "fa", "-o", "fa", "-k", "25", "-d", "4"]
OUTPUTS = ("output_forward.k25_norm4_thread0.fastq",
           "output_reverse.k25_norm4_thread0.fastq")


def test_golden_k25_regenerates_with_reference_package(tmp_path, capsys):
    from nomalise_kmers_multi_large_tpu import cli as ref_cli

    # one device: the test session's JAX may expose several CPU devices
    assert ref_cli.main([*ARGS, "--table", "hashed", "--devices", "1",
                         "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert _totals(out) == _totals((GOLDEN / "stdout_stable.txt").read_text())
    for name in OUTPUTS:
        assert (tmp_path / name).read_bytes() == (GOLDEN / name).read_bytes()


def test_cli_reproduces_golden_k25(tmp_path, capsys):
    assert cli.main([*ARGS, "--device", "cpu", "--out-dir",
                     str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert _totals(out) == (5000, 3981, 1019, 438093)
    assert _totals(out) == _totals(
        (GOLDEN / "stdout_stable.txt").read_text())
    for name in OUTPUTS:
        assert (tmp_path / name).read_bytes() == (GOLDEN / name).read_bytes()


@pytest.mark.parametrize("k,slot_bytes", [(15, 8), (16, 8), (25, 12)])
def test_startup_line_bytes_per_slot(tmp_path, capsys, k, slot_bytes):
    """Fingerprint and count planes of int32, plus the wide table's second
    fingerprint plane at k > 16."""
    fa = tmp_path / "a.fa"
    _write_fasta(fa, ["ACGT" * 10, "TTGCA" * 8])
    assert cli.main(["-f", str(fa), "-s", "-t", "fa", "-o", "fa", "-k",
                     str(k), "-d", "2", "--device", "cpu", "--out-dir",
                     str(tmp_path)]) == 0
    slots = 16384 * 64
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith(f"bucket count table: {slots:,} slots per shard")
    assert f"; {slots * slot_bytes:,} bytes of cpu memory" in line


@pytest.mark.parametrize("k", [16, 17, 24, 25, 31])
def test_table_rule_takes_wide_k(k):
    for table in ("auto", "bucket"):
        cfg = port_config(Config(forward_files=("a.fa",), single=True,
                                 ksize=k, table=table))
        assert cfg.table == "bucket"


@pytest.mark.parametrize("changes", [
    dict(ksize=32),
])
def test_table_rule_rejects_what_the_wide_path_lacks(changes):
    with pytest.raises(ConfigError):
        port_config(Config(forward_files=("a.fa",), single=True, **changes))


@pytest.mark.parametrize("changes", [
    dict(ksize=25, table="hashed"),
    dict(ksize=25, depth=70000),
    dict(ksize=25, sharding="global", table="hashed"),
])
def test_table_rule_takes_hashed_at_wide_k(changes):
    """--table hashed, and auto at a depth per shard above 65535, resolve
    to the hashed table at k = 16..31, in Mode B (--sharding global) too."""
    cfg = port_config(Config(forward_files=("a.fa",), single=True, **changes))
    assert cfg.table == "hashed"
