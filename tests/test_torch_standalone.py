"""The port stands alone: in a fresh interpreter its CLI reproduces the
goldens on the CPU, and afterwards neither ``jax`` nor any module of the JAX
package has been imported. Its own copies of the CLI parser and of
``Config`` behave as the JAX package's."""
import os
import pathlib
import subprocess
import sys

import pytest

from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import Config, ConfigError
from nomalise_kmers_multi_large_tpu import cli as ref_cli
from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.config import ConfigError as RefError

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"

_RUN = """
import sys
from nomalise_kmers_multi_large_torch import cli
rc = cli.main(sys.argv[1:])
foreign = sorted(m for m in sys.modules if m == "jax"
                 or m.startswith(("jax.", "nomalise_kmers_multi_large_tpu")))
print("FOREIGN_MODULES", foreign)
sys.exit(rc)
"""


@pytest.mark.parametrize("k,golden", [
    (15, "fasta_in_paired_k15"),
    (25, "fasta_in_paired_k25_jax"),
])
def test_port_cli_runs_golden_without_jax_package(tmp_path, k, golden):
    args = ["-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"),
            "-t", "fa", "-o", "fa", "-k", str(k), "-d", "4",
            "--device", "cpu", "--out-dir", str(tmp_path)]
    proc = subprocess.run([sys.executable, "-c", _RUN, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout[-2000:]
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm4_thread0.fastq"
        assert (tmp_path / name).read_bytes() == \
            (GOLDEN / golden / name).read_bytes(), name


def test_port_cli_relaxed_checkpoints_debug3_without_jax_package(tmp_path):
    """The modules of relaxed mode, checkpoints and the debug tiers (the
    codec, the shadow, the checkpoint manager) import nothing of JAX
    either: a run with all three, on the first 300 pairs."""
    inputs = []
    for name in ("a1", "b1"):
        lines = (DATA / f"{name}.fasta").read_text().splitlines(True)
        (tmp_path / f"{name}.fa").write_text("".join(lines[:600]))
        inputs.append(str(tmp_path / f"{name}.fa"))
    args = ["-f", inputs[0], "-r", inputs[1], "-t", "fa", "-o", "fa",
            "-k", "15", "-d", "4", "--mode", "relaxed", "--checkpoint-every",
            "1", "--checkpoint-dir", str(tmp_path / "ckpt"), "--debug", "3",
            "--batch-reads", "100", "--device", "cpu",
            "--out-dir", str(tmp_path / "out")]
    proc = subprocess.run([sys.executable, "-c", _RUN, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout[-2000:]
    assert "DEBUG: New Kmer hash: " in proc.stdout
    assert "Thread 0 - Sequence pair 300 " in proc.stdout
    assert (tmp_path / "ckpt" / "manifest.json").exists()
    assert (tmp_path / "ckpt" / "shadow0.npz").exists()


@pytest.mark.parametrize("mode", ["local", "global"])
def test_port_cli_multi_device_and_profile_without_jax_package(tmp_path,
                                                               mode):
    """The modules of Modes A and B, the multi-host hooks and --profile
    import nothing of JAX either: the k = 15 golden on 2 logical CPU
    devices, profiled."""
    args = ["-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"),
            "-t", "fa", "-o", "fa", "-k", "15", "-d", "4", "--devices", "2",
            "--sharding", mode, "--profile", str(tmp_path / "trace"),
            "--device", "cpu", "--out-dir", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _RUN, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout[-2000:]
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
    if mode == "global":
        for base in ("output_forward", "output_reverse"):
            name = f"{base}.k15_norm4_thread0.fastq"
            assert (tmp_path / name).read_bytes() == \
                (GOLDEN / "fasta_in_paired_k15" / name).read_bytes()
    else:
        assert len(list(tmp_path.glob("output_*_thread1.fastq"))) == 2


def _flags(parser):
    return {(a.dest, tuple(a.option_strings), repr(a.default), a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


def test_port_parser_keeps_every_reference_flag():
    ref, port = _flags(ref_cli.build_parser()), _flags(cli.build_parser())
    assert ref <= port
    assert port - ref == {("device", ("--device",), "'cuda'", None, None)}


@pytest.mark.parametrize("changes", [
    dict(), dict(single=False), dict(ksize=4), dict(ksize=32),
    dict(depth=1), dict(depth=3, shards=2), dict(shards=0),
    dict(shards=257), dict(coverage=1.5), dict(coverage=0.0001),
    dict(informat="sam"), dict(informat="fa", outformat="fq"),
    dict(memory_gb=-1), dict(batch_reads=0), dict(batch_reads=16385),
    dict(stride=16), dict(dispatch_group=0), dict(prefetch=-1),
    dict(depth=70000), dict(mode="fast"), dict(table="direct", ksize=21),
    dict(sharding="global", stride=2),
])
def test_config_validates_like_reference_config(changes):
    kw = dict(forward_files=("a.fq",), single=True, table="bucket")
    kw.update(changes)
    try:
        RefConfig(**kw).validate()
        ref_error = None
    except RefError as e:
        ref_error = str(e)
    try:
        Config(**kw).validate()
        port_error = None
    except ConfigError as e:
        port_error = str(e)
    assert port_error == ref_error
    assert (ref_error is None) == (changes == {})
