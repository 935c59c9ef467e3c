"""The port's k-mer spectrum against the JAX package's ``spectrum()``,
tolerance 0: the state of each of the four tables (bucket, wide bucket,
direct, hashed) after a run of the port, carried into the JAX layout, gives
the same histogram, distinct and total k-mers, coverage peak and genome
estimate in both packages. And ``--spectrum``: the port's CLI prints the
JAX CLI's spectrum blocks line for line (one shard, and ``-p 2``). The
hashed tables start at 2^18 slots: at 2^16 the JAX package's seed pass,
which has no replay, drops inserts that the port recovers."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu import cli as ref_cli
from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.models.spectrum import (
    spectrum as ref_spectrum,
)
from nomalise_kmers_multi_large_tpu.table import (
    BucketTable as RefBucket, DirectTable as RefDirect,
    HashedTable as RefHashed,
)
from nomalise_kmers_multi_large_tpu.table.base import TableState as RefState
from nomalise_kmers_multi_large_tpu.table.bucket import (
    BucketTableWide as RefBucketWide,
)
from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.models.spectrum import spectrum
from nomalise_kmers_multi_large_torch.table import state_to_numpy

DATA = pathlib.Path(__file__).resolve().parent / "data"
HASH_SLOTS = 1 << 18


def _head(src, dst, records):
    lines = pathlib.Path(src).read_text().splitlines(True)
    pathlib.Path(dst).write_text("".join(lines[:2 * records]))
    return str(dst)


def _small_hash_tables(monkeypatch):
    for cls in (Config, RefConfig):
        monkeypatch.setattr(cls, "initial_hash_capacity",
                            property(lambda self: HASH_SLOTS))


def _ref_table(t):
    kind = type(t).__name__
    if kind == "BucketTableWide":
        return RefBucketWide(t.k, rows=t.rows)
    if kind == "BucketTable":
        return RefBucket(t.k, rows=t.rows)
    if kind == "DirectTable":
        return RefDirect(t.k)
    return RefHashed(t.k, t.capacity)


@pytest.mark.parametrize("table,k,kind", [
    ("bucket", 13, "BucketTable"),
    ("bucket", 21, "BucketTableWide"),
    ("direct", 11, "DirectTable"),
    ("hashed", 21, "HashedTable"),
])
def test_spectrum_equals_jax_on_the_carried_state(tmp_path, monkeypatch,
                                                  table, k, kind):
    _small_hash_tables(monkeypatch)
    fwd = _head(DATA / "a1.fasta", tmp_path / "a.fa", 800)
    rev = _head(DATA / "b1.fasta", tmp_path / "b.fa", 800)
    norm = Normalizer(Config(forward_files=(fwd,), reverse_files=(rev,),
                             informat="fa", outformat="fa", ksize=k, depth=4,
                             batch_reads=256, table=table,
                             out_dir=str(tmp_path)), device="cpu")
    norm.run()
    t, st = norm.tables[0], norm.states[0]
    assert type(t).__name__ == kind
    got = spectrum(t, st)
    want = ref_spectrum(_ref_table(t), RefState(*(
        None if x is None else jnp.asarray(x) for x in state_to_numpy(st))))
    np.testing.assert_array_equal(got.histogram, np.asarray(want.histogram))
    assert got[1:] == tuple(want[1:])
    assert got.distinct_kmers > 10000 and got.coverage_peak > 1
    assert got.genome_size_estimate > 0


def _spectrum_lines(text):
    lines = text.splitlines()
    first = next(i for i, ln in enumerate(lines) if "Kmer Spectrum" in ln)
    return lines[first:]


@pytest.mark.parametrize("table,k,shards", [("direct", 13, 1),
                                            ("hashed", 25, 1),
                                            ("hashed", 21, 2)])
def test_spectrum_flag_prints_the_jax_cli_blocks(tmp_path, monkeypatch,
                                                 capsys, table, k, shards):
    _small_hash_tables(monkeypatch)
    args = ["-f", _head(DATA / "a1.fasta", tmp_path / "a.fa", 1000),
            "-r", _head(DATA / "b1.fasta", tmp_path / "b.fa", 1000),
            "-t", "fa", "-o", "fa", "-k", str(k), "-d", "4", "-p",
            str(shards), "--batch-reads", "256", "--table", table,
            "--spectrum"]
    assert cli.main([*args, "--device", "cpu", "--out-dir",
                     str(tmp_path / "port")]) == 0
    port = _spectrum_lines(capsys.readouterr().out)
    assert ref_cli.main([*args, "--devices", "1", "--out-dir",
                         str(tmp_path / "ref")]) == 0
    ref = _spectrum_lines(capsys.readouterr().out)
    assert port == ref
    assert sum("Kmer Spectrum" in ln for ln in port) == shards
    # every shard counted some of the stream
    assert all(int(ln.split(": ")[1].replace(",", "")) > 0
               for ln in port if ln.startswith("Distinct kmers"))
