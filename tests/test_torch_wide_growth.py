"""The port's wide path growing from 512 rows, end to end, against the
reference package's hashed table, whose output does not depend on rows:
paired at k = 25 (seed pass, growth, grow-and-replay), and single-end with
stride 2 at k = 21. Output files, -P dumps and totals, byte for byte."""
import pathlib

import nomalise_kmers_multi_large_torch.table as port_table
from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _head(src, dst, records):
    """The first `records` FASTA records (two lines each) of src."""
    with open(src) as f:
        lines = f.readlines()[:2 * records]
    dst.write_text("".join(lines))
    return str(dst)


def _run_both(tmp_path, monkeypatch, **kw):
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    def cfg(sub, table, cls=Config):
        (tmp_path / sub).mkdir()
        return cls(informat="fa", outformat="fa", depth=4,
                      print_table=True, out_dir=str(tmp_path / sub),
                      table=table, **kw)

    # the port's wide table starts at 512 rows instead of 2^14
    monkeypatch.setattr(port_table, "default_rows_wide",
                        lambda k, memory_bytes=None: 512)
    port = Normalizer(cfg("port", "auto"), device="cpu")
    assert port.tables[0].wide and port.tables[0].rows == 512
    prep = port.run()
    rrep = RefNormalizer(cfg("ref", "hashed", RefConfig)).run()
    assert (prep.total_processed, prep.total_printed, prep.total_skipped,
            prep.max_total_kmers) == (
        rrep.total_processed, rrep.total_printed, rrep.total_skipped,
        rrep.max_total_kmers)
    assert 0 < prep.total_printed < prep.total_processed
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert sum("kmer" in n for n in names) == 2   # -P seed and table dumps
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    return port


def test_paired_k25_grows_and_replays_like_hashed_reference(
        tmp_path, monkeypatch, capsys):
    fa = _head(DATA / "a1.fasta", tmp_path / "a.fa", 600)
    fb = _head(DATA / "b1.fasta", tmp_path / "b.fa", 600)
    port = _run_both(tmp_path, monkeypatch, forward_files=(fa,),
                     reverse_files=(fb,), ksize=25, batch_reads=128,
                     verbose=True)
    err = capsys.readouterr()
    assert port.tables[0].rows > 512
    assert "expansion triggered" in err.out
    assert "table row overflow" in err.err
    assert int(port.states[0].overflow) == 0


def test_single_stride2_grows_like_hashed_reference(tmp_path, monkeypatch):
    fa = _head(DATA / "a1.fasta", tmp_path / "a.fa", 1500)
    port = _run_both(tmp_path, monkeypatch, forward_files=(fa,), single=True,
                     ksize=21, stride=2, batch_reads=256)
    assert port.tables[0].rows > 512
