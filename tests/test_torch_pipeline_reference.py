"""The port's Normalizer against the reference Normalizer on a k = 9 run that
grows from 128 rows: output files, -P dumps, totals and exported tables,
byte for byte."""
import numpy as np

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from test_engine import _make_reads
from test_torch_pipeline import _write_fasta


def test_normalizer_matches_reference_while_growing(tmp_path):
    """k=9 from 128 rows: the table grows during the seed pass (which seeds
    every record, so the stream itself drops nothing even on the reference,
    whose replay misreads a table grown between dispatch and retire);
    outputs, -P dumps, totals and exported tables must agree."""
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    reads = _make_reads(1024)
    fa, fb = tmp_path / "a.fa", tmp_path / "b.fa"
    _write_fasta(fa, reads[0::2])
    _write_fasta(fb, reads[1::2])

    def cfg(sub, table, cls=Config):
        (tmp_path / sub).mkdir()
        return cls(forward_files=(str(fa),), reverse_files=(str(fb),),
                      informat="fa", outformat="fa", ksize=9, depth=4,
                      batch_reads=128, print_table=True,
                      out_dir=str(tmp_path / sub), table=table)

    port = Normalizer(cfg("port", "auto"), device="cpu")
    ref = RefNormalizer(cfg("ref", "bucket", RefConfig))
    assert port.tables[0].rows == ref.tables[0].rows == 128
    prep, rrep = port.run(), ref.run()
    assert port.tables[0].rows == ref.tables[0].rows > 128
    assert (prep.total_processed, prep.total_printed, prep.total_skipped,
            prep.max_total_kmers) == (
        rrep.total_processed, rrep.total_printed, rrep.total_skipped,
        rrep.max_total_kmers)
    assert 0 < prep.total_printed < prep.total_processed
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert len(names) == 4  # two read outputs, seed dump, table dump
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    for a, b in zip(port.tables[0].export(port.states[0]),
                    ref.tables[0].export(ref.states[0])):
        np.testing.assert_array_equal(a, b)
