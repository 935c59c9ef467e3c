"""The port's Normalizer against the reference Normalizer on the wide path
at golden size: k = 25 on tests/data/{a1,b1}.fasta, paired, with -P, the
reference on its wide bucket table (Pallas kernels in interpret mode).
Output files, -P dumps, totals and exported tables, byte for byte."""
import pathlib

import numpy as np

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer

DATA = pathlib.Path(__file__).resolve().parent / "data"


def test_normalizer_matches_reference_k25_a1b1(tmp_path):
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    def cfg(sub, table, cls=Config):
        (tmp_path / sub).mkdir()
        return cls(forward_files=(str(DATA / "a1.fasta"),),
                      reverse_files=(str(DATA / "b1.fasta"),),
                      informat="fa", outformat="fa", ksize=25, depth=4,
                      print_table=True, out_dir=str(tmp_path / sub),
                      table=table)

    port = Normalizer(cfg("port", "auto"), device="cpu")
    ref = RefNormalizer(cfg("ref", "bucket", RefConfig))
    assert port.tables[0].wide and ref.tables[0].wide
    prep, rrep = port.run(), ref.run()
    totals = (prep.total_processed, prep.total_printed, prep.total_skipped,
              prep.max_total_kmers)
    assert totals == (rrep.total_processed, rrep.total_printed,
                      rrep.total_skipped, rrep.max_total_kmers)
    assert totals == (5000, 3981, 1019, 438093)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    # two read outputs, the seed dump and the table dump (-P)
    assert len(names) == 4 and sum("kmer" in n for n in names) == 2
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    for a, b in zip(port.tables[0].export(port.states[0]),
                    ref.tables[0].export(ref.states[0])):
        np.testing.assert_array_equal(a, b)
