"""The port's Normalizer with logical shards (-p 2) and grouped dispatch
(--dispatch-group 2) against the reference Normalizer: per-shard output
files, -P dumps and totals byte for byte."""
from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.engine.pipeline import (
    Normalizer as RefNormalizer,
)
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from test_engine import _make_reads
from test_torch_pipeline import _write_fasta


def test_shards_and_dispatch_groups_match_reference(tmp_path):
    reads = _make_reads(768)
    fa, fb = tmp_path / "a.fa", tmp_path / "b.fa"
    _write_fasta(fa, reads[0::2])
    _write_fasta(fb, reads[1::2])

    def cfg(sub, table, cls=Config):
        (tmp_path / sub).mkdir()
        return cls(forward_files=(str(fa),), reverse_files=(str(fb),),
                      informat="fa", outformat="fa", ksize=9, depth=6,
                      shards=2, dispatch_group=2, batch_reads=48,
                      print_table=True, out_dir=str(tmp_path / sub),
                      table=table)

    prep = Normalizer(cfg("port", "auto"), device="cpu").run()
    rrep = RefNormalizer(cfg("ref", "bucket", RefConfig)).run()
    assert (prep.total_processed, prep.total_printed, prep.total_skipped,
            prep.max_total_kmers) == (
        rrep.total_processed, rrep.total_printed, rrep.total_skipped,
        rrep.max_total_kmers)
    assert 0 < prep.total_printed < prep.total_processed
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert len(names) == 7  # 2 shards x 2 mates, seed dump, 2 table dumps
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
