"""Mode B of the port on the bucket table (--sharding global; one exact
table row-range-sharded over D logical CPU devices, parallel/modes.py)
against the goldens and the port's one-device run, tolerance 0: the
reference golden fasta_in_paired_k15 and the JAX package's
fasta_in_paired_k25_jax at D = 2 and 4 (the -P dump equal to a one-device
run's); growth mid-stream from a small table; relaxed counts; full skew,
where every window of the stream belongs to one row shard (the JAX
package's fixed all_to_all bins drop windows there, parallel/modes.py:175
and :190; the port's exchange sizes each segment exactly and drops none).
Then the ConfigErrors, and checkpoints in the JAX layout (one whole-table
state) that cross between Mode B and the one-device engine both ways."""
import contextlib
import functools
import io
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.engine.checkpoint import (
    CheckpointManager as RefManager,
)
from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import Config, ConfigError
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from nomalise_kmers_multi_large_torch.parallel.modes import (
    RowShardedBucketTable,
)
from nomalise_kmers_multi_large_torch.table import BucketTable
from test_torch_checkpoint import (
    _inputs, _interrupt, _kw, _outputs, _totals,
)
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA, GOLDEN = ROOT / "tests" / "data", ROOT / "tests" / "golden"
CPU = torch.device("cpu")


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _cli(out, k, extra=()):
    return _quiet(lambda: cli.main([
        "-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"), "-t",
        "fa", "-o", "fa", "-k", str(k), "-d", "4", "-P", "--device", "cpu",
        "--out-dir", str(out), *extra]))


@functools.lru_cache(maxsize=None)
def _one_device_dump(k: int) -> bytes:
    out = pathlib.Path(tempfile.mkdtemp(prefix="nkm_mode_b_"))
    assert _cli(out, k) == 0
    return (out / f"output_kmer.k{k}_norm4_thread0.tsv").read_bytes()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,golden", [(15, "fasta_in_paired_k15"),
                                      (25, "fasta_in_paired_k25_jax")])
def test_mode_b_cli_reproduces_the_golden(tmp_path, k, golden, n):
    assert _cli(tmp_path, k, ["--devices", str(n), "--sharding",
                              "global"]) == 0
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm4_thread0.fastq"
        assert (tmp_path / name).read_bytes() == \
            (GOLDEN / golden / name).read_bytes(), name
    dump = (tmp_path / f"output_kmer.k{k}_norm4_thread0.tsv").read_bytes()
    assert dump == _one_device_dump(k)
    assert not list(tmp_path.glob("*thread1*"))


def _fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


def _pair(tmp_path, reads1, reads2):
    return dict(forward_files=(_fastq(tmp_path / "r1.fq", reads1),),
                reverse_files=(_fastq(tmp_path / "r2.fq", reads2),))


def _mode_b(kw, n, rows=None):
    """A Mode B engine on n CPU devices; `rows`: its table's start size."""
    norm = MeshNormalizer(Config(**kw, sharding="global"), [CPU] * n)
    if rows:
        t = RowShardedBucketTable(BucketTable(kw["ksize"], rows=rows),
                                  [CPU] * n)
        norm.tables, norm.states = [t], [t.init()]
    return norm


def _one_device(kw, rows=None):
    norm = Normalizer(Config(**kw), device="cpu")
    if rows:
        norm.tables = [BucketTable(kw["ksize"], rows=rows)]
        norm.states = [norm.tables[0].init()]
    return norm


@pytest.mark.parametrize("n", [2, 4])
def test_mode_b_grows_mid_stream_as_one_device(tmp_path, n):
    """From 512 rows at k = 9 with one seeded record, the table grows while
    the stream runs (and replays where a row filled); every row shard
    doubles at each growth. Outputs, dump and totals equal the one-device
    run from the same start."""
    rng = np.random.default_rng(7)
    pool = ["".join(rng.choice(list("ACGT"), size=80)) for _ in range(900)]
    reads = [pool[i % 40] if i % 3 == 0 else pool[i] for i in range(900)]
    inputs = _pair(tmp_path, reads[:450], reads[450:])
    kws = [_kw(tmp_path, sub, inputs, informat="fq", outformat="fq",
               ksize=9, depth=4, table="bucket", batch_reads=128,
               seed_records=1, print_table=True, memory_gb=1)
           for sub in ("b", "one")]
    mb, one = _mode_b(kws[0], n, rows=512), _one_device(kws[1], rows=512)
    reps = [_quiet(mb.run), _quiet(one.run)]
    assert mb.tables[0].rows == one.tables[0].rows > 512
    assert all(k.shape[0] == mb.tables[0].rows // n
               for k in mb.states[0].keys)
    assert int(mb.states[0].overflow) == 0
    assert _totals(reps[0]) == _totals(reps[1])
    assert _outputs(kws[0]) == _outputs(kws[1])


@pytest.mark.parametrize("k", [13, 21])
def test_mode_b_relaxed_counts_are_exact(tmp_path, k):
    """--mode relaxed reorders ranks among a batch's copies of a code and
    nothing else: the -P dump equals the exact Mode B run's, and so do the
    processed and distinct counts."""
    inputs = _inputs(tmp_path, 300, True)
    kws = {m: _kw(tmp_path, m, inputs, ksize=k, table="bucket",
                  batch_reads=64, mode=m, print_table=True)
           for m in ("exact", "relaxed")}
    reps = {m: _quiet(_mode_b(kw, 4).run) for m, kw in kws.items()}
    name = f"output_kmer.k{k}_norm4_thread0.tsv"
    dumps = {m: (pathlib.Path(kw["out_dir"]) / name).read_bytes()
             for m, kw in kws.items()}
    assert dumps["exact"] == dumps["relaxed"]
    assert reps["exact"].total_processed == reps["relaxed"].total_processed
    assert reps["exact"].max_total_kmers == reps["relaxed"].max_total_kmers


@pytest.mark.parametrize("n,k", [(2, 15), (4, 25)])
def test_mode_b_full_skew_drops_no_window(tmp_path, n, k):
    """400 copies of one pair of poly-C mates: every window is one code,
    owned by one row shard, which receives the whole stream. Its count is
    every window of the input, and the run equals the one-device run."""
    inputs = _pair(tmp_path, ["C" * 150] * 400, ["C" * 150] * 400)
    kws = [_kw(tmp_path, sub, inputs, informat="fq", outformat="fq",
               ksize=k, depth=4, table="bucket", batch_reads=128,
               print_table=True) for sub in ("b", "one")]
    mb = _mode_b(kws[0], n)
    reps = [_quiet(mb.run), _quiet(_one_device(kws[1]).run)]
    assert _totals(reps[0]) == _totals(reps[1])
    assert _outputs(kws[0]) == _outputs(kws[1])
    dump = (pathlib.Path(kws[0]["out_dir"])
            / f"output_kmer.k{k}_norm4_thread0.tsv").read_text()
    assert dump == f"{'C' * k}\t{400 * 2 * (150 - k + 1)}\n"
    assert int(mb.states[0].overflow) == 0
    assert reps[0].total_processed == 400


@pytest.mark.parametrize("changes,n,match", [
    (dict(stride=2), 2, "stride"),
    (dict(batch_reads=8193), 2, "16384"),
    (dict(), 3, "power-of-two"),
    (dict(ksize=9), 2, "128-row shards"),       # 128 rows in all
    (dict(ksize=16), 64, "512-row shards"),     # 2^14 rows, 256 a shard
])
def test_mode_b_config_errors(changes, n, match):
    kw = dict(forward_files=("x.fq",), reverse_files=("y.fq",), ksize=13,
              sharding="global", table="bucket")
    kw.update(changes)
    with pytest.raises(ConfigError, match=match):
        MeshNormalizer(Config(**kw), [CPU] * n)


def test_mode_b_checkpoints_cross_with_the_one_device_engine(tmp_path):
    """Mode B on 4 devices, interrupted after its third retire, leaves one
    whole-table state (shard0.npz, 16384 x 64 planes at k = 15), which the
    JAX package's loader reads; the one-device engine resumes it. And a
    one-device checkpoint resumes in Mode B on 2 devices. Both give the
    bytes of an uninterrupted run."""
    inputs = _inputs(tmp_path, 600, True)

    def kw(sub, **more):
        return _kw(tmp_path, sub, inputs, ksize=15, table="bucket", **more)

    full_kw = kw("full")
    full = _quiet(_one_device(full_kw).run)
    for first, then in ((4, 1), (1, 2)):
        sub = f"from{first}"
        ck = dict(checkpoint_every=1,
                  checkpoint_dir=str(tmp_path / f"ck{first}"))
        part = kw(sub, **ck)
        engine = MeshNormalizer if first > 1 else Normalizer
        _quiet(lambda: _interrupt(
            engine, _mode_b(part, first) if first > 1
            else _one_device(part), 3))
        z = np.load(tmp_path / f"ck{first}" / "shard0.npz")
        assert z["keys"].shape == z["counts"].shape == (16384, 64)
        states, resume = RefManager(RefConfig(**part)).load()
        assert len(states) == 1 and resume.records_done == 2 * 128
        again = dict(part, resume=True)
        rep = _quiet(_mode_b(again, then).run if then > 1
                     else _one_device(again).run)
        assert _totals(rep) == _totals(full)
        assert _outputs(part) == _outputs(full_kw)
