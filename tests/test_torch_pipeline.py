"""The port's slice end to end on the CPU: golden parity through the CLI,
grow-and-replay when growth lands between a dispatch and its overflowing
retire, the table rule, and the import and device rules (the comparisons
with the reference Normalizer are in test_torch_pipeline_reference.py and
test_torch_pipeline_shards.py). Outputs compare byte for
byte and totals exactly."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import (
    Config, port_config,
)
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"


def _write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")


def _totals(text):
    keys = ("Processed Records", "Printed Records", "Skipped Records",
            "Cumulative Max unique kmers in any thread")
    return tuple(int(re.search(rf"{k}: ([\d,]+)", text).group(1)
                     .replace(",", "")) for k in keys)


def test_cli_reproduces_golden_fasta_in_paired_k15(tmp_path, capsys):
    rc = cli.main([
        "-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"),
        "-t", "fa", "-o", "fa", "-k", "15", "-d", "4",
        "--device", "cpu", "--out-dir", str(tmp_path),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert _totals(out) == (5000, 3921, 1079, 497496)
    assert _totals(out) == _totals(
        (GOLDEN / "fasta_in_paired_k15" / "stdout_stable.txt").read_text())
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k15_norm4_thread0.fastq"
        assert (tmp_path / name).read_bytes() == \
            (GOLDEN / "fasta_in_paired_k15" / name).read_bytes()


def test_growth_between_dispatch_and_overflowing_retire(tmp_path, capsys):
    """Batch 0 lifts occupancy over the growth headroom without a full row;
    batch 1 overflows rows. Batch 1's retire comes after the flush of batch
    2 has already grown the table on the mirror from batch 0, so the replay
    must grow batch 1's pre-dispatch state with the descriptor it was
    dispatched on. The result equals a run whose table never grows."""
    rng = np.random.default_rng(11)
    reads = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(375)]
    fa = tmp_path / "a.fa"
    _write_fasta(fa, reads)

    def run(sub, memory_gb):
        out = tmp_path / sub
        out.mkdir()
        cfg = Config(forward_files=(str(fa),), single=True, informat="fa",
                     outformat="fa", ksize=9, depth=2, batch_reads=125,
                     seed_records=1, memory_gb=memory_gb, verbose=True,
                     out_dir=str(out))
        norm = Normalizer(cfg, device="cpu")
        rep = norm.run()
        return norm, rep, (out / "output_forward.k9_norm2_thread0.fastq"
                           ).read_bytes()

    grown, grep_, gout = run("grown", 0)
    text = capsys.readouterr()
    assert "expansion triggered" in text.out
    assert "table row overflow" in text.err
    assert int(grown.states[0].overflow) == 0
    # --memory_start 1 sizes the table at 4^9 slots: no growth, no overflow
    fixed, frep, fout = run("fixed", 1)
    assert not fixed.tables[0].can_grow
    assert gout == fout
    assert (grep_.total_processed, grep_.total_printed, grep_.total_skipped,
            grep_.max_total_kmers) == (
        frep.total_processed, frep.total_printed, frep.total_skipped,
        frep.max_total_kmers)
    for a, b in zip(grown.tables[0].export(grown.states[0]),
                    fixed.tables[0].export(fixed.states[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("changes,table", [
    (dict(), "bucket"),
    (dict(ksize=13, depth=200000, shards=2), "direct"),  # depth/shard > 65535
    (dict(ksize=21, table="hashed"), "hashed"),         # wide, hashed
    (dict(table="direct"), "direct"),
    (dict(mode="relaxed", table="direct"), "direct"),   # direct, relaxed
    (dict(checkpoint_every=5, n_devices=2, sharding="global",
          table="direct"), "direct"),                   # Mode B, direct
    (dict(debug=5, sharding="global", table="hashed"), "hashed"),
    (dict(spectrum=True), "bucket"),
    (dict(seed_table="x.tsv"), "bucket"),
    (dict(n_devices=2, sharding="global", table="direct"), "direct"),
    (dict(sharding="global", table="hashed"), "hashed"),
    (dict(profile_dir="trace", sharding="global", ksize=13,
          depth=200000), "direct"),            # auto -> direct, in Mode B
    (dict(mode="relaxed"), "bucket"),
    (dict(ksize=21, mode="relaxed"), "bucket"),
    (dict(checkpoint_every=5, resume=True), "bucket"),
    (dict(debug=2), "bucket"),
    (dict(debug=4, ksize=25), "bucket"),
])
def test_table_rule_and_unported_options(changes, table):
    """The table each config resolves to: port_config accepts every
    option, --sharding global on the direct and hashed tables too (auto
    above depth 65535 included)."""
    cfg = Config(forward_files=("a.fa",), single=True, **changes)
    assert port_config(cfg).table == table


@pytest.mark.parametrize("changes", [
    dict(checkpoint_every=5, n_devices=2),
    dict(debug=5),
    dict(debug=9, ksize=25),
    dict(n_devices=4),
    dict(sharding="global"),
    dict(sharding="global", ksize=25, n_devices=2),
    dict(profile_dir="trace"),
])
def test_multi_device_profile_and_deep_debug_accepted(changes):
    """Options the port runs since its multi-device slice: every
    --devices, Mode B on the bucket table, --profile, --debug above 4."""
    cfg = port_config(Config(forward_files=("a.fa",), single=True,
                             **changes))
    assert cfg.table == "bucket"


def test_port_imports_no_jax():
    code = ("import sys, nomalise_kmers_multi_large_torch, "
            "nomalise_kmers_multi_large_torch.cli, "
            "nomalise_kmers_multi_large_torch.engine.pipeline, "
            "nomalise_kmers_multi_large_torch.table.direct, "
            "nomalise_kmers_multi_large_torch.table.hashed, "
            "nomalise_kmers_multi_large_torch.ops.streamrank, "
            "nomalise_kmers_multi_large_torch.ops.hashed_kernel, "
            "nomalise_kmers_multi_large_torch.models.spectrum, "
            "nomalise_kmers_multi_large_torch.parallel.engine, "
            "nomalise_kmers_multi_large_torch.parallel.mesh, "
            "nomalise_kmers_multi_large_torch.parallel.modes, "
            "nomalise_kmers_multi_large_torch.parallel.multihost, "
            "nomalise_kmers_multi_large_torch.utils.profiling; "
            "sys.exit(1 if any(m == 'jax' or m.startswith("
            "('jax.', 'nomalise_kmers_multi_large_tpu')) "
            "for m in sys.modules) else 0)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without")
    cfg = Config(forward_files=(str(DATA / "a1.fasta"),), single=True,
                 informat="fa", outformat="fa", out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Normalizer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-f", str(DATA / "a1.fasta"), "-s", "-t", "fa", "-o", "fa",
                  "--out-dir", str(tmp_path)])
