"""Checkpoints and resume in the port: an interrupted and resumed run writes
the bytes of an uninterrupted one (k = 11 single-end, k = 21 paired), a
checkpoint crosses between the port and the JAX package both ways, a
changed config is refused, a resume of a finished run reports its totals,
and stale debug shadows in a reused directory are not restored (the JAX
package's loader restores them)."""
import contextlib
import gc
import io
import json
import pathlib

import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.engine.checkpoint import (
    CheckpointManager as RefManager,
)
from nomalise_kmers_multi_large_tpu.table import BucketTable as RefTable
from nomalise_kmers_multi_large_torch.config import Config, port_config
from nomalise_kmers_multi_large_torch.engine.checkpoint import (
    CheckpointManager,
)
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.table import BucketTable

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _head(src, dst, records):
    lines = pathlib.Path(src).read_text().splitlines(True)
    pathlib.Path(dst).write_text("".join(lines[:2 * records]))
    return str(dst)


def _inputs(tmp_path, records, paired):
    fwd = (_head(DATA / "a1.fasta", tmp_path / "a.fa", records),)
    if not paired:
        return dict(forward_files=fwd, single=True)
    return dict(forward_files=fwd,
                reverse_files=(_head(DATA / "b1.fasta", tmp_path / "b.fa",
                                     records),))


def _kw(tmp_path, sub, inputs, **kw):
    out = tmp_path / sub
    out.mkdir(exist_ok=True)
    base = dict(informat="fa", outformat="fa", depth=4, batch_reads=128,
                out_dir=str(out), checkpoint_dir=str(tmp_path / "ckpt"),
                **inputs)
    base.update(kw)
    return base


def _outputs(kw) -> dict:
    return {p.name: p.read_bytes()
            for p in pathlib.Path(kw["out_dir"]).glob("output_*")}


def _interrupt(cls, norm, after: int):
    """Run `norm` and stop it with a KeyboardInterrupt after its `after`-th
    retire."""
    calls = {"n": 0}
    orig = cls._retire

    def bomb(self, *a):
        r = orig(self, *a)
        calls["n"] += 1
        if calls["n"] == after:
            raise KeyboardInterrupt
        return r

    cls._retire = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            norm.run()
    finally:
        cls._retire = orig
    # the JAX engine leaves its output files open on an interrupt: close
    # them now, not after a resume has appended to the same files
    del norm
    gc.collect()


def _totals(rep):
    return (rep.total_processed, rep.total_printed, rep.total_skipped,
            rep.max_total_kmers)


@pytest.mark.parametrize("k,paired,records", [(11, False, 1200),
                                              (21, True, 600)])
def test_resume_equals_uninterrupted_run(tmp_path, k, paired, records):
    inputs = _inputs(tmp_path, records, paired)
    full_kw = _kw(tmp_path, "full", inputs, ksize=k)
    full = Normalizer(Config(**full_kw), device="cpu").run()
    part_kw = _kw(tmp_path, "part", inputs, ksize=k, checkpoint_every=1)
    n = Normalizer(Config(**part_kw), device="cpu")
    _interrupt(Normalizer, n, 3)
    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert manifest["records_done"] == 2 * 128 and not manifest["shadows"]
    resumed = Normalizer(Config(**part_kw, resume=True), device="cpu")
    rep = resumed.run()
    assert resumed.tables[0].rows > 128 or k > 15
    assert _totals(rep) == _totals(full)
    got, want = _outputs(part_kw), _outputs(full_kw)
    assert got == want and len(want) == 1 + paired
    assert 0 < full.total_printed < full.total_processed == records


def test_resume_with_another_config_is_refused(tmp_path):
    inputs = _inputs(tmp_path, 300, False)
    kw = _kw(tmp_path, "a", inputs, ksize=11, checkpoint_every=1)
    Normalizer(Config(**kw), device="cpu").run()
    bad = dict(kw, resume=True, depth=8)
    with pytest.raises(ValueError, match="mismatch"):
        Normalizer(Config(**bad), device="cpu").run()


def test_resume_of_a_finished_run_reports_its_totals(tmp_path, capsys):
    inputs = _inputs(tmp_path, 300, True)
    kw = _kw(tmp_path, "a", inputs, ksize=11, checkpoint_every=1)
    first = Normalizer(Config(**kw), device="cpu").run()
    again = Normalizer(Config(**kw, resume=True), device="cpu").run()
    assert _totals(again) == _totals(first) and first.total_processed == 300
    assert "Resuming from checkpoint: file 2, 0 records done" in \
        capsys.readouterr().out


# ----------------------------------------------------------------------
# across the packages: both engines on a 1024-row table (no growth, so the
# JAX engine's interpret-mode step compiles once)

ROWS = 1024


def _port(kw) -> Normalizer:
    n = Normalizer(Config(**kw), device="cpu")
    n.tables = [BucketTable(kw["ksize"], rows=ROWS)]
    n.states = [n.tables[0].init()]
    return n


def _ref(kw):
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    n = RefNormalizer(RefConfig(**dict(kw, table="bucket")))
    n.tables = [RefTable(kw["ksize"], rows=ROWS)]
    n.states = [n.tables[0].init()]
    return n


def _quiet_run(n):
    with contextlib.redirect_stdout(io.StringIO()):
        return n.run()


def test_checkpoints_cross_between_port_and_jax_package(tmp_path):
    """Each package is interrupted after its second retire (one checkpoint,
    at 64 records) with the same config: the shard files hold the same
    arrays, of the same dtypes. The port's checkpoint resumes in the JAX
    engine, and the JAX package's in the port, to the uninterrupted run's
    bytes."""
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    inputs = _inputs(tmp_path, 400, False)
    full_kw = _kw(tmp_path, "full", inputs, ksize=11)
    full = _quiet_run(_port(full_kw))
    want = _outputs(full_kw)
    dirs = {}
    for who, make, cls in (("port", _port, Normalizer),
                           ("jax", _ref, RefNormalizer)):
        kw = _kw(tmp_path, who, inputs, ksize=11, batch_reads=64,
                 checkpoint_every=1, checkpoint_dir=str(tmp_path / who))
        with contextlib.redirect_stdout(io.StringIO()):
            _interrupt(cls, make(kw), 2)
        dirs[who] = kw
    zp = np.load(tmp_path / "port" / "shard0.npz")
    zj = np.load(tmp_path / "jax" / "shard0.npz")
    assert list(zp.keys()) == list(zj.keys())
    for name in zj:
        assert zp[name].dtype == zj[name].dtype and \
            zp[name].shape == zj[name].shape, name
        np.testing.assert_array_equal(zp[name], zj[name])
    mp, mj = (json.loads((tmp_path / w / "manifest.json").read_text())
              for w in ("port", "jax"))
    assert mp["config"] == mj["config"] and mp["config"]["table"] == "bucket"
    assert (mp["file_index"], mp["records_done"], mp["counters"]) == \
        (mj["file_index"], mj["records_done"], mj["counters"])

    # the JAX checkpoint resumes in the port, the port's in the JAX engine
    port_kw = dict(dirs["port"], checkpoint_dir=dirs["jax"]["checkpoint_dir"],
                   resume=True)
    jax_kw = dict(dirs["jax"], checkpoint_dir=dirs["port"]["checkpoint_dir"],
                  resume=True)
    for kw, who in ((port_kw, "jax"), (jax_kw, "port")):
        # the manifest names the writer's outputs: resume where they are
        kw["out_dir"] = dirs[who]["out_dir"]
    rep_port = _quiet_run(Normalizer(Config(**port_kw), device="cpu"))
    rep_jax = _quiet_run(RefNormalizer(RefConfig(**dict(jax_kw,
                                                        table="bucket"))))
    for rep, kw in ((rep_port, port_kw), (rep_jax, jax_kw)):
        assert _totals(rep) == _totals(full)
        assert _outputs(kw) == want


def test_stale_shadows_in_a_reused_directory_are_not_restored(tmp_path,
                                                              capsys):
    """A run at --debug 3 leaves shadow0.npz behind; a later run without
    --debug reuses the directory and checkpoints without shadows. A resume
    at --debug 3 then starts its shadow empty, with the warning; the JAX
    package's loader hands it the stale shadow. A manifest without the
    "shadows" key (the JAX package's) reads as no shadows."""
    inputs = _inputs(tmp_path, 300, False)
    kw = _kw(tmp_path, "a", inputs, ksize=11, checkpoint_every=1)
    Normalizer(Config(**dict(kw, debug=3)), device="cpu").run()
    ckpt = tmp_path / "ckpt"
    assert json.loads((ckpt / "manifest.json").read_text())["shadows"]
    _interrupt(Normalizer, Normalizer(Config(**kw), device="cpu"), 2)
    assert (ckpt / "shadow0.npz").exists()
    assert not json.loads((ckpt / "manifest.json").read_text())["shadows"]

    resume_cfg = port_config(Config(**dict(kw, debug=3, resume=True)))
    _, rp = CheckpointManager(resume_cfg).load("cpu")
    assert rp.shadows is None
    _, rrp = RefManager(RefConfig(**dict(kw, debug=3, resume=True,
                                         table="bucket"))).load()
    assert rrp.shadows is not None and len(rrp.shadows[0]) > 0

    capsys.readouterr()
    n = Normalizer(resume_cfg, device="cpu")
    n.run()
    out = capsys.readouterr()
    assert "count from the resume point" in out.err
    first = next(ln for ln in out.out.splitlines()
                 if ln.startswith("DEBUG: Kmer hash"))
    assert first.endswith("Count: 0")

    manifest = json.loads((ckpt / "manifest.json").read_text())
    del manifest["shadows"]
    (ckpt / "manifest.json").write_text(json.dumps(manifest))
    assert CheckpointManager(resume_cfg).load("cpu")[1].shadows is None
