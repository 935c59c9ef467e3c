"""Checkpoints of the direct and hashed tables, across the packages: the
port and the JAX package, each interrupted after the same retire, save the
same stream position, counters and table contents (the direct table's
counts and ``seeded_lo.npy`` array for array; the hashed table's codes and
counts, whose slots may differ), and each resumes the other's checkpoint to
the bytes of an uninterrupted run. The port's hashed table starts at 1024
slots and grows, the JAX package's at 2^18, so each resume also rebuilds a
table of another capacity. And the loader's repair: a stale
``seeded_lo.npy`` in a reused directory is not restored (the JAX package's
loader restores it)."""
import contextlib
import io
import json

import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.engine.checkpoint import (
    CheckpointManager as RefManager,
)
from nomalise_kmers_multi_large_torch.config import Config, port_config
from nomalise_kmers_multi_large_torch.engine.checkpoint import (
    CheckpointManager,
)
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from test_torch_checkpoint import _inputs, _interrupt, _outputs, _totals, _kw


def _hash_slots(monkeypatch, port_slots=1024, ref_slots=1 << 18):
    monkeypatch.setattr(Config, "initial_hash_capacity",
                        property(lambda self: port_slots))
    monkeypatch.setattr(RefConfig, "initial_hash_capacity",
                        property(lambda self: ref_slots))


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn()


def _contents(z):
    """(code, count) of a saved shard's occupied slots, ascending, and its
    used and overflow counters."""
    counts = z["counts"]
    if "keys" not in z:   # direct: a slot is its code
        code = np.nonzero(counts)[0].astype(np.uint64)
        vals = counts[code.astype(np.int64)]
    else:                 # hashed: uint32 (hi, lo) planes [2, C]
        keys = z["keys"].astype(np.uint64)
        occ = np.nonzero(keys[0] | keys[1])[0]
        code = (keys[0, occ] << np.uint64(32)) | keys[1, occ]
        order = np.argsort(code)
        code, vals = code[order], counts[occ][order]
    return code, vals, int(z["used"]), int(z["overflow"])


@pytest.mark.parametrize("table,k", [("direct", 11), ("hashed", 21)])
def test_fallback_checkpoints_cross_between_port_and_jax(tmp_path,
                                                         monkeypatch, table,
                                                         k):
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    _hash_slots(monkeypatch)
    inputs = _inputs(tmp_path, 400, True)
    full_kw = _kw(tmp_path, "full", inputs, ksize=k, table=table)
    full = _quiet(Normalizer(Config(**full_kw), device="cpu").run)
    want = _outputs(full_kw)
    dirs = {}
    for who, make in (("port", lambda c: Normalizer(Config(**c), "cpu")),
                      ("jax", lambda c: RefNormalizer(RefConfig(**c)))):
        kw = _kw(tmp_path, who, inputs, ksize=k, table=table, batch_reads=64,
                 checkpoint_every=1, checkpoint_dir=str(tmp_path / who))
        cls = Normalizer if who == "port" else RefNormalizer
        _quiet(lambda: _interrupt(cls, make(kw), 3))
        dirs[who] = kw
    mp, mj = (json.loads((tmp_path / w / "manifest.json").read_text())
              for w in ("port", "jax"))
    assert mp["config"] == mj["config"] and mp["config"]["table"] == table
    assert (mp["file_index"], mp["records_done"], mp["counters"]) == \
        (mj["file_index"], mj["records_done"], mj["counters"])
    assert mp["seeded_lo"] == (table == "direct")
    zp, zj = (np.load(tmp_path / w / "shard0.npz") for w in ("port", "jax"))
    assert sorted(zp.keys()) == sorted(zj.keys())
    for name in zj:
        assert zp[name].dtype == zj[name].dtype, name
    for a, b in zip(_contents(zp), _contents(zj)):
        np.testing.assert_array_equal(a, b)
    if table == "direct":
        np.testing.assert_array_equal(zp["counts"], zj["counts"])
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "seeded_lo.npy"),
            np.load(tmp_path / "jax" / "seeded_lo.npy"))
    else:
        assert zp["counts"].shape[0] < zj["counts"].shape[0] == 1 << 18

    # each package resumes the other's checkpoint, where its outputs are
    port_kw = dict(dirs["port"], checkpoint_dir=dirs["jax"]["checkpoint_dir"],
                   out_dir=dirs["jax"]["out_dir"], resume=True)
    jax_kw = dict(dirs["jax"], checkpoint_dir=dirs["port"]["checkpoint_dir"],
                  out_dir=dirs["port"]["out_dir"], resume=True)
    port = Normalizer(Config(**port_kw), device="cpu")
    rep_port = _quiet(port.run)
    rep_jax = _quiet(RefNormalizer(RefConfig(**jax_kw)).run)
    for rep, kw in ((rep_port, port_kw), (rep_jax, jax_kw)):
        assert _totals(rep) == _totals(full)
        assert _outputs(kw) == want
    assert 0 < full.total_printed < full.total_processed
    if table == "hashed":   # the JAX checkpoint's capacity, grown or not
        assert port.tables[0].capacity >= 1 << 18


def test_stale_seeded_lo_in_a_reused_directory_is_not_restored(tmp_path,
                                                               monkeypatch):
    """A direct run leaves seeded_lo.npy behind; a hashed run reuses the
    directory and checkpoints without it. The port's loader restores no
    seeds for it; the JAX package's loader hands it the stale file. A
    manifest without the "seeded_lo" key (the JAX package's) reads as saved
    exactly when its table is the direct one."""
    _hash_slots(monkeypatch, 1 << 16)
    inputs = _inputs(tmp_path, 200, False)
    base = dict(ksize=11, checkpoint_every=1)
    direct = _kw(tmp_path, "d", inputs, table="direct", **base)
    _quiet(Normalizer(Config(**direct), device="cpu").run)
    ckpt = tmp_path / "ckpt"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["seeded_lo"] and (ckpt / "seeded_lo.npy").exists()
    stale = np.load(ckpt / "seeded_lo.npy")
    assert stale.size > 1000

    cfg = port_config(Config(**dict(direct, resume=True)))
    np.testing.assert_array_equal(
        CheckpointManager(cfg).load("cpu")[1].seeded_lo, stale)
    del manifest["seeded_lo"]
    (ckpt / "manifest.json").write_text(json.dumps(manifest))
    np.testing.assert_array_equal(
        CheckpointManager(cfg).load("cpu")[1].seeded_lo, stale)

    hashed = _kw(tmp_path, "h", inputs, table="hashed", **base)
    _quiet(Normalizer(Config(**hashed), device="cpu").run)
    assert not json.loads((ckpt / "manifest.json").read_text())["seeded_lo"]
    cfg = port_config(Config(**dict(hashed, resume=True)))
    assert CheckpointManager(cfg).load("cpu")[1].seeded_lo is None
    _, rrp = RefManager(RefConfig(**dict(hashed, resume=True))).load()
    np.testing.assert_array_equal(rrp.seeded_lo, stale)
