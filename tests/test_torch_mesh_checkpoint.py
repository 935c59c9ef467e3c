"""Mode A checkpoints across the packages: the JAX MeshNormalizer and the
port's, each on 2 devices (conftest's virtual CPU devices; 2 logical CPU
devices), write D shard states (shard0.npz, shard1.npz) and the manifest in
one layout. A Mode A run of either package, interrupted after its third
retire, resumes in the other to the bytes and totals of an uninterrupted
run, on the direct table at k = 11."""
import contextlib
import io

import pytest
import torch

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.parallel.engine import (
    MeshNormalizer as RefMesh,
)
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from test_torch_checkpoint import (
    _inputs, _interrupt, _kw, _outputs, _totals,
)
from one_thread import one_torch_thread  # noqa: F401

N = 2


def _port(kw):
    return MeshNormalizer(Config(**kw), [torch.device("cpu")] * N)


def _ref(kw):
    return RefMesh(RefConfig(**kw), n_devices=N)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_mode_a_checkpoints_cross_between_port_and_jax(tmp_path, first):
    inputs = _inputs(tmp_path, 600, True)
    cfg = dict(ksize=11, depth=4, table="direct", batch_reads=64)
    full_kw = _kw(tmp_path, "full", inputs, **cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        full = _port(full_kw).run()
        part_kw = _kw(tmp_path, "part", inputs, checkpoint_every=1, **cfg)
        # the JAX engine retires a batch at a time, the port a shard's
        # slice of it: both stop after their checkpoint at 128 pairs
        if first == "jax":
            _interrupt(RefMesh, _ref(part_kw), 3)
        else:
            _interrupt(MeshNormalizer, _port(part_kw), 2 * 3)
        then = _port if first == "jax" else _ref
        rep = then(dict(part_kw, resume=True)).run()
    assert (tmp_path / "ckpt" / "shard1.npz").exists()
    assert _totals(rep) == _totals(full)
    assert _outputs(part_kw) == _outputs(full_kw)
    assert len(_outputs(full_kw)) == 2 * N
    assert 0 < full.total_printed < full.total_processed == 600
