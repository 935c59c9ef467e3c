"""--profile and --debug above 4 in the port.

--profile DIR wraps the run in torch.profiler (utils/profiling.py::
device_trace; on the CPU with CPU activity only) and leaves one Chrome
trace in DIR whose events name the run's operators. --debug 5 runs as the
JAX engine runs it, as tier 4 (the reference's probe traces have no
analogue on these tables): stdout line for line equal to the JAX
Normalizer's, with test_torch_debug.py's wall-clock filter. And the debug
tiers of Mode A: --debug 3 on 2 devices, one batch a dispatch and three,
line for line equal to the JAX MeshNormalizer's (each shard's slice of a
batch before the next batch's)."""
import contextlib
import io
import json
import pathlib

import pytest
import torch

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.parallel.engine import (
    MeshNormalizer as RefMesh,
)
from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import Config, port_config
from nomalise_kmers_multi_large_torch.engine.report import (
    without_clock_lines,
)
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from test_torch_checkpoint import _inputs, _kw
from test_torch_debug import (
    PAIRS, config_kw, port_normalizer, ref_lines, run_stdout,
)
from one_thread import one_torch_thread  # noqa: F401

DATA = pathlib.Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("devices", [1, 2])
def test_profile_writes_a_trace(tmp_path, devices):
    trace = tmp_path / "trace"
    lines = (DATA / "a1.fasta").read_text().splitlines(True)[:400]
    (tmp_path / "a.fa").write_text("".join(lines))
    assert cli.main(["-f", str(tmp_path / "a.fa"), "-s", "-t", "fa", "-o",
                     "fa", "-k", "15", "-d", "4", "--device", "cpu",
                     "--devices", str(devices), "--profile", str(trace),
                     "--out-dir", str(tmp_path / "out")]) == 0
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::sort" in names and len(events) > 100
    for s in range(devices):   # Mode A on 2: thread 0 and 1, depth 2
        name = f"output_forward.k15_norm{4 // devices}_thread{s}.fastq"
        assert (tmp_path / "out" / name).stat().st_size > 0


def test_debug_above_4_runs_as_4():
    cfg = port_config(Config(forward_files=("a.fa",), single=True, debug=7))
    assert cfg.debug == 7 and cfg.table == "bucket"


def test_debug_5_stdout_equals_jax_engine(tmp_path):
    got = run_stdout(port_normalizer(**config_kw("paired", 5, tmp_path)))
    assert got == list(ref_lines("paired", 5))
    assert got == [ln for ln in ref_lines("paired", 4)]
    records = [ln for ln in got if " PRINTED: " in ln or " SKIPPED: " in ln]
    assert len(records) == PAIRS
    assert any(ln.startswith("FWD seq: ") for ln in got)


@pytest.mark.parametrize("group", [1, 3])
def test_mode_a_debug3_stdout_equals_jax_mesh(tmp_path, group):
    inputs = _inputs(tmp_path, 200, True)
    kw = dict(ksize=11, depth=4, table="direct", batch_reads=64, debug=3,
              dispatch_group=group)
    runs = {"jax": lambda k: RefMesh(RefConfig(**k), n_devices=2),
            "port": lambda k: MeshNormalizer(Config(**k),
                                             [torch.device("cpu")] * 2)}
    lines = {}
    for name, make in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            make(_kw(tmp_path, name, inputs, **kw)).run()
        lines[name] = without_clock_lines(buf.getvalue())
    assert lines["port"] == lines["jax"]
    assert any(ln.startswith("Thread 1 - Sequence pair 100 ")
               for ln in lines["port"])
    assert any(ln.startswith("DEBUG: ") for ln in lines["port"])
