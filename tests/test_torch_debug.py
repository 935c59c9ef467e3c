"""The port's --debug tiers against the JAX engine, line for line: per-record
PRINTED/SKIPPED lines (debug 2), per-upsert lines from the host shadow and
the batch round-trip self-check (debug 3), the raw record dump (debug 4).

Both engines run the first 200 pairs of tests/data/{a1,b1}.fasta at -k 11
-d 2 on a bucket table of 1024 rows (the 200 pairs need no growth, so the
JAX engine's interpret-mode step compiles once per configuration, and its
compiled steps are shared between its runs). Stdout must be equal except
for the wall-clock lines and the stage timer's report."""
import contextlib
import functools
import io
import pathlib

import pytest

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.table import BucketTable as RefTable
from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.engine import pipeline
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.engine.report import (
    without_clock_lines as stable_lines,
)
from nomalise_kmers_multi_large_torch.table import BucketTable

DATA = pathlib.Path(__file__).resolve().parent / "data"
PAIRS = 200
ROWS = 1024


@functools.lru_cache(maxsize=None)
def reads_dir() -> pathlib.Path:
    """The first PAIRS pairs of a1/b1, written once per process."""
    import tempfile

    d = pathlib.Path(tempfile.mkdtemp(prefix="nkm_debug_reads_"))
    for name in ("a1", "b1"):
        lines = (DATA / f"{name}.fasta").read_text().splitlines(True)
        (d / f"{name}.fa").write_text("".join(lines[:2 * PAIRS]))
    return d


def config_kw(kind: str, debug: int, out_dir) -> dict:
    """kind: "paired", "paired-canonical" or "single"."""
    d = reads_dir()
    kw = dict(forward_files=(str(d / "a1.fa"),), informat="fa",
              outformat="fa", ksize=11, depth=2, table="bucket", debug=debug,
              canonical=kind == "paired-canonical", out_dir=str(out_dir))
    if kind == "single":
        kw["single"] = True
    else:
        kw["reverse_files"] = (str(d / "b1.fa"),)
    return kw


def run_stdout(norm) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        norm.run()
    return stable_lines(buf.getvalue())


def port_normalizer(**kw) -> Normalizer:
    n = Normalizer(Config(**kw), device="cpu")
    n.tables = [BucketTable(kw["ksize"], rows=ROWS)]
    n.states = [n.tables[0].init()]
    return n


#: canonical -> (tables, compiled steps) of the first JAX run
_REF_STEPS: dict = {}


@functools.lru_cache(maxsize=None)
def ref_lines(kind: str, debug: int) -> tuple[str, ...]:
    """The JAX engine's stable stdout lines for a configuration."""
    import tempfile

    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    kw = config_kw(kind, debug, tempfile.mkdtemp(prefix="nkm_debug_ref_"))
    n = RefNormalizer(RefConfig(**kw))
    shared = _REF_STEPS.get(kw["canonical"])
    if shared is None:
        n.tables = [RefTable(kw["ksize"], rows=ROWS)]
        _REF_STEPS[kw["canonical"]] = (n.tables, n._steps_cache)
    else:
        n.tables, n._steps_cache = list(shared[0]), shared[1]
    n.states = [n.tables[0].init()]
    return tuple(run_stdout(n))


@pytest.mark.parametrize("debug", [2, 3, 4])
@pytest.mark.parametrize("kind", ["paired", "paired-canonical", "single"])
def test_debug_tier_stdout_equals_jax_engine(tmp_path, kind, debug):
    got = run_stdout(port_normalizer(**config_kw(kind, debug, tmp_path)))
    want = list(ref_lines(kind, debug))
    assert got == want
    records = [ln for ln in got if " PRINTED: " in ln or " SKIPPED: " in ln]
    assert len(records) == PAIRS
    assert any(" SKIPPED: " in ln for ln in records)
    assert any(ln.startswith("DEBUG: ") for ln in got) == (debug > 2)
    assert any(ln.startswith("FWD seq: ") for ln in got) == (debug > 3)


def test_debug3_across_a_resume_equals_uninterrupted(tmp_path):
    """Interrupted after its second retire (one checkpoint taken, at 64
    pairs) and resumed: the interrupted run's lines are a prefix of the JAX
    engine's uninterrupted stdout, and the resumed run's lines from its
    first record on are its suffix. The shadow rides the checkpoint, so the
    upsert counts stay absolute."""
    kw = config_kw("paired", 3, tmp_path)
    kw.update(batch_reads=64, checkpoint_every=1,
              checkpoint_dir=str(tmp_path / "ckpt"))
    want = list(ref_lines("paired", 3))
    first = port_normalizer(**kw)
    calls = {"n": 0}
    orig = Normalizer._retire

    def bomb(self, *a):
        r = orig(self, *a)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        return r

    buf = io.StringIO()
    Normalizer._retire = bomb
    try:
        with pytest.raises(KeyboardInterrupt), contextlib.redirect_stdout(buf):
            first.run()
    finally:
        Normalizer._retire = orig
    part = stable_lines(buf.getvalue())
    assert part == want[:len(part)]

    resumed = run_stdout(Normalizer(Config(**dict(kw, resume=True)),
                                    device="cpu"))
    assert resumed[0] == "Resuming from checkpoint: file 1, 64 records done"
    start = next(i for i, ln in enumerate(resumed) if ln.startswith("DEBUG"))
    assert "Sequence pair 65 " in next(
        ln for ln in resumed[start:] if ln.startswith("Thread 0 - Sequence"))
    tail = [ln for ln in resumed[start:]
            if not ln.startswith("Processing file pair")]
    assert tail == want[len(want) - len(tail):]


def test_debug3_roundtrip_exits_on_codec_mismatch(tmp_path, monkeypatch):
    """A corrupted decode makes the self-check exit, as the reference does
    (nk.c:957-959)."""
    real = pipeline.decode_codes

    def corrupt(hi, lo, k):
        out = real(hi, lo, k)
        out[0] = ("A" if out[0][0] != "A" else "C") + out[0][1:]
        return out

    monkeypatch.setattr(pipeline, "decode_codes", corrupt)
    with pytest.raises(SystemExit, match="kmers do not match hash"):
        port_normalizer(**config_kw("single", 3, tmp_path)).run()


@pytest.mark.parametrize("k", [11, 21])
def test_debug3_roundtrip_exits_on_encode_kernel_mismatch(tmp_path,
                                                          monkeypatch, k):
    """An encode result that disagrees with the codec in one window makes
    the self-check exit."""
    name = "encode_keys" if k <= 15 else "encode_keys_wide"
    real = getattr(pipeline, name)

    def corrupt(*a):
        out = real(*a)
        first = out[0] if isinstance(out, tuple) else out
        first[0, 3] ^= 1
        return out

    monkeypatch.setattr(pipeline, name, corrupt)
    kw = config_kw("single", 3, tmp_path)
    kw["ksize"] = k
    with pytest.raises(SystemExit, match="fused encode kernel disagrees"):
        Normalizer(Config(**kw), device="cpu").run()
