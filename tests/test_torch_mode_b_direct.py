"""Mode B of the port on the direct table (--sharding global --table direct:
the 4^k counts cut into D code ranges over D logical CPU devices,
parallel/modes.py::RangeShardedDirectTable and ModeBStreamStep) against the
JAX package and the port's one-device run, tolerance 0:

- the step against the JAX ``ModeBStep`` on conftest's virtual CPU mesh,
  seeded numpy batches, exact and relaxed, stride 1 and 2, paired and
  single, canonical: keep masks, stats, per-read tallies each batch, and
  the counts slot for slot;
- the engine against the JAX ``MeshNormalizer(sharding="global")`` and
  against the port's one-device run (outputs, -P dumps, totals);
- the reference golden through the CLI, -P dumps and --spectrum equal to
  a one-device run, --debug 3 stdout with --dispatch-group 2 equal to it;
- checkpoints crossing Mode B, the one-device port and the JAX loader;
- the descriptor's gather, split, used_count and export with seeds; a D
  that is not a power of two refused.

The helpers are shared with tests/test_torch_mode_b_hashed.py."""
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.engine.checkpoint import (
    CheckpointManager as RefManager,
)
from nomalise_kmers_multi_large_tpu.engine.step import (
    BatchStep as RefBatchStep,
)
from nomalise_kmers_multi_large_tpu.parallel.engine import (
    MeshNormalizer as RefMesh,
)
from nomalise_kmers_multi_large_tpu.parallel.mesh import data_mesh
from nomalise_kmers_multi_large_tpu.parallel.modes import ModeBStep
from nomalise_kmers_multi_large_tpu.table import DirectTable as RefDirect
from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.config import Config, ConfigError
from nomalise_kmers_multi_large_torch.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_torch.engine.report import (
    without_clock_lines,
)
from nomalise_kmers_multi_large_torch.parallel.engine import MeshNormalizer
from nomalise_kmers_multi_large_torch.parallel.modes import (
    ModeBStreamStep, RangeShardedDirectTable,
)
from nomalise_kmers_multi_large_torch.table import DirectTable
from test_engine import _make_reads
from test_torch_checkpoint import _inputs, _interrupt, _kw, _outputs, _totals
from test_torch_standalone import _RUN
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA, GOLDEN = ROOT / "tests" / "data", ROOT / "tests" / "golden"
CPU = torch.device("cpu")
K = 9            # the step tests' k: 4^9 slots
ROWS = 64        # the step tests' read rows a batch


def quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn()


# ----------------------------------------------------------------------
# the step against the JAX ModeBStep

def step_batches(seed: int, paired: bool, n_batches: int = 4):
    """Seeded batches of ROWS read rows of 40 bp drawn from a few bases,
    with short and empty rows: (bases uint8 [R, 48], lengths, rec_valid)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(6, 40), dtype=np.uint8)
    out = []
    for _ in range(n_batches):
        bases = np.zeros((ROWS, 48), np.uint8)
        bases[:, :40] = pool[rng.integers(0, len(pool), size=ROWS)]
        sub = rng.random((ROWS, 40)) < 0.02
        bases[:, :40][sub] = rng.integers(0, 4, size=int(sub.sum()))
        lengths = np.full(ROWS, 40, np.int32)
        lengths[::7] = rng.integers(0, 41, size=lengths[::7].size)
        lengths[lengths < K] = 0
        if paired:
            pair = lengths.reshape(-1, 2)
            rv = pair.min(1) > 0
            lengths = np.where(np.repeat(rv, 2), lengths, 0).astype(np.int32)
        else:
            rv = lengths > 0
        out.append((bases, lengths, rv))
    return out


def step_pair(ref_table, table, n, **kw):
    """The JAX ModeBStep on an n-device mesh and the port's Mode B step on
    n CPU devices, with the same BatchStep arguments."""
    args = dict(k=kw.pop("k", K), depth_per_shard=3, coverage=0.6, **kw)
    ref = ModeBStep(data_mesh(n), RefBatchStep(ref_table, **args))
    return ref, ModeBStreamStep(table, **args)


def run_step_pair(ref, port, ref_state, state, batches):
    """Both steps over the batches: keep masks, stats and tallies equal
    batch by batch. Returns the two final states."""
    for bases, lengths, rv in batches:
        ref_state, *want = ref(ref_state, jnp.asarray(bases),
                               jnp.asarray(lengths), jnp.asarray(rv))
        state, *got = port.step(state, bases, lengths, rv)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for tree_got, tree_want in zip(got[1:], want[1:]):
            for a, b in zip(tree_got, tree_want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return ref_state, state


STEP_CASES = [  # n, paired, mode, stride, canonical
    (2, True, "exact", 1, False), (4, False, "exact", 2, True),
    (4, True, "relaxed", 1, True), (2, False, "relaxed", 2, False),
]


@pytest.mark.parametrize("n,paired,mode,stride,canonical", STEP_CASES)
def test_step_equals_jax_mode_b_step(n, paired, mode, stride, canonical):
    t = RangeShardedDirectTable(DirectTable(K), [CPU] * n)
    ref, port = step_pair(RefDirect(K), t, n, paired=paired, mode=mode,
                          stride=stride, canonical=canonical)
    rs, ps = run_step_pair(ref, port, ref.init_state(), t.init(),
                           step_batches(n + 10 * stride, paired))
    counts = t.gather(ps, "cpu").counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(rs.counts))
    assert counts.sum() > 0 and all(c.shape == (4 ** K // n,)
                                    for c in ps.counts)


# ----------------------------------------------------------------------
# the engine

def engine_kw(tmp_path, sub, inputs, table, **kw):
    return _kw(tmp_path, sub, inputs, table=table,
               **{"print_table": True, "batch_reads": 64, **kw})


def mode_b(kw, n):
    return MeshNormalizer(Config(**kw, sharding="global"), [CPU] * n)


def one_device(kw):
    return Normalizer(Config(**kw), device="cpu")


def check_against_jax_mesh(tmp_path, table, k, n, kind):
    """The JAX MeshNormalizer in Mode B and the port's on n devices: every
    output file and the totals equal."""
    inputs = _inputs(tmp_path, 300, kind != "single")
    cfg = dict(ksize=k, canonical=kind == "canonical")
    ref_kw = engine_kw(tmp_path, "ref", inputs, table, **cfg)
    port_kw = engine_kw(tmp_path, "port", inputs, table, **cfg)
    want = quiet(lambda: RefMesh(RefConfig(**ref_kw, sharding="global"),
                                 n_devices=n).run())
    got = quiet(mode_b(port_kw, n).run)
    assert _totals(got) == _totals(want)
    assert _outputs(port_kw) == _outputs(ref_kw)
    assert len(_outputs(port_kw)) == 3 + (kind != "single")
    assert 0 < want.total_printed < want.total_processed == 300


@pytest.mark.parametrize("n,kind", [(2, "paired"), (4, "single"),
                                    (4, "canonical")])
def test_mode_b_equals_jax_mesh_normalizer(tmp_path, n, kind):
    check_against_jax_mesh(tmp_path, "direct", 11, n, kind)


def reads_inputs(tmp_path, paired: bool, n: int = 400):
    """tests/test_engine.py's duplicated reads as FASTQ: one file, or two
    mates."""
    reads = _make_reads(2 * n if paired else n)
    files = []
    for m, part in enumerate((reads[:n], reads[n:]) if paired else (reads,)):
        path = tmp_path / f"reads{m}.fq"
        path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                                for i, r in enumerate(part)))
        files.append(str(path))
    if paired:
        return dict(forward_files=(files[0],), reverse_files=(files[1],))
    return dict(forward_files=(files[0],), single=True)


ENGINE_CASES = [  # n, paired, extra options
    (2, True, dict()), (4, True, dict(mode="relaxed")),
    (4, False, dict(stride=2)), (2, False, dict(canonical=True)),
    (4, True, dict(stride=2, mode="relaxed", dispatch_group=2)),
]


def check_against_one_device(tmp_path, table, k, n, paired, extra):
    """Mode B on n devices and the one-device engine on
    tests/test_engine.py's reads: outputs, -P dumps and totals equal."""
    inputs = reads_inputs(tmp_path, paired)
    kws = [engine_kw(tmp_path, sub, inputs, table, ksize=k, depth=3,
                     informat="fq", outformat="fq", **extra)
           for sub in ("b", "one")]
    norm = mode_b(kws[0], n)
    reps = [quiet(norm.run), quiet(one_device(kws[1]).run)]
    assert _totals(reps[0]) == _totals(reps[1])
    assert _outputs(kws[0]) == _outputs(kws[1])
    assert 0 < reps[0].total_printed < reps[0].total_processed
    assert int(norm.states[0].overflow) == 0
    return norm


@pytest.mark.parametrize("n,paired,extra", ENGINE_CASES)
def test_mode_b_equals_one_device(tmp_path, n, paired, extra):
    norm = check_against_one_device(tmp_path, "direct", 11, n, paired, extra)
    assert [c.device for c in norm.states[0].counts] == [CPU] * n


def cli_run(out, k, table, extra=()) -> int:
    return quiet(lambda: cli.main([
        "-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"), "-t",
        "fa", "-o", "fa", "-k", str(k), "-d", "4", "--device", "cpu",
        "--table", table, "--out-dir", str(out), *extra]))


MODE_B_CLI = ["--sharding", "global", "--devices"]


def check_golden(tmp_path, k, golden, table, n):
    """The CLI in Mode B on n devices reproduces the golden."""
    assert cli_run(tmp_path, k, table, [*MODE_B_CLI, str(n)]) == 0
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k{k}_norm4_thread0.fastq"
        assert (tmp_path / name).read_bytes() == \
            (GOLDEN / golden / name).read_bytes(), name


def check_dumps_and_spectrum(tmp_path, k, table, n, capsys):
    """-P (the seed dump and the table dump) and --spectrum in Mode B on n
    devices equal the one-device run's, through the CLI, on the first
    1,500 pairs of tests/data."""
    inputs = _inputs(tmp_path, 1500, True)
    outs = []
    for sub, extra in (("b", [*MODE_B_CLI, str(n)]), ("one", [])):
        capsys.readouterr()
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.main([
                "-f", *inputs["forward_files"], "-r",
                *inputs["reverse_files"],
                "-t", "fa", "-o", "fa", "-k", str(k), "-d", "4", "-P",
                "--spectrum", "--device", "cpu", "--table", table,
                "--out-dir", str(tmp_path / sub), *extra]) == 0
        text = capsys.readouterr().out
        outs.append((text[text.index("--- Kmer Spectrum ---"):],
                     {p.name: p.read_bytes()
                      for p in (tmp_path / sub).glob("output_*")}))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == 4 and "Distinct kmers" in outs[0][0]


@pytest.mark.parametrize("n", [2, 4])
def test_mode_b_dumps_and_spectrum_equal_one_device(tmp_path, n, capsys):
    check_dumps_and_spectrum(tmp_path, 11, "direct", n, capsys)


def check_debug(tmp_path, table, k, capsys):
    """--debug 3 (records, upsert lines, the round-trip check) with
    --dispatch-group 2: Mode B's stdout equals the one-device run's but
    for the wall-clock lines."""
    inputs = reads_inputs(tmp_path, True, 150)
    texts = []
    for sub, make in (("b", lambda kw: mode_b(kw, 2)), ("one", one_device)):
        kw = engine_kw(tmp_path, sub, inputs, table, ksize=k, depth=3,
                       debug=3, dispatch_group=2, batch_reads=32,
                       informat="fq", outformat="fq")
        capsys.readouterr()
        with contextlib.redirect_stderr(io.StringIO()):
            make(kw).run()
        texts.append(without_clock_lines(capsys.readouterr().out))
    assert texts[0] == texts[1]
    assert any("SKIPPED" in line for line in texts[0])


def test_mode_b_debug_3_equals_one_device(tmp_path, capsys):
    check_debug(tmp_path, "direct", 11, capsys)


def check_golden_without_jax(tmp_path, table):
    """The CLI in Mode B reproduces the k = 15 golden on 2 logical CPU
    devices, in a process of its own that imports nothing of JAX."""
    args = ["-f", str(DATA / "a1.fasta"), "-r", str(DATA / "b1.fasta"),
            "-t", "fa", "-o", "fa", "-k", "15", "-d", "4", "--table", table,
            *MODE_B_CLI, "2", "--device", "cpu", "--out-dir", str(tmp_path)]
    proc = subprocess.run([sys.executable, "-c", _RUN, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout[-2000:]
    for base in ("output_forward", "output_reverse"):
        name = f"{base}.k15_norm4_thread0.fastq"
        assert (tmp_path / name).read_bytes() == \
            (GOLDEN / "fasta_in_paired_k15" / name).read_bytes()


def test_mode_b_cli_reproduces_the_golden_importing_no_jax(tmp_path):
    check_golden_without_jax(tmp_path, "direct")


# ----------------------------------------------------------------------
# checkpoints

def check_checkpoints(tmp_path, table, k, slots: int):
    """Mode B on 4 devices, interrupted after its third retire, leaves one
    whole-table state that the JAX loader reads and that the port's
    one-device engine and the JAX engine each resume to the bytes of an
    uninterrupted run; and a one-device checkpoint resumes in Mode B on 2
    devices to the same bytes."""
    from nomalise_kmers_multi_large_tpu.engine.pipeline import (
        Normalizer as RefNormalizer,
    )

    inputs = _inputs(tmp_path, 400, True)

    def kw(sub, **more):
        return _kw(tmp_path, sub, inputs, ksize=k, table=table, **more)

    full_kw = kw("full")
    full = quiet(one_device(full_kw).run)
    want = _outputs(full_kw)
    resumers = {
        "port": lambda c: one_device(c),
        "jax": lambda c: RefNormalizer(RefConfig(**c)),
        "mode_b": lambda c: mode_b(c, 2),
    }
    for first, then in ((4, "port"), (4, "jax"), (1, "mode_b")):
        ck = dict(checkpoint_every=1,
                  checkpoint_dir=str(tmp_path / f"ck{first}{then}"))
        part = kw(f"from{first}{then}", **ck)
        cls = MeshNormalizer if first > 1 else Normalizer
        quiet(lambda: _interrupt(
            cls, mode_b(part, first) if first > 1 else one_device(part), 3))
        z = np.load(tmp_path / f"ck{first}{then}" / "shard0.npz")
        assert z["counts"].ndim == 1 and z["counts"].shape[0] >= slots
        manifest = json.loads((tmp_path / f"ck{first}{then}"
                               / "manifest.json").read_text())
        assert manifest["seeded_lo"] == (table == "direct")
        states, resume = RefManager(RefConfig(**part)).load()
        assert len(states) == 1 and resume.records_done == 2 * 128
        again = dict(part, resume=True)
        rep = quiet(resumers[then](again).run)
        assert _totals(rep) == _totals(full)
        assert _outputs(part) == want
    assert 0 < full.total_printed < full.total_processed


def test_mode_b_checkpoints_cross_with_one_device_and_jax(tmp_path):
    check_checkpoints(tmp_path, "direct", 11, 4 ** 11)


# ----------------------------------------------------------------------
# the descriptor

def seeded_direct(rng, k, n):
    """A RangeShardedDirectTable on n CPU devices with random counts, the
    same whole state on one device, and a seed set (sorted codes, some
    counted, some not)."""
    t = RangeShardedDirectTable(DirectTable(k), [CPU] * n)
    whole = DirectTable(k).init()
    hit = rng.integers(1, 4 ** k, size=300)
    whole.counts[torch.from_numpy(hit)] = torch.from_numpy(
        rng.integers(1, 9, size=300, dtype=np.int32))
    seeds = np.unique(np.concatenate([hit[:50], rng.integers(
        1, 4 ** k, size=80)])).astype(np.uint32)
    return t, t.split(whole), whole, seeds


@pytest.mark.parametrize("n", [2, 4, 8])
def test_direct_shards_gather_split_and_export(n):
    rng = np.random.default_rng(n)
    t, st, whole, seeds = seeded_direct(rng, 8, n)
    one = DirectTable(8)
    assert torch.equal(t.gather(st, "cpu").counts, whole.counts)
    for j, c in enumerate(st.counts):
        span = 4 ** 8 // n
        assert torch.equal(c, whole.counts[j * span:(j + 1) * span])
    codes = torch.arange(4 ** 8)
    assert torch.equal(t.owner(codes), codes // (4 ** 8 // n))
    for s in (None, seeds):
        assert t.used_count(st, s) == one.used_count(whole, s)
        for a, b in zip(t.export(st, s), one.export(whole, s)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("table", ["direct", "auto"])
def test_mode_b_refuses_a_device_count_not_a_power_of_two(table):
    kw = dict(forward_files=("x.fq",), reverse_files=("y.fq",), ksize=11,
              sharding="global", table=table, depth=200000)
    with pytest.raises(ConfigError, match="direct needs a power-of-two"):
        MeshNormalizer(Config(**kw), [CPU] * 3)
