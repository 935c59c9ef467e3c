"""Several host processes in the port (parallel/multihost.py), for real: two
OS processes join a gloo process group through torchrun's variables
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), each runs the port's CLI over
its share of two file pairs (assign_files), and the totals are summed over
both. The aggregated totals equal the sum of single-process runs on each
pair, and each process's output files equal its single run's, byte for
byte. Then the int64 aggregate: totals past 2^31 survive. The pattern of
tests/test_multihost.py, on tests/data."""
import os
import pathlib
import re
import socket
import subprocess
import sys

import torch

from nomalise_kmers_multi_large_torch import cli
from nomalise_kmers_multi_large_torch.engine.report import RunReport
from nomalise_kmers_multi_large_torch.parallel import multihost
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
RECORDS = 400


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pairs(tmp_path):
    """Two file pairs: records [0, 400) and [400, 800) of a1/b1."""
    files = {}
    for name in ("a1", "b1"):
        lines = (DATA / f"{name}.fasta").read_text().splitlines(True)
        for part in range(2):
            path = tmp_path / f"{name}_{part}.fa"
            lo = 2 * RECORDS * part
            path.write_text("".join(lines[lo:lo + 2 * RECORDS]))
            files[name, part] = str(path)
    return files


def _args(fwd, rev, out):
    return ["-f", *fwd, "-r", *rev, "-t", "fa", "-o", "fa", "-k", "13",
            "-d", "3", "--device", "cpu", "--out-dir", str(out)]


def test_two_processes_aggregate_to_the_sum_of_single_runs(tmp_path,
                                                           capsys):
    files = _pairs(tmp_path)
    fwd = [files["a1", 0], files["a1", 1]]
    rev = [files["b1", 0], files["b1", 1]]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": f"{ROOT}:{os.environ.get('PYTHONPATH', '')}"}
    code = ("import sys; from nomalise_kmers_multi_large_torch import cli; "
            "sys.exit(cli.main(sys.argv[1:]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *_args(fwd, rev, tmp_path / f"p{r}")],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    # process r took pair r (round robin), and only rank 0 reports the sum
    assert "file pair 1 of 1: " + files["a1", 0] in logs[0]
    assert "file pair 1 of 1: " + files["a1", 1] in logs[1]
    assert "Aggregated over" not in logs[1]
    got = re.search(r"Aggregated over 2 processes: Processed ([\d,]+), "
                    r"Printed ([\d,]+), Skipped ([\d,]+), Max unique kmers "
                    r"in a process: ([\d,]+)", logs[0])
    got = [int(x.replace(",", "")) for x in got.groups()]

    want = [0, 0, 0, 0]
    for part in range(2):
        out = tmp_path / f"solo{part}"
        assert cli.main(_args([fwd[part]], [rev[part]], out)) == 0
        text = capsys.readouterr().out
        vals = [int(re.search(rf"{p}: ([\d,]+)", text).group(1)
                    .replace(",", ""))
                for p in ("Processed Records", "Printed Records",
                          "Skipped Records",
                          "Cumulative Max unique kmers in any thread")]
        want = [a + b for a, b in zip(want[:3], vals[:3])] + \
            [max(want[3], vals[3])]
        names = sorted(p.name for p in out.glob("output_*"))
        assert names == sorted(p.name for p in
                               (tmp_path / f"p{part}").glob("output_*"))
        for name in names:
            assert (out / name).read_bytes() == \
                (tmp_path / f"p{part}" / name).read_bytes(), name
    assert got == want
    assert want[0] == 2 * RECORDS and 0 < want[1] < want[0]


def test_aggregate_report_is_int64_safe(monkeypatch):
    """Totals past 2^31 (the reference's flagship run processed
    2,987,923,777 records) and a unique count past 2^32, from two
    processes that report the same numbers."""
    monkeypatch.setattr(multihost.dist, "is_available", lambda: True)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 2)

    def all_gather(out, t):
        for o in out:
            o.copy_(t)

    monkeypatch.setattr(multihost.dist, "all_gather", all_gather)
    rep = RunReport()
    rep.total_processed = 2_987_923_777
    rep.total_printed = 352_574_553
    rep.total_skipped = rep.total_processed - rep.total_printed
    rep.max_total_kmers = 5_000_000_000
    out = multihost.aggregate_report(rep, paired=True)
    assert out.total_processed == 2 * 2_987_923_777
    assert out.total_printed == 2 * 352_574_553
    assert out.total_skipped == 2 * (2_987_923_777 - 352_574_553)
    assert out.max_total_kmers == 5_000_000_000


def test_one_process_is_unchanged(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.maybe_initialize() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert multihost.assign_files(("a", "b"), ("c", "d"), 0, 1) == \
        (("a", "b"), ("c", "d"))
    assert multihost.assign_files(("a", "b", "e"), ("c", "d"), 1, 2) == \
        (("b",), ("d",))
    rep = RunReport()
    rep.total_processed = 7
    assert multihost.aggregate_report(rep, paired=False).total_processed == 7
