"""The port's copy of the host layer (io/) against the JAX package's io/:
the same record frames, batches, packed bases and output bytes, on
tests/data and on a synthetic FASTQ pair made from a numpy seed, both with
the native C path and with the numpy fallback (NKML_NO_NATIVE=1)."""
import dataclasses
import pathlib

import numpy as np
import pytest

from nomalise_kmers_multi_large_torch.config import Config
from nomalise_kmers_multi_large_torch.io import native, pack, reader, writer
from nomalise_kmers_multi_large_tpu.config import Config as RefConfig
from nomalise_kmers_multi_large_tpu.io import native as ref_native
from nomalise_kmers_multi_large_tpu.io import pack as ref_pack
from nomalise_kmers_multi_large_tpu.io import reader as ref_reader
from nomalise_kmers_multi_large_tpu.io import writer as ref_writer

DATA = pathlib.Path(__file__).resolve().parent / "data"
COLS = [f.name for f in dataclasses.fields(reader.RecordColumns)]


@pytest.fixture(params=["native", "numpy"])
def io_mode(request, monkeypatch):
    """Both packages' native layers on, or both forced to numpy."""
    for mod in (native, ref_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    if request.param == "numpy":
        monkeypatch.setenv("NKML_NO_NATIVE", "1")
        assert native.get_lib() is None and ref_native.get_lib() is None
    else:
        monkeypatch.delenv("NKML_NO_NATIVE", raising=False)
        assert native.get_lib() is not None
        assert ref_native.get_lib() is not None
    return request.param


def _synthetic_pair(tmp_path, n=3000, seed=7):
    """Paired FASTQ with ragged lengths, N bases, headers with and without
    mate suffixes, and no newline at the end of the second file."""
    rng = np.random.default_rng(seed)
    paths = []
    for mate in (1, 2):
        recs = []
        for i in range(n):
            length = int(rng.integers(10, 220))
            seq = np.frombuffer(b"ACGTN", np.uint8)[
                rng.choice(5, size=length, p=[.24, .24, .24, .24, .04])]
            hdr = f"@read{i}" + (f"/{mate}" if i % 3 else " extra")
            recs.append(f"{hdr}\n{seq.tobytes().decode()}\n+\n"
                        f"{'I' * length}\n")
        text = "".join(recs)
        if mate == 2:
            text = text[:-1]
        path = tmp_path / f"s{mate}.fq"
        path.write_text(text)
        paths.append(str(path))
    return paths


def _inputs(tmp_path):
    s1, s2 = _synthetic_pair(tmp_path)
    return [(str(DATA / "a1.fasta"), str(DATA / "b1.fasta"), False),
            (s1, s2, True)]


def _cols_equal(a, b):
    for name in COLS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("chunk", [64, 1 << 16, 64 << 20])
def test_record_frames_match_jax_io(tmp_path, io_mode, chunk):
    for f1, f2, fastq in _inputs(tmp_path):
        for path in (f1, f2):
            got = reader.RecordColumns.concat(list(
                reader.FastxFile(path, fastq).record_blocks(chunk)))
            want = ref_reader.RecordColumns.concat(list(
                ref_reader.FastxFile(path, fastq).record_blocks(chunk)))
            assert len(got) > 1000
            _cols_equal(got, want)


@pytest.mark.parametrize("batch", [64, 777, 8192])
def test_paired_batches_and_packing_match_jax_io(tmp_path, io_mode, batch):
    for f1, f2, fastq in _inputs(tmp_path):
        got = reader.paired_batch_iterator(
            reader.FastxFile(f1, fastq), reader.FastxFile(f2, fastq), batch)
        want = ref_reader.paired_batch_iterator(
            ref_reader.FastxFile(f1, fastq), ref_reader.FastxFile(f2, fastq),
            batch)
        n_batches = 0
        for g, w in zip(got, want, strict=True):
            n_batches += 1
            for side in ("fwd", "rev"):
                gc, wc = getattr(g, side), getattr(w, side)
                _cols_equal(gc, wc)
                data = getattr(g, side + "_file").data
                pad = int(max(gc.seq_len.max(), 15))
                gb, gl = pack.pack_batch(data, gc.seq_start, gc.seq_len, pad,
                                         15)
                wb, wl = ref_pack.pack_batch(data, wc.seq_start, wc.seq_len,
                                             pad, 15)
                np.testing.assert_array_equal(gb, wb)
                np.testing.assert_array_equal(gl, wl)
        assert n_batches >= 1


def test_single_batches_match_jax_io(tmp_path, io_mode):
    for f1, _, fastq in _inputs(tmp_path):
        got = list(reader.batch_iterator(reader.FastxFile(f1, fastq), 1000))
        want = list(ref_reader.batch_iterator(
            ref_reader.FastxFile(f1, fastq), 1000))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _cols_equal(g.fwd, w.fwd)


def test_invalid_dna_raises_like_jax_io(tmp_path, io_mode):
    p = tmp_path / "bad.fq"
    p.write_bytes(b"@r\nACGTXACGTACGTACGT\n+\nFFFFFFFFFFFFFFFFF\n")
    cols = next(reader.FastxFile(str(p), True).record_blocks())
    with pytest.raises(pack.InvalidSequenceError, match="DNA"):
        pack.pack_batch(reader.FastxFile(str(p), True).data, cols.seq_start,
                        cols.seq_len, 32, 15)
    with pytest.raises(ref_pack.InvalidSequenceError, match="DNA"):
        ref_pack.pack_batch(ref_reader.FastxFile(str(p), True).data,
                            cols.seq_start, cols.seq_len, 32, 15)


@pytest.mark.parametrize("outformat", ["fq", "fa"])
def test_writers_match_jax_io(tmp_path, io_mode, outformat):
    for f1, f2, fastq in _inputs(tmp_path):
        if not fastq and outformat == "fq":
            continue  # FASTA in, FASTQ out is a config error
        outs = {}
        for label, cls, rd, wr in (("port", Config, reader, writer),
                                   ("ref", RefConfig, ref_reader,
                                    ref_writer)):
            out = tmp_path / f"{label}_{pathlib.Path(f1).stem}_{outformat}"
            cfg = cls(forward_files=(f1,), reverse_files=(f2,), ksize=15,
                      depth=4, informat="fq" if fastq else "fa",
                      outformat=outformat, out_dir=str(out))
            w = wr.ShardWriter(cfg, 0)
            for b in rd.paired_batch_iterator(rd.FastxFile(f1, fastq),
                                              rd.FastxFile(f2, fastq), 700):
                w.write_kept(b, np.random.default_rng(len(b)).random(
                    len(b)) < 0.6)
            w.close()
            outs[label] = [pathlib.Path(p).read_bytes() for p in w.paths()]
            assert [pathlib.Path(p).name for p in w.paths()] == [
                wr.output_filename("output_forward", 15, 4, 0),
                wr.output_filename("output_reverse", 15, 4, 0)]
        assert outs["port"] == outs["ref"]
        assert all(len(x) > 1000 for x in outs["port"])
