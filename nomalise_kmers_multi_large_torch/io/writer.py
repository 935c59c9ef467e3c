"""Per-shard output writers.

Reproduces the reference's output layer (L6): per-thread output files opened once
and shared across all input files (main normalise_kmers_multi_large.c:2283-2303),
reference file naming ``{base}.k{k}_norm{depth_per_cpu}_thread{t}.{suffix}``
(``create_output_filename`` :834-850) with the suffix hard-coded to "fastq" even
for FASTA output (main :2286,:2296 — a verified reference quirk we match), and
``fastq_to_fasta`` header rewriting with /1 and /2 mate suffixes (:852-876).

Kept records are written by copying raw bytes out of the input memory map — the
same zero-reformat strategy the reference gets from fprintf'ing its line buffers.

Intentional divergence: the reference's single-end fq->fa path builds the FASTA
string but never writes it (:1995-1999, a verified bug producing empty output);
we write it.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from nomalise_kmers_multi_large_torch.io.reader import FastxFile, RecordColumns


def output_filename(basename: str, k: int, norm_depth: int, shard: int,
                    suffix: str = "fastq") -> str:
    """create_output_filename (:834-850); shard < 0 omits the _thread part."""
    if shard >= 0:
        return f"{basename}.k{k}_norm{norm_depth}_thread{shard}.{suffix}"
    return f"{basename}.k{k}_norm{norm_depth}.{suffix}"


def _fasta_record(data: np.ndarray, hdr_start: int, hdr_len: int,
                  seq_start: int, seq_len: int, is_forward: bool) -> bytes:
    """fastq_to_fasta (:852-876): '@hdr' -> '>hdr', append /1 or /2 if absent."""
    suffix = b"/1" if is_forward else b"/2"
    hdr = bytes(data[hdr_start: hdr_start + hdr_len])
    hdr = b">" + hdr[1:]
    if len(hdr) < 2 or hdr[-2:] != suffix:
        hdr += suffix
    seq = bytes(data[seq_start: seq_start + seq_len]).replace(b"N", b"A")
    return hdr + b"\n" + seq + b"\n"


class ShardWriter:
    """Output files of one shard ("thread"), living for the whole run."""

    def __init__(self, cfg, shard: int, out_dir: Optional[str] = None,
                 resume_sizes: Optional[dict] = None):
        self.cfg = cfg
        self.shard = shard
        out_dir = out_dir if out_dir is not None else cfg.out_dir
        os.makedirs(out_dir, exist_ok=True)
        k, d = cfg.ksize, cfg.depth_per_shard
        # suffix is always "fastq" (reference quirk, main :2286)
        self.fwd_path = os.path.join(out_dir, output_filename("output_forward", k, d, shard))
        self.fwd = self._open(self.fwd_path, resume_sizes)
        self.rev_path = None
        self.rev = None
        if cfg.reverse_files:
            self.rev_path = os.path.join(out_dir, output_filename("output_reverse", k, d, shard))
            self.rev = self._open(self.rev_path, resume_sizes)
        self._fq_to_fa = cfg.is_input_fastq and not cfg.is_output_fastq

    @staticmethod
    def _open(path: str, resume_sizes: Optional[dict]):
        """Fresh run truncates; resume truncates to the checkpointed byte size
        (dropping records written after the snapshot) and appends."""
        if resume_sizes is not None and os.path.exists(path):
            f = open(path, "r+b")
            f.truncate(resume_sizes.get(path, 0))
            f.seek(0, os.SEEK_END)
            return f
        return open(path, "wb")

    def paths(self) -> list[str]:
        return [p for p in (self.fwd_path, self.rev_path) if p]

    def flush(self):
        self.fwd.flush()
        if self.rev:
            self.rev.flush()

    # ------------------------------------------------------------------
    def _write_one(self, out, data: np.ndarray, cols: RecordColumns, i: int,
                   is_forward: bool):
        if self._fq_to_fa:
            out.write(
                _fasta_record(
                    data,
                    int(cols.hdr_start[i]), int(cols.hdr_len[i]),
                    int(cols.seq_start[i]), int(cols.seq_len[i]),
                    is_forward,
                )
            )
        else:
            # the reference's replacestr rewrites N->A IN the record buffer before
            # validation (:1406,:1426-1427), so its output carries the rewrite in
            # the sequence line (headers/quality untouched)
            rec_start, rec_end = int(cols.rec_start[i]), int(cols.rec_end[i])
            seq_start = int(cols.seq_start[i])
            seq_end = seq_start + int(cols.seq_len[i])
            seq = bytes(data[seq_start:seq_end])
            if b"N" in seq:
                out.write(bytes(data[rec_start:seq_start]))
                out.write(seq.replace(b"N", b"A"))
                out.write(bytes(data[seq_end:rec_end]))
            else:
                out.write(bytes(data[rec_start:rec_end]))

    @staticmethod
    def _cols_matrix(cols: RecordColumns) -> np.ndarray:
        return np.stack(
            [cols.rec_start, cols.rec_end, cols.hdr_start, cols.hdr_len,
             cols.seq_start, cols.seq_len], axis=1,
        ).astype(np.int64)

    def write_kept(self, batch, keep: np.ndarray):
        """Write every kept record of a RecordBatch, preserving input order."""
        idx = np.flatnonzero(keep)
        if idx.size == 0:
            return
        if not self._fq_to_fa:
            # native batch assembly (one memcpy pass + one write syscall)
            from nomalise_kmers_multi_large_torch.io import native

            blob = native.emit(batch.fwd_file.data, self._cols_matrix(batch.fwd), keep)
            if blob is not None:
                self.fwd.write(blob)
                if batch.rev is not None and self.rev is not None:
                    rblob = native.emit(
                        batch.rev_file.data, self._cols_matrix(batch.rev), keep
                    )
                    self.rev.write(rblob)
                return
        fdata = batch.fwd_file.data
        for i in idx:
            self._write_one(self.fwd, fdata, batch.fwd, int(i), True)
        if batch.rev is not None and self.rev is not None:
            rdata = batch.rev_file.data
            for i in idx:
                self._write_one(self.rev, rdata, batch.rev, int(i), False)

    def close(self):
        self.fwd.close()
        if self.rev:
            self.rev.close()
