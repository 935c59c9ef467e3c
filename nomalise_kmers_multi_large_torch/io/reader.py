"""Streaming FASTQ/FASTA record framing over memory-mapped input.

Host-side analogue of the reference's input layer (``mmap_file``
normalise_kmers_multi_large.c:424-461, ``read_line`` :394-409, 4-lines-per-FASTQ /
2-lines-per-FASTA record framing :1572,:1925). Framing is vectorized: newline
positions come from one ``np.flatnonzero`` sweep per chunk, grouped
lines-per-record at a time, so the host keeps up with the device instead of
walking bytes one at a time.

The reference's thread-chunk splitting (``calculate_thread_positions`` :1240-1300)
has no analogue here: batches are cut record-wise on the host and sharded across
devices by the engine, which is both simpler and exact (no byte-boundary
back-scanning needed).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

_CHUNK = 64 << 20  # bytes per framing sweep


class InputFormatError(ValueError):
    pass


@dataclasses.dataclass
class RecordColumns:
    """Byte geometry of a block of records (absolute file offsets)."""

    rec_start: np.ndarray  # int64 [n]
    rec_end: np.ndarray    # int64 [n] one past the final newline
    hdr_start: np.ndarray  # int64 [n]
    hdr_len: np.ndarray    # int64 [n]
    seq_start: np.ndarray  # int64 [n]
    seq_len: np.ndarray    # int64 [n]

    def __len__(self):
        return self.rec_start.shape[0]

    @staticmethod
    def concat(blocks: list["RecordColumns"]) -> "RecordColumns":
        return RecordColumns(
            *(np.concatenate([getattr(b, f.name) for b in blocks])
              for f in dataclasses.fields(RecordColumns))
        )

    def slice(self, lo: int, hi: int) -> "RecordColumns":
        return RecordColumns(
            *(getattr(self, f.name)[lo:hi] for f in dataclasses.fields(RecordColumns))
        )


class FastxFile:
    """One memory-mapped FASTQ/FASTA input file with streaming record framing."""

    def __init__(self, path: str, fastq: bool, io_threads: int = 0):
        self.path = path
        self.fastq = fastq
        self.lines_per_record = 4 if fastq else 2
        self.io_threads = io_threads  # 0 = native.default_threads()
        self.data: np.ndarray = np.memmap(path, np.uint8, "r")
        self.size = int(self.data.shape[0])
        # magic-byte check (reference main :2336-2346)
        first = chr(self.data[0]) if self.size else ""
        want = "@" if fastq else ">"
        if first != want:
            kind = "FASTQ" if fastq else "FASTA"
            raise InputFormatError(
                f"Input {kind} file {path} starts with {first!r} which is not expected"
            )

    def record_blocks(self, chunk_bytes: int = _CHUNK) -> Iterator[RecordColumns]:
        """Yield blocks of complete records in file order.

        Uses the native multi-threaded framer (io/_fastx.c fastx_frame_win:
        parallel newline index + arithmetic column build) when available;
        the numpy sweep below is the portable fallback and differential
        oracle (tests/test_native.py)."""
        from nomalise_kmers_multi_large_torch.io import native

        if native.get_lib() is not None:
            yield from self._record_blocks_native(chunk_bytes)
            return
        yield from self._record_blocks_numpy(chunk_bytes)

    def _record_blocks_native(self, chunk_bytes: int) -> Iterator[RecordColumns]:
        from nomalise_kmers_multi_large_torch.io import native

        lpr = self.lines_per_record
        pos = 0
        window = chunk_bytes
        while pos < self.size:
            scan_end = min(pos + window, self.size)
            # record-count cap only bounds the cols buffer; a saturated call
            # simply resumes from next_start on the next loop iteration
            max_records = min(chunk_bytes // 128 + 16, 1 << 20)
            got = native.frame(self.data, pos, lpr, max_records,
                               threads=self.io_threads, scan_end=scan_end)
            if got is None:  # native lost mid-stream (alloc failure)
                yield from self._record_blocks_numpy(chunk_bytes, start=pos)
                return
            cols, nxt = got
            if len(cols):
                # one contiguous copy releases the oversized frame buffer;
                # the yielded columns are views into it
                cols = cols.copy()
                yield RecordColumns(
                    rec_start=cols[:, 0], rec_end=cols[:, 1],
                    hdr_start=cols[:, 2], hdr_len=cols[:, 3],
                    seq_start=cols[:, 4], seq_len=cols[:, 5],
                )
                pos = nxt
                window = chunk_bytes
            elif scan_end >= self.size:
                return  # trailing partial record: unframed (numpy path too)
            else:
                window *= 2  # a record crosses the window; widen and retry

    def _record_blocks_numpy(self, chunk_bytes: int,
                             start: int = 0) -> Iterator[RecordColumns]:
        lpr = self.lines_per_record
        pos = start
        carry = np.empty(0, np.int64)  # newline offsets not yet forming a record
        boundary = start  # start offset of the next unframed record
        while pos < self.size:
            end = min(pos + chunk_bytes, self.size)
            nl = np.flatnonzero(self.data[pos:end] == 10).astype(np.int64) + pos
            if end == self.size and (self.size == 0 or self.data[self.size - 1] != 10):
                # treat EOF as an implicit final newline (reference read_line stops
                # at NUL, which mmap zero-fill provides past EOF)
                nl = np.append(nl, np.int64(self.size))
            allnl = np.concatenate([carry, nl]) if carry.size else nl
            nrec = allnl.shape[0] // lpr
            if nrec:
                m = allnl[: nrec * lpr].reshape(nrec, lpr)
                rec_start = np.empty(nrec, np.int64)
                rec_start[0] = boundary
                rec_start[1:] = m[:-1, -1] + 1
                yield RecordColumns(
                    rec_start=rec_start,
                    # clamp: the implicit EOF newline is not a real byte
                    rec_end=np.minimum(m[:, -1] + 1, self.size),
                    hdr_start=rec_start,
                    hdr_len=m[:, 0] - rec_start,
                    seq_start=m[:, 0] + 1,
                    seq_len=m[:, 1] - m[:, 0] - 1,
                )
                boundary = int(m[-1, -1]) + 1
                carry = allnl[nrec * lpr:]
            else:
                carry = allnl
            pos = end


class BufferedRecords:
    """Pull-based adapter over `record_blocks` serving exactly-n record slices."""

    def __init__(self, f: FastxFile):
        self.file = f
        self._it = f.record_blocks()
        self._buf: Optional[RecordColumns] = None
        self._off = 0

    def take(self, n: int) -> RecordColumns:
        """Return up to n records (fewer only at EOF)."""
        got: list[RecordColumns] = []
        need = n
        while need > 0:
            if self._buf is None or self._off >= len(self._buf):
                try:
                    self._buf = next(self._it)
                    self._off = 0
                except StopIteration:
                    break
            take = min(need, len(self._buf) - self._off)
            got.append(self._buf.slice(self._off, self._off + take))
            self._off += take
            need -= take
        if not got:
            return RecordColumns(*(np.empty(0, np.int64) for _ in range(6)))
        return got[0] if len(got) == 1 else RecordColumns.concat(got)


@dataclasses.dataclass
class RecordBatch:
    """One host batch, ready for packing and (after the device step) writing."""

    fwd_file: FastxFile
    fwd: RecordColumns
    rev_file: Optional[FastxFile] = None
    rev: Optional[RecordColumns] = None

    def __len__(self):
        return len(self.fwd)


def batch_iterator(f: FastxFile, batch: int) -> Iterator[RecordBatch]:
    buf = BufferedRecords(f)
    while True:
        cols = buf.take(batch)
        if len(cols) == 0:
            return
        yield RecordBatch(fwd_file=f, fwd=cols)


def paired_batch_iterator(
    fwd: FastxFile, rev: FastxFile, batch: int
) -> Iterator[RecordBatch]:
    """Lockstep pairing; stops at the shorter file (reference while-condition
    :1605-1606 stops when either mmap range is exhausted)."""
    bf, br = BufferedRecords(fwd), BufferedRecords(rev)
    while True:
        cf = bf.take(batch)
        cr = br.take(batch)
        n = min(len(cf), len(cr))
        if n == 0:
            return
        yield RecordBatch(
            fwd_file=fwd, fwd=cf.slice(0, n), rev_file=rev, rev=cr.slice(0, n)
        )
