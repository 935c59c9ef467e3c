"""Host-side pipeline prefetch.

The reference overlaps nothing on the host: each pthread frames, counts and
writes serially (normalise_kmers_multi_large.c:1568-1770). Here host framing
and packing would serialize with device compute, so this wrapper runs the
produce stage (mmap framing + native packing) on a worker thread with a
bounded queue: the consumer overlaps it with device dispatch and wait (which
release the GIL), the classic data-loader double buffer. The port's copy of
nomalise_kmers_multi_large_tpu/utils/prefetch.py.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class PrefetchIterator(Iterator[T]):
    """Iterate `src` on a daemon worker thread, `depth` items ahead.

    Exceptions raised by the producer re-raise in the consumer at the point
    of next(). close() stops the worker promptly (used on early exit)."""

    def __init__(self, src: Iterable[T], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: BaseException | None = None

        def work():
            try:
                for item in src:
                    while True:
                        if self._stop.is_set():
                            return
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001 — propagated to consumer
                self._exc = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(_DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _DONE:
            self._t.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so the worker's pending put unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5)
