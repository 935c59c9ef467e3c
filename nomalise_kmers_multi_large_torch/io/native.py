"""ctypes bindings for the native host-IO fast path (_fastx.c).

The shared object is built on first use with the system compiler into the
package's git-ignored ``_build/`` directory, and rebuilt when the source is
newer. Set NKML_NO_NATIVE=1 to force the numpy fallback (tests run both and
compare).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_fastx.c")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "_fastx.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    cc = sysconfig.get_config_var("CC") or "cc"
    cc = cc.split()[0]
    tmp = tempfile.mktemp(suffix=".so", dir=_BUILD)
    cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC]
    cmd_portable = [cc, "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            # cross/odd toolchains may reject -march=native
            subprocess.run(cmd_portable, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return _SO
    except (subprocess.CalledProcessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("NKML_NO_NATIVE") == "1":
        return None
    so = _SO if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC) else _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    c_i64 = ctypes.c_longlong
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.fastx_frame_win.restype = c_i64
    lib.fastx_frame_win.argtypes = [
        u8p, c_i64, c_i64, c_i64, ctypes.c_int, c_i64, i64p,
        ctypes.POINTER(c_i64), ctypes.c_int,
    ]
    lib.fastx_pack_mt.restype = c_i64
    lib.fastx_pack_mt.argtypes = [
        u8p, c_i64, i64p, i64p, c_i64, c_i64, c_i64, u8p, i32p, ctypes.c_int,
    ]
    lib.fastx_emit.restype = c_i64
    lib.fastx_emit.argtypes = [u8p, i64p, u8p, c_i64, u8p, c_i64]
    _lib = lib
    return _lib


def default_threads() -> int:
    """IO worker threads: NKMT_IO_THREADS overrides; else all cores (the
    ctypes calls release the GIL, so the C pool scales past one core even
    under a Python prefetch thread)."""
    env = os.environ.get("NKMT_IO_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, os.cpu_count() or 1)


# ----------------------------------------------------------------------
def frame(data: np.ndarray, start: int, lines_per_record: int,
          max_records: int, threads: int = 0, scan_end: int = -1):
    """Returns (cols int64 [n, 6], next_start) or None if native unavailable.

    threads > 1 parallelizes the newline index (count + fill passes) across
    a per-call pthread pool; 0 = default_threads(). scan_end bounds the scan
    window for streaming callers (records crossing it are left for the next
    call); -1 = end of buffer."""
    lib = get_lib()
    if lib is None:
        return None
    cols = np.empty((max_records, 6), np.int64)
    nxt = ctypes.c_longlong(0)
    n = lib.fastx_frame_win(
        np.ascontiguousarray(data), data.shape[0], start,
        scan_end if scan_end >= 0 else data.shape[0], lines_per_record,
        max_records, cols, ctypes.byref(nxt),
        threads if threads > 0 else default_threads(),
    )
    if n < 0:
        return None  # allocation failure: caller falls back to numpy
    return cols[:n], int(nxt.value)


def pack(data: np.ndarray, starts: np.ndarray, lens: np.ndarray, pad: int,
         min_len: int, threads: int = 0):
    """Returns (bases u8 [n, pad], lengths i32 [n]) or None; raises on bad DNA."""
    lib = get_lib()
    if lib is None:
        return None
    n = starts.shape[0]
    bases = np.empty((n, pad), np.uint8)
    lengths = np.empty(n, np.int32)
    rc = lib.fastx_pack_mt(
        np.ascontiguousarray(data), data.shape[0],
        np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(lens, np.int64),
        n, pad, min_len, bases, lengths,
        threads if threads > 0 else default_threads(),
    )
    if rc < 0:
        row = -int(rc) - 1
        from nomalise_kmers_multi_large_torch.io.pack import InvalidSequenceError

        seq = bytes(data[starts[row]: starts[row] + lens[row]])
        raise InvalidSequenceError(
            f"FATAL: sequence does not appear to be a DNA sequence\n"
            f"{seq.decode(errors='replace')}"
        )
    return bases, lengths


def emit(data: np.ndarray, cols: np.ndarray, keep: np.ndarray) -> Optional[bytes]:
    """Assemble kept raw records (with N->A in seq lines) in one call."""
    lib = get_lib()
    if lib is None:
        return None
    kept = cols[keep.astype(bool)]
    cap = int((kept[:, 1] - kept[:, 0]).sum()) if kept.size else 0
    out = np.empty(cap, np.uint8)
    w = lib.fastx_emit(
        np.ascontiguousarray(data),
        np.ascontiguousarray(cols, np.int64),
        np.ascontiguousarray(keep.astype(np.uint8)),
        cols.shape[0], out, cap,
    )
    if w < 0:
        return None
    return out[:w].tobytes()
