"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library of its own, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds); one source may hold several
kernels (segscan.cu holds the narrow and the wide scan, bucket.cu K4 and
its check pass). Builds land in
``_build/<hash>/`` beside this file, keyed by a hash of the sources and
flags; the first kernel call of a process compiles every stale source, all
of them in parallel.

Every C entry point returns ``cudaGetLastError()`` after its launches and
``launch`` raises when that is not 0. Each successful launch adds one to the
kernel's count, which a run reads to show that its path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> its source in csrc/
KERNEL_SOURCES = {
    "encode_keys": "encode.cu",
    "rank_cand_scan": "segscan.cu",
    "bucket_overflow_check": "bucket.cu",
    "bucket_batch": "bucket.cu",
    "encode_keys_wide": "encode_wide.cu",
    "rank_cand_scan_wide": "segscan.cu",
    "bucket_overflow_check_wide": "bucket_wide.cu",
    "bucket_batch_wide": "bucket_wide.cu",
    "hashed_insert": "hashed.cu",
}

_launches = {name: 0 for name in KERNEL_SOURCES}
_libs: dict[str, ctypes.CDLL] = {}  # by source
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def launches() -> dict[str, int]:
    """Kernel launches per kernel since the last reset_launches()."""
    return dict(_launches)


def reset_launches():
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def build_dir() -> str:
    """Directory of the build keyed by the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _so_path(directory: str, source: str) -> str:
    return os.path.join(directory, os.path.splitext(source)[0] + ".so")


def build() -> dict[str, str]:
    """Compile every kernel source that has no current build, all nvcc
    processes started together. Returns {source: shared library path}.
    Each build's compiler output (ptxas: registers, shared memory and
    spills of each kernel) is kept beside its library (build_log)."""
    with _lock:
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        paths = {src: _so_path(out_dir, src)
                 for src in sorted(set(KERNEL_SOURCES.values()))}
        todo = [(src, so) for src, so in paths.items() if not os.path.exists(so)]
        if not todo:
            return paths
        nvcc = _nvcc()
        procs = []
        for src, so in todo:
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, src)]
            procs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, so, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src}:\n{log.decode(errors='replace')}")
            else:
                with open(os.path.splitext(so)[0] + ".log", "wb") as f:
                    f.write(log)
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        return paths


def build_log(source: str) -> str:
    """The compiler output of `source`'s current build (after build())."""
    path = os.path.splitext(_so_path(build_dir(), source))[0] + ".log"
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def function(kernel: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of `kernel`'s library (built on first
    use), with its argument types declared and an int return."""
    fn = _functions.get((kernel, symbol))
    if fn is None:
        src = KERNEL_SOURCES[kernel]
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build()[src])
            lib.nkm_error_string.argtypes = [ctypes.c_int]
            lib.nkm_error_string.restype = ctypes.c_char_p
            _libs[src] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(kernel, symbol)] = fn
    return fn


def launch(kernel: str, fn: ctypes._CFuncPtr, *args):
    """Call a C entry point; raise on a CUDA error, else count the launch."""
    rc = fn(*args)
    if rc != 0:
        msg = _libs[KERNEL_SOURCES[kernel]].nkm_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc}: {msg}")
    _launches[kernel] += 1


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
