"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the repository root (a directory
git ignores), then loaded with ``ctypes``.  The library's file name carries
a digest of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  Nothing happens at import: a kernel is built
the first time its wrapper launches it, or up front, all sources in
parallel, by ``build_all()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..errors import KernelError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signature of every entry point: argument types; each returns a
# cudaError_t: cudaGetLastError() after its launch (fphash_host_cuda: then
# its stream's synchronisation; fphash_host_map: the driver's mapping).
SIGNATURES = {
    "chunker": {
        "boundary_bitmap_cuda": (_P, _I64, _P, ctypes.c_int,
                                 ctypes.c_uint32, ctypes.c_uint32, _P),
    },
    "fphash": {
        "fphash_many_cuda": (_P, _P, _P, _I64, _P, _P),
        "fphash_one_cuda": (_P, _I64, _P, _P),
        "fphash_host_map": (_P, ctypes.c_int, _P),
        "fphash_host_cuda": (_P, _I64, _P, ctypes.c_int, _P),
    },
}

SOURCES = tuple(SIGNATURES)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelError("nvcc not found: the CUDA kernels need the CUDA "
                          "toolkit (nvcc on PATH or under /usr/local/cuda)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def log_path(name: str) -> Path:
    """The nvcc log of the library ``library_path(name)``, kept beside it."""
    return library_path(name).with_suffix(".log")


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for one source unless its library and log are already
    built."""
    out = library_path(name)
    if out.exists() and log_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> str:
    out, tmp, proc = job
    log, _ = proc.communicate()
    log_path(name).write_text(log)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent build never sees half
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source at once (one nvcc each, started
    together) and return the compiler log of each library, read back from
    its build when it was built already."""
    jobs = {name: _start(name) for name in names}
    return {name: (_finish(name, job) if job is not None
                   else log_path(name).read_text())
            for name, job in jobs.items()}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        cdll = _libs.get(name)
        if cdll is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            cdll = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(cdll, fn).argtypes = list(argtypes)
                getattr(cdll, fn).restype = ctypes.c_int
            _libs[name] = cdll
        return cdll


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")
