"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each source ``csrc/<name>.cu`` exports a plain ``extern "C"`` interface
(pointers, ints and the stream; the return value is ``cudaGetLastError()``),
so it compiles in seconds without PyTorch's headers.  The library is built
at first use into ``_build/`` beside the package (listed in ``.gitignore``),
named by a hash of its source and flags so an edited source never loads a
stale build.  A missing CUDA toolkit raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, spills) of each library built by this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc "
                           "on PATH): the port's kernels cannot be built")
    nvcc = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found under CUDA_HOME={CUDA_HOME}")
    return str(nvcc)


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc build (None when the library is already built)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build(*names: str) -> None:
    """Compile the named kernels, one nvcc process each, all at once."""
    with _LOCK:
        jobs = {n: _start(n) for n in names if n not in _LIBS}
        for n, job in jobs.items():
            _finish(n, job)


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use;
    ``bind(lib)`` declares its entry points' ctypes signatures once, when
    the library is loaded."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                bind(lib)
                _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
