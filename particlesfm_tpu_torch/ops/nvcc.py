"""Builds the port's CUDA kernel sources (`csrc/*.cu`, plain C interfaces)
into shared libraries for sm_90a and loads them with ctypes (`load`).

A library is built the first time its wrapper meets a CUDA tensor, into
`_build/` beside the sources; its file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is built once
per checkout. nvcc's `-Xptxas -v` report (registers, shared memory, spills)
is kept beside the library as `<name>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_libs = {}              # source -> its loaded library
_libs_lock = threading.Lock()


def build_library(source: Path, flags=()) -> Path:
    """Compile `source` with nvcc into BUILD_DIR; returns the library's path."""
    from torch.utils.cpp_extension import CUDA_HOME

    key = source.read_bytes() + "\0".join(flags).encode()
    so = BUILD_DIR / f"{source.stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if so.exists():
        return so
    if CUDA_HOME is None:
        raise RuntimeError(f"{source.stem}: no CUDA toolkit found to build the kernel")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"),
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", *flags,
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{source.stem}: nvcc failed:\n{res.stdout}\n{res.stderr}")
    (BUILD_DIR / (so.stem + ".log")).write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def load(source: Path, symbol: str, argtypes, flags=()) -> ctypes.CDLL:
    """Build (first use) and load `source`'s library, once per process; its
    launch function `symbol` takes `argtypes` and returns a cudaError code."""
    with _libs_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source, flags)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[source] = lib
    return lib
