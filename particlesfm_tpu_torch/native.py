"""ctypes bindings for the C++ host runtime native/hostops.cc
(port of particlesfm_tpu/native/__init__.py; the same library and the same
six entry points).

The library covers the irregular host-side loops of the SfM front end
(connected components, maximum spanning tree, MFAS ordering, observation
and pair-tensor packing, covisibility). It is built from native/hostops.cc
with native/Makefile at first use; when it cannot be built or loaded each
entry point returns None and its caller runs the numpy version instead.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_LIB_PATH = _NATIVE_DIR / "libparticlesfm_host.so"
_LOCK_PATH = _NATIVE_DIR / ".build.lock"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def ensure_built(force: bool = False) -> bool:
    """Compile the shared library if needed. Returns True when it exists.

    Safe across processes: one builder at a time (a lock file beside the
    library), each building in a directory of its own and renaming the
    finished library into place, so the library's path never names a
    half-written file."""
    if _LIB_PATH.exists() and not force:
        return True
    try:
        with open(_LOCK_PATH, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _LIB_PATH.exists() and not force:
                return True             # built while this process waited
            with tempfile.TemporaryDirectory(prefix=".build-", dir=_NATIVE_DIR) as tmp:
                for f in ("Makefile", "hostops.cc"):
                    shutil.copy2(_NATIVE_DIR / f, tmp)
                subprocess.run(["make", "-s", "-C", tmp], check=True,
                               capture_output=True, timeout=120)
                os.replace(Path(tmp) / _LIB_PATH.name, _LIB_PATH)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False
    return _LIB_PATH.exists()


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not ensure_built():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _load_failed = True
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.psfm_connected_components.restype = None
    lib.psfm_connected_components.argtypes = [ctypes.c_int32, ctypes.c_int64, i32p, i32p]
    lib.psfm_maximum_spanning_tree.restype = ctypes.c_int64
    lib.psfm_maximum_spanning_tree.argtypes = [ctypes.c_int32, ctypes.c_int64, i32p, f64p, i64p]
    lib.psfm_mfas_order.restype = None
    lib.psfm_mfas_order.argtypes = [ctypes.c_int32, ctypes.c_int64, i32p, f64p, i32p]
    lib.psfm_build_observations.restype = ctypes.c_int64
    lib.psfm_build_observations.argtypes = [
        ctypes.c_int64, ctypes.c_int32, u8p, f32p,
        ctypes.c_int32, ctypes.c_int32, i32p, f32p, u8p, i64p]
    lib.psfm_covisibility.restype = None
    lib.psfm_covisibility.argtypes = [ctypes.c_int64, ctypes.c_int32, u8p, i32p]
    lib.psfm_build_pair_tensors.restype = None
    lib.psfm_build_pair_tensors.argtypes = [
        ctypes.c_int64, ctypes.c_int32, u8p, f32p, ctypes.c_int32,
        ctypes.c_int64, i32p, i32p, i64p, f32p, f32p, u8p, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    return _get() is not None


def connected_components(num_nodes: int, edges: np.ndarray) -> Optional[np.ndarray]:
    lib = _get()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, np.int32)
    labels = np.empty(num_nodes, np.int32)
    lib.psfm_connected_components(num_nodes, len(edges), edges, labels)
    return labels


def maximum_spanning_tree(num_nodes: int, edges: np.ndarray, weights: np.ndarray):
    lib = _get()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, np.int32)
    weights = np.ascontiguousarray(weights, np.float64)
    chosen = np.empty(max(num_nodes - 1, 1), np.int64)
    k = lib.psfm_maximum_spanning_tree(num_nodes, len(edges), edges, weights, chosen)
    return chosen[:k]


def mfas_order(num_nodes: int, edges: np.ndarray, proj: np.ndarray):
    lib = _get()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, np.int32)
    proj = np.ascontiguousarray(proj, np.float64)
    order = np.empty(num_nodes, np.int32)
    lib.psfm_mfas_order(num_nodes, len(edges), edges, proj, order)
    return order


def build_observations(mask: np.ndarray, xy: np.ndarray, min_len: int, max_obs: int):
    lib = _get()
    if lib is None:
        return None
    N, T = mask.shape
    mask_u8 = np.ascontiguousarray(mask, np.uint8)
    xy_f = np.ascontiguousarray(xy, np.float32)
    frame_idx = np.zeros((N, max_obs), np.int32)
    uv = np.zeros((N, max_obs, 2), np.float32)
    omask = np.zeros((N, max_obs), np.uint8)
    rows = np.zeros(N, np.int64)
    k = lib.psfm_build_observations(N, T, mask_u8, xy_f, min_len, max_obs,
                                    frame_idx, uv, omask, rows)
    return frame_idx[:k], uv[:k], omask[:k].astype(bool), rows[:k]


def build_pair_tensors(mask: np.ndarray, xy: np.ndarray, pairs: np.ndarray,
                       counts: np.ndarray, max_m: int, sel: np.ndarray):
    """Fill per-pair padded correspondence tensors (one O(sum L^2) pass).

    `sel` [E, max_m] int64: sorted positions (among each pair's common tracks)
    to keep when counts[e] > max_m; ignored otherwise."""
    lib = _get()
    if lib is None:
        return None
    N, T = mask.shape
    E = len(pairs)
    uv1 = np.zeros((E, max_m, 2), np.float32)
    uv2 = np.zeros((E, max_m, 2), np.float32)
    pmask = np.zeros((E, max_m), np.uint8)
    tidx = np.full((E, max_m), -1, np.int64)
    lib.psfm_build_pair_tensors(
        N, T, np.ascontiguousarray(mask, np.uint8), np.ascontiguousarray(xy, np.float32),
        max_m, E, np.ascontiguousarray(pairs, np.int32),
        np.ascontiguousarray(counts, np.int32), np.ascontiguousarray(sel, np.int64),
        uv1, uv2, pmask, tidx)
    return uv1, uv2, pmask.astype(bool), tidx


def covisibility(mask: np.ndarray) -> Optional[np.ndarray]:
    lib = _get()
    if lib is None:
        return None
    N, T = mask.shape
    covis = np.zeros((T, T), np.int32)
    lib.psfm_covisibility(N, T, np.ascontiguousarray(mask, np.uint8), covis)
    return covis
