"""Middlebury .flo optical-flow file I/O (TAG 202021.25).

Interop with upstream ParticleSfM's on-disk flow contract
(point_trajectory/utils.py:43-56): directories flow_f/, flow_b/,
flow_f2/, flow_b2/ of per-pair .flo files, sorted by name.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

TAG_FLOAT = 202021.25


def read_flo(path) -> np.ndarray:
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if not np.isclose(tag, TAG_FLOAT):
            raise ValueError(f"{path}: bad .flo magic {tag}")
        w = struct.unpack("<i", f.read(4))[0]
        h = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(8 * w * h), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    assert c == 2, "flow must be (H, W, 2)"
    with open(path, "wb") as f:
        f.write(np.float32(TAG_FLOAT).tobytes())
        f.write(struct.pack("<ii", w, h))
        f.write(flow.tobytes())


def load_flow_dir(flow_dir) -> np.ndarray:
    """Load all .flo files in a directory sorted by name -> [T, H, W, 2]."""
    names = sorted(Path(flow_dir).glob("*.flo"))
    if not names:
        raise FileNotFoundError(f"no .flo files in {flow_dir}")
    return np.stack([read_flo(n) for n in names], axis=0)


def save_flow_dir(flow_dir, flows, names=None) -> None:
    flow_dir = Path(flow_dir)
    flow_dir.mkdir(parents=True, exist_ok=True)
    for i, fl in enumerate(flows):
        name = names[i] if names is not None else f"{i:05d}.flo"
        write_flo(flow_dir / name, fl)
