"""Plain reader of the repo's flax msgpack checkpoints and the carry-over of
their weights onto the reference nets.

A frozen copy of the msgpack decoder and the three state-dict converters of
the port's `io/checkpoint.py`, so that the benchmark's references load
`checkpoints/*.msgpack` themselves and take no weights the program made.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Decoder:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            return self.str_(self.unpack(sized[b]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _unpackb(data: bytes, raw: bool):
    dec = _Decoder(data, raw)
    out = dec.obj()
    if dec.pos != len(dec.data):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpackb(payload, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def load_msgpack(path) -> dict:
    """The checkpoint's tree of dicts and numpy arrays."""
    return _unpackb(Path(path).read_bytes(), raw=False)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def conv_state_dict(params: dict, batch_stats: dict | None = None) -> dict:
    """flax conv/batch-norm trees (RAFT, DepthNet) -> a torch state dict:
    conv kernels HWIO -> OIHW, batch-norm scale -> weight, statistics from
    `batch_stats`."""
    sd = {}
    for name, v in _flatten(params):
        mod, _, leaf = name.rpartition(".")
        a = np.asarray(v)
        if leaf == "kernel":
            sd[f"{mod}.weight"] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy())
        elif leaf in ("scale", "bias"):
            sd[f"{mod}.{'weight' if leaf == 'scale' else 'bias'}"] = torch.from_numpy(a.copy())
        else:
            raise KeyError(f"unexpected parameter {name}")
    for name, v in _flatten(batch_stats or {}):
        mod, _, leaf = name.rpartition(".")
        sd[f"{mod}.{ {'mean': 'running_mean', 'var': 'running_var'}[leaf]}"] = \
            torch.from_numpy(np.asarray(v).copy())
        sd.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0))
    return sd


def motionseg_state_dict(params: dict, batch_stats: dict) -> dict:
    """flax TrajOADepth trees -> a torch state dict: Dense (in, out) ->
    Linear (out, in); attention DenseGeneral kernels flattened heads-outermost;
    LayerNorm/BatchNorm scale -> weight; statistics from `batch_stats`."""
    sd = {}
    for name, v in _flatten(params):
        mod, _, leaf = name.rpartition(".")
        a = np.asarray(v)
        if leaf == "kernel":
            a = a.reshape(-1, a.shape[-1]) if mod.endswith(".out") else a.reshape(a.shape[0], -1)
            sd[f"{mod}.weight"] = torch.from_numpy(a.T.copy())
        elif leaf == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(a.copy())
        elif leaf == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(a.reshape(-1).copy())
        else:
            raise KeyError(f"unexpected motion-seg parameter {name}")
    for name, v in _flatten(batch_stats):
        mod, _, leaf = name.rpartition(".")
        sd[f"{mod}.{ {'mean': 'running_mean', 'var': 'running_var'}[leaf]}"] = \
            torch.from_numpy(np.asarray(v).copy())
    return sd
