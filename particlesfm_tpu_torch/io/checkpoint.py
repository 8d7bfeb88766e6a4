"""Reader for the repo's flax msgpack checkpoints, and weight carry-over.

`checkpoints/*.msgpack` are written by `flax.serialization.msgpack_serialize`.
The port reads them without msgpack or flax: `msgpack_restore` decodes the
subset flax writes (maps, arrays, str, bin, ints, floats, bool, nil, and the
ext types flax registers for numpy data) and returns the same tree of dicts and
numpy arrays as `flax.serialization.msgpack_restore`.

`raft_state_dict_from_jax` maps the flax RAFT parameter tree onto the port's
`models.raft.RAFT` state dict: module paths are identical, conv kernels go
from HWIO to OIHW.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw          # str payloads as bytes (flax's inner ndarray tuples)

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
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
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
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
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


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpackb(payload, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _reject_chunked(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(
                "msgpack: chunked arrays (leaves over 1 GiB, "
                f"{_CHUNKED}) are not supported")
        for v in tree.values():
            _reject_chunked(v)


def msgpack_restore(encoded: bytes):
    """Decode a flax msgpack checkpoint into dicts of numpy arrays."""
    tree = _unpackb(encoded, raw=False)
    _reject_chunked(tree)
    return tree


def load_msgpack(path):
    return msgpack_restore(Path(path).read_bytes())


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def raft_state_dict_from_jax(params: dict, batch_stats: dict | None = None) -> dict:
    """flax RAFT `params` (+ `batch_stats` for batch-norm encoders) -> the
    port's RAFT state dict. Load it with `load_state_dict(..., strict=True)`."""
    sd = {}
    for name, v in _flatten(params):
        mod, _, leaf = name.rpartition(".")
        a = np.asarray(v)
        if leaf == "kernel":           # conv HWIO -> OIHW
            sd[f"{mod}.weight"] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy())
        elif leaf == "scale":          # batch-norm affine
            sd[f"{mod}.weight"] = torch.from_numpy(a.copy())
        elif leaf == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(a.copy())
        else:
            raise KeyError(f"unexpected RAFT parameter {name}")
    for name, v in _flatten(batch_stats or {}):
        mod, _, leaf = name.rpartition(".")
        key = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{mod}.{key}"] = torch.from_numpy(np.asarray(v).copy())
        sd.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0))
    return sd
