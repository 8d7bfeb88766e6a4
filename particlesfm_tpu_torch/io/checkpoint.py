"""Reader for the repo's flax msgpack checkpoints, and weight carry-over.

`checkpoints/*.msgpack` are written by `flax.serialization.msgpack_serialize`.
The port reads them without msgpack or flax: `msgpack_restore` decodes the
subset flax writes (maps, arrays, str, bin, ints, floats, bool, nil, and the
ext types flax registers for numpy data) and returns the same tree of dicts and
numpy arrays as `flax.serialization.msgpack_restore`.

`msgpack_serialize` is the writer: the bytes `flax.serialization.
msgpack_serialize` writes for the same tree (dict keys sorted, arrays as the
ndarray ext type, numpy scalars as the scalar ext type), so JAX loads what
the port trains.

`raft_state_dict_from_jax` maps the flax RAFT parameter tree onto the port's
`models.raft.RAFT` state dict: module paths are identical, conv kernels go
from HWIO to OIHW. The `*_variables_from_torch` functions are the inverses:
a port state dict -> flax `params` and `batch_stats` trees.
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


_MAX_ARRAY_BYTES = 1 << 30     # flax chunks larger leaves; the port does not


class _Encoder:
    def __init__(self):
        self.out = bytearray()

    def head(self, n: int, fix: int, fix_max: int, codes) -> None:
        """A length-prefixed header: the fix form up to fix_max, else the
        first of `codes` ((code, struct format, max)) whose max holds n."""
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
            return
        for code, fmt, top in codes:
            if n <= top:
                self.out.append(code)
                self.out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: length {n} too large")

    def int_(self, v: int) -> None:
        if 0 <= v < 0x80 or -0x20 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        table = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
                 (0xCF, ">Q", 0, (1 << 64) - 1)) if v >= 0 else \
            ((0xD0, ">b", -0x80, -1), (0xD1, ">h", -0x8000, -1),
             (0xD2, ">i", -0x80000000, -1), (0xD3, ">q", -(1 << 63), -1))
        for code, fmt, lo, hi in table:
            if lo <= v <= hi:
                self.out.append(code)
                self.out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} out of range")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out.append(fixed[n])
        else:
            self.head(n, None, -1, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
        self.out += struct.pack(">b", code)
        self.out += payload

    def obj(self, v, sort_keys: bool = True) -> None:
        if v is None:
            self.out.append(0xC0)
        elif isinstance(v, bool):
            self.out.append(0xC3 if v else 0xC2)
        elif isinstance(v, int):
            self.int_(v)
        elif isinstance(v, float):
            self.out.append(0xCB)
            self.out += struct.pack(">d", v)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self.head(len(b), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                         (0xDB, ">I", 0xFFFFFFFF)))
            self.out += b
        elif isinstance(v, (bytes, bytearray)):
            self.head(len(v), None, -1, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                         (0xC6, ">I", 0xFFFFFFFF)))
            self.out += v
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 15, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
            for x in v:
                self.obj(x, sort_keys)
        elif isinstance(v, dict):
            self.head(len(v), 0x80, 15, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
            for k in (sorted(v, key=str) if sort_keys else v):
                self.obj(str(k), sort_keys)
                self.obj(v[k], sort_keys)
        elif isinstance(v, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_to_bytes(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(v)))
        elif torch.is_tensor(v):
            self.obj(v.detach().cpu().numpy(), sort_keys)
        else:
            raise TypeError(f"msgpack: cannot serialize {type(v).__name__}")


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    if a.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError("msgpack: arrays over 1 GiB (flax chunks them) are not supported")
    enc = _Encoder()
    enc.obj(([int(n) for n in a.shape], a.dtype.name, a.tobytes("C")))
    return bytes(enc.out)


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists, Python scalars, numpy arrays and
    scalars (torch tensors become numpy arrays) as
    `flax.serialization.msgpack_serialize` does: dict keys sorted, as the
    flax writer's tree map leaves them."""
    enc = _Encoder()
    enc.obj(tree)
    return bytes(enc.out)


def save_msgpack(path, tree) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(tree))


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


def loaded(module: torch.nn.Module, state_dict: dict, device) -> torch.nn.Module:
    """`module` with `state_dict` loaded strictly, in eval mode on `device`:
    one inference replica of a net."""
    module.load_state_dict(state_dict, strict=True)
    return module.to(device).eval()


def depth_state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """flax DepthNet `params` + `batch_stats` -> the port's DepthNet state
    dict: convs and batch norms, mapped as for RAFT (conv HWIO -> OIHW,
    BatchNorm scale/bias from params, mean/var from batch_stats)."""
    return raft_state_dict_from_jax(params, batch_stats)


def motionseg_state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """flax TrajOADepth `params` + `batch_stats` -> the port's state dict.

    Dense (in, out) -> Linear (out, in); the attention projections' DenseGeneral
    kernels (in, heads, head_dim) and (heads, head_dim, out) flatten to
    (in, heads*head_dim) and (heads*head_dim, out) with heads outermost before
    the transpose, their biases to one axis; LayerNorm and BatchNorm scale ->
    weight; batch_stats mean/var -> running_mean/running_var."""
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
        key = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{mod}.{key}"] = torch.from_numpy(np.asarray(v).copy())
    return sd


def _unflatten(flat: dict) -> dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _np32(t) -> np.ndarray:
    """A copy of a tensor's or an array's values as numpy."""
    if torch.is_tensor(t):
        return t.detach().cpu().numpy().copy()
    return np.array(t)


def conv_bn_variables_from_torch(state_dict: dict) -> tuple:
    """A RAFT or DepthNet state dict (tensors or numpy arrays by name) ->
    flax (`params`, `batch_stats`): the inverse of `raft_state_dict_from_jax`
    (conv OIHW -> HWIO kernel, BatchNorm weight -> scale, running mean/var ->
    batch_stats mean/var; num_batches_tracked dropped)."""
    params, stats = {}, {}
    for name, v in state_dict.items():
        mod, _, leaf = name.rpartition(".")
        v = _np32(v)
        if leaf == "weight":
            if v.ndim == 4:
                params[f"{mod}.kernel"] = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
            else:
                params[f"{mod}.scale"] = v
        elif leaf == "bias":
            params[f"{mod}.bias"] = v
        elif leaf in ("running_mean", "running_var"):
            stats[f"{mod}.{leaf[8:]}"] = v
        elif leaf != "num_batches_tracked":
            raise KeyError(f"unexpected state-dict entry {name}")
    return _unflatten(params), _unflatten(stats)


def conv_bn_arrays_from_jax(params: dict) -> dict:
    """A flax conv/batch-norm params tree -> numpy arrays by the port's
    parameter names (`raft_state_dict_from_jax`'s mapping)."""
    return {k: v.numpy() for k, v in raft_state_dict_from_jax(params).items()}


def raft_variables_from_torch(state_dict: dict) -> dict:
    """The port's RAFT state dict -> flax `params` (plus `batch_stats` for
    batch-norm encoders, as convert_raft writes them)."""
    params, stats = conv_bn_variables_from_torch(state_dict)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def depth_variables_from_torch(state_dict: dict) -> dict:
    """The port's DepthNet state dict -> flax {"params", "batch_stats"}."""
    params, stats = conv_bn_variables_from_torch(state_dict)
    return {"params": params, "batch_stats": stats}


_ATTN_PROJ = (".query", ".key", ".value")


def motionseg_variables_from_torch(state_dict: dict, nhead: int = 4) -> dict:
    """The port's TrajOADepth state dict -> flax {"params", "batch_stats"}:
    the inverse of `motionseg_state_dict_from_jax` (Linear (out, in) ->
    Dense (in, out); the attention projections back to DenseGeneral's
    (in, heads, head_dim) and (heads, head_dim, out) kernels and (heads,
    head_dim) biases; LayerNorm/BatchNorm weight -> scale)."""
    params, stats = {}, {}
    for name, v in state_dict.items():
        mod, _, leaf = name.rpartition(".")
        a = _np32(v)
        if leaf == "weight" and a.ndim == 2:
            k = a.T
            if mod.endswith(_ATTN_PROJ):
                k = k.reshape(k.shape[0], nhead, -1)
            elif mod.endswith(".out"):
                k = k.reshape(nhead, -1, k.shape[-1])
            params[f"{mod}.kernel"] = np.ascontiguousarray(k)
        elif leaf == "weight":
            params[f"{mod}.scale"] = a
        elif leaf == "bias":
            params[f"{mod}.bias"] = a.reshape(nhead, -1) if mod.endswith(_ATTN_PROJ) else a
        elif leaf in ("running_mean", "running_var"):
            stats[f"{mod}.{leaf[8:]}"] = a
        elif leaf != "num_batches_tracked":
            raise KeyError(f"unexpected state-dict entry {name}")
    return {"params": _unflatten(params), "batch_stats": _unflatten(stats)}
