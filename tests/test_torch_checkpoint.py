"""Port parity: the msgpack checkpoint reader and the RAFT weight carry-over.

The port's pure-Python decoder must return exactly what
`flax.serialization.msgpack_restore` returns for every checkpoint in the repo,
and `raft_state_dict_from_jax` must load strictly into the port's RAFT.
"""
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore, msgpack_serialize

from particlesfm_tpu_torch.io.checkpoint import (msgpack_restore as port_restore,
                                                 raft_state_dict_from_jax)
from particlesfm_tpu_torch.models.raft import RAFT, compact_raft

CKPTS = sorted((Path(__file__).resolve().parents[1] / "checkpoints").glob("*.msgpack"))


def _assert_same_tree(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, np.generic) and isinstance(b, np.generic)), path
    if isinstance(a, dict):
        assert list(a.keys()) == list(b.keys()), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    else:
        assert a == b, path


def test_repo_has_three_checkpoints():
    assert len(CKPTS) == 3


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: p.name)
def test_reader_matches_flax(path):
    blob = path.read_bytes()
    _assert_same_tree(port_restore(blob), msgpack_restore(blob))


def test_reader_covers_msgpack_types():
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33,
                 -128, -129, -32768, -32769, -2**31 - 1, -2**40],
        "floats": [0.5, -1.25e300],
        "flags": [True, False, None],
        "text": "x" * 40 + "é",
        "long_text": "y" * 70000,
        "raw": b"\x00\x01" * 200,
        "arr": np.arange(24, dtype=np.int16).reshape(2, 3, 4),
        "scalar": np.float32(2.5),
        "many": {str(i): i for i in range(20)},
        "list": list(range(20)),
    }
    blob = msgpack_serialize(tree)
    _assert_same_tree(port_restore(blob), msgpack_restore(blob))


def test_reader_rejects_chunked_arrays_and_garbage():
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True}})
    with pytest.raises(ValueError, match="chunked"):
        port_restore(chunked)
    with pytest.raises(ValueError):
        port_restore(msgpack.packb({"a": 1}) + b"\x00")


def test_raft_state_dict_loads_strictly():
    path = next(p for p in CKPTS if p.name == "raft_synth.msgpack")
    params = port_restore(path.read_bytes())["params"]
    model = compact_raft()
    missing, unexpected = model.load_state_dict(raft_state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    k = params["update_block"]["encoder"]["convc1"]["kernel"]      # HWIO
    w = model.update_block.encoder.convc1.weight                   # OIHW
    np.testing.assert_array_equal(w.detach().numpy(), k.transpose(3, 2, 0, 1))


def test_raft_batch_norm_state_dict_loads_strictly():
    """Full-width RAFT (batch-norm context encoder): params + batch_stats."""
    sd = RAFT().state_dict()
    params, stats = {}, {}
    for name, t in sd.items():
        *mod, leaf = name.split(".")
        a = t.numpy()
        if leaf == "weight" and a.ndim == 4:
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            node = stats
            for m in mod:
                node = node.setdefault(m, {})
            node[leaf.split("_")[1]] = a
            continue
        elif leaf == "num_batches_tracked":
            continue
        node = params
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = a
    model = RAFT()
    model.load_state_dict(raft_state_dict_from_jax(params, stats), strict=True)
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name
