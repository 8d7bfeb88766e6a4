"""Port parity: the msgpack checkpoint reader and the weight carry-over.

The port's pure-Python decoder must return exactly what
`flax.serialization.msgpack_restore` returns for every checkpoint in the repo,
and the RAFT, DepthNet and TrajOADepth state dicts must load strictly into
the port's models, every flax leaf landing in exactly one tensor.
"""
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore, msgpack_serialize

from particlesfm_tpu_torch.io.checkpoint import (depth_state_dict_from_jax,
                                                 motionseg_state_dict_from_jax,
                                                 msgpack_restore as port_restore,
                                                 raft_state_dict_from_jax)
from particlesfm_tpu_torch.models.depth import DepthNet
from particlesfm_tpu_torch.models.motionseg import TrajOADepth
from particlesfm_tpu_torch.models.raft import RAFT, compact_raft
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("name,convert,model", [
    ("depth_synth.msgpack", depth_state_dict_from_jax, DepthNet),
    ("motionseg_synth3d.msgpack", motionseg_state_dict_from_jax, lambda: TrajOADepth((30, 53))),
])
def test_every_leaf_maps_to_one_tensor(name, convert, model):
    """Each flax leaf of params and batch_stats lands in exactly one port
    tensor of the same element count and values; nothing is left over on
    either side (the strict load checks names and shapes)."""
    blob = port_restore(next(p for p in CKPTS if p.name == name).read_bytes())
    leaves = dict(_leaves({"params": blob["params"], "batch_stats": blob["batch_stats"]}))
    sd = convert(blob["params"], blob["batch_stats"])
    net = model()
    net.load_state_dict(sd, strict=True)
    ported = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert len(ported) == len(leaves)
    used = set()
    for key, t in ported.items():
        *mod, leaf = key.split(".")
        leaf = {"weight": "kernel" if t.dim() >= 2 else "scale",
                "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        flax_key = "/".join([col, *mod, leaf])
        a = leaves[flax_key]
        assert a.size == t.numel(), key
        assert np.array_equal(np.sort(a.ravel()), np.sort(t.numpy().ravel())), key
        used.add(flax_key)
    assert used == set(leaves)
    for key, t in net.state_dict().items():
        if key in sd:
            assert torch.equal(t, sd[key]), key


def test_attention_kernels_put_heads_outermost():
    blob = port_restore(next(p for p in CKPTS if p.name == "motionseg_synth3d.msgpack")
                        .read_bytes())
    sd = motionseg_state_dict_from_jax(blob["params"], blob["batch_stats"])
    attn = blob["params"]["joint_encoder"]["dec0"]["cross_attn"]
    q, out = attn["query"]["kernel"], attn["out"]["kernel"]          # (16,4,4), (4,4,16)
    wq = sd["joint_encoder.dec0.cross_attn.query.weight"].numpy()    # (16 = h*4+d, 16 in)
    wo = sd["joint_encoder.dec0.cross_attn.out.weight"].numpy()      # (16 out, 16 = h*4+d)
    for h in range(4):
        for d in range(4):
            np.testing.assert_array_equal(wq[h * 4 + d], q[:, h, d])
            np.testing.assert_array_equal(wo[:, h * 4 + d], out[h, d])
    np.testing.assert_array_equal(sd["joint_encoder.dec0.cross_attn.query.bias"].numpy(),
                                  attn["query"]["bias"].reshape(-1))
