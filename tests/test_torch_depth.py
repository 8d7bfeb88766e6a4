"""Port parity: the bilinear resize, DepthNet on the repo's checkpoint, the
per-frame normalization, the pipeline's depth apply and the 16-bit depth PNG
contract, against the JAX package.

Tolerances: resize within 1e-5 of jax.image.resize (antialiased where the
image shrinks); DepthNet within 1e-4 before normalization; the depth apply
(normalized, rounded to float16) within one float16 step (1e-3); PNGs
written by either package read back identically by both.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from particlesfm_tpu.io.images import read_depth_png16 as jread_png16
from particlesfm_tpu.io.images import write_depth_png16 as jwrite_png16
from particlesfm_tpu.models.depth import DepthNet as JDepthNet
from particlesfm_tpu.models.depth import normalize_depth as jnormalize_depth
from particlesfm_tpu.pipeline import run as jrun
from particlesfm_tpu_torch.io.checkpoint import depth_state_dict_from_jax
from particlesfm_tpu_torch.io.images import read_depth_png16, write_depth_png16
from particlesfm_tpu_torch.models.depth import DepthNet, normalize_depth, resize_bilinear
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.utils.config import Config

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "depth_synth.msgpack"


@pytest.mark.parametrize("src,dst", [
    ((436, 1024), (30, 53)),        # the seg apply's depth resize
    ((14, 32), (28, 64)),           # the decoder of a 436x1024 DepthNet ...
    ((28, 64), (55, 128)),
    ((55, 128), (109, 256)),
    ((109, 256), (218, 512)),
    ((218, 512), (436, 1024)),      # ... and its head
    ((30, 40), (20, 60)),           # shrinks in H, grows in W
])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(0).random((2, 3) + src).astype(np.float32)
    y_j = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + dst, "bilinear"))
    y = resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert y.shape == y_j.shape
    assert np.abs(y - y_j).max() <= 1e-5


@pytest.fixture(scope="module")
def nets():
    blob = msgpack_restore(CKPT.read_bytes())
    model = DepthNet()
    model.load_state_dict(depth_state_dict_from_jax(blob["params"], blob["batch_stats"]),
                          strict=True)
    return blob, model.eval()


@pytest.mark.parametrize("hw", [(64, 96), (70, 100)])
def test_depthnet_matches_jax(nets, hw):
    blob, model = nets
    img = np.random.default_rng(1).uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
    out_j = np.asarray(jax.jit(jax.vmap(
        lambda im: JDepthNet().apply(blob, im, train=False)))(jnp.asarray(img)))
    with torch.no_grad():
        out = model(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()
    assert out.shape == out_j.shape == (2,) + hw
    assert np.abs(out - out_j).max() <= 1e-4
    n_j = np.asarray(jax.vmap(jnormalize_depth)(jnp.asarray(out_j)))
    n = normalize_depth(torch.from_numpy(np.array(out_j))).numpy()
    np.testing.assert_allclose(n, n_j, atol=1e-6)
    assert n.min() == 0.0 and np.allclose(n.max(axis=(1, 2)), 1.0)


def test_depth_apply_matches_jax():
    """The pipeline's depth apply: blocks of 4 frames from the uint8 stack,
    normalized per frame, rounded to float16 (5 frames: a partial block)."""
    stack = np.random.default_rng(2).integers(0, 256, (5, 48, 64, 3)).astype(np.uint8)
    d_j = jrun._load_depth_apply(Config())(stack.astype(np.float32))
    d = run._load_depth_apply(Config(), torch.device("cpu"))(torch.from_numpy(stack))
    assert d.dtype == torch.float32 and d.shape == (5, 48, 64)
    d = d.numpy()
    assert np.array_equal(d, d.astype(np.float16).astype(np.float32))
    assert np.abs(d - d_j).max() <= 1e-3


def test_depth_png16_contract(tmp_path):
    d = np.random.default_rng(3).random((7, 9)).astype(np.float32)
    d[0, 0], d[0, 1] = 0.0, 1.0
    write_depth_png16(tmp_path / "port.png", d)
    jwrite_png16(tmp_path / "jax.png", d)
    for p in ("port.png", "jax.png"):
        a, b = read_depth_png16(tmp_path / p), jread_png16(tmp_path / p)
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - d).max() <= 1 / 65535
    np.testing.assert_array_equal(read_depth_png16(tmp_path / "port.png"),
                                  read_depth_png16(tmp_path / "jax.png"))

