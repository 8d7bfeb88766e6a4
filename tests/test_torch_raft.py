"""Port parity: RAFT on the repo's checkpoint, and its pieces alone.

The flow of the compact checkpoint on a rendered 64x96 pair (the pyramid
needs >= 64 px sides) agrees with the JAX model within 1e-3 px at 2 and 8 GRU
iterations; `build_corr_pyramid` and `upsample_flow_convex` agree at 1e-5.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from particlesfm_tpu.models import raft as jraft
from particlesfm_tpu_torch.io.checkpoint import raft_state_dict_from_jax
from particlesfm_tpu_torch.models import raft
from particlesfm_tpu_torch.synth import random_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "raft_synth.msgpack"


@pytest.fixture(scope="module")
def pair():
    sc = random_scene(np.random.default_rng(5), num_views=2, height=64, width=96,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3)
    return sc.render(0).astype(np.float32), sc.render(1).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return msgpack_restore(CKPT.read_bytes())["params"]


@pytest.mark.parametrize("iters", [2, 8])
def test_compact_raft_matches_jax(pair, params, iters):
    img1, img2 = pair
    jmodel = jraft.compact_raft()
    want = np.asarray(jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b, iters=iters))(
        params, jnp.asarray(img1), jnp.asarray(img2)))
    model = raft.compact_raft()
    model.load_state_dict(raft_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
                           iters=iters)[0].numpy()
    assert got.shape == (64, 96, 2)
    assert np.abs(want).mean() > 0.5                  # a real, non-trivial flow
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_full_width_raft_batch_norm_matches_jax(pair):
    """raft-things widths with the batch-norm context encoder, random weights."""
    img1, img2 = pair
    jmodel = jraft.RAFT()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img1), jnp.asarray(img2), iters=1)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=2))(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(img1), jnp.asarray(img2)))
    model = raft.RAFT()
    model.load_state_dict(raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), stats), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
                           iters=2)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_build_corr_pyramid_matches_jax():
    rng = np.random.default_rng(0)
    H, W, D = 8, 16, 32
    f1 = rng.normal(size=(H, W, D)).astype(np.float32)
    f2 = rng.normal(size=(H, W, D)).astype(np.float32)
    want = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = raft.build_corr_pyramid(torch.from_numpy(f1.transpose(2, 0, 1))[None],
                                  torch.from_numpy(f2.transpose(2, 0, 1))[None], 4)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w)[..., 0], rtol=0, atol=1e-5)


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(1)
    H, W = 5, 7
    flow = rng.normal(0, 2, (H, W, 2)).astype(np.float32)
    mask = rng.normal(0, 3, (H, W, 576)).astype(np.float32)
    want = np.asarray(jraft.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)))
    got = raft.upsample_flow_convex(torch.from_numpy(flow.transpose(2, 0, 1))[None],
                                    torch.from_numpy(mask.transpose(2, 0, 1))[None])
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want, rtol=0, atol=1e-5)


def test_instance_norm_matches_jax():
    x = np.random.default_rng(2).normal(3, 2, (2, 5, 6, 4)).astype(np.float32)
    want = np.asarray(jraft._instance_norm(jnp.asarray(x)))        # NHWC
    got = raft._instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
