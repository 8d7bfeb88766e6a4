"""Port parity: dense ops (bilinear_sample, flow_check, free_cell_mask,
motion_boundary, compose_flow, stride2_compose_fallback).

Same seeded numpy inputs through the JAX function and the port's; values at
atol 1e-6 (the composed flows at 1e-5 px) and masks identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.ops import density as jdensity
from particlesfm_tpu.ops import flow_ops as jflow
from particlesfm_tpu.ops import sampling as jsampling
from particlesfm_tpu_torch.ops import density, flow_ops, sampling

from flow_scenes import make_flow_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

H, W = 24, 32


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("zero_pad", [True, False])
def test_bilinear_sample_matches_jax(zero_pad):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(H, W, 3)).astype(np.float32)
    xy = rng.uniform(-3, W + 3, (50, 7, 2)).astype(np.float32)
    xy[..., 1] = rng.uniform(-3, H + 3, (50, 7))
    xy[:5] = np.round(xy[:5])                      # integer coords hit exact corners
    want = np.asarray(jsampling.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), zero_pad))
    got = sampling.bilinear_sample(t(img), t(xy), zero_pad).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bilinear_sample_batched_equals_per_image():
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, H, W, 2)).astype(np.float32)
    xy = rng.uniform(-2, W, (3, 40, 2)).astype(np.float32)
    got = sampling.bilinear_sample(t(imgs), t(xy)).numpy()
    for b in range(3):
        want = np.asarray(jsampling.bilinear_sample(jnp.asarray(imgs[b]), jnp.asarray(xy[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("thres", [0.5, 1.0])
def test_flow_check_matches_jax(thres):
    sc = make_flow_scene(num_views=4, height=H, width=W, focal=40.0)
    rng = np.random.default_rng(2)
    ff = sc["flows"]["flow_f"] + rng.normal(0, 0.6, sc["flows"]["flow_f"].shape).astype(np.float32)
    fb = sc["flows"]["flow_b"]
    occ_j, err_j = jflow.flow_check(jnp.asarray(ff), jnp.asarray(fb), thres)
    occ_t, err_t = flow_ops.flow_check(t(ff), t(fb), thres)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    assert 0 < occ_t.numpy().mean() < 1                 # both outcomes occur


@pytest.mark.parametrize("radius", [1.0, 2.0, 3.0])
def test_free_cell_mask_matches_jax(radius):
    rng = np.random.default_rng(int(radius))
    occupied = (rng.random((H, W)) < 0.05).astype(np.float32)
    want = np.asarray(jdensity.free_cell_mask(jnp.asarray(occupied), radius))
    got = density.free_cell_mask(t(occupied), radius).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(density.disc_kernel(radius), jdensity.disc_kernel(radius))


def test_motion_boundary_matches_jax_and_reference():
    """tests/test_ops.py's motion-boundary case on the port: equal to JAX's
    mask and to the reference's numpy semantics (trajectory.py:39-43)."""
    flow = np.random.default_rng(0).normal(size=(15, 19, 2)).astype(np.float32)
    got = flow_ops.motion_boundary(t(flow), 0.02).numpy()
    np.testing.assert_array_equal(got, np.asarray(jflow.motion_boundary(jnp.asarray(flow), 0.02)))
    dx = np.zeros_like(flow)
    dy = np.zeros_like(flow)
    dx[:, :-1] = np.abs(flow[:, :-1] - flow[:, 1:])
    dy[:-1] = np.abs(flow[:-1] - flow[1:])
    ref = np.sqrt(dx.mean(-1) ** 2 + dy.mean(-1) ** 2) > 0.02 * np.linalg.norm(flow, axis=-1)
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_compose_flow_constant_translation():
    """Interior: the exact chain; valid is False where p + f_ab left the image."""
    f_ab = np.full((20, 30, 2), (3.0, 1.0), np.float32)
    f_bc = np.full((20, 30, 2), (2.0, -1.0), np.float32)
    comp, valid = (x.numpy() for x in flow_ops.compose_flow(t(f_ab), t(f_bc)))
    np.testing.assert_allclose(comp[valid], np.broadcast_to((5.0, 0.0), comp[valid].shape),
                               atol=1e-5)
    assert valid[:-1, :27].all()
    assert not valid[:, 27:].any()


def test_compose_flow_matches_jax():
    """Random fields whose lookups cross every edge: composition within
    1e-5 px of JAX's (the four-corner sample fades to zero past the edge)."""
    rng = np.random.default_rng(4)
    f_ab = rng.normal(0, 4.0, (3, H, W, 2)).astype(np.float32)
    f_bc = rng.normal(0, 2.0, (3, H, W, 2)).astype(np.float32)
    comp, valid = flow_ops.compose_flow(t(f_ab), t(f_bc))
    for k in range(3):
        jc, jv = jflow.compose_flow(jnp.asarray(f_ab[k]), jnp.asarray(f_bc[k]))
        np.testing.assert_allclose(comp[k].numpy(), np.asarray(jc), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(valid[k].numpy(), np.asarray(jv))
    assert not valid.all() and valid.any()


def test_stride2_compose_fallback_matches_jax():
    """tests/test_ops.py's fallback case on the port, against JAX: the same
    `used` mask and the blended flow within 1e-5 px; agreeing pixels keep
    the net's values and the corrupted block takes the composition where
    it is defined."""
    rng = np.random.default_rng(0)
    f1a = rng.normal(0, 0.5, (3, H, W, 2)).astype(np.float32)
    f1b = rng.normal(0, 0.5, (3, H, W, 2)).astype(np.float32)
    comps, valids = (x.numpy() for x in flow_ops.compose_flow(t(f1a), t(f1b)))
    net = comps + rng.normal(0, 0.1, (3, H, W, 2)).astype(np.float32)
    net[1, 5:12, 6:14] += 25.0
    out, used = (x.numpy() for x in flow_ops.stride2_compose_fallback(
        t(net), t(f1a), t(f1b), disagree_px=4.0))
    jout, jused = jflow.stride2_compose_fallback(jnp.asarray(net), jnp.asarray(f1a),
                                                 jnp.asarray(f1b), disagree_px=4.0)
    np.testing.assert_array_equal(used, np.asarray(jused))
    np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[0], net[0])
    assert not used[0].any() and not used[2].any()
    v1 = valids[1, 5:12, 6:14]
    assert (used[1, 5:12, 6:14] | ~v1).all()
    assert np.abs(out[1, 5:12, 6:14][v1] - comps[1, 5:12, 6:14][v1]).max() < 1e-5
