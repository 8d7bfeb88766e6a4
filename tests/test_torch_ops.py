"""Port parity: dense ops (bilinear_sample, flow_check, free_cell_mask).

Same seeded numpy inputs through the JAX function and the port's; values at
atol 1e-6 and masks identical.
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
