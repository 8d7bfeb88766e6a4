"""Port parity: photometric flow refinement.

`photometric_refine_scheduled` (the default window-annealed schedule the
pipeline runs) on small textured pairs related by a known warp, with a biased
initial flow: the port agrees with the JAX refinement within 1e-4 px.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.flow import refine as jrefine
from particlesfm_tpu_torch.flow import refine

H, W = 48, 64


def _textured(rng):
    base = rng.uniform(0, 1, (H + 32, W + 32)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(8):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, base)
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    return base


@pytest.fixture(scope="module")
def batch():
    """Two RGB pairs: I2 is I1's texture shifted by a sub-pixel translation
    (bilinear resample), flow0 = GT + a smooth structured bias."""
    rng = np.random.default_rng(0)
    img1s, img2s, flows = [], [], []
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for shift in ((1.3, -0.7), (-0.4, 2.2)):
        big = np.stack([_textured(rng) for _ in range(3)], -1)
        I1 = big[16:16 + H, 16:16 + W]
        x = xs + 16 + shift[0]
        y = ys + 16 + shift[1]
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        fx, fy = (x - x0)[..., None], (y - y0)[..., None]
        I2 = ((1 - fx) * (1 - fy) * big[y0, x0] + fx * (1 - fy) * big[y0, x0 + 1]
              + (1 - fx) * fy * big[y0 + 1, x0] + fx * fy * big[y0 + 1, x0 + 1])
        bias = np.stack([0.4 + 0.3 * np.sin(xs / 17.0), -0.3 + 0.2 * np.cos(ys / 11.0)], -1)
        img1s.append(I1)
        img2s.append(I2.astype(np.float32))
        flows.append((-np.asarray(shift) + bias).astype(np.float32))
    return np.stack(img1s), np.stack(img2s), np.stack(flows)


def test_refine_scheduled_matches_jax(batch):
    img1s, img2s, flows = batch
    want = np.asarray(jrefine.photometric_refine_scheduled(
        jnp.asarray(img1s), jnp.asarray(img2s), jnp.asarray(flows), max_total=3.0))
    got = refine.photometric_refine_scheduled(
        torch.from_numpy(img1s), torch.from_numpy(img2s), torch.from_numpy(flows),
        max_total=3.0).numpy()
    assert np.abs(got - flows).max() > 0.1            # refinement moved the flow
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_refine_pair_matches_jax_grayscale(batch):
    img1s, img2s, flows = batch
    g1, g2 = img1s[0].mean(-1), img2s[0].mean(-1)
    want = np.asarray(jrefine.photometric_refine_pair(
        jnp.asarray(g1), jnp.asarray(g2), jnp.asarray(flows[0]), iters=3,
        window_sigma=2.0, window_radius=4))
    got = refine.photometric_refine_pair(
        torch.from_numpy(g1), torch.from_numpy(g2), torch.from_numpy(flows[0]), iters=3,
        window_sigma=2.0, window_radius=4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_gradients_keep_zero_borders():
    img = torch.arange(20.0).view(1, 4, 5) ** 2
    gx, gy = refine._gradients(img)
    jgx, jgy = jrefine._gradients(jnp.asarray(img[0].numpy()))
    np.testing.assert_array_equal(gx[0].numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy[0].numpy(), np.asarray(jgy))
