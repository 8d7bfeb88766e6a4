"""Port parity: the plain correlation lookup (CPU side of kernel K1).

The port's plain version is held against all three JAX formulations:
`lookup_corr` (the XLA path the JAX pipeline runs), `lookup_corr_gather`
(its per-corner reference) and the Pallas kernel in interpret mode, as
tests/test_pallas.py runs it. atol 1e-5 (f32 bilinear weights; the JAX
formulations sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.models.raft import (build_corr_pyramid, lookup_corr,
                                         lookup_corr_gather)
from particlesfm_tpu.ops.corr_lookup import lookup_corr_pyramid_pallas
from particlesfm_tpu_torch.ops import corr_lookup as port

H, W, D, LEVELS = 8, 16, 32, 3


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(3)
    f1 = rng.normal(size=(H, W, D)).astype(np.float32)
    f2 = rng.normal(size=(H, W, D)).astype(np.float32)
    jpyr = build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), num_levels=LEVELS)
    # JAX levels [P, Hl, Wl, 1] -> port levels [B=1, P, Hl, Wl]
    tpyr = [torch.from_numpy(np.asarray(c)[None, ..., 0].copy()) for c in jpyr]
    return jpyr, tpyr


def _coords(kind):
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    if kind == "in_range":
        return np.stack([xs, ys], -1) + rng.uniform(-2, 2, (H, W, 2)).astype(np.float32)
    if kind == "mixed":
        return rng.uniform(-4, 20, (H, W, 2)).astype(np.float32)
    c = rng.uniform(-2, 2, (H, W, 2)).astype(np.float32)
    c[::2] += 1000.0
    c[1::2] -= 1000.0
    return c


def _port(tpyr, coords, radius):
    out = port.lookup_corr(tpyr, torch.from_numpy(coords.reshape(1, H * W, 2)), radius)
    return out.numpy().reshape(H, W, -1)


@pytest.mark.parametrize("radius", [1, 3, 4])
@pytest.mark.parametrize("kind", ["in_range", "mixed", "far"])
def test_plain_lookup_matches_jax(pyramids, radius, kind):
    jpyr, tpyr = pyramids
    coords = _coords(kind)
    got = _port(tpyr, coords, radius)
    assert got.shape == (H, W, LEVELS * (2 * radius + 1) ** 2)
    jc = jnp.asarray(coords)
    for ref in (lookup_corr(jpyr, jc, radius), lookup_corr_gather(jpyr, jc, radius),
                lookup_corr_pyramid_pallas(jpyr, jc, radius, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    if kind == "far":
        assert not got.any()


def test_cpu_tensors_take_plain_version(pyramids):
    _, tpyr = pyramids
    before = port.launches
    _port(tpyr, _coords("in_range"), 4)
    assert port.launches == before          # the kernel counter counts CUDA launches only


def test_batched_pairs_are_independent(pyramids):
    _, tpyr = pyramids
    c = torch.from_numpy(_coords("mixed").reshape(1, H * W, 2))
    one = port.lookup_corr(tpyr, c, 4)
    two = port.lookup_corr([torch.cat([t, 2 * t]) for t in tpyr], torch.cat([c, c]), 4)
    torch.testing.assert_close(two[0], one[0], rtol=0, atol=0)
    torch.testing.assert_close(two[1], 2 * one[0], rtol=0, atol=1e-5)
