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
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


LEVEL_HW = [(H >> l, W >> l) for l in range(LEVELS)]


def _coords(kind, radius=4):
    """[H, W, 2] level-0 coordinates of one kind (edge kinds hit each level's
    edges at that level's scale, coords / 2^l)."""
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    grid = np.stack([xs, ys], -1)
    lvl = rng.integers(0, LEVELS, (H, W, 2))
    scale = (2.0 ** lvl).astype(np.float32)
    hw = np.array(LEVEL_HW, np.float32)[lvl, [1, 0]]          # (Wl, Hl) per axis
    if kind == "in_range":
        return grid + rng.uniform(-2, 2, (H, W, 2)).astype(np.float32)
    if kind == "mixed":
        return rng.uniform(-4, 20, (H, W, 2)).astype(np.float32)
    if kind == "integer":
        return grid + rng.integers(-3, 4, (H, W, 2)).astype(np.float32)
    if kind == "edges":               # exactly Wl-1 / Hl-1 or -1 at level l
        return np.where(rng.random((H, W, 2)) < 0.5, hw - 1, -1.0).astype(np.float32) * scale
    if kind == "below_zero":          # just below 0 on one axis, in range on the other
        eps = rng.choice(np.float32([1e-7, 1e-3, 0.3, 0.999]), (H, W))
        c = grid.copy()
        axis = rng.integers(0, 2, (H, W))
        np.put_along_axis(c, axis[..., None], (-eps * scale[..., 0])[..., None], axis=-1)
        return c
    if kind == "clamp":               # centre in (Wl+r, Wl+r+1) or (-(r+2), -(r+1))
        u = rng.uniform(0.01, 0.99, (H, W, 2)).astype(np.float32)
        c = np.where(rng.random((H, W, 2)) < 0.5, hw + radius + u, -(radius + 1 + u)) * scale
        keep = rng.random((H, W)) < 0.5                       # one axis clamped, one in range
        c[keep, 1] = grid[keep, 1]
        return c.astype(np.float32)
    c = rng.uniform(-2, 2, (H, W, 2)).astype(np.float32)
    c[::2] += 1000.0
    c[1::2] -= 1000.0
    return c


def _port(tpyr, coords, radius):
    out = port.lookup_corr(tpyr, torch.from_numpy(coords.reshape(1, H * W, 2)), radius)
    return out.numpy().reshape(H, W, -1)


@pytest.mark.parametrize("radius", [1, 3, 4])
@pytest.mark.parametrize("kind", ["in_range", "mixed", "far", "integer", "edges",
                                  "below_zero", "clamp"])
def test_plain_lookup_matches_jax(pyramids, radius, kind):
    jpyr, tpyr = pyramids
    coords = _coords(kind, radius)
    got = _port(tpyr, coords, radius)
    assert got.shape == (H, W, LEVELS * (2 * radius + 1) ** 2)
    jc = jnp.asarray(coords)
    for ref in (lookup_corr(jpyr, jc, radius), lookup_corr_gather(jpyr, jc, radius),
                lookup_corr_pyramid_pallas(jpyr, jc, radius, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    if kind == "far":
        assert not got.any()
    if kind == "clamp":               # a level whose window lies off the map reads 0
        K2 = (2 * radius + 1) ** 2
        for lvl, (Hl, Wl) in enumerate(LEVEL_HW):
            c = coords / 2 ** lvl
            off = ((c[..., 0] >= Wl + radius) | (c[..., 1] >= Hl + radius)
                   | (c.min(-1) < -(radius + 1)))
            assert off.any()
            assert not got[off][:, lvl * K2:(lvl + 1) * K2].any()


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


def _window_bytes_brute(shapes, coords, r):
    """Count in-map cells of every (2r+2)^2 window one by one."""
    n = 0
    for lvl, (Hl, Wl) in enumerate(shapes):
        for cx, cy in coords.reshape(-1, 2).astype(np.float64) / 2 ** lvl:
            x0, y0 = int(np.floor(cx)) - r, int(np.floor(cy)) - r
            n += sum(0 <= x0 + i < Wl and 0 <= y0 + j < Hl
                     for i in range(2 * r + 2) for j in range(2 * r + 2))
    B, P = coords.shape[:2]
    return 4 * (B * P * len(shapes) * (2 * r + 1) ** 2 + B * P * 2 + n)


@pytest.mark.parametrize("radius", [1, 4])
def test_lookup_bytes_counts_in_map_window_cells(radius):
    """The bound's byte count: in range, on the edges, far out, and levels
    smaller than the window (3x5 and 1x2 hold no full 10x10 window)."""
    shapes = [(12, 20), (6, 10), (3, 5), (1, 2)]
    rng = np.random.default_rng(11)
    coords = np.concatenate([
        rng.uniform(0, 20, (40, 2)),                          # in range
        rng.uniform(-6, 26, (40, 2)),                         # over the edges
        np.float64([[19, 11], [-1, -1], [0, 0], [-9.5, 3], [24.5, 5]]),
        np.float64([[1e4, 5], [-1e4, -1e4], [3, 3e7]]),       # far out
    ]).astype(np.float32).reshape(2, -1, 2)
    got = port.lookup_bytes(shapes, torch.from_numpy(coords), radius)
    assert got == _window_bytes_brute(shapes, coords, radius)
