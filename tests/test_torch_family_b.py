"""Port parity: the held-out family B renderer (synth/family_b.py).

The port's copy must render what the reference renders from the same seed,
bit for bit: images, gt_flow, gt_depth, gt_dynamic, world_to_cam and
intrinsics_matrix at 64x96 over 3 frames, static and dynamic. The
reference's own ground-truth checks (tests/test_family_b.py) then hold for
the port's renderer, as cases of one parametrised test.
"""
import numpy as np
import pytest

from particlesfm_tpu.synth.family_b import random_box_scene as jrandom_box_scene
from particlesfm_tpu_torch.synth.family_b import random_box_scene


def _scene(fn, seed=0, **kw):
    args = dict(num_views=6, height=72, width=112, num_dynamic=1,
                motion_scale=0.6, num_boxes=6)
    args.update(kw)
    return fn(np.random.default_rng(seed), **args)


@pytest.mark.parametrize("num_dynamic", [0, 2])
def test_renders_equal_the_reference_bit_for_bit(num_dynamic):
    kw = dict(num_views=3, height=64, width=96, num_dynamic=num_dynamic, num_boxes=5)
    sc, jsc = _scene(random_box_scene, 7, **kw), _scene(jrandom_box_scene, 7, **kw)
    np.testing.assert_array_equal(sc.intrinsics_matrix(), jsc.intrinsics_matrix())
    for v in range(3):
        np.testing.assert_array_equal(sc.render(v), jsc.render(v))
        np.testing.assert_array_equal(sc.gt_depth(v), jsc.gt_depth(v))
        np.testing.assert_array_equal(sc.gt_dynamic(v), jsc.gt_dynamic(v))
        np.testing.assert_array_equal(sc.world_to_cam(v), jsc.world_to_cam(v))
    for a, b in ((0, 1), (0, 2), (2, 1)):
        np.testing.assert_array_equal(sc.gt_flow(a, b), jsc.gt_flow(a, b))
    assert sc.gt_dynamic(1).any() == (num_dynamic > 0)


def _depth_positive_and_finite():
    sc = _scene(random_box_scene)
    for v in (0, 3):
        z = sc.gt_depth(v)
        assert np.isfinite(z).all()
        assert (z > 0).all()
        assert z.max() / z.min() > 3.0


def _grid(sc):
    us, vs = np.meshgrid(np.arange(sc.width, dtype=np.float64),
                         np.arange(sc.height, dtype=np.float64))
    return us, vs


def _flow_matches_reprojection_of_material_points():
    sc = _scene(random_box_scene, 1)
    a, b = 1, 2
    pts, idx, _, _ = sc.hit_points(a)
    pts_b = pts.copy()
    for i, bx in enumerate(sc.boxes):
        m = idx == i
        if m.any():
            pts_b[m] += (b - a) * bx.vel
    us, vs = _grid(sc)
    want = (sc.project(b, pts_b) - np.stack([us, vs], -1)).astype(np.float32)
    np.testing.assert_allclose(sc.gt_flow(a, b), want, atol=1e-5)


def _flow_photometric_consistency_static():
    sc = _scene(random_box_scene, 2, num_dynamic=0)
    Ia = sc.render(0).astype(np.float32) / 255.0
    Ib = sc.render(1).astype(np.float32) / 255.0
    fl = sc.gt_flow(0, 1)
    H, W = Ia.shape[:2]
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    ub = np.clip(np.round(us + fl[..., 0]).astype(int), 0, W - 1)
    vb = np.clip(np.round(vs + fl[..., 1]).astype(int), 0, H - 1)
    inb = ((us + fl[..., 0] >= 1) & (us + fl[..., 0] <= W - 2)
           & (vs + fl[..., 1] >= 1) & (vs + fl[..., 1] <= H - 2))
    err = np.abs(Ib[vb, ub] - Ia).mean(axis=-1)
    assert np.median(err[inb]) < 0.1


def _dynamic_mask_only_on_movers():
    dyn = _scene(random_box_scene, 3, num_dynamic=2).gt_dynamic(2)
    assert dyn.dtype == bool
    assert 0.0 <= dyn.mean() < 0.5
    assert not _scene(random_box_scene, 4, num_dynamic=0).gt_dynamic(1).any()


def _pose_project_roundtrip():
    sc = _scene(random_box_scene, 5)
    pts, _, _, _ = sc.hit_points(2)
    uv = sc.project(2, pts)
    us, vs = _grid(sc)
    np.testing.assert_allclose(uv[..., 0], us, atol=1e-6)
    np.testing.assert_allclose(uv[..., 1], vs, atol=1e-6)


def _images_have_texture_and_nuisances_bounded():
    sc = _scene(random_box_scene, 6)
    imgs = np.stack([sc.render(v) for v in range(3)])
    assert imgs.std(axis=(1, 2, 3)).min() > 10.0
    d01 = np.abs(imgs[0].astype(int) - imgs[1].astype(int)).mean()
    assert 1.0 < d01 < 80.0


@pytest.mark.parametrize("check", [
    _depth_positive_and_finite, _flow_matches_reprojection_of_material_points,
    _flow_photometric_consistency_static, _dynamic_mask_only_on_movers,
    _pose_project_roundtrip, _images_have_texture_and_nuisances_bounded,
], ids=lambda f: f.__name__.lstrip("_"))
def test_reference_ground_truth_checks_hold(check):
    check()
