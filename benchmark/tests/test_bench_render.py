"""The benchmark's device renderer against the port's numpy renderer: the
same generator state gives the same scene, frames, poses and focal."""
import numpy as np
import pytest
import torch

import bench_scenes as S
from particlesfm_tpu_torch.synth.render import random_scene

RECIPE = dict(focal_factor=[1.02, 1.38], num_dynamic=[1, 2], motion_scale=[0.06, 0.2],
              rot_scale=[0.08, 0.32], num_static_obj=[6, 12])


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 7])
def test_frames_poses_focal_equal_numpy_renderer(seed):
    T, H, W = 5, 40, 72
    scene = S.draw_scene(np.random.default_rng(seed), RECIPE, T, H, W)
    rng = np.random.default_rng(seed)
    focal = W * rng.uniform(1.02, 1.38)
    nd = int(rng.integers(1, 3))
    ms, rs = float(rng.uniform(0.06, 0.2)), float(rng.uniform(0.08, 0.32))
    ns = int(rng.integers(6, 13))
    ref = random_scene(rng, num_views=T, height=H, width=W, focal=focal, num_dynamic=nd,
                       motion_scale=ms, rot_scale=rs, num_static_obj=ns)
    assert scene.K == ref.K
    for v in range(T):
        a = S.render_frame(scene, v, "cpu").numpy().astype(int)
        b = ref.render(v).astype(int)
        # float64 sines of two libraries may round a level across a boundary
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3
        np.testing.assert_allclose(scene.w2c(v), ref.world_to_cam(v), rtol=0, atol=1e-12)


def test_seeded_rng_takes_large_and_negative_seeds():
    a = S.seeded_rng(2 ** 40 + 3, 0, 1).random()
    assert a == S.seeded_rng(2 ** 40 + 3, 0, 1).random()
    assert a != S.seeded_rng(-(2 ** 40 + 3), 0, 1).random()


def test_ppm_round_trip(tmp_path):
    from PIL import Image

    fr = (np.arange(6 * 10 * 3) % 256).astype(np.uint8).reshape(6, 10, 3)
    S.write_ppm(tmp_path / "a.ppm", fr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.ppm")), fr)


def test_render_sequence_writes_frames(tmp_path):
    seq = S.render_sequence(np.random.default_rng(1), RECIPE, 3, 32, 48, tmp_path / "s", "cpu")
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == [
        "000000.ppm", "000001.ppm", "000002.ppm"]
    assert seq.frames.shape == (3, 32, 48, 3) and seq.frames.dtype == np.uint8
    assert torch.is_tensor(S.render_frame(seq.scene, 0, "cpu"))
