"""Port parity: the incremental mapper (mirrors tests/test_incremental.py).

JAX's `run_incremental_mapper` runs once on the 8-view orbit scene (module
fixture; ~60 s of compiles on one core), the port's on the same tracks with
the reference's draws. Tolerances: the same seed pair, registered frames and
registration order; Sim3 ATE between the two packages' camera centers
<= 1e-3 x the span; focal within 1e-3 relative. The port-only cases hold
the port to test_incremental.py's own ground-truth bounds.
"""
import numpy as np
import pytest
import torch

from particlesfm_tpu.sfm.incremental import run_incremental_mapper as jrun_incremental
from particlesfm_tpu.utils.config import SfmConfig as JSfmConfig
from particlesfm_tpu_torch.geometry import alignment, se3
from particlesfm_tpu_torch.sfm.incremental import run_incremental_mapper
from particlesfm_tpu_torch.tracks.store import TrackArrays
from particlesfm_tpu_torch.utils.config import SfmConfig

from synthetic import orbit_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _centers(rec):
    return se3.camera_center(torch.as_tensor(rec.qvec), torch.as_tensor(rec.tvec)).numpy()


def _order(logs):
    """(seed pair line, registered images in order) from the mapper's log."""
    seed = next(m.split(":")[0] for m in logs if "seed pair" in m)
    return seed, [int(m.split("registered image ")[1].split()[0])
                  for m in logs if "registered image" in m]


@pytest.fixture(scope="module")
def orbit():
    sc = orbit_scene(num_views=8, num_points=250, pixel_noise=0.3, seed=3)
    args = (sc["tracks"], sc["height"], sc["width"])
    jlogs, logs = [], []
    jrec = jrun_incremental(*args, JSfmConfig(), log=jlogs.append)
    rec = run_incremental_mapper(*args, SfmConfig(), log=logs.append, device="cpu")
    return sc, jrec, jlogs, rec, logs


def test_registers_the_reference_frames_in_the_reference_order(orbit):
    sc, jrec, jlogs, rec, logs = orbit
    np.testing.assert_array_equal(rec.registered, jrec.registered)
    assert rec.num_registered == 8
    assert _order(logs) == _order(jlogs)


def test_poses_and_focal_match_the_reference(orbit):
    sc, jrec, _, rec, _ = orbit
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    reg = rec.registered
    assert alignment.ate_rmse(_centers(rec)[reg], _centers(jrec)[reg]) <= 1e-3 * span
    assert abs(float(rec.params[0]) / float(jrec.params[0]) - 1) < 1e-3
    assert rec.track_valid.sum() == jrec.track_valid.sum()


def test_reconstructs_orbit(orbit):
    sc, _, _, rec, _ = orbit
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    reg = rec.registered
    assert alignment.ate_rmse(_centers(rec)[reg], sc["centers"][reg]) < 0.02 * span
    assert rec.track_valid.sum() > 150
    assert rec.points.shape == (len(rec.track_row), 3) and np.isfinite(rec.points).all()


def test_seg_geometry_gate():
    """Noisy seg labels (false dynamic flags) are advisory in the port's
    incremental mapper too: epipolar evidence rescues static tracks."""
    sc = orbit_scene(num_views=8, num_points=260, pixel_noise=0.3, seed=11)
    tracks = sc["tracks"]
    labels = np.zeros(tracks.mask.shape, np.int8)
    labels[np.random.default_rng(2).random(tracks.num_tracks) < 0.4] = 1
    noisy = TrackArrays(xy=tracks.xy, mask=tracks.mask, labels=labels)
    logs = []
    rec = run_incremental_mapper(noisy, sc["height"], sc["width"], SfmConfig(),
                                 log=logs.append, device="cpu")
    assert rec.num_registered == 8
    assert any("seg-geometry gate" in m for m in logs)
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    reg = rec.registered
    assert alignment.ate_rmse(_centers(rec)[reg], sc["centers"][reg]) < 0.02 * span
    assert rec.track_valid.sum() > 0.8 * tracks.num_tracks


def test_too_few_views_fail_gracefully():
    """Two views give the seed pair and nothing to register: a failed
    reconstruction (fewer than 3 registered), as in the reference."""
    sc = orbit_scene(num_views=2, num_points=100, pixel_noise=0.3, seed=4)
    rec = run_incremental_mapper(sc["tracks"], sc["height"], sc["width"], SfmConfig(),
                                 log=lambda *a: None, device="cpu")
    assert rec.num_registered == 0
