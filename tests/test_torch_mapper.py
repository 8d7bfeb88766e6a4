"""Port parity: the global mapper, the reconstruction manager and the model
export against the JAX package (mirrors tests/test_mapper.py,
test_manager.py and test_mapper_degenerate.py).

The JAX manager runs once on the orbit scene (module fixture; its first
model is JAX's `run_global_mapper` on the same tracks); the port runs both.
Tolerances: the same registered frames; Sim3 ATE between the two packages'
camera centers <= 1e-3 scene units; focal within 1e-3 relative; the
exported models read back with the same images and camera, poses within
1e-4 and the same points within 1e-3. The port-only cases hold the port to
the reference tests' own ground-truth bounds.
"""
import numpy as np
import pytest
import torch

from particlesfm_tpu.sfm import export as jexport
from particlesfm_tpu.sfm import manager as jmanager
from particlesfm_tpu.utils.config import SfmConfig as JSfmConfig
from particlesfm_tpu_torch.geometry import alignment, se3
from particlesfm_tpu_torch.io import colmap_model as cm
from particlesfm_tpu_torch.sfm import export, manager
from particlesfm_tpu_torch.sfm.mapper import run_global_mapper
from particlesfm_tpu_torch.sfm.stats import compute_model_stats
from particlesfm_tpu_torch.tracks.store import TrackArrays
from particlesfm_tpu_torch.utils.config import SfmConfig

from synthetic import orbit_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

QUIET = dict(log=lambda *a: None)


def _centers(rec):
    return se3.camera_center(torch.as_tensor(rec.qvec), torch.as_tensor(rec.tvec)).numpy()


def _cfg(cls):
    cfg = cls()
    cfg.ba.refine_focal_length = True    # the default prior 768 px vs the scene's 500
    cfg.ba.max_tracks = 250              # BA on a ranked subset, as at full size
    return cfg


@pytest.fixture(scope="module")
def orbit():
    sc = orbit_scene(num_views=10, num_points=300, pixel_noise=0.3, seed=1)
    args = (sc["tracks"], sc["height"], sc["width"])
    jmodels = jmanager.run_reconstruction_manager(*args, _cfg(JSfmConfig), **QUIET)
    rec = run_global_mapper(*args, _cfg(SfmConfig), device="cpu", **QUIET)
    models = manager.run_reconstruction_manager(*args, _cfg(SfmConfig), device="cpu", **QUIET)
    return sc, jmodels, rec, models


def test_mapper_registers_the_reference_frames(orbit):
    sc, jmodels, rec, _ = orbit
    np.testing.assert_array_equal(rec.registered, jmodels[0].registered)
    assert rec.num_registered == 10


def test_mapper_poses_match_the_reference(orbit):
    sc, jmodels, rec, _ = orbit
    reg = rec.registered
    assert alignment.ate_rmse(_centers(rec)[reg], _centers(jmodels[0])[reg]) <= 1e-3
    # and the reference test's own bound against the ground truth
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    assert alignment.ate_rmse(_centers(rec)[reg], sc["centers"][reg]) < 0.01 * span


def test_mapper_focal_matches_the_reference(orbit):
    _, jmodels, rec, _ = orbit
    assert abs(float(rec.params[0]) / float(jmodels[0].params[0]) - 1) < 1e-3
    assert abs(float(rec.params[0]) - 500.0) < 10.0


def test_mapper_stats_match_the_reference(orbit):
    _, jmodels, rec, _ = orbit
    s = compute_model_stats(rec)
    from particlesfm_tpu.sfm.stats import compute_model_stats as jstats
    sj = jstats(jmodels[0])
    assert s["num_reg_images"] == sj["num_reg_images"] == 10
    assert abs(s["num_points3D"] - sj["num_points3D"]) <= 0.01 * sj["num_points3D"]
    assert abs(s["mean_reprojection_error_px"] - sj["mean_reprojection_error_px"]) < 1e-2
    assert s["mean_reprojection_error_px"] < 1.0


def test_manager_matches_the_reference(orbit):
    _, jmodels, rec, models = orbit
    assert len(models) == len(jmodels) == 1
    np.testing.assert_array_equal(models[0].registered, jmodels[0].registered)
    np.testing.assert_allclose(models[0].qvec, rec.qvec, atol=0)   # deterministic


def test_exported_models_read_back_equal(orbit, tmp_path):
    """Both packages' writers on their own reconstructions; the port's
    reader reads both. The scene scale is the LUD solution's camera spread,
    which ADMM's loose stop (1e-4 residuals) leaves a few percent apart, so
    translations and points are compared after that scale ratio."""
    _, jmodels, rec, _ = orbit
    export.write_colmap_model(rec, tmp_path / "port")
    jexport.write_colmap_model(jmodels[0], tmp_path / "ref")
    cp, ip, pp = cm.read_model_binary(tmp_path / "port")
    cj, ij, pj = cm.read_model_binary(tmp_path / "ref")
    assert cp[1].model == cj[1].model == "SIMPLE_PINHOLE"
    np.testing.assert_allclose(cp[1].params, cj[1].params, rtol=1e-3)
    assert sorted(ip) == sorted(ij)
    scale = (np.linalg.norm([ij[k].tvec for k in ij]) / np.linalg.norm([ip[k].tvec for k in ip]))
    assert abs(scale - 1) < 0.05
    for k in ip:
        assert ip[k].name == ij[k].name
        q1, q2 = ip[k].qvec, ij[k].qvec
        np.testing.assert_allclose(q1 * np.sign(q1 @ q2), q2, atol=1e-4)
        np.testing.assert_allclose(ip[k].tvec * scale, ij[k].tvec, atol=1e-3)
    common = set(pp) & set(pj)
    assert len(common) >= 0.99 * max(len(pp), len(pj))
    err = max(np.abs(pp[k].xyz * scale - pj[k].xyz).max() for k in common)
    assert err < 1e-3


def test_colmap_export_roundtrip(orbit, tmp_path):
    """The fast binary writer against the dict model, field for field (as
    tests/test_mapper.py holds the reference's)."""
    _, _, rec, _ = orbit
    cams, images, points = export.to_colmap_model(rec)
    export.write_colmap_model(rec, tmp_path / "model")
    cams2, images2, points2 = cm.read_model_binary(tmp_path / "model")
    assert len(images2) == rec.num_registered and len(points2) == len(points)
    for iid, im in images.items():
        np.testing.assert_allclose(images2[iid].qvec, im.qvec, atol=1e-9)
        np.testing.assert_allclose(images2[iid].xys, im.xys, atol=1e-9)
        np.testing.assert_array_equal(images2[iid].point3D_ids, im.point3D_ids)
    for pid, p in points.items():
        np.testing.assert_allclose(points2[pid].xyz, p.xyz, atol=1e-9)
        np.testing.assert_array_equal(points2[pid].image_ids, p.image_ids)
        np.testing.assert_array_equal(points2[pid].point2D_idxs, p.point2D_idxs)
    cm.write_model_text(cams, images, points, tmp_path / "txt")
    cams3, images3, points3 = cm.read_model_text(tmp_path / "txt")
    assert len(images3) == len(images) and len(points3) == len(points)


def test_converted_outputs_match_the_reference(orbit, tmp_path):
    _, jmodels, rec, _ = orbit
    export.write_converted_outputs(rec, tmp_path / "port")
    jexport.write_converted_outputs(jmodels[0], tmp_path / "ref")
    for sub in ("poses", "intrinsics", "depths"):
        a = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        b = sorted(p.name for p in (tmp_path / "ref" / sub).iterdir())
        assert a == b and len(a) == 10
    P = np.loadtxt(tmp_path / "port" / "poses" / "000003.txt")
    Pj = np.loadtxt(tmp_path / "ref" / "poses" / "000003.txt")
    np.testing.assert_allclose(P[:, :3], Pj[:, :3], atol=1e-4)
    K = np.loadtxt(tmp_path / "port" / "intrinsics" / "000003.txt")
    np.testing.assert_allclose(K, np.loadtxt(tmp_path / "ref" / "intrinsics" / "000003.txt"),
                               rtol=1e-3)
    d = np.load(tmp_path / "port" / "depths" / "000003.npy")
    assert d.shape == (480, 640) and (d > 0).sum() > 100


# ---- port-only cases, held to the reference tests' own bounds ------------

def _split_scene():
    sc1 = orbit_scene(num_views=7, num_points=220, seed=0)
    sc2 = orbit_scene(num_views=5, num_points=160, seed=1)
    xy = np.zeros((380, 12, 2), np.float32)
    mask = np.zeros((380, 12), bool)
    xy[:220, :7], mask[:220, :7] = sc1["tracks"].xy, sc1["tracks"].mask
    xy[220:, 7:], mask[220:, 7:] = sc2["tracks"].xy, sc2["tracks"].mask
    return TrackArrays(xy=xy, mask=mask)


def test_manager_split_sequence_two_models(tmp_path):
    models = manager.run_reconstruction_manager(_split_scene(), 480, 640, SfmConfig(),
                                                device="cpu", **QUIET)
    assert sorted(m.num_registered for m in models) == [5, 7]
    assert (np.stack([m.registered for m in models]).sum(0) <= 1).all()
    best = manager.write_models(models, tmp_path / "model", **QUIET)
    assert best.num_registered == 7
    for sub in ("0", "1", "."):
        assert (tmp_path / "model" / sub / "images.bin").exists()
    assert len(cm.read_images_binary(tmp_path / "model" / "images.bin")) == 7


def test_manager_passes_labels_to_gate():
    sc = orbit_scene(num_views=8, num_points=280, pixel_noise=0.3, seed=13)
    tracks = sc["tracks"]
    labels = np.zeros(tracks.mask.shape, np.int8)
    labels[np.random.default_rng(5).random(tracks.num_tracks) < 0.4] = 1
    logs = []
    models = manager.run_reconstruction_manager(
        TrackArrays(xy=tracks.xy, mask=tracks.mask, labels=labels), sc["height"], sc["width"],
        SfmConfig(), device="cpu", log=lambda *a: logs.append(" ".join(map(str, a))))
    assert any("seg-geometry gate" in m for m in logs)
    best = manager.largest_model(models)
    assert best.num_registered == 8 and best.track_valid.sum() > 0.8 * tracks.num_tracks


def test_glomap_mode_recovers_poses():
    sc = orbit_scene(num_views=10, num_points=300, pixel_noise=0.3, seed=2)
    cfg = SfmConfig()
    cfg.sfm_type = "glomap"
    rec = run_global_mapper(sc["tracks"], sc["height"], sc["width"], cfg, device="cpu", **QUIET)
    assert rec.num_registered == 10
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    assert alignment.ate_rmse(_centers(rec), sc["centers"]) < 0.01 * span


def test_multi_start_runs_above_flow_noise():
    """Kept observations above cfg.multi_start_err_px (0.65 px) start the
    mapper again with the loop-consistency gate and keep the better score;
    the result holds the reference tests' 0.01-of-span bound."""
    sc = orbit_scene(num_views=10, num_points=300, pixel_noise=1.0, seed=1)
    cfg = SfmConfig()
    cfg.ba.refine_focal_length = True
    logs = []
    rec = run_global_mapper(sc["tracks"], sc["height"], sc["width"], cfg, device="cpu",
                            log=lambda *a: logs.append(" ".join(map(str, a))))
    assert any("multi-start with loop-consistency gate" in m for m in logs)
    assert any("multi-start scores" in m for m in logs)
    assert rec.num_registered == 10
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    assert alignment.ate_rmse(_centers(rec), sc["centers"]) < 0.01 * span


def test_random_tracks_fail_gracefully():
    rng = np.random.default_rng(0)
    tracks = TrackArrays(xy=rng.uniform(0, 400, (300, 8, 2)).astype(np.float32),
                         mask=rng.random((300, 8)) < 0.6)
    rec = run_global_mapper(tracks, 480, 640, SfmConfig(), device="cpu", **QUIET)
    assert rec.num_registered == 0 and rec.points.shape[0] == 0


def _project_scene(X, Rs, ts, f, h, w):
    T, N = len(Rs), len(X)
    xy = np.zeros((N, T, 2), np.float32)
    mask = np.zeros((N, T), bool)
    for t in range(T):
        Xc = X @ Rs[t].T + ts[t]
        u = f * Xc[:, 0] / Xc[:, 2] + w / 2
        v = f * Xc[:, 1] / Xc[:, 2] + h / 2
        xy[:, t, 0], xy[:, t, 1] = u, v
        mask[:, t] = (Xc[:, 2] > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return TrackArrays(xy=xy, mask=mask)


def _yaw(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def test_mapper_survives_planar_scene():
    """All points on one plane: the essential RANSAC is degenerate and the
    classification's repose-from-H path keeps the mapper on track."""
    rng = np.random.default_rng(0)
    T, h, w, f = 8, 480, 640, 768.0
    Rs, ts, Cs = [], [], []
    for i in range(T):
        a = np.deg2rad(3.0 * i)
        C = np.array([6.0 * np.sin(a), 0.15 * i, -6.0 * np.cos(a) + 6.0])
        R = _yaw(-a * 0.5)
        Rs.append(R), ts.append(-R @ C), Cs.append(C)
    X = np.stack([rng.uniform(-6, 6, 400), rng.uniform(-4, 4, 400), np.full(400, 8.0)], 1)
    tracks = _project_scene(X, np.array(Rs), np.array(ts), f, h, w)
    tracks.xy += rng.normal(0, 0.3, tracks.xy.shape).astype(np.float32)
    rec = run_global_mapper(tracks, h, w, SfmConfig(), device="cpu", **QUIET)
    assert rec.num_registered == T
    Cs = np.array(Cs)
    assert alignment.ate_rmse(_centers(rec), Cs) < 0.05 * np.linalg.norm(Cs[-1] - Cs[0])


def test_pure_rotation_fails_gracefully():
    """A tripod pan has no baseline anywhere: a failed reconstruction, not
    fabricated positions."""
    rng = np.random.default_rng(1)
    T, h, w, f = 6, 480, 640, 768.0
    Rs = np.array([_yaw(np.deg2rad(2.5 * i)) for i in range(T)])
    X = np.stack([rng.uniform(-5, 5, 300), rng.uniform(-3, 3, 300), rng.uniform(6, 14, 300)], 1)
    tracks = _project_scene(X, Rs, np.zeros((T, 3)), f, h, w)
    rec = run_global_mapper(tracks, h, w, SfmConfig(), device="cpu", **QUIET)
    assert rec.num_registered == 0

