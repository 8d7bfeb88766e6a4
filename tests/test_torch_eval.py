"""Port parity: the evaluation tools (eval/traj_iou.py, eval/sintel.py,
eval/scannet.py, eval/plots.py, the eval package's exports).

`trajectory_label_metrics` is exactly equal to the reference's on seeded
labeled tracks; the Sintel and ScanNet CLIs write byte-equal errors_ate.txt
on pose and ground-truth files the tests write (a good, a drifting, an
under-registered and a missing sequence); `plot_trajectories` writes its PNG.
"""
import numpy as np
import pytest

import particlesfm_tpu.eval as jeval
from particlesfm_tpu.eval import scannet as jscannet
from particlesfm_tpu.eval import sintel as jsintel
from particlesfm_tpu.tracks.store import TrackArrays as JTrackArrays
import particlesfm_tpu_torch.eval as peval
from particlesfm_tpu_torch.eval import plots, scannet, sintel, traj_iou
from particlesfm_tpu_torch.eval.pose_eval import write_sintel_cam
from particlesfm_tpu_torch.tracks.store import TrackArrays

PRED = "particlesfm_tpu/colmap_outputs_converted/poses"


def _labeled_tracks(seed, N=300, T=7, H=40, W=56):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-2, W + 1, (N, T)), rng.uniform(-2, H + 1, (N, T))],
                  -1).astype(np.float32)
    mask = rng.random((N, T)) < 0.7
    mask[:, 3] = False                               # a frame nobody observes
    labels = (rng.random((N, T)) < 0.3).astype(np.int8)
    gt = np.zeros((T, H, W), np.float32)
    gt[:, 10:25, 15:40] = 1.0
    return xy, mask, labels, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_label_metrics_equal_the_reference(seed):
    xy, mask, labels, gt = _labeled_tracks(seed)
    got = traj_iou.trajectory_label_metrics(TrackArrays(xy, mask, labels), gt)
    want = jeval.trajectory_label_metrics(JTrackArrays(xy, mask, labels), gt)
    assert got == want
    assert got["num_images"] == 6.0
    assert traj_iou.DEGENERATE_SINTEL_SEQS == jeval.traj_iou.DEGENERATE_SINTEL_SEQS


def test_eval_package_exports_the_references_names():
    names = ("evaluate_sequence", "load_pose_dir", "read_sintel_cam", "read_scannet_pose",
             "trajectory_label_metrics")
    for n in names:
        assert hasattr(peval, n) and hasattr(jeval, n), n


def _rot(rng, amp):
    a = rng.normal(size=3) * amp
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R, _ = np.linalg.qr(np.eye(3) + K)
    return R * np.sign(np.diag(R))[None]


def _trajectory(rng, T):
    """GT world-to-camera [T, 3, 4] on a smooth walk, and a noisy Sim3 copy."""
    gt, est = [], []
    s, Rw, tw = 1.7, _rot(rng, 0.3), rng.normal(size=3)
    for i in range(T):
        R = _rot(rng, 0.05) @ _rot(np.random.default_rng(i), 0.1)
        C = np.array([0.3 * i, 0.05 * np.sin(i), 0.02 * i * i]) + rng.normal(size=3) * 0.01
        gt.append(np.concatenate([R, (-R @ C)[:, None]], 1))
        Ce = s * Rw @ C + tw + rng.normal(size=3) * 0.02
        Re = R @ Rw.T
        est.append(np.concatenate([Re, (-Re @ Ce)[:, None]], 1))
    return np.stack(gt), np.stack(est)


@pytest.fixture(scope="module")
def pose_roots(tmp_path_factory):
    """Sintel and ScanNet layouts over 4 sequences: 12 frames each; `seq_c`
    has 8 of 12 predicted (under the 80% rule), `seq_d` no prediction."""
    root = tmp_path_factory.mktemp("poses")
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 48], [0, 500.0, 32], [0, 0, 1]])
    for seq, keep in (("seq_a", 12), ("seq_b", 12), ("seq_c", 8), ("seq_d", 0)):
        gt, est = _trajectory(rng, 12)
        (root / "sintel" / seq).mkdir(parents=True)
        (root / "scannet" / seq / "pose").mkdir(parents=True)
        if keep:
            (root / "pred" / seq / PRED).mkdir(parents=True)
        for i in range(12):
            write_sintel_cam(root / "sintel" / seq / f"frame_{i + 1:04d}.cam", K, gt[i])
            c2w = np.linalg.inv(np.vstack([gt[i], [0, 0, 0, 1]]))
            np.savetxt(root / "scannet" / seq / "pose" / f"frame_{i + 1:04d}.txt", c2w)
            if i < keep:
                np.savetxt(root / "pred" / seq / PRED / f"frame_{i + 1:04d}.txt", est[i])
    return root


@pytest.mark.parametrize("tool", ["sintel", "scannet"])
def test_eval_clis_write_the_references_errors_ate(pose_roots, tool):
    mods = {"sintel": (sintel, jsintel), "scannet": (scannet, jscannet)}[tool]
    argv = ["--gt_root", str(pose_roots / tool), "--pred_root", str(pose_roots / "pred"),
            "--seqs", "seq_a", "seq_b", "seq_c", "seq_d", "seq_missing"]
    out = pose_roots / "pred" / "errors_ate.txt"
    texts = []
    for mod in mods:
        out.unlink(missing_ok=True)
        assert mod.main(argv) == 0
        texts.append(out.read_bytes())
    assert texts[0] == texts[1]
    txt = texts[0].decode()
    assert "seq_a: ATE" in txt and "seq_c: FAILED (8/12" in txt and "seq_d: FAILED" in txt
    assert "seq_missing" not in txt and "failures 2/4" in txt


def test_scannet_cli_lists_every_scene_by_default(pose_roots):
    out = pose_roots / "pred" / "errors_ate.txt"
    texts = []
    for mod in (scannet, jscannet):
        out.unlink(missing_ok=True)
        mod.main(["--gt_root", str(pose_roots / "scannet"), "--pred_root",
                  str(pose_roots / "pred")])
        texts.append(out.read_bytes())
    assert texts[0] == texts[1] and b"seq_c" in texts[0]


def test_plot_trajectories_writes_png(pose_roots, tmp_path):
    from particlesfm_tpu_torch.eval.pose_eval import load_pose_dir, read_sintel_cam

    gt = {p.stem: read_sintel_cam(p)[1]
          for p in sorted((pose_roots / "sintel" / "seq_a").glob("*.cam"))}
    est = load_pose_dir(pose_roots / "pred" / "seq_a" / PRED)
    plots.plot_trajectories(est, gt, tmp_path / "seq_a.png", "seq_a")
    assert (tmp_path / "seq_a.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    plots.plot_trajectories(dict(list(est.items())[:2]), gt, tmp_path / "few.png")
    assert not (tmp_path / "few.png").exists()      # fewer than 3 common frames
