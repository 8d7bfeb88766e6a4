"""Port parity: the trajectory motion-seg net on the repo's checkpoint, the
window cut and sample, the GT label helper, and `segment_tracks` with both
real checkpoints, against the JAX package.

Tolerances: logits within 1e-3 and finite, padded (fully invalid) track
slots included; windows, samples and GT labels identical; segment_tracks
labels identical except at observations whose logit lies within 1e-3 of the
decision threshold's.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from particlesfm_tpu.models.motionseg import TrajOADepth as JTrajOADepth
from particlesfm_tpu.motionseg import infer as jinfer
from particlesfm_tpu.motionseg.data import find_traj_label as jfind_traj_label
from particlesfm_tpu.pipeline import run as jrun
from particlesfm_tpu.tracks import store as jstore
from particlesfm_tpu_torch.io.checkpoint import motionseg_state_dict_from_jax
from particlesfm_tpu_torch.models.motionseg import TrajOADepth
from particlesfm_tpu_torch.motionseg import infer
from particlesfm_tpu_torch.motionseg.data import find_traj_label
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.tracks.store import TrackArrays, sample_inside_window
from particlesfm_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "motionseg_synth3d.msgpack"
HW = (30, 53)


def test_trajoadepth_matches_jax():
    blob = msgpack_restore(CKPT.read_bytes())
    variables = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    model = TrajOADepth(HW)
    model.load_state_dict(motionseg_state_dict_from_jax(blob["params"], blob["batch_stats"]),
                          strict=True)
    rng = np.random.default_rng(0)
    B, N, L = 2, 300, 10
    traj = rng.uniform(0, 1, (B, N, L, 2)).astype(np.float32)
    valid = rng.random((B, N, L)) < 0.8
    traj[:, -40:], valid[:, -40:] = 0.0, False            # padded slots
    valid[:, :20, 1::2] = False                           # gaps inside a track
    depth = rng.uniform(0, 1, (B, L) + HW).astype(np.float32)
    out_j = np.asarray(jax.jit(lambda v, t, d, m: JTrajOADepth(input_hw=HW).apply(
        v, t, d, m, train=False))(variables, jnp.asarray(traj), jnp.asarray(depth),
                                  jnp.asarray(valid)))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(traj), torch.from_numpy(depth),
                           torch.from_numpy(valid)).numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - out_j).max() <= 1e-3


def test_trajoadepth_holds_at_chunk_width():
    """At the main path's chunk width (13,107 slots, a third padded) the
    logits do not move when the tracks are reordered (the soft pooling over
    the track axis is order-free up to rounding), and agree with JAX's."""
    blob = msgpack_restore(CKPT.read_bytes())
    variables = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    model = TrajOADepth(HW)
    model.load_state_dict(motionseg_state_dict_from_jax(blob["params"], blob["batch_stats"]),
                          strict=True)
    rng = np.random.default_rng(0)
    N, L = 13107, 10
    traj = rng.uniform(0, 1, (1, N, L, 2)).astype(np.float32)
    valid = rng.random((1, N, L)) < 0.8
    traj[:, -4000:], valid[:, -4000:] = 0.0, False
    depth = rng.uniform(0, 1, (1, L) + HW).astype(np.float32)
    perm = rng.permutation(N)
    t, d, v = torch.from_numpy(traj), torch.from_numpy(depth), torch.from_numpy(valid)
    with torch.no_grad():
        out = model.eval()(t, d, v).numpy()
        out_p = model(t[:, perm], d, v[:, perm]).numpy()
    out_j = np.asarray(jax.jit(lambda v, t, d, m: JTrajOADepth(input_hw=HW).apply(
        v, t, d, m, train=False))(variables, jnp.asarray(traj), jnp.asarray(depth),
                                  jnp.asarray(valid)))
    assert np.abs(out_p - out[:, perm]).max() <= 1e-4
    assert np.abs(out - out_j).max() <= 1e-3


@pytest.mark.parametrize("T,w", [(5, 10), (10, 10), (12, 10), (48, 10), (47, 7)])
def test_cut_windows_matches_jax(T, w):
    a, b = infer.cut_windows(T, w), jinfer.cut_windows(T, w)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _tracks(seed, N, T, H, W):
    rng = np.random.default_rng(seed)
    xy = np.zeros((N, T, 2), np.float32)
    mask = np.zeros((N, T), bool)
    for n in range(N):
        s = int(rng.integers(0, T - 3))
        ln = int(rng.integers(3, T - s + 1))
        mask[n, s:s + ln] = rng.random(ln) < 0.9
        mask[n, s:s + 3] = True
        xy[n, s:s + ln] = (rng.uniform(0, [W, H])
                           + np.cumsum(rng.normal(0, 1.5, (ln, 2)), 0))
    return np.clip(xy, 0, [W - 1, H - 1]).astype(np.float32) * mask[..., None], mask


def test_sample_inside_window_matches_jax():
    xy, mask = _tracks(1, 400, 12, 48, 64)
    win = np.arange(2, 12)
    a = sample_inside_window(TrackArrays(xy, mask), win, max_num_tracks=150,
                             rng=np.random.default_rng(5))
    b = jstore.sample_inside_window(jstore.TrackArrays(xy=xy, mask=mask), win,
                                    max_num_tracks=150, rng=np.random.default_rng(5))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a[2]) == 150


def test_find_traj_label_matches_jax():
    xy, mask = _tracks(2, 200, 12, 48, 64)
    gt = np.random.default_rng(3).random((12, 48, 64)) < 0.3
    np.testing.assert_array_equal(find_traj_label(xy, mask, gt), jfind_traj_label(xy, mask, gt))
    win = np.arange(2, 12)
    np.testing.assert_array_equal(find_traj_label(xy[:, win], mask[:, win], gt, win),
                                  jfind_traj_label(xy[:, win], mask[:, win], gt, win))


def test_segment_tracks_matches_jax():
    """Both packages' depth and seg applies on the repo's checkpoints; 12
    frames make two windows (the second realigned to the end), 1,500 tracks
    with max_cells 2048 make two chunks of 1,024 with zero-padded slots. The
    net calls these random tracks static, so the decision threshold is set
    at the median logit to split them."""
    T, H, W = 12, 48, 64
    xy, mask = _tracks(4, 1500, T, H, W)
    frames = np.random.default_rng(6).integers(0, 256, (T, H, W, 3)).astype(np.uint8)
    cfg = Config()
    d_j = jrun._load_depth_apply(cfg)(frames.astype(np.float32))
    d = run._load_depth_apply(cfg, torch.device("cpu"))(torch.from_numpy(frames))
    seg_j = jrun._load_seg_apply(cfg)
    seg = run._load_seg_apply(cfg, torch.device("cpu"))
    assert seg.accepts_u16 and seg.threshold is None

    logits = []

    def recording(traj, depth, valid):
        out = seg(traj, depth, valid)
        logits.append(out.numpy())
        return out

    recording.accepts_u16 = True
    kw = dict(window_size=10, traj_max_num=1400, max_cells=2048)
    infer.segment_tracks(recording, TrackArrays(xy, mask), d, (H, W), **kw)
    assert len(logits) == 2 and logits[0].shape == (2, 1024)
    lg = np.concatenate(logits, 1)
    assert np.isfinite(lg).all()
    rng = np.random.default_rng(0)
    samples = [sample_inside_window(TrackArrays(xy, mask), win, max_num_tracks=1400, rng=rng)
               for win in infer.cut_windows(T, 10)]
    cut = float(np.median(np.concatenate([lg[b, :len(s[2])] for b, s in enumerate(samples)])))
    kw["threshold"] = float(1 / (1 + np.exp(-cut)))
    lab = infer.segment_tracks(seg, TrackArrays(xy, mask), d, (H, W), **kw).labels
    lab_j = jinfer.segment_tracks(seg_j, jstore.TrackArrays(xy=xy, mask=mask), d_j,
                                  (H, W), **kw).labels
    # observations whose window logit is within 1e-3 of the decision
    near = np.zeros_like(mask)
    for b, (win, (_, present, rows)) in enumerate(zip(infer.cut_windows(T, 10), samples)):
        close = np.abs(lg[b, :len(rows)] - cut) < 1e-3
        near[rows[:, None], win[None, :]] |= present & close[:, None]
    assert mask.sum() > 5000
    assert not np.any((lab != lab_j) & ~near)
    assert 0.2 < lab[mask].mean() < 0.8
