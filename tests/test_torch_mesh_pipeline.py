"""The pipeline's data-parallel applies on a mesh of CPU devices equal their
one-device results: the flow pair apply (5 pairs on a 2-entry mesh, so the
last block is ragged), the depth apply, the seg apply's window split under
`segment_tracks`; and `run_pipeline` builds its mesh from the device it is
given. Flows, depths and logits are compared bit for bit: each net call
runs the rows its one-device call runs (seg: a subset of the same windows,
which the net treats independently)."""
import numpy as np
import pytest
import torch

from particlesfm_tpu_torch.flow import infer
from particlesfm_tpu_torch.motionseg.infer import segment_tracks
from particlesfm_tpu_torch.parallel import make_mesh
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.synth import random_scene
from particlesfm_tpu_torch.tracks.store import TrackArrays
from particlesfm_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

T, H, W = 10, 64, 96
CPU = torch.device("cpu")
MESH2 = make_mesh(devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def frames():
    sc = random_scene(np.random.default_rng(0), num_views=T, height=H, width=W,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    return np.stack([np.asarray(sc.render(i)) for i in range(T)])


@pytest.fixture(autouse=True)
def empty_cache():
    run._APPLY_CACHE.clear()
    yield
    run._APPLY_CACHE.clear()


def _counting_net_calls(monkeypatch):
    sizes = []
    net = infer._net_flow

    def counted(model, i1, i2, iters, scale):
        sizes.append(i1.shape[0])
        return net(model, i1, i2, iters, scale)

    monkeypatch.setattr(infer, "_net_flow", counted)
    return sizes


@pytest.mark.parametrize("refine", [False, True])
def test_flow_pairs_on_a_mesh_equal_one_device(frames, monkeypatch, refine):
    """Blocks of 2 x 2 pairs: shards get pairs [0, 1] and [2, 3], then the
    ragged block's one pair goes to entry 0 — the one-device groups."""
    sizes = _counting_net_calls(monkeypatch)
    ia, ib = np.array([0, 1, 2, 3, 4]), np.array([1, 2, 3, 4, 5])
    kw = dict(iters=2, per_device=2,
              refine_schedule=((2, 1.0, 2),) if refine else None)
    one = infer.load_flow_apply_pairs(run.DEFAULT_RAFT_CKPT, device="cpu", **kw)
    want = one(frames, ia, ib)
    meshed = infer.load_flow_apply_pairs(run.DEFAULT_RAFT_CKPT, mesh=MESH2, **kw)
    got = meshed(frames, ia, ib)
    assert got.shape == (5, H, W, 2)
    assert torch.equal(got, want)
    assert sizes == [2, 2, 1] * 2


def test_depth_apply_on_a_mesh_equals_one_device(frames):
    """10 frames: blocks of 4 per entry (8 per block on 2 entries), the last
    block's 2 frames on entry 0."""
    cfg = Config()
    want = run._load_depth_apply(cfg, CPU)(torch.from_numpy(frames))
    got = run._load_depth_apply(cfg, MESH2)(torch.from_numpy(frames))
    assert got.shape == (T, H, W)
    assert torch.equal(got, want)


def _tracks(seed, N, T, H, W):
    rng = np.random.default_rng(seed)
    xy = np.zeros((N, T, 2), np.float32)
    mask = np.zeros((N, T), bool)
    for n in range(N):
        s = int(rng.integers(0, T - 3))
        ln = int(rng.integers(3, T - s + 1))
        mask[n, s:s + ln] = True
        xy[n, s:s + ln] = rng.uniform(0, [W, H]) + np.cumsum(rng.normal(0, 1.5, (ln, 2)), 0)
    return np.clip(xy, 0, [W - 1, H - 1]).astype(np.float32) * mask[..., None], mask


def test_segment_tracks_on_a_mesh_equals_one_device(monkeypatch):
    """28 frames make 3 windows (the last realigned to the end); 3,500 tracks
    with max_cells 2048 make two chunks. segment_tracks calls the apply once
    a chunk with all 3 windows; on the 2-entry mesh the apply splits them
    into blocks of 2 and 1. The threshold sits at the median logit so the
    labels are mixed."""
    from particlesfm_tpu_torch.models.motionseg import TrajOADepth

    n_frames, h, w = 28, 48, 64
    xy, mask = _tracks(4, 3500, n_frames, h, w)
    depth = torch.from_numpy(np.random.default_rng(1).random((n_frames, h, w), np.float32))
    cfg = Config()
    seg_one, seg_mesh = run._load_seg_apply(cfg, CPU), run._load_seg_apply(cfg, MESH2)
    logits, net_batches = {}, []
    forward = TrajOADepth.forward

    def counted(self, traj, *a, **k):
        net_batches.append(traj.shape[0])
        return forward(self, traj, *a, **k)

    monkeypatch.setattr(TrajOADepth, "forward", counted)

    def recording(apply, tag):
        def rec(traj, d, valid):
            out = apply(traj, d, valid)
            logits.setdefault(tag, []).append(out)
            return out
        rec.accepts_u16 = True
        return rec

    kw = dict(window_size=10, traj_max_num=1400, max_cells=2048)
    segment_tracks(recording(seg_one, "one"), TrackArrays(xy, mask), depth, (h, w), **kw)
    assert net_batches == [3, 3]
    segment_tracks(recording(seg_mesh, "mesh"), TrackArrays(xy, mask), depth, (h, w), **kw)
    assert net_batches[2:] == [2, 1, 2, 1]
    assert [lg.shape[0] for lg in logits["mesh"]] == [3, 3]
    one = torch.cat(logits["one"], 1)
    assert torch.equal(torch.cat(logits["mesh"], 1), one)
    cut = float(one[one != 0].median())
    kw["threshold"] = float(1 / (1 + np.exp(-cut)))
    lab = segment_tracks(seg_one, TrackArrays(xy, mask), depth, (h, w), **kw).labels
    lab_mesh = segment_tracks(seg_mesh, TrackArrays(xy, mask), depth, (h, w), **kw).labels
    assert 0.1 < lab[mask].mean() < 0.9
    np.testing.assert_array_equal(lab_mesh, lab)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("device,cards,want", [
    ("cpu", 0, ("cpu",)),
    ("cuda:1", 2, ("cuda:1",)),
    ("cuda", 3, ("cuda:0", "cuda:1", "cuda:2")),
])
def test_run_pipeline_builds_its_mesh(tmp_path, monkeypatch, device, cards, want):
    """run_pipeline's applies get the mesh of its device: the CPU or one
    named card alone, every visible card (faked here) for a bare "cuda"."""
    if cards:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    seen = []

    def stop(cfg, mesh):
        seen.append(mesh.key())
        raise _Stop

    monkeypatch.setattr(run, "_load_raft_apply", stop)
    monkeypatch.setattr(run, "load_image_stack",
                        lambda d: (np.zeros((2, 8, 8, 3), np.float32), ["a", "b"]))
    with pytest.raises(_Stop):
        run.run_pipeline(tmp_path, tmp_path / "out", Config(), log=lambda m: None,
                         device=device)
    assert seen == [want]
