"""CUDA tests of the port: each kernel against its plain version, and the
torch-op stages (self-calibration, depth, motion seg) and one step of each
trainer on the card against the same code on the CPU. The tracker's kernel
K2 is held against its plain torch version on the card, on random blocks and
frame by frame along rendered scenes of both benchmark configurations.

Marked `cuda`; they skip without a CUDA device. This file imports torch and
the port only (no JAX), so it runs on a GPU machine without the reference:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from particlesfm_tpu_torch.models.raft import build_corr_pyramid
from particlesfm_tpu_torch.ops import corr_lookup as cl
from particlesfm_tpu_torch.ops.sampling import bilinear_sample
from particlesfm_tpu_torch.tracks import engine
from particlesfm_tpu_torch.tracks import optimize as lm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode; the stages "
                    "are held card against CPU)")
    return torch.device("cuda")


def _pyramid(dev, B, H8, W8, levels):
    g = torch.Generator(device=dev).manual_seed(0)
    f1 = torch.randn(B, 64, H8, W8, generator=g, device=dev)
    f2 = torch.randn(B, 64, H8, W8, generator=g, device=dev)
    return build_corr_pyramid(f1, f2, levels)


def _coords(kind, B, H8, W8, levels, radius):
    """[B, H8*W8, 2] level-0 coordinates of one kind; the edge kinds hit each
    level's edges at that level's scale (coords / 2^l)."""
    rng = np.random.default_rng(1)
    P = H8 * W8
    ys, xs = np.mgrid[0:H8, 0:W8]
    grid = np.broadcast_to(np.stack([xs, ys], -1).reshape(1, P, 2), (B, P, 2)).astype(np.float32)
    lvl = rng.integers(0, levels, (B, P, 2))
    scale = 2.0 ** lvl
    hw = np.array([(H8 >> l, W8 >> l) for l in range(levels)], np.float64)[lvl, [1, 0]]
    if kind == "uniform":             # over the map and its border, 20% far out
        c = rng.uniform(-4, 1, (B, P, 2)) + rng.uniform(0, 1, (B, P, 2)) * [W8 + 8, H8 + 8]
        far = rng.random((B, P)) < 0.2
        c[far] = [-1e4, 3e4]
    elif kind == "integer":
        c = grid + rng.integers(-3, 4, (B, P, 2))
    elif kind == "edges":             # exactly Wl-1 / Hl-1 or -1 at level l
        c = np.where(rng.random((B, P, 2)) < 0.5, hw - 1, -1.0) * scale
    elif kind == "below_zero":        # just below 0 on one axis, in range on the other
        c = grid.astype(np.float64)
        axis = rng.integers(0, 2, (B, P))
        eps = rng.choice([1e-7, 1e-3, 0.3, 0.999], (B, P)) * scale[..., 0]
        np.put_along_axis(c, axis[..., None], -eps[..., None], axis=-1)
    else:                             # "clamp": centre in (Wl+r, Wl+r+1) or (-(r+2), -(r+1))
        u = rng.uniform(0.01, 0.99, (B, P, 2))
        c = np.where(rng.random((B, P, 2)) < 0.5, hw + radius + u, -(radius + 1 + u)) * scale
        keep = rng.random((B, P)) < 0.5
        c[keep, 1] = grid[keep, 1]
    return torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32))


def _check(pyr, coords, radius):
    """K1 against plain: one launch, 16-byte copies exactly when every level's
    width is a multiple of 4, within 1e-5 * max|corr|, and a level whose
    window lies off the map reads exactly 0."""
    before, before_vec = cl.launches, cl.vec_launches
    got = cl.lookup_corr(pyr, coords, radius)
    assert cl.launches == before + 1
    assert cl.vec_launches - before_vec == all(c.shape[-1] % 4 == 0 for c in pyr)
    want = cl.lookup_corr_plain(pyr, coords, radius)
    torch.cuda.synchronize()
    scale = float(pyr[0].abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    K2 = (2 * radius + 1) ** 2
    for lvl, c in enumerate(pyr):
        Hl, Wl = c.shape[-2:]
        p = coords / 2 ** lvl
        off = ((p[..., 0] >= Wl + radius) | (p[..., 1] >= Hl + radius)
               | (p.amin(-1) < -(radius + 1)))
        assert bool((got[..., lvl * K2:(lvl + 1) * K2][off] == 0).all())


@pytest.mark.parametrize("B,H8,W8,levels,radius", [
    (8, 55, 128, 4, 4),      # the main path's block at 1024x436
    (4, 32, 40, 4, 4),       # the flow trainer's validation (256x320, batch 4)
    (3, 13, 21, 4, 4),       # odd sizes: level 3 is 1x2
    (2, 16, 24, 2, 1),
    (1, 9, 10, 1, 3),
])
def test_corr_lookup_kernel_matches_plain(cuda, B, H8, W8, levels, radius):
    pyr = _pyramid(cuda, B, H8, W8, levels)
    _check(pyr, _coords("uniform", B, H8, W8, levels, radius).to(cuda), radius)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("radius", cl.RADII)
def test_corr_lookup_every_instantiation(cuda, radius, levels):
    # B*P = 546 / 418 is not a multiple of the 16-pixel tile; width 21 takes
    # the 4-byte copies, width 32 (levels 32..4) the 16-byte ones
    for H8, W8 in ((13, 21), (13, 32)):
        pyr = _pyramid(cuda, 2, H8, W8, levels)
        _check(pyr, _coords("uniform", 2, H8, W8, levels, radius).to(cuda), radius)


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("kind", ["integer", "edges", "below_zero", "clamp"])
def test_corr_lookup_edge_coordinates(cuda, kind, radius):
    for B, H8, W8 in ((3, 13, 21), (1, 9, 10), (2, 9, 32)):
        pyr = _pyramid(cuda, B, H8, W8, 4)
        _check(pyr, _coords(kind, B, H8, W8, 4, radius).to(cuda), radius)


def test_corr_lookup_repeated_launches(cuda):
    # the launch set-up is cached per instantiation and device: later launches
    # of one instantiation, with fewer and with more tiles than resident
    # blocks, give the same result as the first
    for B, H8, W8 in ((8, 55, 128), (1, 9, 12), (8, 55, 128)):
        pyr = _pyramid(cuda, B, H8, W8, 4)
        coords = _coords("uniform", B, H8, W8, 4, 4).to(cuda)
        first = cl.lookup_corr(pyr, coords, 4)
        _check(pyr, coords, 4)
        assert torch.equal(cl.lookup_corr(pyr, coords, 4), first)


def test_corr_lookup_kernel_rejects_bad_input(cuda):
    pyr = [torch.zeros(1, 4, 2, 2, device=cuda)]
    with pytest.raises(ValueError):
        cl.lookup_corr_cuda(pyr, torch.zeros(1, 4, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        cl.lookup_corr_cuda(pyr * 5, torch.zeros(1, 4, 2, device=cuda))


@pytest.mark.parametrize("radius", [0, 5])
def test_corr_lookup_rejects_unsupported_radius(cuda, radius):
    pyr = [torch.zeros(1, 4, 12, 12, device=cuda)]
    before = cl.launches
    with pytest.raises(ValueError):
        cl.lookup_corr(pyr, torch.zeros(1, 4, 2, device=cuda), radius)
    assert cl.launches == before


def _k2_vs_plain(args, f, num_iters, patch, upper_flow=20.0):
    """K2 and the plain version on copies of the same frame state: (the
    eligible mask, K2's and the plain version's refined [C, 4] positions).
    K2 launches once and leaves every slot that is not eligible as it was."""
    maps, (prev2, prev1, new_pos, survive, start_time) = args[:4], args[4:]
    out = []
    for fn in (lm.track_lm, lm.track_lm_plain):
        p1, p2 = prev1.clone(), new_pos.clone()
        before = lm.launches
        fn(*maps, prev2, p1, p2, survive, start_time, f, upper_flow=upper_flow,
           num_iters=num_iters, patch=patch)
        assert lm.launches == before + (fn is lm.track_lm)
        out.append(torch.cat([p1, p2], -1))
    eligible = survive & (start_time <= f - 1)
    same = torch.cat([prev1, new_pos], -1)[~eligible]
    assert torch.equal(out[0][~eligible], same)
    return eligible, out[0], out[1]


def _gap_stats(eligible, got, want):
    """(eligible slots, those whose position moved by more than 1e-4 px,
    the largest gap in px, the share equal to the last bit)."""
    gap = (got - want)[eligible].view(-1, 2, 2).norm(dim=-1).amax(-1)
    exact = (got == want)[eligible].all(-1)
    n = int(eligible.sum())
    return n, int((gap > 1e-4).sum()), float(gap.max()) if n else 0.0, \
        float(exact.float().mean()) if n else 1.0


def _lm_block(dev, C=40_000, H=436, W=1024, f=5, seed=0):
    """A random frame state: smooth flows with noise, stride-2 flows large
    enough that |flow02| >= 20 gates a third of the anchors off, occlusion
    in 8x8 tiles (anchors inside read o02 = 1: scale 0), 40% of the heads
    within 4 px of one of the four borders (their windows clip), and slots
    that are dead or born too late (masked)."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    def smooth(amp):
        coarse = amp * torch.randn(1, 2, H // 32 + 2, W // 32 + 2, generator=g, device=dev)
        fl = F.interpolate(coarse, size=(H, W), mode="bicubic", align_corners=True)[0]
        return (fl.permute(1, 2, 0) + 0.3 * torch.randn(H, W, 2, generator=g, device=dev)
                ).contiguous()

    tiles = (rand(H // 8 + 1, W // 8 + 1) < 0.2).float()
    occ02 = tiles.repeat_interleave(8, 0).repeat_interleave(8, 1)[:H, :W].contiguous()
    size = torch.tensor([W, H], device=dev, dtype=torch.float32)
    prev1 = (-2 + (size + 3) * rand(C, 2))
    near = rand(C) < 0.4
    axis = (rand(C) < 0.5).long()
    edge = torch.where(rand(C) < 0.5, -2 + 6 * rand(C), size[axis] - 5 + 6 * rand(C))
    prev1[near, axis[near]] = edge[near]
    prev2 = prev1 + 2 * torch.randn(C, 2, generator=g, device=dev)
    new_pos = prev1 + 2 * torch.randn(C, 2, generator=g, device=dev)
    survive = rand(C) < 0.85
    start_time = torch.randint(0, f + 1, (C,), generator=g, device=dev, dtype=torch.int32)
    return (smooth(4), smooth(4), smooth(14), occ02, prev2.contiguous(), prev1.contiguous(),
            new_pos.contiguous(), survive, start_time)


@pytest.mark.parametrize("num_iters", [0, 1, 12])
@pytest.mark.parametrize("patch", [True, False])
def test_track_lm_kernel_matches_plain(cuda, patch, num_iters):
    """K2 against the plain torch ops on the card, on a random block: at
    most 1e-4 of the eligible slots move by more than 1e-4 px."""
    f = 5
    args = _lm_block(cuda, f=f)
    eligible, got, want = _k2_vs_plain(args, f, num_iters, patch)
    # the block holds every kind of row
    x0, f02, occ02, prev1 = args[4], args[2], args[3], args[5]
    o02 = bilinear_sample(occ02[..., None], x0)[..., 0]
    gated = bilinear_sample(f02, x0).norm(dim=-1) >= 20.0
    W, H = occ02.shape[1], occ02.shape[0]
    border = ((prev1[:, 0] < 3) | (prev1[:, 0] > W - 4) | (prev1[:, 1] < 3)
              | (prev1[:, 1] > H - 4))
    for kind in (eligible & (o02 == 1), eligible & gated, ~eligible, eligible & border):
        assert int(kind.sum()) > 500
    n, bad, worst, exact = _gap_stats(eligible, got, want)
    print(f"[track_lm] patch={patch} iters={num_iters}: {n} eligible, {bad} > 1e-4 px, "
          f"largest gap {worst:.3e} px, bit-equal {100 * exact:.4f}%")
    assert bad <= 1e-4 * n
    if num_iters == 0:
        assert torch.equal(got, want)


def _recipe_flows(dev, kind, frames=12, seed=0):
    """Exact stride-1 and stride-2 forward and backward flows of a scene drawn
    from a benchmark configuration's recipe (the renderer's random_scene, as
    benchmark/bench_scenes.py draws it): `sintel` 1024x436 with 1-2 moving
    spheres, `scannet` 640x480 static, focal 0.9 w."""
    from particlesfm_tpu_torch.synth.render import random_scene

    rng = np.random.default_rng(seed)
    H, W, focal, dyn = ((436, 1024, (1.02, 1.38), (1, 2)) if kind == "sintel"
                        else (480, 640, (0.9, 0.9), (0, 0)))
    scene = random_scene(
        rng, frames, H, W, focal=W * rng.uniform(*focal),
        num_dynamic=int(rng.integers(dyn[0], dyn[1] + 1)),
        motion_scale=float(rng.uniform(0.06, 0.20)), rot_scale=float(rng.uniform(0.08, 0.32)),
        num_static_obj=int(rng.integers(6, 13)))
    hits = {}
    scene.hit_points = lambda v, _h=scene.hit_points: hits.get(v) or hits.setdefault(v, _h(v))
    T = frames - 1
    pairs = {"flow_f": [(i, i + 1) for i in range(T)], "flow_b": [(i + 1, i) for i in range(T)],
             "flow_f2": [(i, i + 2) for i in range(T - 1)],
             "flow_b2": [(i + 2, i) for i in range(T - 1)]}
    return {k: torch.from_numpy(np.stack([scene.gt_flow(a, b) for a, b in v])).to(dev)
            for k, v in pairs.items()}, H, W


@pytest.mark.parametrize("kind,thres", [("sintel", 1.0), ("scannet", 3.0)])
def test_tracker_with_k2_matches_plain_frame_by_frame(cuda, monkeypatch, kind, thres):
    """run_tracker on a rendered scene of each configuration's recipe at the
    cell's shape and pool: at every frame K2 and the plain torch ops refine
    the same state; at most 1e-4 of the eligible slots move by more than
    1e-4 px, and K2 launches once a frame from the second on."""
    from particlesfm_tpu_torch.ops.flow_ops import flow_check

    fl, H, W = _recipe_flows(cuda, kind)
    occ, _ = flow_check(fl["flow_f"], fl["flow_b"], thres)
    occ2, _ = flow_check(fl["flow_f2"], fl["flow_b2"], thres)
    stats = []

    def both(*args, upper_flow, num_iters, patch):
        maps, state, f = args[:4], args[4:9], args[9]
        eligible, got, want = _k2_vs_plain(maps + state, f, num_iters, patch, upper_flow)
        stats.append((f,) + _gap_stats(eligible, got, want))
        args[5].copy_(got[:, :2])
        args[6].copy_(got[:, 2:])

    monkeypatch.setattr(engine, "track_lm", both)
    before = lm.launches
    cfg = engine.TrackerConfig(sample_ratio=2, capacity=131072)
    out = engine.run_tracker(fl["flow_f"], occ, fl["flow_f2"], occ2, cfg, H, W)
    T = fl["flow_f"].shape[0]
    assert lm.launches - before == T - 1 and [s[0] for s in stats] == list(range(1, T))
    for f, n, bad, worst, exact in stats:
        print(f"[track_lm] {kind} frame {f}: {n} eligible, {bad} > 1e-4 px, largest gap "
              f"{worst:.3e} px, bit-equal {100 * exact:.4f}%")
        assert bad <= 1e-4 * n
    assert sum(s[1] for s in stats) > 50_000 and int(out.num_trajs) > 50_000


THINGS_CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "raft_things_seed0.msgpack"


def test_things_raft_with_k1_matches_plain_lookup(cuda):
    """The raft-things RAFT of the benchmark's `raft_things` configuration
    (its seeded checkpoint) on one block of 8 pairs of a rendered 1024x436
    scene, edge-padded to 1024x440, at 20 GRU iterations: with K1 (20
    launches) and with `lookup_corr_plain` swapped in, as chip_smoke.py holds
    the compact net. K1 sums each lookup's bilinear terms in another order
    than plain, which moves a correlation feature by ~1e-6 of its size; 20
    GRU iterations carry that into the flow. The bounds are chip_smoke.py's
    for the compact net at 8 iterations; a window read one row or column
    off, or a level dropped, moves the flow by tenths of a pixel."""
    from particlesfm_tpu_torch.flow.infer import _pad8, load_model
    from particlesfm_tpu_torch.synth import random_scene

    sc = random_scene(np.random.default_rng(0), num_views=9, height=436, width=1024,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=8, num_dynamic=1)
    frames = torch.from_numpy(np.stack([sc.render(i) for i in range(9)])).to(cuda)
    x = _pad8(frames.to(torch.float32), 4, 0)
    model, meta = load_model(THINGS_CKPT, cuda)
    assert meta["variant"] == "things" and meta["iters"] == 20
    with torch.inference_mode():
        before = cl.launches
        fk = model(x[:8], x[1:], iters=20)
        assert cl.launches == before + 20
        model.lookup = cl.lookup_corr_plain
        fp = model(x[:8], x[1:], iters=20)
    d = (fk - fp).abs()
    mean_d, max_d = float(d.mean()), float(d.max())
    print(f"things RAFT, 8 pairs at 1024x440, 20 iterations: |K1 - plain| flow mean "
          f"{mean_d:.3e} px, max {max_d:.3e} px; |flow| mean {float(fp.norm(dim=-1).mean()):.3f} px")
    assert mean_d <= 1e-3 and max_d <= 1e-2


@pytest.mark.parametrize("cin,cout", [(256, 192), (256, 126)])
def test_im2col_conv_is_conv2d_without_cudnn(cuda, cin, cout):
    """The raft-things motion encoder's two `_Im2colConv2d`s at a block of 8
    pairs (55x128): bit-equal to `F.conv2d` with cuDNN turned off, the path
    the limits of the `raft_things` configuration were calibrated on."""
    from particlesfm_tpu_torch.models.raft import _Im2colConv2d

    torch.manual_seed(0)
    conv = _Im2colConv2d(cin, cout, 3, padding=1).to(cuda)
    x = torch.randn(8, cin, 55, 128, device=cuda)
    with torch.inference_mode():
        got = conv(x)
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    assert torch.equal(got, want)


def test_selfcal_card_matches_cpu(cuda):
    """Same flows, same injected RANSAC draws: the focal within 1e-3."""
    from flow_scenes import make_conditioned_flow_scene

    from particlesfm_tpu_torch.globalsfm import selfcal

    sc = make_conditioned_flow_scene(num_views=12, height=192, width=256, focal=240.0)
    P = selfcal.num_selfcal_pairs(sc["flows"]["flow_f"].shape[0])
    g = torch.Generator().manual_seed(0)
    u_f, u_h = torch.rand(P, 64, 8, generator=g), torch.rand(P, 32, 4, generator=g)
    infos = [selfcal.estimate_focal_from_flows(
        {k: torch.from_numpy(sc["flows"][k]).to(dev) for k in ("flow_f", "flow_b")},
        192, 256, u_f=u_f, u_h=u_h) for dev in (cuda, torch.device("cpu"))]
    assert abs(infos[0]["focal"] / infos[1]["focal"] - 1) <= 1e-3
    assert infos[0]["interior"] == infos[1]["interior"]
    assert abs(infos[0]["focal"] / 240.0 - 1) < 0.06


def test_depthnet_card_matches_cpu(cuda):
    from particlesfm_tpu_torch.pipeline.run import _load_depth_apply
    from particlesfm_tpu_torch.utils.config import Config

    stack = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (5, 70, 100, 3)).astype(np.uint8))
    d_gpu = _load_depth_apply(Config(), cuda)(stack)
    d_cpu = _load_depth_apply(Config(), torch.device("cpu"))(stack)
    assert d_gpu.is_cuda and d_gpu.shape == (5, 70, 100)
    assert float((d_gpu.cpu() - d_cpu).abs().max()) <= 1e-3


def test_motionseg_card_matches_cpu(cuda):
    """Seg apply (u16 tracks, depth resized to the checkpoint's 30x53) with
    padded track slots: logits within 1e-3, all finite."""
    from particlesfm_tpu_torch.pipeline.run import _load_seg_apply
    from particlesfm_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    B, N, L = 2, 300, 10
    traj = rng.integers(0, 65536, (B, N, L, 2)).astype(np.uint16)
    valid = rng.random((B, N, L)) < 0.8
    traj[:, -40:], valid[:, -40:] = 0, False
    depth = torch.from_numpy(rng.random((B, L, 60, 90)).astype(np.float32))
    out = [_load_seg_apply(Config(), dev)(traj, depth.to(dev), valid).cpu()
           for dev in (cuda, torch.device("cpu"))]
    assert bool(torch.isfinite(out[0]).all())
    assert float((out[0] - out[1]).abs().max()) <= 1e-3


def _orbit_tracks(num_views=10, num_points=300, seed=1, focal=500.0, h=480, w=640, noise=0.3):
    """Cameras on an arc looking at a point cloud (tests/synthetic.py's
    orbit_scene without JAX): TrackArrays and the true camera centers."""
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    rng = np.random.default_rng(seed)
    ang = np.linspace(-0.6, 0.6, num_views)
    C = np.stack([5 * np.sin(ang), 0.3 * np.sin(2 * ang), -5 * np.cos(ang)], 1)
    X = rng.uniform([-2, -1.5, -1.5], [2, 1.5, 1.5], (num_points, 3))
    xy = np.zeros((num_points, num_views, 2), np.float32)
    mask = np.zeros((num_points, num_views), bool)
    for v, c in enumerate(C):
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Xc = (X - c) @ R.T
        uv = focal * Xc[:, :2] / Xc[:, 2:] + [w / 2, h / 2] + rng.normal(0, noise, (num_points, 2))
        xy[:, v] = uv
        mask[:, v] = (Xc[:, 2] > 0.1) & (uv[:, 0] > 0) & (uv[:, 0] < w) & (uv[:, 1] > 0) & (uv[:, 1] < h)
    return TrackArrays(xy=xy, mask=mask), C


def test_global_mapper_card_matches_cpu(cuda):
    """The whole mapper on the card and on the CPU: the same registered
    frames, camera centers within Sim3 ATE 1e-4, focal within 1e-4 relative;
    a second card run bit-identical (no atomic sum reaches a decision)."""
    from particlesfm_tpu_torch.geometry import se3
    from particlesfm_tpu_torch.geometry.alignment import ate_rmse
    from particlesfm_tpu_torch.sfm.mapper import run_global_mapper
    from particlesfm_tpu_torch.utils.config import SfmConfig

    tracks, _ = _orbit_tracks()
    cfg = SfmConfig()
    cfg.ba.refine_focal_length = True
    recs = [run_global_mapper(tracks, 480, 640, cfg, device=d, log=lambda *a: None)
            for d in (cuda, "cpu", cuda)]

    def centers(r):
        return se3.camera_center(torch.as_tensor(r.qvec), torch.as_tensor(r.tvec)).numpy()

    assert (recs[0].registered == recs[1].registered).all() and recs[0].num_registered == 10
    assert ate_rmse(centers(recs[0]), centers(recs[1])) <= 1e-4
    assert abs(float(recs[0].params[0]) / float(recs[1].params[0]) - 1) <= 1e-4
    np.testing.assert_array_equal(recs[0].qvec, recs[2].qvec)
    np.testing.assert_array_equal(recs[0].tvec, recs[2].tvec)


def test_segment_sums_card_are_deterministic(cuda):
    """One-hot per-camera sums on the card: equal to float64 scatter-adds
    within float32 rounding, and bit-identical across repeats."""
    from particlesfm_tpu_torch.ops.segment import row_segment_sum, segment_sum

    g = torch.Generator(device=cuda).manual_seed(0)
    idx = torch.randint(0, 48, (700_000,), generator=g, device=cuda)
    val = torch.randn(700_000, 6, generator=g, device=cuda)
    a, b = segment_sum(idx, val, 48), segment_sum(idx, val, 48)
    assert torch.equal(a, b)
    ref = torch.zeros(48, 6, dtype=torch.float64).index_add_(0, idx.cpu(), val.cpu().double())
    torch.testing.assert_close(a.cpu().double(), ref, rtol=1e-4, atol=1e-2)
    fidx = idx[:20_000].reshape(1000, 20)
    w = val[:20_000, 0].reshape(1000, 20)
    r = row_segment_sum(fidx, w, 48)
    ref = torch.zeros(1000, 48, dtype=torch.float64).scatter_add_(1, fidx.cpu(), w.cpu().double())
    torch.testing.assert_close(r.cpu().double(), ref, rtol=1e-5, atol=1e-5)


def _train_step_both(cuda, make, step):
    """(loss, gradient global norm) of one step on the card and on the CPU
    from the same initial model (`make()` on the CPU, copied to the card)."""
    import copy

    from particlesfm_tpu_torch.utils.optim import global_norm

    base = make()
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = copy.deepcopy(base).to(dev)
        loss = step(model, dev)
        out.append((float(loss), float(global_norm([p.grad.cpu() for p in model.parameters()]))))
    return out


@pytest.mark.parametrize("trainer", ["flow", "depth", "motionseg"])
def test_train_step_card_matches_cpu(cuda, trainer):
    """One training step of each trainer from the same flax-initialized
    parameters and batch, TF32 off: loss within 1e-4 relative, gradient
    global norm within 1e-3."""
    from particlesfm_tpu_torch.utils.optim import flax_init_

    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    if trainer == "flow":
        from particlesfm_tpu_torch.flow import train as ft
        from particlesfm_tpu_torch.models.raft import compact_raft, lookup_corr_hat

        b = [torch.from_numpy(rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32))
             for _ in range(2)] + [torch.from_numpy(rng.normal(0, 3, (2, 64, 96, 2))
                                                    .astype(np.float32))]

        def make():
            m = flax_init_(compact_raft(remat=True), gen)
            m.lookup = lookup_corr_hat
            return m

        def step(m, dev):
            return ft.loss_and_grads(m, *(t.to(dev) for t in b), 3, use_tf32=False)
    elif trainer == "depth":
        from particlesfm_tpu_torch.depth import train as dt
        from particlesfm_tpu_torch.models.depth import DepthNet

        bi = torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
        bd = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64)).astype(np.float32))

        def make():
            return flax_init_(DepthNet(), gen).train()

        def step(m, dev):
            return dt.loss_and_grads(m, bi.to(dev), bd.to(dev), use_tf32=False)
    else:
        from particlesfm_tpu_torch.models.motionseg import TrajOADepth
        from particlesfm_tpu_torch.motionseg import train as mt
        from particlesfm_tpu_torch.motionseg.synth3d import synth3d_batch

        batch = synth3d_batch(rng, B=2, num_static=200, num_dyn_max=80, depth_hw=(30, 53))

        def make():
            return flax_init_(TrajOADepth(input_hw=(30, 53)), gen).train()

        def step(m, dev):
            return mt.loss_and_grads(m, batch)[0]
    (lc, gc), (lp, gp) = _train_step_both(cuda, make, step)
    assert np.isfinite(lc) and abs(lc - lp) <= 1e-4 * abs(lp)
    assert abs(gc - gp) <= 1e-3 * gp
