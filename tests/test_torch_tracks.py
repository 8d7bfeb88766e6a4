"""Port parity: path-consistency LM and the tracker.

`optimize_locations` agrees with JAX at atol 1e-4; `run_tracker` +
`assemble_tracks` fed identical flows (tests/flow_scenes.py:make_flow_scene)
give identical track masks and positions within 1e-3 px. The refinement
step's dispatch (`optimize.track_lm`) takes the plain torch ops on the CPU,
bit for bit the engine's former inline step, and kernel K2's argument checks
raise before anything is built or launched.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.ops.flow_ops import flow_check as jflow_check
from particlesfm_tpu.tracks import engine as jengine
from particlesfm_tpu.tracks import optimize as joptimize
from particlesfm_tpu.tracks import store as jstore
from particlesfm_tpu_torch.ops.flow_ops import flow_check
from particlesfm_tpu_torch.tracks import engine, optimize, store

from particlesfm_tpu_torch.ops.sampling import bilinear_sample
from particlesfm_tpu_torch.utils import profiling

from flow_scenes import make_flow_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def scene():
    return make_flow_scene(num_views=7, height=48, width=64, focal=80.0)


def _lm_problem(scene, n=200, seed=0):
    rng = np.random.default_rng(seed)
    flow12 = scene["flows"]["flow_f"][1]
    H, W = flow12.shape[:2]
    x0 = np.stack([rng.uniform(-1, W, n), rng.uniform(-1, H, n)], -1)
    uv_ref1 = x0 + rng.normal(scale=0.5, size=(n, 2))
    uv_ref2 = x0 + flow12[0, 0] + rng.normal(scale=0.8, size=(n, 2))
    scale = rng.uniform(0.0, 1.0, size=n)
    p0 = np.concatenate([uv_ref1, uv_ref2], -1) + rng.normal(scale=0.3, size=(n, 4))
    mask = (rng.random(n) < 0.8).astype(np.float32)
    return [a.astype(np.float32) for a in (p0, uv_ref1, uv_ref2, scale, flow12, mask)]


@pytest.mark.parametrize("patch", [False, True])
def test_optimize_locations_matches_jax(scene, patch):
    args = _lm_problem(scene)
    want = np.asarray(joptimize.optimize_locations(
        *[jnp.asarray(a) for a in args[:5]], mask=jnp.asarray(args[5]),
        num_iters=12, patch=patch))
    got = optimize.optimize_locations(
        *[torch.from_numpy(a) for a in args[:5]], mask=torch.from_numpy(args[5]),
        num_iters=12, patch=patch).numpy()
    assert np.abs(got - args[0]).max() > 0.05          # the solve moved points
    np.testing.assert_array_equal(got[args[5] == 0], args[0][args[5] == 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_solve4_spd_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(50, 4, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(4, dtype=np.float32)
    g = rng.normal(size=(50, 4)).astype(np.float32)
    want = np.asarray(joptimize._solve4_spd(jnp.asarray(H), jnp.asarray(g)))
    got = optimize._solve4_spd(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", H, got), g, rtol=0, atol=1e-3)


@pytest.mark.parametrize("path_consistency", [True, False])
def test_tracker_and_assembly_match_jax(scene, path_consistency):
    fl = scene["flows"]
    H, W = scene["height"], scene["width"]
    occ, _ = jflow_check(jnp.asarray(fl["flow_f"]), jnp.asarray(fl["flow_b"]), 1.0)
    occ2, _ = jflow_check(jnp.asarray(fl["flow_f2"]), jnp.asarray(fl["flow_b2"]), 1.0)
    jcfg = jengine.TrackerConfig(sample_ratio=2, capacity=2048,
                                 path_consistency=path_consistency)
    jout = jengine.run_tracker(jnp.asarray(fl["flow_f"]), occ, jnp.asarray(fl["flow_f2"]),
                               occ2, jcfg, H, W)
    want = jstore.assemble_tracks(jout, min_len=3)

    t = {k: torch.from_numpy(v) for k, v in fl.items()}
    tocc, _ = flow_check(t["flow_f"], t["flow_b"], 1.0)
    tocc2, _ = flow_check(t["flow_f2"], t["flow_b2"], 1.0)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(occ))
    tcfg = engine.TrackerConfig(sample_ratio=2, capacity=2048,
                                path_consistency=path_consistency)
    tout = engine.run_tracker(t["flow_f"], tocc, t["flow_f2"], tocc2, tcfg, H, W)
    got = store.assemble_tracks(tout, min_len=3)

    assert int(tout.num_trajs) == int(jout.num_trajs)
    assert int(tout.overflow) == int(jout.overflow)
    np.testing.assert_array_equal(tout.traj_ids.numpy(), np.asarray(jout.traj_ids))
    assert got.num_tracks > 100
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_allclose(got.xy, want.xy, rtol=0, atol=1e-3)


def test_tracker_pool_overflow_matches_jax(scene):
    """Capacity far below the candidate grid: spawns are dropped, ids stay
    consistent, and the masked scatters never write a slot twice."""
    fl = scene["flows"]
    H, W = scene["height"], scene["width"]
    occ = np.zeros(fl["flow_f"].shape[:3], np.float32)
    jcfg = jengine.TrackerConfig(sample_ratio=2, capacity=300, path_consistency=False)
    jout = jengine.run_tracker(jnp.asarray(fl["flow_f"]), jnp.asarray(occ), None, None,
                               jcfg, H, W)
    tcfg = engine.TrackerConfig(sample_ratio=2, capacity=300, path_consistency=False)
    tout = engine.run_tracker(torch.from_numpy(fl["flow_f"]), torch.from_numpy(occ),
                              None, None, tcfg, H, W)
    assert int(tout.overflow) == int(jout.overflow) > 0
    np.testing.assert_array_equal(tout.traj_ids.numpy(), np.asarray(jout.traj_ids))
    np.testing.assert_allclose(tout.positions.numpy(), np.asarray(jout.positions),
                               rtol=0, atol=1e-4)


def _frame_state(scene, n=400, f=3, seed=2):
    """A tracker state at frame f on the scene's flows: n slots over the
    image and a 2 px band around it (the LM windows clip at all four
    borders), a mix of survivors born by f-1, survivors born at f and dead
    slots, and occluded anchors."""
    rng = np.random.default_rng(seed)
    fl = scene["flows"]
    H, W = scene["height"], scene["width"]
    occ2 = (rng.random(fl["flow_f2"].shape[:3]) < 0.3).astype(np.float32)
    prev2 = np.stack([rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)], -1)
    prev1 = prev2 + fl["flow_f"][0, 0, 0] + rng.normal(scale=0.4, size=(n, 2))
    new_pos = prev1 + fl["flow_f"][0, 0, 0] + rng.normal(scale=0.4, size=(n, 2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return dict(
        flow12=t(fl["flow_f"][f]), flow01=t(fl["flow_f"][f - 1]),
        flow02=t(fl["flow_f2"][f - 1]), occ02=t(occ2[f - 1]), prev2=t(prev2),
        prev1=t(prev1), new_pos=t(new_pos), survive=torch.from_numpy(rng.random(n) < 0.8),
        start_time=torch.from_numpy(rng.integers(0, f + 1, n).astype(np.int32)), f=f)


@pytest.mark.parametrize("patch", [False, True])
def test_track_lm_cpu_is_the_former_inline_step(scene, patch):
    """On CPU tensors `track_lm` refines in place exactly (bit for bit) what
    the engine's inline step computed with `optimize_locations`."""
    st = _frame_state(scene)
    f, x0 = st["f"], st["prev2"]
    eligible = st["survive"] & (st["start_time"] <= f - 1)
    f02 = bilinear_sample(st["flow02"], x0)
    o02 = bilinear_sample(st["occ02"][..., None], x0)[..., 0]
    scale = (1.0 - o02) * (torch.sqrt((f02 * f02).sum(-1)) < 20.0).to(o02.dtype)
    p = torch.cat([st["prev1"], st["new_pos"]], dim=-1)
    p_opt = optimize.optimize_locations(
        p, x0 + bilinear_sample(st["flow01"], x0), x0 + f02, scale, st["flow12"],
        mask=eligible.to(p.dtype), num_iters=12, patch=patch)
    want1 = torch.where(eligible[:, None], p_opt[:, 0:2], st["prev1"])
    want2 = torch.where(eligible[:, None], p_opt[:, 2:4], st["new_pos"])

    got1, got2 = st["prev1"].clone(), st["new_pos"].clone()
    optimize.track_lm(st["flow12"], st["flow01"], st["flow02"], st["occ02"], x0, got1, got2,
                      st["survive"], st["start_time"], f, upper_flow=20.0, num_iters=12,
                      patch=patch)
    assert 50 < int(eligible.sum()) < len(eligible)
    assert float((got1 - st["prev1"]).abs().max()) > 0.05      # the solve moved points
    assert torch.equal(got1, want1) and torch.equal(got2, want2)
    assert torch.equal(got1[~eligible], st["prev1"][~eligible])
    assert torch.equal(got2[~eligible], st["new_pos"][~eligible])


def test_tracker_skips_f0_where_no_slot_is_eligible(scene, monkeypatch):
    """The engine runs the refinement at every frame but the first, and at
    f == 0 the step changes nothing (every start_time is >= 0 > f - 1), so
    the skipped loop equals the unskipped one: the same call at f == 0 on
    the state the first refined frame was given leaves it as it was."""
    fl = {k: torch.from_numpy(v) for k, v in scene["flows"].items()}
    H, W = scene["height"], scene["width"]
    occ, _ = flow_check(fl["flow_f"], fl["flow_b"], 1.0)
    occ2, _ = flow_check(fl["flow_f2"], fl["flow_b2"], 1.0)
    calls = []
    real = optimize.track_lm

    def spy(*args, **kw):
        calls.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return real(*args, **kw)

    monkeypatch.setattr(engine, "track_lm", spy)
    cfg = engine.TrackerConfig(sample_ratio=2, capacity=2048)
    engine.run_tracker(fl["flow_f"], occ, fl["flow_f2"], occ2, cfg, H, W)
    T = fl["flow_f"].shape[0]
    assert [c[9] for c in calls] == list(range(1, T))

    maps = (fl["flow_f"][0], fl["flow_f"][0], fl["flow_f2"][0], occ2[0])
    prev2, prev1, new_pos, survive, start_time = calls[0][4:9]
    assert bool(survive.any()) and int(start_time.min()) >= 0
    got1, got2 = prev1.clone(), new_pos.clone()
    real(*maps, prev2, got1, got2, survive, start_time, 0, upper_flow=cfg.upper_flow,
         num_iters=cfg.gn_iters, patch=cfg.patch_lm)
    assert torch.equal(got1, prev1) and torch.equal(got2, new_pos)


def _no_kernel(monkeypatch):
    """Make any attempt to build or load K2 fail the test; returns the launch
    count before (the module's count is per process, so compare it)."""
    def refuse(*a, **kw):
        raise AssertionError("K2's library was loaded")
    monkeypatch.setattr(optimize, "load_library", refuse)
    return optimize.launches


def test_track_lm_never_launches_or_counts_on_cpu(scene, monkeypatch):
    launches = _no_kernel(monkeypatch)
    fl = {k: torch.from_numpy(v) for k, v in scene["flows"].items()}
    occ, _ = flow_check(fl["flow_f"], fl["flow_b"], 1.0)
    occ2, _ = flow_check(fl["flow_f2"], fl["flow_b2"], 1.0)
    before = len(profiling.records())
    profiling.enable()
    try:
        with profiling.span("tracks.scan"):
            engine.run_tracker(fl["flow_f"], occ, fl["flow_f2"], occ2,
                               engine.TrackerConfig(sample_ratio=2, capacity=2048),
                               scene["height"], scene["width"])
    finally:
        profiling.disable()
    mine = profiling.records()[before:]
    assert [r.name for r in mine] == ["tracks.scan"]
    assert "tracks.lm_kernel" not in mine[0].counters
    assert optimize.launches == launches


def _bad_inputs(st, case):
    st = dict(st)
    if case == "dtype":
        st["prev1"] = st["prev1"].double()
    elif case == "survive_dtype":
        st["survive"] = st["survive"].to(torch.uint8)
    elif case == "non_contiguous":
        st["flow12"] = st["flow12"].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "slot_count":
        st["new_pos"] = torch.cat([st["new_pos"], st["new_pos"][:1]])
    elif case == "map_shape":
        st["occ02"] = st["occ02"][:-1]
    elif case == "num_iters":
        st["num_iters"] = -1
    return st


@pytest.mark.parametrize("case", ["dtype", "survive_dtype", "non_contiguous", "slot_count",
                                  "map_shape", "num_iters", "cpu_device"])
def test_track_lm_kernel_checks_raise_before_any_launch(scene, case, monkeypatch):
    """K2's wrapper refuses what the kernel does not take (and CPU tensors)
    before it builds or launches anything."""
    launches = _no_kernel(monkeypatch)
    st = _bad_inputs(dict(_frame_state(scene), num_iters=12), case)
    with pytest.raises(ValueError):
        optimize.track_lm_cuda(st["flow12"], st["flow01"], st["flow02"], st["occ02"],
                               st["prev2"], st["prev1"], st["new_pos"], st["survive"],
                               st["start_time"], st["f"], 20.0, st["num_iters"], True)
    assert optimize.launches == launches


def _assemble_numpy(out, min_len):
    """The former numpy body of `store.assemble_tracks`: the whole emission
    plane fetched to the host (positions as u16 at 1/32 px), scattered into
    dense [num_trajs, T+1] arrays, short rows dropped at the end."""
    q = torch.clamp(torch.round(out.positions * 32.0), 0, 65535).to(torch.int32)
    positions = q.cpu().numpy().astype(np.uint16).astype(np.float32) * (1.0 / 32.0)
    traj_ids = out.traj_ids.cpu().numpy()
    valid = traj_ids >= 0
    n = int(out.num_trajs)
    T1 = positions.shape[0]
    tv, cv = np.nonzero(valid)
    ids = traj_ids[tv, cv]
    xy = np.zeros((n, T1, 2), np.float32)
    mask = np.zeros((n, T1), bool)
    xy[ids, tv] = positions[tv, cv]
    mask[ids, tv] = True
    keep = mask.sum(axis=1) >= min_len
    return store.TrackArrays(xy=xy[keep], mask=mask[keep])


def _emissions(case, min_len, T1=12, C=96, n=160, seed=5):
    """A tracker output of `case`: each trajectory holds one slot in each of
    its frames, every fifth id has no entry (gaps in the numbering), lengths
    include min_len - 1 and min_len exactly, and invalid slots hold garbage."""
    rng = np.random.default_rng(seed)
    ids = np.full((T1, C), -1, np.int32)
    pos = rng.uniform(-50.0, 2100.0, (T1, C, 2)).astype(np.float32)
    if case == "no_trajs":
        n = 0
    lengths = rng.integers(1, T1 + 1, n)
    lengths[1::7], lengths[2::7] = min_len - 1, min_len
    if case == "none_kept":
        lengths[:] = min_len - 1
    for k in range(n):
        if k % 5 == 0 or case == "no_valid_slot":
            continue
        frames = np.sort(rng.choice(T1, lengths[k], replace=False))
        for t in frames:
            free = np.nonzero(ids[t] < 0)[0]
            if len(free):
                ids[t, rng.choice(free)] = k
    if case == "clamp":
        # below 0, -0.0 after rounding, the largest u16, beyond it, ties
        edge = np.array([-3.0, -1e-3, -0.0, 0.0, 1 / 64, 3 / 64, 2047.96875, 2047.99,
                         2048.0, 2500.0, 1e6, 5.015625], np.float32)
        pos[..., 0] = rng.choice(edge, (T1, C))
    return engine.TrackerOutput(
        positions=torch.from_numpy(pos), traj_ids=torch.from_numpy(ids),
        valid=torch.from_numpy(ids >= 0), num_trajs=torch.tensor(n, dtype=torch.int32),
        overflow=torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("min_len", [1, 3])
@pytest.mark.parametrize("case", ["random", "clamp", "no_valid_slot", "none_kept",
                                  "no_trajs"])
def test_assembly_equals_the_former_numpy_body(case, min_len):
    """The assembly on tensors gives the former host assembly's arrays to the
    last bit (the sign of zero included), as numpy arrays, and counts no
    fetch off the card."""
    out = _emissions(case, min_len)
    want = _assemble_numpy(out, min_len)
    before = len(profiling.records())
    profiling.enable()
    try:
        with profiling.span("tracks.assemble"):
            got = store.assemble_tracks(out, min_len=min_len)
    finally:
        profiling.disable()
    assert [r.name for r in profiling.records()[before:]] == ["tracks.assemble"]
    assert "tracks.fetch_bytes" not in profiling.records()[-1].counters
    assert isinstance(got.xy, np.ndarray) and isinstance(got.mask, np.ndarray)
    assert got.xy.dtype == np.float32 and got.mask.dtype == np.bool_
    assert got.xy.shape == want.xy.shape and got.mask.shape == want.mask.shape
    np.testing.assert_array_equal(got.xy, want.xy)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.xy.tobytes() == want.xy.tobytes()
    lengths = want.mask.sum(1)
    if case in ("random", "clamp"):
        assert got.num_tracks > 50 and (lengths == min_len).any()
        dropped = (out.traj_ids.numpy() >= 0).sum() - want.mask.sum()
        assert (dropped > 0) == (min_len > 1)
    else:
        assert got.num_tracks == 0
        assert ((out.traj_ids.numpy() >= 0).any()) == (case == "none_kept" and min_len > 1)
    if case == "clamp":
        assert got.xy[..., 0][got.mask].min() == 0 and got.xy.max() == 65535 / 32
