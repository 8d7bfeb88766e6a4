"""Port parity: path-consistency LM and the tracker.

`optimize_locations` agrees with JAX at atol 1e-4; `run_tracker` +
`assemble_tracks` fed identical flows (tests/flow_scenes.py:make_flow_scene)
give identical track masks and positions within 1e-3 px.
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
