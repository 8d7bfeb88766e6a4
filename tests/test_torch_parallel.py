"""Port parity of parallel/ (mesh, sharding helpers, sharded BA) and of BA's
`reduce_fn`, on meshes of CPU devices.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py provides;
the port's mesh of `[cpu] * 8` stands in for them. Tolerances are the
reference's own (tests/test_parallel.py): occlusion mask 1e-6 and error
1e-5; sharded BA cost within 1e-3 relative, q 1e-4, t and X 1e-3. With
`reduce_fn=None` (or the identity) BA is bit-identical to the plain call.
"""
import socket
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from particlesfm_tpu.globalsfm import ba as jba
from particlesfm_tpu.globalsfm.tracks3d import TrackObs as JTrackObs
from particlesfm_tpu.ops.flow_ops import occlusion_mask as jocclusion_mask
from particlesfm_tpu.parallel import make_mesh as jmake_mesh
from particlesfm_tpu.parallel import sharded_map_frames as jsharded_map_frames
from particlesfm_tpu.parallel.sharded_ba import sharded_bundle_adjust as jsharded_ba
from particlesfm_tpu_torch.globalsfm.ba import bundle_adjust, default_free_masks
from particlesfm_tpu_torch.globalsfm.tracks3d import TrackObs, triangulate_tracks
from particlesfm_tpu_torch.ops.flow_ops import occlusion_mask
from particlesfm_tpu_torch.parallel import (data_sharding, init_distributed, make_mesh,
                                            replicated, shard_frames, sharded_bundle_adjust,
                                            sharded_map_frames)
from particlesfm_tpu_torch.parallel import sharded_ba
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

sys.path.insert(0, str(Path(__file__).parent))
from synthetic import orbit_scene  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=CPU8)


def test_mesh_and_sharding(mesh):
    assert mesh.shape == {"data": 8} and mesh.axis_names == ("data",)
    assert data_sharding(mesh, 2).spec == ("data", None) and replicated(mesh).spec == ()
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    shards, n = shard_frames(x, mesh)
    assert n == 16 and len(shards) == 8
    assert all(s.shape == (2, 2) and s.device == torch.device("cpu") for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)


def test_shard_frames_pads_uneven(mesh):
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    shards, n = shard_frames(x, mesh)
    assert n == 5 and sum(s.shape[0] for s in shards) == 8
    # padded by repeating the last row, as the reference pads
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x[[0, 1, 2, 3, 4, 4, 4, 4]])


def test_two_axis_mesh_shape():
    m = make_mesh((2, 4), ("data", "model"), devices=CPU8)
    assert m.shape == {"data": 2, "model": 4} and m.devices.shape == (2, 4)
    assert len(shard_frames(np.zeros((6, 1)), m)[0]) == 2
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 4)


def test_sharded_flow_check_matches_jax(mesh):
    """The reference's test_parallel.py:34-45 flows through both packages'
    sharded_map_frames (11 frames on 8 shards: padding runs)."""
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(0)
    T, H, W = 11, 16, 24
    ff = rng.normal(0, 2, (T, H, W, 2)).astype(np.float32)
    fb = -ff + rng.normal(0, 0.05, ff.shape).astype(np.float32)
    occ, err = sharded_map_frames(lambda f, b: occlusion_mask(f, b, 1.0), mesh, ff, fb)
    occ_j, err_j = jsharded_map_frames(lambda f, b: jocclusion_mask(f, b, 1.0),
                                       jmake_mesh(axes=("data",)), ff, fb)
    assert occ.shape == (T, H, W) and err.shape == (T, H, W)
    np.testing.assert_allclose(occ.numpy(), np.asarray(occ_j), atol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), atol=1e-5)
    plain = occlusion_mask(torch.from_numpy(ff), torch.from_numpy(fb), 1.0)
    assert torch.equal(occ, plain[0]) and torch.equal(err, plain[1])


def _problem(N=65, seed=3):
    """The reference test's orbit_scene BA problem (test_parallel.py:115-136)
    as numpy arrays, X0 by the port's triangulation."""
    sc = orbit_scene(num_views=8, num_points=N, pixel_noise=0.3, seed=seed)
    K = 8
    fidx = np.zeros((N, K), np.int64)
    uv = np.zeros((N, K, 2), np.float32)
    m = np.zeros((N, K), bool)
    for n in range(N):
        views = np.nonzero(sc["vis"][:, n])[0][:K]
        fidx[n, :len(views)] = views
        uv[n, :len(views)] = sc["uv"][views, n]
        m[n, :len(views)] = True
    q, t, params = (np.asarray(sc[k], np.float32) for k in ("q", "t", "params"))
    obs = TrackObs(torch.from_numpy(fidx), torch.from_numpy(uv), torch.from_numpy(m))
    X0 = triangulate_tracks(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(params),
                            obs).numpy()
    return dict(q=q, t=t, params=params, X=X0, fidx=fidx, uv=uv, mask=m,
                free=default_free_masks(8).numpy(), pm=np.ones(N, np.float32))


def _args(p):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return (t["q"], t["t"], t["params"], t["X"], TrackObs(t["fidx"], t["uv"], t["mask"]),
            t["free"], t["pm"])


def _assert_close_ba(got, ref):
    """The reference's sharded-BA tolerances (test_parallel.py:135-140)."""
    cost, cost_ref = float(got["cost"]), float(ref["cost"])
    assert abs(cost - cost_ref) / max(cost_ref, 1e-9) < 1e-3
    np.testing.assert_allclose(np.asarray(got["q"]), np.asarray(ref["q"]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got["t"]), np.asarray(ref["t"]), atol=1e-3)
    assert np.asarray(got["X"]).shape == np.asarray(ref["X"]).shape
    np.testing.assert_allclose(np.asarray(got["X"]), np.asarray(ref["X"]), atol=1e-3)


def _fields(st):
    return {k: getattr(st, k) for k in ("q", "t", "X", "cost")}


@pytest.fixture(scope="module")
def problem():
    p = _problem()
    plain = bundle_adjust(*_args(p), max_iterations=5)
    return p, plain


def test_sharded_bundle_adjust_matches_plain_and_jax(mesh, problem):
    """8 CPU shards at N = 65 (padded to 72) against the port's plain BA and
    against JAX's shard_map BA on its 8 virtual devices, same inputs."""
    p, plain = problem
    sh = sharded_bundle_adjust(mesh, *_args(p), max_iterations=5)
    assert sh.X.shape == (65, 3) and sh.iters == plain.iters
    _assert_close_ba(_fields(sh), _fields(plain))
    jobs = JTrackObs(jnp.asarray(p["fidx"], jnp.int32), jnp.asarray(p["uv"]),
                     jnp.asarray(p["mask"]))
    jst = jsharded_ba(jmake_mesh(axes=("data",)), jnp.asarray(p["q"]), jnp.asarray(p["t"]),
                      jnp.asarray(p["params"]), jnp.asarray(p["X"]), jobs,
                      jba.default_free_masks(8), jnp.asarray(p["pm"]), max_iterations=5)
    _assert_close_ba(_fields(sh), {k: getattr(jst, k) for k in ("q", "t", "X", "cost")})


def test_sharded_bundle_adjust_two_axis_mesh_and_pcg(problem):
    """A 2 x 4 data x model mesh shards the tracks over both axes (8
    shards); the PCG solver's matvec sums take the same reduction."""
    p, plain = problem
    m = make_mesh((2, 4), ("data", "model"), devices=CPU8)
    _assert_close_ba(_fields(sharded_bundle_adjust(m, *_args(p), max_iterations=5)),
                     _fields(plain))
    pcg = bundle_adjust(*_args(p), max_iterations=5, solver="pcg")
    sh = sharded_bundle_adjust(make_mesh(devices=["cpu"] * 3), *_args(p), max_iterations=5,
                               solver="pcg")
    _assert_close_ba(_fields(sh), _fields(pcg))


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_reduce_fn_none_is_bit_identical(problem, solver):
    """reduce_fn=None, the identity and a one-entry mesh give the plain
    call's result bit for bit; the identity is called at the reference's
    reduction points: per LM step cost0, Hcc, gc, Hcf, Hff, gf, S_cf, S_ff,
    rhs_c, rhs_f, cost1 and the dense S or one per PCG matvec, then the
    final cost."""
    p, _ = problem
    kw = dict(max_iterations=4, solver=solver, pcg_iters=6)
    ref = bundle_adjust(*_args(p), **kw)
    calls = []

    def identity(x):
        calls.append(x.shape)
        return x

    for st in (bundle_adjust(*_args(p), reduce_fn=None, **kw),
               bundle_adjust(*_args(p), reduce_fn=identity, **kw),
               sharded_bundle_adjust(make_mesh(devices=["cpu"]), *_args(p), **kw)):
        for k in ("q", "t", "X", "params", "cost", "lam"):
            assert torch.equal(getattr(st, k), getattr(ref, k)), k
        assert st.iters == ref.iters
    per_step = 12 if solver == "dense" else 11 + kw["pcg_iters"] + 1
    assert len(calls) == per_step * ref.iters + 1
    if solver == "dense":
        assert (48, 48) in calls


def test_shard_that_raises_is_raised_without_hanging(mesh, problem, monkeypatch):
    """Shard 3 fails at its third reduction while the others wait for their
    turn: the call raises that error within seconds."""
    p, _ = problem
    real = sharded_ba.bundle_adjust

    def faulty(*a, reduce_fn=None, **kw):
        if threading.current_thread().name == "ba-shard-3":
            n = [0]

            def failing(x):
                n[0] += 1
                if n[0] == 3:
                    raise ValueError("shard fault")
                return reduce_fn(x)
            return real(*a, reduce_fn=failing, **kw)
        return real(*a, reduce_fn=reduce_fn, **kw)

    monkeypatch.setattr(sharded_ba, "bundle_adjust", faulty)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard fault"):
        sharded_bundle_adjust(mesh, *_args(p), max_iterations=5)
    assert time.perf_counter() - t0 < 30


def test_shard_that_never_reduces_times_out(problem, monkeypatch):
    p, _ = problem
    real = sharded_ba.bundle_adjust

    def stalled(*a, **kw):
        if threading.current_thread().name == "ba-shard-1":
            time.sleep(1.0)
        return real(*a, **kw)

    monkeypatch.setattr(sharded_ba, "bundle_adjust", stalled)
    monkeypatch.setattr(sharded_ba, "BARRIER_TIMEOUT_S", 0.2)
    with pytest.raises(RuntimeError, match="waited more than"):
        sharded_bundle_adjust(make_mesh(devices=["cpu"] * 2), *_args(p), max_iterations=5)


def test_two_gloo_processes_give_plain_ba(problem, tmp_path):
    """Two processes (gloo, FileStore), each with 2 local CPU shards: 4
    shards in all over one process group, each process passing the whole
    problem. Both return the same result, within the tolerances of plain BA."""
    import torch.multiprocessing as tmp

    from torch_parallel_worker import run_sharded_ba

    p, plain = problem
    ctx = tmp.spawn(run_sharded_ba, args=(2, str(tmp_path / "store"), str(tmp_path), 2, p),
                    nprocs=2, join=False)
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the two processes did not finish in 120 s"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in ("q", "t", "X", "cost", "iters"):
        np.testing.assert_array_equal(res[0][k], res[1][k])
    assert int(res[0]["iters"]) == plain.iters
    _assert_close_ba(res[0], {k: v.numpy() for k, v in _fields(plain).items()})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_world_size_one_round_trip(problem):
    """init_distributed("localhost:port", 1, 0, backend="gloo") starts a
    one-process group; sharded BA's sum is all-reduced over it and matches
    plain BA; the group is torn down after."""
    p, plain = problem
    init_distributed(f"localhost:{_free_port()}", 1, 0, backend="gloo")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_rank() == 0
        x = torch.arange(3.0)
        dist.all_reduce(x)
        assert torch.equal(x, torch.arange(3.0))
        sh = sharded_bundle_adjust(make_mesh(devices=["cpu"] * 2), *_args(p), max_iterations=5)
        _assert_close_ba(_fields(sh), _fields(plain))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_init_distributed_env_rendezvous(monkeypatch):
    """With no coordinator the rendezvous is env:// (what torchrun sets)."""
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port())),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    init_distributed(backend="gloo")
    try:
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        init_distributed("localhost:1", backend="gloo")
