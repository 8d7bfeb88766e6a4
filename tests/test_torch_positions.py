"""Port parity: linear (spectral) and nonlinear (1DSfM) position estimation,
alone and in the global mapper (mirrors tests/test_nonlinear_pos.py and
tests/test_mapper.py:119-142).

On seeded view graphs (12 views, edges to the next 4 views, 2% direction
noise, 1% baseline-ratio noise) both estimators agree with JAX's within Sim3
ATE 1e-4 of the position spread: the port computes both in float64, so
the difference is JAX's float32 rounding (the nonlinear estimator's free
scale is removed by the similarity). The mapper
with each method is held to test_mapper.py's ground-truth bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.globalsfm.linear_position import estimate_positions_linear as jlinear
from particlesfm_tpu.globalsfm.nonlinear_position import refine_positions_nonlinear as jnonlinear
from particlesfm_tpu.globalsfm.translation import TripletConstraints as JTripletConstraints
from particlesfm_tpu.graph import extract_triplets
from particlesfm_tpu_torch.geometry import alignment, se3
from particlesfm_tpu_torch.globalsfm.linear_position import estimate_positions_linear
from particlesfm_tpu_torch.globalsfm.nonlinear_position import refine_positions_nonlinear
from particlesfm_tpu_torch.globalsfm.translation import TripletConstraints
from particlesfm_tpu_torch.sfm.mapper import run_global_mapper
from particlesfm_tpu_torch.utils.config import SfmConfig

from synthetic import orbit_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

V = 12


def _graph(seed):
    rng = np.random.default_rng(seed)
    C = np.stack([np.linspace(0, 5, V), np.sin(np.linspace(0, 3, V)),
                  0.3 * rng.normal(size=V)], 1)
    edges = np.array([(i, j) for i in range(V) for j in range(i + 1, min(V, i + 5))], np.int32)
    w = C[edges[:, 0]] - C[edges[:, 1]]
    w = w + 0.02 * rng.normal(size=w.shape) * np.linalg.norm(w, axis=1, keepdims=True)
    w = (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    tris = extract_triplets(edges)
    edge_of = {(int(a), int(b)): e for e, (a, b) in enumerate(edges)}
    tri_edges = np.array([[edge_of[(i, j)], edge_of[(i, k)], edge_of[(j, k)]]
                          for i, j, k in tris], np.int32)
    b = np.linalg.norm(C[edges[:, 0]] - C[edges[:, 1]], axis=1)
    ratios = (b[tri_edges] * (1 + 0.01 * rng.normal(size=tri_edges.shape))).astype(np.float32)
    weight = rng.uniform(0.5, 1.0, len(tris)).astype(np.float32)
    weight[::7] = 0.0                                  # disabled triplets add nothing
    return rng, C, edges, w, tris, tri_edges, ratios, weight


def _spread(p):
    return float(np.linalg.norm(p - p.mean(0), axis=1).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_positions_match_jax(seed):
    _, C, edges, w, tris, tri_edges, ratios, weight = _graph(seed)
    pj = np.asarray(jlinear(V, jnp.asarray(edges), jnp.asarray(w), jnp.asarray(tris),
                            JTripletConstraints(jnp.asarray(tri_edges), jnp.asarray(ratios),
                                                jnp.asarray(weight))))
    pt = estimate_positions_linear(
        V, torch.as_tensor(edges), torch.as_tensor(w), torch.as_tensor(tris),
        TripletConstraints(torch.as_tensor(tri_edges), torch.as_tensor(ratios),
                           torch.as_tensor(weight))).numpy()
    assert pt.dtype == np.float32 and np.all(pt[0] == 0)
    # the same gauge: view 0 at the origin, unit median distance, same sign
    assert abs(np.median(np.linalg.norm(pt[1:], axis=1)) - 1) < 1e-5
    assert alignment.ate_rmse(pt, pj) <= 1e-4 * _spread(pj)
    assert np.abs(pt - pj).max() <= 1e-3
    assert alignment.ate_rmse(pt, C) <= 0.02 * _spread(C)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nonlinear_positions_match_jax(seed):
    rng, C, edges, w, *_ = _graph(seed)
    p0 = (C + rng.normal(0, 0.15, C.shape)).astype(np.float32)
    p0[0] = C[0]
    em = np.ones(len(edges), np.float32)
    pj = np.asarray(jnonlinear(V, jnp.asarray(edges), jnp.asarray(w), jnp.asarray(em),
                               jnp.asarray(p0)))
    pt = refine_positions_nonlinear(V, torch.as_tensor(edges), torch.as_tensor(w),
                                    torch.as_tensor(em), torch.as_tensor(p0)).numpy()
    np.testing.assert_array_equal(pt[0], p0[0])        # p0 pinned
    assert alignment.ate_rmse(pt, pj) <= 1e-4 * _spread(pj)


def test_nonlinear_masked_edges_add_nothing():
    """Edges with mask 0 leave the refinement as if they were absent."""
    rng, C, edges, w, *_ = _graph(0)
    p0 = torch.as_tensor((C + rng.normal(0, 0.15, C.shape)).astype(np.float32))
    em = np.ones(len(edges), np.float32)
    em[[3, 11, 20]] = 0.0
    keep = em > 0
    masked = refine_positions_nonlinear(V, torch.as_tensor(edges), torch.as_tensor(w),
                                        torch.as_tensor(em), p0).numpy()
    removed = refine_positions_nonlinear(V, torch.as_tensor(edges[keep]),
                                         torch.as_tensor(w[keep]),
                                         torch.ones(int(keep.sum())), p0).numpy()
    np.testing.assert_allclose(masked, removed, rtol=0, atol=1e-5)


def test_nonlinear_refines_noisy_positions_toward_truth():
    """tests/test_nonlinear_pos.py on the port: the complete graph's
    refinement cuts the error of a noisy start by > 70% (scale about p0)."""
    rng = np.random.default_rng(0)
    n = 12
    centers = np.stack([np.linspace(0, 5, n), np.sin(np.linspace(0, 3, n)),
                        0.2 * rng.normal(size=n)], 1).astype(np.float32)
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)], np.int32)
    w = centers[edges[:, 0]] - centers[edges[:, 1]]
    w = w / np.linalg.norm(w, axis=1, keepdims=True)
    p0 = centers + rng.normal(0, 0.15, centers.shape).astype(np.float32)
    p0[0] = centers[0]
    p = refine_positions_nonlinear(n, torch.as_tensor(edges), torch.as_tensor(w, dtype=torch.float32),
                                   torch.ones(len(edges)), torch.as_tensor(p0)).numpy()

    def err(x):
        d = x - x[0]
        g = centers - centers[0]
        s = np.sum(d * g) / max(np.sum(d * d), 1e-12)
        return np.linalg.norm(s * d - g, axis=1).mean()
    assert err(p) < 0.3 * err(p0)


@pytest.mark.parametrize("method,seed", [("nonlinear", 5), ("linear", 6)])
def test_mapper_position_method(method, seed):
    """test_mapper.py's nonlinear and linear cases on the port: all 8 views
    registered, Sim3 ATE < 0.01 x the span."""
    sc = orbit_scene(num_views=8, num_points=250, pixel_noise=0.3, seed=seed)
    cfg = SfmConfig()
    cfg.position.method = method
    logs = []
    rec = run_global_mapper(sc["tracks"], sc["height"], sc["width"], cfg, log=logs.append,
                            device="cpu")
    assert any(f"{method} " in m and "position" in m for m in logs)
    assert rec.num_registered == 8
    c = se3.camera_center(torch.as_tensor(rec.qvec), torch.as_tensor(rec.tvec)).numpy()
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    assert alignment.ate_rmse(c[rec.registered], sc["centers"][rec.registered]) < 0.01 * span
