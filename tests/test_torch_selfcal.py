"""Port parity: flow self-calibration (globalsfm/selfcal.py) against the JAX
package, fed the reference's own RANSAC draws (jax.random under the same
`split` calls, also recomputed without JAX by `reference_draws`), and the
flow stage's selfcal.json reader.

Tolerances: F-RANSAC inlier counts equal per pair, or within 1 where an
error lies within 1e-4 (relative) of the threshold; the shared focal within
1e-3 relative, the confidence within 0.02 and num_pairs within 1; on
make_conditioned_flow_scene(16, 192, 256, 240) the focal within 1e-3 and
`interior` equal, and with the port's own generator an estimate that passes
the acceptance gate within 6% of the true focal.

With 20% gross outliers in 100-point pairs the reference's float32 RANSAC
winners hang on rounding: scaling its inputs by 1 +- 2^-22 (about one
float32 step) moves its inlier counts and its focal by more than those
tolerances (the tests below assert it). The port forms and solves the normal
matrices in float64, so it is one more rounding of the same computation;
there it is held to the reference's own movement under that scaling, and
the focal also to the reference's spread over RANSAC keys.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.globalsfm import selfcal as jselfcal
from particlesfm_tpu.pipeline.stages import read_flow_selfcal as jread_flow_selfcal
from particlesfm_tpu_torch.globalsfm import selfcal
from particlesfm_tpu_torch.pipeline.stages import read_flow_selfcal
from particlesfm_tpu_torch.utils.config import Config

from flow_scenes import make_conditioned_flow_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F_GT, CX, CY = 310.0, 160.0, 120.0
_ROUNDINGS = (1.0 + 2.0 ** -22, 1.0 - 2.0 ** -22)   # about one float32 step


def _draws(key, P, S=64):
    """The uniform draws the reference makes for F-RANSAC ([P, S, 8]) and
    for the planar check's H-RANSAC ([P, 32, 4]) under `key`."""
    u_f = jax.vmap(lambda k: jax.random.uniform(k, (S, 8)))(jax.random.split(key, P))
    k_h, _ = jax.random.split(key)
    u_h = jax.vmap(lambda k: jax.random.uniform(k, (32, 4)))(jax.random.split(k_h, P))
    return torch.from_numpy(np.array(u_f)), torch.from_numpy(np.array(u_h))


def _project_pairs(seed, num_pairs=24, num_points=100, noise=0.3, outliers=0.2):
    rng = np.random.default_rng(seed)
    uv1 = np.zeros((num_pairs, num_points, 2), np.float32)
    uv2 = np.zeros_like(uv1)
    for p in range(num_pairs):
        X = np.stack([rng.uniform(-2, 2, num_points), rng.uniform(-1, 1, num_points),
                      rng.uniform(4, 10, num_points)], -1)
        a = rng.normal(size=3) * 0.08
        R, _ = np.linalg.qr(np.eye(3) + np.cross(np.eye(3), a))
        t = rng.normal(size=3)
        X2 = X @ R.T + 0.4 * t / np.linalg.norm(t)
        uv1[p] = X[:, :2] / X[:, 2:] * F_GT + [CX, CY]
        uv2[p] = X2[:, :2] / X2[:, 2:] * F_GT + [CX, CY]
    uv1 += rng.normal(size=uv1.shape).astype(np.float32) * noise
    uv2 += rng.normal(size=uv2.shape).astype(np.float32) * noise
    n_out = int(outliers * num_points)
    uv2[:, :n_out] = rng.uniform(0, 320, (num_pairs, n_out, 2))
    mask = rng.random((num_pairs, num_points)) < 0.95
    return uv1, uv2, mask


@pytest.fixture(scope="module")
def pairs():
    return _project_pairs(0)


@pytest.mark.parametrize("outliers", [0.0, 0.2])
def test_estimate_fundamentals_matches_jax(outliers):
    uv1, uv2, mask = _project_pairs(0, outliers=outliers)
    key = jax.random.PRNGKey(1)
    fr_j = jselfcal.estimate_fundamentals(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                          jnp.asarray(mask), 4.0)
    u_f, _ = _draws(key, uv1.shape[0])
    fr = selfcal.estimate_fundamentals(torch.from_numpy(uv1), torch.from_numpy(uv2),
                                       torch.from_numpy(mask), 4.0, u=u_f)
    from particlesfm_tpu.geometry.epipolar import sampson_error

    err_j = np.asarray(sampson_error(fr_j.F, jnp.asarray(uv1), jnp.asarray(uv2)))
    near = (np.abs(np.where(mask, err_j, np.inf) - 4.0) <= 4e-4).any(-1)
    n_j = np.asarray(fr_j.num_inliers)
    d = np.abs(fr.num_inliers.numpy().astype(int) - n_j)
    assert n_j.min() >= 40
    if outliers == 0:
        assert np.all((d == 0) | (near & (d <= 1)))
    else:   # hypotheses from outlier-laden samples: see the module docstring
        assert np.all(d <= 0.06 * n_j) and (d == 0).mean() >= 0.8
        d_ref = [np.abs(np.asarray(jselfcal.estimate_fundamentals(
            key, jnp.asarray(uv1 * np.float32(s)), jnp.asarray(uv2 * np.float32(s)),
            jnp.asarray(mask), 4.0).num_inliers).astype(int) - n_j) for s in _ROUNDINGS]
        assert max(x.max() for x in d_ref) >= 1          # the reference itself moves
        assert d.max() <= max(x.max() for x in d_ref)
        assert (d > 0).sum() <= max((x > 0).sum() for x in d_ref)


def test_focal_cost_curves_match_jax(pairs):
    uv1, uv2, mask = pairs
    fr_j = jselfcal.estimate_fundamentals(jax.random.PRNGKey(1), jnp.asarray(uv1),
                                          jnp.asarray(uv2), jnp.asarray(mask), 4.0)
    f_grid = np.exp(np.linspace(np.log(100.0), np.log(1000.0), 96)).astype(np.float32)
    c_j = np.asarray(jax.jit(jselfcal.focal_cost_curves)(fr_j.F, jnp.asarray([CX, CY]),
                                                         jnp.asarray(f_grid)))
    c = selfcal.focal_cost_curves(torch.from_numpy(np.array(fr_j.F)),
                                  torch.tensor([CX, CY]), torch.from_numpy(f_grid)).numpy()
    # the cost is (s1 - s2) / (s1 + s2) of a nearly repeated pair where E is
    # nearly essential: both packages lose ~sqrt(eps) there
    assert np.abs(c - c_j).max() <= 2e-3
    assert np.array_equal(c.argmin(1), c_j.argmin(1))


@pytest.mark.parametrize("n", [95, 96])
def test_median_rows_matches_jnp_median(n):
    x = np.random.default_rng(n).random((5, n)).astype(np.float32)
    np.testing.assert_array_equal(selfcal._median_rows(torch.from_numpy(x)).numpy()[:, 0],
                                  np.asarray(jnp.median(jnp.asarray(x), axis=1)))


def test_log_grid_matches_jax():
    g = selfcal._log_grid(0.3 * 256, 3.0 * 256, 96, "cpu").numpy()
    g_j = np.asarray(jnp.exp(jnp.linspace(jnp.log(jnp.float32(76.8)),
                                          jnp.log(jnp.float32(768.0)), 96)))
    np.testing.assert_allclose(g, g_j, rtol=1e-6)


def _shared_focal(uv1, uv2, mask, key):
    est_j = jselfcal.estimate_shared_focal(
        key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
        jnp.asarray([CX, CY], jnp.float32), 100.0, 1000.0)
    u_f, u_h = _draws(key, uv1.shape[0])
    est = selfcal.estimate_shared_focal(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(mask),
        (CX, CY), 100.0, 1000.0, u_f=u_f, u_h=u_h)
    return est, est_j


@pytest.mark.parametrize("seed", [1, 2])
def test_estimate_shared_focal_matches_jax(seed):
    uv1, uv2, mask = _project_pairs(seed, outliers=0.0)
    est, est_j = _shared_focal(uv1, uv2, mask, jax.random.PRNGKey(0))
    assert abs(float(est.focal) / float(est_j.focal) - 1) <= 1e-3
    assert abs(float(est.confidence) - float(est_j.confidence)) <= 0.02
    assert abs(int(est.num_pairs) - int(est_j.num_pairs)) <= 1
    assert abs(float(est.focal) / F_GT - 1) < 0.05


def test_estimate_shared_focal_with_outliers_within_reference_spread(pairs):
    uv1, uv2, mask = pairs
    est, est_j = _shared_focal(uv1, uv2, mask, jax.random.PRNGKey(0))
    spread = [float(jselfcal.estimate_shared_focal(
        jax.random.PRNGKey(k), jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
        jnp.asarray([CX, CY], jnp.float32), 100.0, 1000.0).focal) for k in range(1, 5)]
    spread.append(float(est_j.focal))
    assert abs(float(est.focal) - float(est_j.focal)) <= max(spread) - min(spread)
    assert abs(int(est.num_pairs) - int(est_j.num_pairs)) <= 1
    # the reference's own movement when its inputs move by about one float32 step
    moved = [abs(float(jselfcal.estimate_shared_focal(
        jax.random.PRNGKey(0), jnp.asarray(uv1 * np.float32(s)),
        jnp.asarray(uv2 * np.float32(s)), jnp.asarray(mask),
        jnp.asarray([CX * s, CY * s], jnp.float32), 100.0, 1000.0).focal)
        / float(est_j.focal) - 1) for s in _ROUNDINGS]
    assert max(moved) > 1e-3                # beyond the outlier-free tolerance
    assert abs(float(est.focal) / float(est_j.focal) - 1) <= max(moved)


@pytest.mark.parametrize("seed", [0, 1, 123456789])
def test_reference_draws_are_jax_draws(seed):
    """`reference_draws` recomputes jax.random's threefry stream bit for bit."""
    for P in (3, 90):
        u_f, u_h = _draws(jax.random.PRNGKey(seed), P)
        r_f, r_h = selfcal.reference_draws(seed, P)
        assert torch.equal(u_f, r_f) and torch.equal(u_h, r_h)


@pytest.fixture(scope="module")
def conditioned():
    return make_conditioned_flow_scene(num_views=16, height=192, width=256, focal=240.0)


def _gate_accepts(info, min_pairs=16, min_conf=0.3, max_dip=0.5):
    """Mirror of stages.read_flow_selfcal's strict tier."""
    return (info["interior"] and info["num_pairs"] >= min_pairs
            and info["dip"] <= max_dip and info["confidence"] >= min_conf)


def test_estimate_focal_from_flows_matches_jax(conditioned):
    sc = conditioned
    info_j = jselfcal.estimate_focal_from_flows(sc["flows"], 192, 256, seed=0)
    P = selfcal.num_selfcal_pairs(sc["flows"]["flow_f"].shape[0])
    u_f, u_h = _draws(jax.random.PRNGKey(0), P)
    flows = {k: torch.from_numpy(v) for k, v in sc["flows"].items()}
    info = selfcal.estimate_focal_from_flows(flows, 192, 256, seed=0, u_f=u_f, u_h=u_h)
    assert abs(info["focal"] / info_j["focal"] - 1) <= 1e-3
    assert info["interior"] == info_j["interior"]
    assert abs(info["num_pairs"] - info_j["num_pairs"]) <= 1
    # the port's own generator: accepted, and within 6% of the true focal
    own = selfcal.estimate_focal_from_flows(flows, 192, 256, seed=0)
    assert _gate_accepts(own), own
    assert abs(own["focal"] / sc["focal"] - 1) < 0.06, own


def test_small_image_answer_is_the_references():
    flows = {k: np.zeros((3, 40, 60, 2), np.float32) for k in ("flow_f", "flow_b")}
    assert selfcal.estimate_focal_from_flows(flows, 40, 60) == \
        jselfcal.estimate_focal_from_flows(flows, 40, 60)


def test_focal_does_not_hang_on_rounding(pairs):
    """Scaling every coordinate (and the principal point) by 1 + 2^-22, about
    two float32 steps, moves the focal by < 1e-5 even with gross outliers:
    the card and the CPU round differently."""
    uv1, uv2, mask = (torch.from_numpy(a) for a in pairs)
    u_f, u_h = _draws(jax.random.PRNGKey(0), uv1.shape[0])
    f = [float(selfcal.estimate_shared_focal(
        uv1 * s, uv2 * s, mask, (CX * s, CY * s), 100.0, 1000.0, u_f=u_f, u_h=u_h).focal)
        for s in (1.0, 1.0 + 2.0 ** -22)]
    assert abs(f[1] / f[0] - 1) < 1e-5


def test_injected_draws_must_have_the_right_shape(pairs):
    uv1, uv2, mask = (torch.from_numpy(a) for a in pairs)
    with pytest.raises(ValueError, match="injected draws"):
        selfcal.estimate_fundamentals(uv1, uv2, mask, 4.0, u=torch.rand(3, 64, 8))


def test_read_flow_selfcal_tiers(tmp_path):
    """Strict tier -> +-15% BA trust region, marginal tier (shallow dip,
    decent agreement) -> +-30%, junk -> None; as the reference reads it."""
    cfg = Config()
    base = {"focal": 1234.0, "num_pairs": 40, "interior": True}
    cases = [
        ({**base, "confidence": 0.9, "dip": 0.2}, (1234.0, 0.15)),
        ({**base, "confidence": 0.56, "dip": 0.57}, (1234.0, 0.30)),
        ({**base, "confidence": 0.21, "dip": 0.53}, None),
        ({**base, "confidence": 0.9, "dip": 0.2, "interior": False}, None),
        ({**base, "num_pairs": 3, "confidence": 0.9, "dip": 0.2}, None),
    ]
    for info, want in cases:
        (tmp_path / "selfcal.json").write_text(json.dumps(info))
        assert read_flow_selfcal(tmp_path, cfg) == want
        assert jread_flow_selfcal(tmp_path, cfg) == want
    (tmp_path / "selfcal.json").unlink()
    assert read_flow_selfcal(tmp_path, cfg) is None
