"""Port parity: the global SfM solvers and the SfM front end against the JAX
package on the same seeded inputs (mirrors tests/test_globalsfm.py,
test_twoview_classify.py, test_two_model.py, test_pair_span.py and
test_global_positioning.py).

Random draws: the port replays the reference's `jax.random` keys
(`twoview.pair_draws`, `threefry_uniform`), so both packages test the same
hypotheses. Tolerances, stated per test: equal discrete outcomes (inlier
sets, configurations, iteration counts where the stop test is far from its
threshold), and 1e-4 on rotations (rad), unit directions and relative costs
unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu import native as jnative
from particlesfm_tpu.geometry import alignment, rotations as jrot
from particlesfm_tpu.globalsfm import ba as jba
from particlesfm_tpu.globalsfm import global_positioning as jgp
from particlesfm_tpu.globalsfm import pnp as jpnp
from particlesfm_tpu.globalsfm import rotation_averaging as jra
from particlesfm_tpu.globalsfm import tracks3d as jt3
from particlesfm_tpu.globalsfm import translation as jtr
from particlesfm_tpu.globalsfm import triplets as jtrip
from particlesfm_tpu.globalsfm import twoview as jtv
from particlesfm_tpu.graph import orientations_from_spanning_tree as j_mst_init
from particlesfm_tpu.sfm import correspondences as jcorr
from particlesfm_tpu_torch import native
from particlesfm_tpu_torch.globalsfm import ba, global_positioning as gp, pnp
from particlesfm_tpu_torch.globalsfm import rotation_averaging as ra
from particlesfm_tpu_torch.globalsfm import tracks3d as t3
from particlesfm_tpu_torch.globalsfm import translation as tr
from particlesfm_tpu_torch.globalsfm import triplets as trip
from particlesfm_tpu_torch.globalsfm import twoview as tv
from particlesfm_tpu_torch.graph import orientations_from_spanning_tree
from particlesfm_tpu_torch.sfm import correspondences as corr
from particlesfm_tpu_torch.tracks.store import TrackArrays

from synthetic import orbit_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _qang(a, b):
    """Angle (rad) between quaternion batches, in float64 (float32 arccos
    near 1 cannot resolve 1e-4)."""
    a, b = np.asarray(_n(a), np.float64), np.asarray(_n(b), np.float64)
    d = np.abs((a * b).sum(-1)) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    d = np.minimum(d, 1.0)
    return 2.0 * np.arctan2(np.sqrt(1.0 - d * d), d)


@pytest.fixture(scope="module")
def scene():
    """8 views on an arc, 300 points, 0.5 px noise, with the pair tensors and
    normalized correspondences of every covisible pair."""
    sc = orbit_scene(num_views=8, num_points=300, pixel_noise=0.5, seed=2)
    tracks = sc["tracks"]
    pt = jcorr.build_pair_tensors(tracks, tracks.mask, 15, seed=100)
    f, pp = sc["focal"], sc["params"][2:4]
    x1 = ((pt.uv1 - pp) / f).astype(np.float32)
    x2 = ((pt.uv2 - pp) / f).astype(np.float32)
    thr = np.full(len(pt.pairs), (4.0 / f) ** 2, np.float32)
    return dict(sc=sc, pt=pt, x1=x1, x2=x2, thr=thr)


def test_pair_draws_are_jax_draws():
    key = jax.random.PRNGKey(7)
    ref = jax.vmap(lambda k: jax.random.uniform(k, (64, 8)))(jax.random.split(key, 5))
    np.testing.assert_array_equal(tv.pair_draws(7, 5, (64, 8)), np.asarray(ref))
    np.testing.assert_array_equal(tv.threefry_uniform(tv.threefry_key(3), (64, 6)),
                                  np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (64, 6))))


def _two_view_both(s, seed, mask=None):
    P = len(s["pt"].pairs)
    mask = s["pt"].mask if mask is None else mask
    ref = jtv.estimate_relative_poses(jax.random.PRNGKey(seed), jnp.asarray(s["x1"]),
                                      jnp.asarray(s["x2"]), jnp.asarray(mask),
                                      jnp.asarray(s["thr"]))
    out = tv.estimate_relative_poses(_t(s["x1"]), _t(s["x2"]), _t(mask), _t(s["thr"]),
                                     u=_t(tv.pair_draws(seed, P, (64, 8))))
    return out, ref


@pytest.mark.parametrize("seed", [0, 7])
def test_estimate_relative_poses_matches_jax(scene, seed):
    """Same draws: identical inlier sets on every pair; rotations within
    1e-5 rad in the median and 5e-3 rad at most, unit translations within
    5e-3, median angles within 1e-3 relative. The bound on the worst pair is the
    reference's own float32 8-point refit, which the port forms in float64
    (ROADMAP section 3)."""
    out, ref = _two_view_both(scene, seed)
    np.testing.assert_array_equal(_n(out.inliers), np.asarray(ref.inliers))
    np.testing.assert_array_equal(_n(out.num_inliers), np.asarray(ref.num_inliers))
    ang = _qang(out.q_rel, ref.q_rel)
    assert np.median(ang) < 1e-5 and ang.max() < 5e-3
    np.testing.assert_allclose(_n(out.t_rel), np.asarray(ref.t_rel), atol=5e-3)
    np.testing.assert_allclose(_n(out.tri_angle), np.asarray(ref.tri_angle), rtol=1e-3)


@pytest.mark.parametrize("seed,noise,outliers", [(2, 0.5, 0.2), (3, 1.0, 0.3), (4, 1.5, 0.3)])
def test_relative_poses_with_outliers_within_reference_spread(seed, noise, outliers):
    """Short baselines and 20-30% gross outliers (as on the main path's video
    pairs): the reference's float32 8-point hypotheses hang on rounding, so
    its own inlier counts change on some pairs when the inputs are scaled by
    1 +- 2^-22. The port (float64 normal matrices) does not move under that
    scaling, and agrees with the reference on at least the share of pairs on
    which the reference agrees with itself, less 0.1."""
    sc = orbit_scene(num_views=12, num_points=400, pixel_noise=noise, seed=seed, arc=0.15)
    pt = jcorr.build_pair_tensors(sc["tracks"], sc["tracks"].mask, 15, seed=100)
    rng = np.random.default_rng(seed)
    uv2 = pt.uv2.copy()
    bad = rng.random(pt.mask.shape) < outliers
    uv2[bad] += rng.normal(0, 30, (bad.sum(), 2)).astype(np.float32)
    f, pp = sc["focal"], sc["params"][2:4]
    x1 = ((pt.uv1 - pp) / f).astype(np.float32)
    x2 = ((uv2 - pp) / f).astype(np.float32)
    P = len(pt.pairs)
    thr = np.full(P, (4.0 / f) ** 2, np.float32)
    u = _t(tv.pair_draws(0, P, (64, 8)))

    def ref(s):
        s = np.float32(s)
        return np.asarray(jtv.estimate_relative_poses(
            jax.random.PRNGKey(0), jnp.asarray(x1 * s), jnp.asarray(x2 * s),
            jnp.asarray(pt.mask), jnp.asarray(thr * s * s)).num_inliers)

    def port(s):
        s = np.float32(s)
        return _n(tv.estimate_relative_poses(_t(x1 * s), _t(x2 * s), _t(pt.mask),
                                             _t(thr * s * s), u=u).num_inliers)

    n_ref = ref(1.0)
    self_agree = [float((n_ref == ref(1 + e)).mean()) for e in (2.0 ** -22, -2.0 ** -22)]
    assert min(self_agree) < 1.0
    n_port = port(1.0)
    np.testing.assert_array_equal(port(1 + 2.0 ** -22), n_port)
    assert float((n_port == n_ref).mean()) >= min(self_agree) - 0.1


def test_second_model_pass_matches_jax(scene):
    """The two-model pass: RANSAC on the first model's outliers (seed + 7)."""
    first, _ = _two_view_both(scene, 0)
    mask_b = scene["pt"].mask & ~_n(first.inliers)
    out, ref = _two_view_both(scene, 7, mask_b)
    np.testing.assert_array_equal(_n(out.num_inliers), np.asarray(ref.num_inliers))


def _classify_both(x1, x2, uv1, uv2, hw, thres_sq=1e-5):
    M = x1.shape[0]
    args = (x1[None], x2[None], np.ones((1, M), bool), np.full((1,), thres_sq, np.float32))
    e = jtv.estimate_relative_poses(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    ref = jtv.classify_two_view(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in args),
                                e.inliers, jnp.asarray(uv1[None]), jnp.asarray(uv2[None]), hw)
    e_p = tv.estimate_relative_poses(*(_t(a) for a in args), u=_t(tv.pair_draws(0, 1, (64, 8))))
    out = tv.classify_two_view(*(_t(a) for a in args), e_p.inliers, _t(uv1[None]),
                               _t(uv2[None]), hw, u=_t(tv.pair_draws(1, 1, (32, 4))))
    return out, ref


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _project(X, R=np.eye(3), t=np.zeros(3)):
    Xc = X @ R.T + t
    return (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)


@pytest.mark.parametrize("kind", ["general", "planar", "panoramic", "watermark"])
def test_classify_two_view_matches_jax(kind):
    """The four configurations of tests/test_twoview_classify.py: the same
    code, the same H inlier count, q_h within 1e-4 rad where it is used
    (planar, panoramic)."""
    rng = np.random.default_rng({"general": 3, "planar": 4, "panoramic": 5, "watermark": 6}[kind])
    f, c = 400.0, np.array([320.0, 240.0])
    thres = 1e-5
    if kind == "general":
        X = rng.uniform(-2, 2, (80, 3)) + np.array([0, 0, 6.0])
        X[:, 2] += rng.uniform(-2, 2, 80)
        x1, x2 = _project(X), _project(X, _rot_y(0.1), np.array([0.5, 0.0, 0.1]))
    elif kind == "planar":
        X = rng.uniform(-1, 1, (80, 3))
        X[:, 2] = 4.0
        x1, x2 = _project(X), _project(X, _rot_y(0.12), np.array([0.4, 0.05, 0.0]))
    elif kind == "panoramic":
        X = rng.uniform(-2, 2, (80, 3)) + np.array([0, 0, 5.0])
        x1, x2 = _project(X), _project(X, _rot_y(0.08))
    else:
        m = 40
        uv1 = np.concatenate([np.stack([rng.uniform(0, 30, m), rng.uniform(0, 480, m)], 1),
                              np.stack([rng.uniform(610, 640, m), rng.uniform(0, 480, m)], 1)])
        x1 = ((uv1 - c) / f).astype(np.float32)
        x2 = ((uv1 + np.array([1.5, 0.8]) - c) / f).astype(np.float32)
        thres = 1e-4
    uv1, uv2 = (x1 * f + c).astype(np.float32), (x2 * f + c).astype(np.float32)
    out, ref = _classify_both(x1, x2, uv1, uv2, (480, 640), thres)
    assert int(out.config[0]) == int(ref.config[0])
    assert int(out.num_h_inliers[0]) == int(ref.num_h_inliers[0])
    if kind in ("planar", "panoramic"):
        assert _qang(out.q_h, ref.q_h).max() < 1e-4


def _rotation_graph(seed=0, V=10, outliers=3):
    rng = np.random.default_rng(seed)
    R = np.asarray(jrot.angle_axis_to_rotmat(jnp.asarray(rng.normal(size=(V, 3)) * 0.5,
                                                          jnp.float32)))
    edges = np.array([(i, j) for i in range(V) for j in range(i + 1, min(V, i + 4))], np.int32)
    noise = np.asarray(jrot.angle_axis_to_rotmat(
        jnp.asarray(rng.normal(size=(len(edges), 3)) * 0.01, jnp.float32)))
    R_rel = noise @ R[edges[:, 1]] @ np.swapaxes(R[edges[:, 0]], -1, -2)
    bad = rng.choice(len(edges), outliers, replace=False)
    R_rel[bad] = np.asarray(jrot.angle_axis_to_rotmat(
        jnp.asarray(rng.normal(size=(outliers, 3)), jnp.float32))) @ R_rel[bad]
    counts = rng.integers(50, 200, len(edges))
    R_init = j_mst_init(V, edges, counts, R_rel.astype(np.float32))
    return V, edges, R_rel.astype(np.float32), R_init.astype(np.float32), R


def test_average_rotations_matches_jax():
    """L1 + IRLS on a graph with 3 gross outliers: the same iteration counts,
    rotation matrices within 1e-4, the same mean residual within 1e-6 rad."""
    V, edges, R_rel, R_init, _ = _rotation_graph()
    Rj, ij = jra.average_rotations(V, jnp.asarray(edges), jnp.asarray(R_rel),
                                   jnp.asarray(R_init), jnp.ones(len(edges)))
    Rp, ip = ra.average_rotations(V, _t(edges, torch.int64), _t(R_rel), _t(R_init),
                                  torch.ones(len(edges)))
    assert (ip["l1_iters"], ip["irls_iters"]) == (int(ij["l1_iters"]), int(ij["irls_iters"]))
    np.testing.assert_allclose(_n(Rp), np.asarray(Rj), atol=1e-4)
    assert abs(float(ip["mean_residual_rad"]) - float(ij["mean_residual_rad"])) < 1e-6


def test_orientations_from_spanning_tree_is_the_reference_copy():
    V, edges, R_rel, _, _ = _rotation_graph(1)
    counts = np.arange(len(edges))
    np.testing.assert_array_equal(orientations_from_spanning_tree(V, edges, counts, R_rel),
                                  j_mst_init(V, edges, counts, R_rel))


def _translation_problem(seed=0, V=8, noise=0.01):
    rng = np.random.default_rng(seed)
    C = np.cumsum(rng.normal(size=(V, 3)), 0).astype(np.float32)
    C -= C[0]
    edges = np.array([(i, j) for i in range(V) for j in range(i + 1, min(V, i + 4))], np.int32)
    w = C[edges[:, 0]] - C[edges[:, 1]]
    w = w / np.linalg.norm(w, axis=-1, keepdims=True)
    w = w + rng.normal(size=w.shape) * noise
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    return V, edges, w, C


@pytest.mark.parametrize("pad", [0, 7])
def test_lud_matches_jax(pad):
    """ADMM on a noisy chain graph, with and without weight-0 padded edges:
    positions within 1e-3 of the reference's (relative to the spread) and of
    each other after Sim3; iteration counts within 5% (the stop test sits
    on the ADMM residual, whose float32 rounding differs)."""
    V, edges, w, C = _translation_problem()
    E = len(edges)
    edges_p = np.pad(edges, ((0, pad), (0, 0)))
    w_p = np.concatenate([w, np.tile(np.float32([[0, 0, 1]]), (pad, 1))])
    em = np.r_[np.ones(E), np.zeros(pad)].astype(np.float32)
    pj, sj, ij = jtr.estimate_positions_lud(V, jnp.asarray(edges_p), jnp.asarray(w_p),
                                            jnp.asarray(em))
    pp, sp, ip = tr.estimate_positions_lud(V, _t(edges_p, torch.int64), _t(w_p), _t(em))
    spread = np.linalg.norm(np.asarray(pj) - np.asarray(pj).mean(0), axis=1).mean()
    assert np.abs(_n(pp) - np.asarray(pj)).max() < 1e-3 * spread
    assert abs(ip["iters"] - int(ij["iters"])) <= 0.05 * int(ij["iters"]) + 1
    assert alignment.ate_rmse(_n(pp), C) < 0.05 * np.linalg.norm(C, axis=1).mean()


def test_lud_with_triplet_constraints_matches_jax(scene):
    """Triplet baseline ratios from the scene's common points, then LUD with
    them: ratios and weights within 1e-4 (relative), positions within 1e-3."""
    sc = scene["sc"]
    V = 8
    R = np.asarray(jrot.quat_to_rotmat(jnp.asarray(sc["q"])))
    C = sc["centers"].astype(np.float32)
    edges = np.array([(i, j) for i in range(V) for j in range(i + 1, V)], np.int32)
    w = C[edges[:, 0]] - C[edges[:, 1]]
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    from particlesfm_tpu.graph import extract_triplets
    tris = extract_triplets(edges)
    eo = {(int(a), int(b)): e for e, (a, b) in enumerate(edges)}
    te = np.array([[eo[(i, j)], eo[(i, k)], eo[(j, k)]] for i, j, k in tris], np.int32)
    tracks = sc["tracks"]
    xi, xj, xk, tm = jcorr.gather_triplet_points(tracks, tracks.mask, tris, seed=100)
    pi, pj_, pk, pm = corr.gather_triplet_points(tracks, tracks.mask, tris, seed=100)
    for a, b in zip((xi, xj, xk, tm), (pi, pj_, pk, pm)):
        np.testing.assert_array_equal(a, b)
    f, c = sc["focal"], sc["params"][2:4]
    nx = [((x - c) / f).astype(np.float32) for x in (xi, xj, xk)]
    tc_j = jtrip.triplet_baseline_constraints(jnp.asarray(R), jnp.asarray(w), jnp.asarray(tris),
                                              jnp.asarray(te), *(jnp.asarray(x) for x in nx),
                                              jnp.asarray(tm))
    tc_p = trip.triplet_baseline_constraints(_t(R), _t(w), _t(tris, torch.int64),
                                             _t(te, torch.int64), *(_t(x) for x in nx), _t(tm))
    np.testing.assert_allclose(_n(tc_p.ratios), np.asarray(tc_j.ratios), rtol=1e-4)
    np.testing.assert_allclose(_n(tc_p.weight), np.asarray(tc_j.weight), rtol=1e-6)
    em = np.ones(len(edges), np.float32)
    pj, _, _ = jtr.estimate_positions_lud(V, jnp.asarray(edges), jnp.asarray(w), jnp.asarray(em),
                                          triplets=tc_j)
    pp, _, _ = tr.estimate_positions_lud(V, _t(edges, torch.int64), _t(w), _t(em), triplets=tc_p)
    spread = np.linalg.norm(np.asarray(pj) - np.asarray(pj).mean(0), axis=1).mean()
    assert np.abs(_n(pp) - np.asarray(pj)).max() < 1e-3 * spread


def test_pairwise_translation_refinement_matches_jax(scene):
    """IRLS baseline directions from the scene's correspondences, started from
    perturbed two-view directions: within 1e-3 of the reference's (64 L1-IRLS
    steps with weights 1/|a.w| amplify float32 rounding)."""
    sc, pt = scene["sc"], scene["pt"]
    R = np.asarray(jrot.quat_to_rotmat(jnp.asarray(sc["q"])))
    C = sc["centers"]
    w = C[pt.pairs[:, 0]] - C[pt.pairs[:, 1]]
    rng = np.random.default_rng(0)
    w0 = (w / np.linalg.norm(w, axis=-1, keepdims=True) + 0.05 * rng.normal(size=w.shape))
    t_rel = np.einsum("eij,ej->ei", R[pt.pairs[:, 1]], w0).astype(np.float32)
    d_j = jtr.directions_from_relative_poses(jnp.asarray(pt.pairs), jnp.asarray(R),
                                             jnp.asarray(t_rel))
    d_p = tr.directions_from_relative_poses(_t(pt.pairs, torch.int64), _t(R), _t(t_rel))
    np.testing.assert_allclose(_n(d_p), np.asarray(d_j), atol=1e-6)
    ref = jtr.refine_pairwise_translations(jnp.asarray(pt.pairs), jnp.asarray(R),
                                           jnp.asarray(scene["x1"]), jnp.asarray(scene["x2"]),
                                           jnp.asarray(pt.mask), d_j)
    out = tr.refine_pairwise_translations(_t(pt.pairs, torch.int64), _t(R), _t(scene["x1"]),
                                          _t(scene["x2"]), _t(pt.mask), d_p)
    np.testing.assert_allclose(_n(out), np.asarray(ref), atol=1e-3)


def _obs(sc):
    """Per-track padded observations of the scene."""
    tracks = sc["tracks"]
    return jcorr.build_observations(tracks, tracks.mask, max_obs_per_track=20, min_track_len=2)


def test_triangulate_and_filter_match_jax(scene):
    """Tracks3d on the scene at perturbed poses: points within 1e-4
    (relative), identical kept-observation masks and valid tracks, errors
    within 1e-3 px."""
    sc = scene["sc"]
    o = _obs(sc)
    rng = np.random.default_rng(1)
    q = (sc["q"] + 0.002 * rng.normal(size=sc["q"].shape)).astype(np.float32)
    t = (sc["t"] + 0.01 * rng.normal(size=sc["t"].shape)).astype(np.float32)
    p = sc["params"]
    jo = jt3.TrackObs(jnp.asarray(o.frame_idx), jnp.asarray(o.uv), jnp.asarray(o.mask))
    po = t3.TrackObs(_t(o.frame_idx, torch.int64), _t(o.uv), _t(o.mask))
    Xj = jt3.triangulate_tracks(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), jo)
    Xp = t3.triangulate_tracks(_t(q), _t(t), _t(p), po)
    np.testing.assert_allclose(_n(Xp), np.asarray(Xj), rtol=1e-4, atol=1e-4)
    for thr in (2.0, 1e9):
        gj, vj, ej = jt3.filter_observations(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), Xj,
                                            jo, thr, 1.5)
        gp_, vp, ep = t3.filter_observations(_t(q), _t(t), _t(p), _t(np.asarray(Xj)), po, thr, 1.5)
        np.testing.assert_array_equal(_n(gp_), np.asarray(gj))
        np.testing.assert_array_equal(_n(vp), np.asarray(vj))
        np.testing.assert_allclose(_n(ep), np.asarray(ej), atol=1e-3)


@pytest.mark.parametrize("refine_focal", [False, True])
def test_bundle_adjust_matches_jax(scene, refine_focal):
    """One LM run (dense Schur solve, soft-L1) from perturbed poses, points
    and focal, with the phase-1 gauge: final cost within 1e-4 relative, poses
    within 1e-4, focal within 1e-4 relative. The iteration counts may differ:
    near convergence the stop test compares a relative cost change with 1e-6,
    the size of float32 rounding of the cost sum."""
    sc = scene["sc"]
    o = _obs(sc)
    rng = np.random.default_rng(2)
    V = len(sc["q"])
    q = np.asarray(jrot.quat_normalize(jnp.asarray(
        sc["q"] + 0.003 * rng.normal(size=sc["q"].shape), jnp.float32)))
    t = (sc["t"] + 0.02 * rng.normal(size=sc["t"].shape)).astype(np.float32)
    p = sc["params"].copy()
    if refine_focal:
        p[:2] *= 1.05
    X = (sc["X"][np.asarray(o.track_row)] + 0.02 * rng.normal(size=(len(o.track_row), 3))
         ).astype(np.float32)
    pm = np.ones(len(X), np.float32)
    anchor = (0, V - 1, 0)
    kw = dict(max_iterations=50, loss_scale=1.0, use_soft_l1=True, refine_focal=refine_focal,
              function_tolerance=1e-6)
    fb = np.float32([0.85, 1.15]) * p[0]
    jo = jt3.TrackObs(jnp.asarray(o.frame_idx), jnp.asarray(o.uv), jnp.asarray(o.mask))
    sj = jba.bundle_adjust(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), jnp.asarray(X), jo,
                           jba.default_free_masks(V, True, anchor), jnp.asarray(pm),
                           focal_bounds=jnp.asarray(fb), **kw)
    po = t3.TrackObs(_t(o.frame_idx, torch.int64), _t(o.uv), _t(o.mask))
    free = ba.default_free_masks(V, True, anchor)
    np.testing.assert_array_equal(_n(free), np.asarray(jba.default_free_masks(V, True, anchor)))
    sp = ba.bundle_adjust(_t(q), _t(t), _t(p), _t(X), po, free, _t(pm), focal_bounds=_t(fb), **kw)
    assert abs(float(sp.cost) - float(sj.cost)) <= 1e-4 * float(sj.cost)
    assert _qang(sp.q, sj.q).max() < 1e-4
    np.testing.assert_allclose(_n(sp.t), np.asarray(sj.t), atol=1e-4)
    assert abs(float(sp.params[0]) / float(sj.params[0]) - 1) < 1e-4
    # the closed-form focal step on the result
    fj = jba.refine_shared_focal(sj.q, sj.t, sj.params, sj.X, jo, jnp.asarray(pm))
    fp = ba.refine_shared_focal(_t(np.asarray(sj.q)), _t(np.asarray(sj.t)),
                                _t(np.asarray(sj.params)), _t(np.asarray(sj.X)), po, _t(pm))
    np.testing.assert_allclose(_n(fp), np.asarray(fj), rtol=1e-5)



@pytest.mark.parametrize("refine_focal", [False, True])
def test_bundle_adjust_pcg_matches_jax(scene, refine_focal):
    """The matrix-free Schur PCG solver (solver="pcg", 50 CG iterations per
    LM step, block-Jacobi preconditioned) from the same perturbed start as
    the dense test: final cost within 1e-4 relative of JAX's PCG, poses
    within 1e-4, focal within 1e-4 relative; and within 1e-3 relative of the
    port's dense solve."""
    sc = scene["sc"]
    o = _obs(sc)
    rng = np.random.default_rng(3)
    V = len(sc["q"])
    q = np.asarray(jrot.quat_normalize(jnp.asarray(
        sc["q"] + 0.003 * rng.normal(size=sc["q"].shape), jnp.float32)))
    t = (sc["t"] + 0.02 * rng.normal(size=sc["t"].shape)).astype(np.float32)
    p = sc["params"].copy()
    if refine_focal:
        p[:2] *= 1.05
    X = (sc["X"][np.asarray(o.track_row)] + 0.02 * rng.normal(size=(len(o.track_row), 3))
         ).astype(np.float32)
    pm = np.ones(len(X), np.float32)
    anchor = (0, V - 1, 0)
    kw = dict(max_iterations=50, pcg_iters=50, loss_scale=1.0, use_soft_l1=True,
              refine_focal=refine_focal, function_tolerance=1e-6)
    jo = jt3.TrackObs(jnp.asarray(o.frame_idx), jnp.asarray(o.uv), jnp.asarray(o.mask))
    sj = jba.bundle_adjust(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), jnp.asarray(X), jo,
                           jba.default_free_masks(V, True, anchor), jnp.asarray(pm),
                           solver="pcg", **kw)
    po = t3.TrackObs(_t(o.frame_idx, torch.int64), _t(o.uv), _t(o.mask))
    free = ba.default_free_masks(V, True, anchor)
    sp = ba.bundle_adjust(_t(q), _t(t), _t(p), _t(X), po, free, _t(pm), solver="pcg", **kw)
    assert abs(float(sp.cost) - float(sj.cost)) <= 1e-4 * float(sj.cost)
    assert _qang(sp.q, sj.q).max() < 1e-4
    np.testing.assert_allclose(_n(sp.t), np.asarray(sj.t), atol=1e-4)
    assert abs(float(sp.params[0]) / float(sj.params[0]) - 1) < 1e-4
    sd = ba.bundle_adjust(_t(q), _t(t), _t(p), _t(X), po, free, _t(pm), solver="dense", **kw)
    assert abs(float(sp.cost) - float(sd.cost)) <= 1e-3 * float(sd.cost)


def _pnp_problem(scene, v=3):
    """One view's 2D-3D pairs with 20% gross outliers, padded to 512."""
    sc = scene["sc"]
    vis = sc["vis"][v]
    X = sc["X"][vis].astype(np.float32)
    x = ((sc["uv"][v, vis] - sc["params"][2:4]) / sc["focal"]).astype(np.float32)
    rng = np.random.default_rng(3)
    bad = rng.random(len(x)) < 0.2
    x[bad] += rng.normal(size=(bad.sum(), 2)).astype(np.float32) * 0.05
    M = 512
    Xc, xc, mc = np.zeros((M, 3), np.float32), np.zeros((M, 2), np.float32), np.zeros(M, bool)
    Xc[:len(X)], xc[:len(X)], mc[:len(X)] = X, x, True
    return Xc, xc, mc


def test_pnp_matches_jax(scene):
    """PnP RANSAC + GN at the mapper's 4 px threshold with the reference's
    draws: the same inlier set, rotation within 1e-3 rad and translation
    within 1e-3 (the reference's own pose moves by 5e-4 rad when its input
    is scaled by 1 + 2^-22)."""
    v = 3
    Xc, xc, mc = _pnp_problem(scene, v)
    thr = np.float32((4.0 / scene["sc"]["focal"]) ** 2)
    rj = jpnp.estimate_pose_pnp(jax.random.PRNGKey(v), jnp.asarray(Xc), jnp.asarray(xc),
                                jnp.asarray(mc), thr)
    rp = pnp.estimate_pose_pnp(_t(Xc), _t(xc), _t(mc), float(thr),
                               u=_t(tv.threefry_uniform(tv.threefry_key(v), (64, 6))))
    np.testing.assert_array_equal(_n(rp.inliers), np.asarray(rj.inliers))
    assert _qang(rp.q, rj.q) < 1e-3
    np.testing.assert_allclose(_n(rp.t), np.asarray(rj.t), atol=1e-3)


def test_pnp_reference_hypotheses_hang_on_rounding(scene):
    """Witness for the port's float64 DLT normal matrix: at a 1 px threshold
    the reference's own inlier count moves when its 3D points are scaled by
    1 +- 2^-22 (its float32 6-point null vectors are rounding-limited), and
    the port's pose is as close to the truth as the reference's worst."""
    v = 3
    Xc, xc, mc = _pnp_problem(scene, v)
    thr = np.float32((1.0 / scene["sc"]["focal"]) ** 2)
    counts, errs = [], []
    sc = scene["sc"]
    for s in (1.0, 1 + 2 ** -22, 1 - 2 ** -22):
        r = jpnp.estimate_pose_pnp(jax.random.PRNGKey(v), jnp.asarray(Xc * np.float32(s)),
                                   jnp.asarray(xc), jnp.asarray(mc), thr)
        counts.append(int(r.num_inliers))
        errs.append(_qang(r.q, sc["q"][v]))
    assert len(set(counts)) > 1
    rp = pnp.estimate_pose_pnp(_t(Xc), _t(xc), _t(mc), float(thr),
                               u=_t(tv.threefry_uniform(tv.threefry_key(v), (64, 6))))
    assert int(rp.num_inliers) >= min(counts)
    assert _qang(rp.q, sc["q"][v]) < 3 * max(errs) + 1e-3


def _bearings(sc):
    V = len(sc["q"])
    R = np.asarray(jrot.quat_to_rotmat(jnp.asarray(sc["q"])))
    N = sc["X"].shape[0]
    fidx = np.zeros((N, V), np.int32)
    a = np.zeros((N, V, 3), np.float32)
    b = np.zeros((N, V, 3), np.float32)
    mask = np.zeros((N, V), bool)
    for n in range(N):
        views = np.nonzero(sc["vis"][:, n])[0]
        for k, v in enumerate(views):
            duv = sc["uv"][v, n] - sc["params"][2:4]
            a[n, k] = R[v].T @ np.array([duv[0], duv[1], 0.0])
            b[n, k] = R[v][2]
            fidx[n, k] = v
            mask[n, k] = True
    return V, fidx, a, b, mask


def test_global_positioning_matches_jax(scene):
    """Bearing-only positioning (the reference's random init is overwritten
    before use): positions within 1e-4 relative to the spread."""
    sc = scene["sc"]
    V, fidx, a, b, mask = _bearings(sc)
    rays = a / sc["focal"] + b
    rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    pj, Xj, dj = jgp.global_positioning(V, jnp.asarray(rays), jnp.asarray(fidx),
                                        jnp.asarray(mask), jax.random.PRNGKey(0))
    pp, Xp, dp = gp.global_positioning(V, _t(rays), _t(fidx, torch.int64), _t(mask))
    spread = np.linalg.norm(np.asarray(pj) - np.asarray(pj).mean(0), axis=1).mean()
    assert np.abs(_n(pp) - np.asarray(pj)).max() < 1e-4 * spread


def test_global_positioning_joint_focal_matches_jax(scene):
    """Joint focal from a 20% high prior: positions within 1e-4 relative and
    focal within 1e-4 relative of the reference's."""
    sc = scene["sc"]
    V, fidx, a, b, mask = _bearings(sc)
    g0 = 1.0 / (1.2 * sc["focal"])
    pj, _, _, fj = jgp.global_positioning_joint_focal(
        V, jnp.asarray(a), jnp.asarray(b), jnp.asarray(fidx), jnp.asarray(mask),
        jax.random.PRNGKey(0), g0=g0)
    pp, _, _, fp = gp.global_positioning_joint_focal(V, _t(a), _t(b), _t(fidx, torch.int64),
                                                     _t(mask), g0=g0)
    spread = np.linalg.norm(np.asarray(pj) - np.asarray(pj).mean(0), axis=1).mean()
    assert np.abs(_n(pp) - np.asarray(pj)).max() < 1e-4 * spread
    assert abs(float(fp) / float(fj) - 1) < 1e-4


# ---------------------------------------------------------------------------
# correspondences and the host library
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_span", [0, 1, 2])
def test_build_pair_tensors_and_observations_match_jax(max_span):
    """Pair tensors (with over-cap Floyd sampling and the span band) and
    observation tensors are the reference's, field for field."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 400, (600, 6, 2)).astype(np.float32)
    mask = rng.random((600, 6)) < 0.8
    labels = (rng.random((600, 6)) < 0.1).astype(np.int8)
    tracks = TrackArrays(xy=xy, mask=mask, labels=labels)
    a = corr.build_pair_tensors(tracks, mask, 15, max_span=max_span, seed=3)
    b = jcorr.build_pair_tensors(tracks, mask, 15, max_span=max_span, seed=3)
    for f in ("pairs", "counts", "uv1", "uv2", "mask", "track_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    if max_span:
        assert (a.pairs[:, 1] - a.pairs[:, 0]).max() == max_span
    np.testing.assert_array_equal(corr.static_observation_mask(tracks),
                                  jcorr.static_observation_mask(tracks))
    oa = corr.build_observations(tracks, mask, max_obs_per_track=4)
    ob = jcorr.build_observations(tracks, mask, max_obs_per_track=4)
    for f in ("frame_idx", "uv", "mask", "track_row"):
        np.testing.assert_array_equal(getattr(oa, f), getattr(ob, f))


def test_epipolar_votes_and_device_observations_match_jax(scene):
    """Dense per-track votes and the observation tensor from the fixed-point
    track upload: votes identical; observations identical to the reference's
    1/32 px quantization."""
    sc, pt = scene["sc"], scene["pt"]
    tracks = sc["tracks"]
    from particlesfm_tpu.geometry import epipolar as jepi
    res = jtv.estimate_relative_poses(jax.random.PRNGKey(0), jnp.asarray(scene["x1"]),
                                      jnp.asarray(scene["x2"]), jnp.asarray(pt.mask),
                                      jnp.asarray(scene["thr"]))
    E = np.asarray(jepi.essential_from_pose(res.q_rel, res.t_rel))
    pp, f = sc["params"][2:4], sc["focal"]
    dev_j = jcorr.upload_tracks_u16(tracks.xy, tracks.mask)
    gj, tj = jcorr.full_epipolar_votes(tracks.xy, tracks.mask, pt.pairs, E, f, pp, scene["thr"],
                                       dev=dev_j, chunk=5)
    dev_p = corr.upload_tracks_u16(tracks.xy, tracks.mask, "cpu")
    gp_, tp = corr.full_epipolar_votes(pt.pairs, E, f, pp, scene["thr"], dev=dev_p, chunk=5)
    np.testing.assert_array_equal(gp_, gj)
    np.testing.assert_array_equal(tp, tj)
    o = jcorr.build_observations(tracks, tracks.mask)
    N = len(o.track_row)
    ofi = o.frame_idx
    sub_fi = np.where(o.mask, ofi, 0)
    oj = jcorr.build_obs_device(dev_j[0], np.pad(o.track_row.astype(np.int32), (0, 32768 - N)),
                                np.pad(ofi, ((0, 32768 - N), (0, 0))),
                                np.pad(sub_fi, ((0, 32768 - N), (0, 0))),
                                np.pad(o.mask, ((0, 32768 - N), (0, 0))))
    op = corr.build_obs_device(dev_p, o.track_row, ofi, sub_fi, o.mask)
    np.testing.assert_array_equal(_n(op.uv), np.asarray(oj.uv)[:N])
    np.testing.assert_array_equal(_n(op.mask), np.asarray(oj.mask)[:N])


@pytest.mark.parametrize("case", ["separating", "min_votes", "guard"])
def test_two_model_clustering_is_the_reference_copy(case):
    """The clustering of tests/test_two_model.py's synthetic memberships."""
    from test_two_model import _scene

    n, pair_t, verified, mA, mB, has_b, _ = _scene(**({"guard": dict(num_static=4, num_dyn=10)}
                                                     .get(case, {})))
    kw = {"min_votes": 20} if case == "min_votes" else {}
    np.testing.assert_array_equal(
        corr.two_model_motion_clustering(n, pair_t, verified, mA, mB, has_b, **kw),
        jcorr.two_model_motion_clustering(n, pair_t, verified, mA, mB, has_b, **kw))
    inl = mA
    for a, b in zip(corr.track_inlier_stats(n, pair_t, verified, inl),
                    jcorr.track_inlier_stats(n, pair_t, verified, inl)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        corr.geometric_dynamic_track_filter(n, pair_t, verified, inl),
        jcorr.geometric_dynamic_track_filter(n, pair_t, verified, inl))


def test_native_binding_matches_the_reference_binding():
    """The port's ctypes binding loads the same library and returns what the
    reference's binding returns for all six entry points."""
    assert native.available() and jnative.available()
    rng = np.random.default_rng(0)
    mask = rng.random((300, 7)) < 0.7
    xy = rng.uniform(0, 100, (300, 7, 2)).astype(np.float32)
    edges = np.array([(0, 1), (1, 2), (3, 4), (5, 6), (4, 5)], np.int32)
    w = np.array([3.0, 1.0, 2.0, 5.0, 4.0])
    np.testing.assert_array_equal(native.connected_components(7, edges),
                                  jnative.connected_components(7, edges))
    np.testing.assert_array_equal(native.maximum_spanning_tree(7, edges, w),
                                  jnative.maximum_spanning_tree(7, edges, w))
    np.testing.assert_array_equal(native.mfas_order(7, edges, w - 2.5),
                                  jnative.mfas_order(7, edges, w - 2.5))
    np.testing.assert_array_equal(native.covisibility(mask), jnative.covisibility(mask))
    for a, b in zip(native.build_observations(mask, xy, 2, 5),
                    jnative.build_observations(mask, xy, 2, 5)):
        np.testing.assert_array_equal(a, b)
    pairs = np.array([(0, 1), (2, 5)], np.int32)
    counts = np.array([int((mask[:, 0] & mask[:, 1]).sum()), int((mask[:, 2] & mask[:, 5]).sum())],
                      np.int32)
    sel = np.tile(np.arange(64), (2, 1))
    for a, b in zip(native.build_pair_tensors(mask, xy, pairs, counts, 64, sel),
                    jnative.build_pair_tensors(mask, xy, pairs, counts, 64, sel)):
        np.testing.assert_array_equal(a, b)


def test_segment_sums_equal_scatter_adds():
    """The one-hot per-camera sums equal float64 scatter-adds within float32
    rounding (rows that straddle the chunk boundary included)."""
    from particlesfm_tpu_torch.ops import segment

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 7, (3000,), generator=g)
    val = torch.randn(3000, 2, 3, generator=g)
    old = segment._CHUNK_ROWS
    try:
        segment._CHUNK_ROWS = 1024
        out = segment.segment_sum(idx, val, 7)
        fidx, w = idx[:2400].reshape(120, 20), val[:2400, 0, 0].reshape(120, 20)
        rows = segment.row_segment_sum(fidx, w, 7)
    finally:
        segment._CHUNK_ROWS = old
    ref = torch.zeros(7, 2, 3, dtype=torch.float64).index_add_(0, idx, val.double())
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-4)
    ref = torch.zeros(120, 7, dtype=torch.float64).scatter_add_(1, fidx, w.double())
    torch.testing.assert_close(rows.double(), ref, rtol=1e-6, atol=1e-6)
