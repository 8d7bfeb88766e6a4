"""Port parity: closed-form 3x3 algebra, the 8-point solve, the Sampson and
transfer errors, minimal samples and H-RANSAC against the JAX package.

Tolerances: eigen/singular values within 1e-5 of the largest where the
eigenvalues are apart; the smallest eigenvector with |cos| >= 1 - 1e-4; F up
to sign within 1e-4; Sampson error within 1e-4 relative (of 1 px^2 below
1 px^2, where an inlier's error is a cancellation residual); identical sample
indices given the same draws; RANSAC inlier counts equal per pair, or within
1 where an error lies within 1e-4 (relative) of the threshold.

Where an eigenvalue repeats (E^T E of an essential matrix, a rank-2 matrix's
zero singular value) the trigonometric closed form loses about sqrt(eps) in
float32 in both packages (arccos near +-1): there the port is held to the
float64 eigenvalues with the reference's own error, plus 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesfm_tpu.geometry import epipolar as jepi
from particlesfm_tpu.geometry import homography as jhom
from particlesfm_tpu.geometry import linalg3 as jlin
from particlesfm_tpu.globalsfm.twoview import _sample_indices as jsample
from particlesfm_tpu_torch.geometry import epipolar, homography, linalg3
from particlesfm_tpu_torch.globalsfm.twoview import sample_indices
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _sym_batch(seed=0, n=64):
    """Random symmetric 3x3s plus the hard cases: E^T E (a repeated top
    eigenvalue), rank-1 and scaled identities."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, 3, 3))
    A = M @ np.swapaxes(M, -1, -2)
    E = []
    for _ in range(8):
        t = rng.normal(size=3)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Ei = np.cross(np.eye(3), t) @ q
        E.append(Ei.T @ Ei)
    v = rng.normal(size=(4, 3))
    extra = [np.outer(x, x) for x in v] + [2.5 * np.eye(3), -np.eye(3)]
    return np.concatenate([A, np.stack(E), np.stack(extra)]).astype(np.float32)


def _pairs(seed, P=6, M=64, noise=0.3, outliers=0.25, f=300.0, planar=False):
    """Projected correspondences of P random two-view pairs (pixels), of a
    3-d point cloud or of a plane."""
    rng = np.random.default_rng(seed)
    uv1 = np.zeros((P, M, 2), np.float32)
    uv2 = np.zeros_like(uv1)
    for p in range(P):
        X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1, 1, M),
                      rng.uniform(4, 10, M)], -1)
        if planar:
            X[:, 2] = 6.0 + 0.3 * X[:, 0] - 0.2 * X[:, 1]
        a = rng.normal(size=3) * 0.1
        R, _ = np.linalg.qr(np.eye(3) + np.cross(np.eye(3), a))
        X2 = X @ R.T + rng.normal(size=3) * 0.4
        uv1[p] = X[:, :2] / X[:, 2:] * f + [160, 120]
        uv2[p] = X2[:, :2] / X2[:, 2:] * f + [160, 120]
    uv1 += rng.normal(size=uv1.shape).astype(np.float32) * noise
    uv2 += rng.normal(size=uv2.shape).astype(np.float32) * noise
    n_out = int(outliers * M)
    uv2[:, :n_out] = rng.uniform(0, 320, (P, n_out, 2))
    mask = rng.random((P, M)) < 0.9
    mask[-1] = False                  # a pair with no valid entry
    mask[-2, 5:] = False              # fewer valid entries than a sample
    return uv1, uv2, mask


def _close_or_as_close_as_jax(x, x_j, x64, scale, sqrt=False):
    """x within 1e-5*scale of the reference where the float64 values are
    apart (> 1e-2*scale) and, for singular values (`sqrt`: square roots of
    eigenvalues), not near 0; elsewhere no farther from float64, relative to
    scale, than the reference's worst value there, plus 1e-5."""
    gaps = np.abs(x64[..., :, None] - x64[..., None, :])
    gaps[..., np.arange(3), np.arange(3)] = np.inf
    apart = gaps.min(-1) > 1e-2 * scale
    if sqrt:
        apart &= x64 > 1e-2 * scale
    assert np.all(np.abs(x - x_j)[apart] <= 1e-5 * np.broadcast_to(scale, x.shape)[apart])
    rel, rel_j = (np.abs(v - x64) / scale for v in (x, x_j))
    return bool(np.all(rel[~apart] <= rel_j[~apart].max(initial=0.0) + 1e-5))


def test_eigh3x3_matches_jax():
    A = _sym_batch()
    w_j, V_j = (np.asarray(x) for x in jlin.eigh3x3_desc(jnp.asarray(A)))
    w, V = (x.numpy() for x in linalg3.eigh3x3_desc(_t(A)))
    w64 = np.linalg.eigvalsh(A.astype(np.float64))[:, ::-1]
    scale = np.abs(w64).max(-1, keepdims=True)
    assert _close_or_as_close_as_jax(w, w_j, w64, scale)
    # A V = V diag(w): the port's vectors are eigenvectors of A
    resid = np.abs(A @ V - V * w[:, None, :]).max(axis=(-2, -1)) / scale[:, 0]
    resid_j = np.abs(A @ V_j - V_j * w_j[:, None, :]).max(axis=(-2, -1)) / scale[:, 0]
    assert resid.max() <= resid_j.max() + 1e-5


def test_svd3x3_matches_jax():
    rng = np.random.default_rng(1)
    E = rng.normal(size=(64, 3, 3)).astype(np.float32)
    E[:16, :, 2] = E[:16, :, 0] + E[:16, :, 1]       # rank 2
    U_j, s_j, Vt_j = (np.asarray(x) for x in jlin.svd3x3(jnp.asarray(E)))
    U, s, Vt = (x.numpy() for x in linalg3.svd3x3(_t(E)))
    s64 = np.linalg.svd(E.astype(np.float64), compute_uv=False)
    assert _close_or_as_close_as_jax(s, s_j, s64, s64[:, :1], sqrt=True)
    recon = (U * s[:, None, :]) @ Vt
    recon_j = (U_j * s_j[:, None, :]) @ Vt_j
    assert np.abs(recon - E).max() <= max(2 * np.abs(recon_j - E).max(),
                                          1e-5 * np.abs(E).max())


def test_smallest_eigvec_psd_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(32, 20, 9))
    X[:8, :, 0] = X[:8, :, 1:].sum(-1)                 # exactly singular
    A = (np.swapaxes(X, -1, -2) @ X).astype(np.float32)
    v_j = np.asarray(jlin.smallest_eigvec_psd(jnp.asarray(A)))
    v = linalg3.smallest_eigvec_psd(_t(A)).numpy()
    cos = np.abs((v * v_j).sum(-1))
    assert cos.min() >= 1 - 1e-4


def test_eight_point_matches_jax():
    uv1, uv2, _ = _pairs(3, P=8, M=40, outliers=0.0)
    F_j = np.asarray(jax.jit(jepi.eight_point)(jnp.asarray(uv1), jnp.asarray(uv2)))
    F = epipolar.eight_point(_t(uv1), _t(uv2)).numpy()
    sign = np.sign((F * F_j).sum(axis=(-2, -1)))[:, None, None]
    assert np.abs(F * sign - F_j).max() <= 1e-4
    # masked, as the RANSAC refit on an inlier set calls it
    m = (np.random.default_rng(0).random((8, 40)) < 0.6).astype(np.float32)
    F_j = np.asarray(jax.jit(jepi.eight_point)(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(m)))
    F = epipolar.eight_point(_t(uv1), _t(uv2), _t(m)).numpy()
    sign = np.sign((F * F_j).sum(axis=(-2, -1)))[:, None, None]
    assert np.abs(F * sign - F_j).max() <= 1e-4


def test_sampson_error_matches_jax():
    uv1, uv2, _ = _pairs(4, P=4, M=50)
    F = np.asarray(jax.jit(jepi.eight_point)(jnp.asarray(uv1[:, 10:]), jnp.asarray(uv2[:, 10:])))
    e_j = np.asarray(jax.jit(jepi.sampson_error)(jnp.asarray(F), jnp.asarray(uv1), jnp.asarray(uv2)))
    e = epipolar.sampson_error(_t(F), _t(uv1), _t(uv2)).numpy()
    assert np.all(np.abs(e - e_j) <= 1e-4 * np.maximum(e_j, 1.0))


@pytest.mark.parametrize("k", [4, 8])
def test_sample_indices_matches_jax(k):
    _, _, mask = _pairs(5, P=5, M=70)
    keys = jax.random.split(jax.random.PRNGKey(7), mask.shape[0])
    idx_j = np.asarray(jax.vmap(lambda kk, m: jsample(kk, m, 32, k))(keys, jnp.asarray(mask)))
    u = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (32, k)))(keys))
    idx = sample_indices(_t(u), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(idx, idx_j)
    valid = mask.any(-1)
    assert mask[np.arange(5)[:, None, None], idx][valid].all()


def test_dlt_and_transfer_error_match_jax():
    uv1, uv2, _ = _pairs(6, P=4, M=30, outliers=0.0)
    H_j = np.asarray(jax.jit(jhom.dlt_homography)(jnp.asarray(uv1), jnp.asarray(uv2)))
    H = homography.dlt_homography(_t(uv1), _t(uv2)).numpy()
    sign = np.sign((H * H_j).sum(axis=(-2, -1)))[:, None, None]
    assert np.abs(H * sign - H_j).max() <= 1e-4
    e_j = np.asarray(jax.jit(jhom.symmetric_transfer_error)(jnp.asarray(H_j), jnp.asarray(uv1),
                                                   jnp.asarray(uv2)))
    e = homography.symmetric_transfer_error(_t(H_j), _t(uv1), _t(uv2)).numpy()
    assert np.all(np.abs(e - e_j) <= 1e-4 * np.maximum(np.abs(e_j), 1e-2))


def _inlier_counts_agree(n, n_j, err_j, thres):
    """Equal counts, or within 1 where some error of the pair lies within
    1e-4 (relative) of the threshold."""
    near = (np.abs(err_j - thres) <= 1e-4 * thres).any(-1)
    d = np.abs(np.asarray(n, np.int64) - np.asarray(n_j, np.int64))
    return np.all((d == 0) | (near & (d <= 1)))


def test_homography_ransac_matches_jax():
    uv1, uv2, mask = _pairs(7, P=8, M=80, planar=True)
    thres = np.full(8, 4.0, np.float32)
    key = jax.random.PRNGKey(3)
    H_j, inl_j, n_j = (np.asarray(x) for x in jax.jit(jhom.homography_ransac)(
        key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), jnp.asarray(thres)))
    u = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (32, 4)))(
        jax.random.split(key, 8)))
    H, inl, n = homography.homography_ransac(
        _t(uv1), _t(uv2), torch.from_numpy(mask), _t(thres), u=_t(u))
    err_j = np.asarray(jax.jit(jhom.symmetric_transfer_error)(jnp.asarray(H_j), jnp.asarray(uv1),
                                                     jnp.asarray(uv2)))
    assert _inlier_counts_agree(n.numpy(), n_j, np.where(mask, err_j, np.inf), 4.0)
    assert n_j[:-2].min() > 0 and n_j[-1] == 0


# ---------------------------------------------------------------------------
# rotations, se3, cameras, triangulation, essential/pose, homography
# decomposition (mirrors tests/test_geometry.py). Tolerances: elementwise
# 1e-5 (absolute on unit-scale quantities, 1e-4 relative on pixels and
# depths); discrete choices (cheirality branch, Shepperd branch) identical.
# ---------------------------------------------------------------------------

from particlesfm_tpu.geometry import cameras as jcam
from particlesfm_tpu.geometry import rotations as jrot
from particlesfm_tpu.geometry import se3 as jse3
from particlesfm_tpu.geometry import triangulation as jtri
from particlesfm_tpu_torch.geometry import cameras, rotations as rot, se3, triangulation


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(port, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(port.numpy() if torch.is_tensor(port) else port,
                               np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("fn", ["quat_to_rotmat", "quat_to_angle_axis", "quat_normalize",
                                "quat_conjugate"])
def test_quaternion_maps_match_jax(fn):
    q = _quats(np.random.default_rng(0), 64)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0.0, 0, 0, -1], [1e-4, 1, 0, 0]]
    _close(getattr(rot, fn)(_t(q)), getattr(jrot, fn)(jnp.asarray(q)))


def test_rotmat_to_quat_matches_jax_on_every_branch():
    """Shepperd's four branches: trace-, x-, y- and z-dominant rotations."""
    rng = np.random.default_rng(1)
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[:3] = np.pi * np.eye(3, dtype=np.float32) * 0.999   # 180 deg about each axis
    R = np.asarray(jrot.angle_axis_to_rotmat(jnp.asarray(aa)))
    _close(rot.rotmat_to_quat(_t(R)), jrot.rotmat_to_quat(jnp.asarray(R)))
    _close(rot.rotmat_to_angle_axis(_t(R)), jrot.rotmat_to_angle_axis(jnp.asarray(R)), atol=1e-4)


def test_angle_axis_products_and_projection_match_jax():
    rng = np.random.default_rng(2)
    aa = (rng.normal(size=(32, 3)) * np.r_[np.ones(28), 1e-7 * np.ones(4)][:, None]).astype(np.float32)
    _close(rot.angle_axis_to_quat(_t(aa)), jrot.angle_axis_to_quat(jnp.asarray(aa)))
    _close(rot.angle_axis_to_rotmat(_t(aa)), jrot.angle_axis_to_rotmat(jnp.asarray(aa)))
    a, b = _quats(rng, 32), _quats(rng, 32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    _close(rot.quat_multiply(_t(a), _t(b)), jrot.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    _close(rot.quat_rotate(_t(a), _t(v)), jrot.quat_rotate(jnp.asarray(a), jnp.asarray(v)))
    _close(rot.skew(_t(v)), jrot.skew(jnp.asarray(v)))
    _close(rot.quat_geodesic_angle(_t(a), _t(b)), jrot.quat_geodesic_angle(jnp.asarray(a), jnp.asarray(b)), atol=1e-3)
    Ra = np.asarray(jrot.quat_to_rotmat(jnp.asarray(a)))
    Rb = np.asarray(jrot.quat_to_rotmat(jnp.asarray(b)))
    _close(rot.rotation_geodesic_angle(_t(Ra), _t(Rb)),
           jrot.rotation_geodesic_angle(jnp.asarray(Ra), jnp.asarray(Rb)), atol=1e-3)
    M = (Ra + 0.05 * rng.normal(size=Ra.shape)).astype(np.float32)
    _close(rot.project_to_rotmat(_t(M)), jrot.project_to_rotmat(jnp.asarray(M)), atol=1e-5)


def test_se3_matches_jax():
    rng = np.random.default_rng(3)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    t1, t2 = rng.normal(size=(2, 16, 3)).astype(np.float32)
    X = rng.normal(size=(16, 3)).astype(np.float32)
    J = [jnp.asarray(a) for a in (q1, t1, q2, t2)]
    P = [_t(a) for a in (q1, t1, q2, t2)]
    for fn in ("pose_compose", "relative_pose"):
        for a, b in zip(getattr(se3, fn)(*P), getattr(jse3, fn)(*J)):
            _close(a, b)
    for a, b in zip(se3.pose_inverse(P[0], P[1]), jse3.pose_inverse(J[0], J[1])):
        _close(a, b)
    _close(se3.pose_apply(P[0], P[1], _t(X)), jse3.pose_apply(J[0], J[1], jnp.asarray(X)))
    _close(se3.camera_center(P[0], P[1]), jse3.camera_center(J[0], J[1]))
    _close(se3.pose_from_center(P[0], P[1]), jse3.pose_from_center(J[0], J[1]))
    _close(se3.pose_to_matrix(P[0], P[1]), jse3.pose_to_matrix(J[0], J[1]))


@pytest.mark.parametrize("model", [0, 1, 2])
def test_cameras_match_jax(model):
    rng = np.random.default_rng(4)
    raw = {0: [500.0, 320.0, 240.0], 1: [500.0, 480.0, 320.0, 240.0],
           2: [500.0, 320.0, 240.0, -0.05]}[model]
    p = cameras.pack_params(model, raw)
    jp = jcam.pack_params(model, raw)
    _close(p, jp)
    assert cameras.unpack_params(model, p) == pytest.approx(jcam.unpack_params(model, jp))
    x = rng.normal(size=(40, 3)).astype(np.float32) + np.float32([0, 0, 4])
    _close(cameras.project(p, _t(x)), jcam.project(jp, jnp.asarray(x)), rtol=1e-5, atol=1e-3)
    uv = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
    _close(cameras.img_to_cam(p, _t(uv)), jcam.img_to_cam(jp, jnp.asarray(uv)))
    _close(cameras.make_default_params(436, 1024), jcam.make_default_params(436, 1024))


def _two_view(rng, n=60, noise=0.0):
    X = rng.uniform([-1, -1, 4], [1, 1, 6], (n, 3))
    aa = np.float32([0.05, -0.1, 0.02])
    q2 = np.asarray(jrot.angle_axis_to_quat(jnp.asarray(aa)))
    t2 = np.float32([0.5, 0.1, 0.05])
    Xc2 = np.asarray(jse3.pose_apply(jnp.asarray(q2), jnp.asarray(t2), jnp.asarray(X, jnp.float32)))
    x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    x2 = (Xc2[:, :2] / Xc2[:, 2:]).astype(np.float32)
    x1 += rng.normal(size=x1.shape).astype(np.float32) * noise
    x2 += rng.normal(size=x2.shape).astype(np.float32) * noise
    return q2, t2, X.astype(np.float32), x1, x2


def test_essential_and_pose_from_essential_match_jax():
    rng = np.random.default_rng(5)
    q2, t2, X, x1, x2 = _two_view(rng, noise=1e-3)
    _close(epipolar.essential_from_pose(_t(q2), _t(t2)),
           jepi.essential_from_pose(jnp.asarray(q2), jnp.asarray(t2)))
    p1 = np.float32([500, 510, 320, 240, 0])
    p2 = np.float32([480, 480, 300, 250, 0])
    E = np.asarray(jepi.essential_from_pose(jnp.asarray(q2), jnp.asarray(t2)))
    _close(epipolar.fundamental_from_essential(_t(E), _t(p1), _t(p2)),
           jepi.fundamental_from_essential(jnp.asarray(E), jnp.asarray(p1), jnp.asarray(p2)))
    En = np.asarray(jepi.essential_closest(jepi.eight_point(jnp.asarray(x1), jnp.asarray(x2))))
    _close(epipolar.essential_closest(_t(En)), jepi.essential_closest(jnp.asarray(En)), atol=1e-4)
    Rs, ts = epipolar.decompose_essential(_t(En))
    jRs, jts = jepi.decompose_essential(jnp.asarray(En))
    _close(Rs, jRs, atol=1e-4)
    _close(ts, jts, atol=1e-4)
    # depths at the true pose (a wrong candidate's near-parallel rays make
    # its depths a cancellation residual)
    R2 = np.asarray(jrot.quat_to_rotmat(jnp.asarray(q2)))
    tu = t2 / np.linalg.norm(t2)
    d = epipolar.triangulate_midpoint_depths(_t(R2), _t(tu), _t(x1), _t(x2))
    jd = jepi.triangulate_midpoint_depths(jnp.asarray(R2), jnp.asarray(tu), jnp.asarray(x1),
                                          jnp.asarray(x2))
    for a, b in zip(d, jd):
        _close(a, b, rtol=1e-4, atol=1e-4)
    q, t, v = epipolar.pose_from_essential(_t(En), _t(x1), _t(x2))
    jq, jt, jv = jepi.pose_from_essential(jnp.asarray(En), jnp.asarray(x1), jnp.asarray(x2))
    _close(q, jq, atol=1e-4)
    _close(t, jt, atol=1e-4)
    assert float(v) == float(jv) == len(x1)


def test_triangulation_matches_jax():
    rng = np.random.default_rng(6)
    q2, t2, X, x1, x2 = _two_view(rng, noise=1e-3)
    n = len(X)
    q1 = np.tile(np.float32([1, 0, 0, 0]), (n, 1))
    t1 = np.zeros((n, 3), np.float32)
    q2n, t2n = np.tile(q2, (n, 1)), np.tile(t2, (n, 1))
    Xp = triangulation.triangulate_two_view(_t(q1), _t(t1), _t(q2n), _t(t2n), _t(x1), _t(x2))
    Xj = jtri.triangulate_two_view(*(jnp.asarray(a) for a in (q1, t1, q2n, t2n, x1, x2)))
    _close(Xp, Xj, rtol=1e-4, atol=1e-4)
    centers = rng.normal(size=(n, 5, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n, 5)) > 0.3).astype(np.float32)
    _close(triangulation.triangulation_angles(_t(centers), _t(X), _t(mask)),
           jtri.triangulation_angles(jnp.asarray(centers), jnp.asarray(X), jnp.asarray(mask)),
           atol=1e-3)
    p = np.float32([500, 500, 320, 240, 0])
    uv = rng.uniform(0, 600, size=(n, 2)).astype(np.float32)
    _close(triangulation.reprojection_errors(_t(q2), _t(t2), _t(p), _t(X), _t(uv)),
           jtri.reprojection_errors(jnp.asarray(q2), jnp.asarray(t2), jnp.asarray(p),
                                    jnp.asarray(X), jnp.asarray(uv)), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("scene", ["planar", "rotation"])
def test_decompose_homography_matches_jax(scene):
    """Faugeras decomposition of a plane seen from a moving camera (the same
    candidate wins; R, t, n and t_mag within 1e-4), and of a pure rotation's
    DLT homography (as tests/test_twoview_classify.py: t_mag < 5e-3 in both,
    R within 2e-3 of the truth and of the reference; t and n are undefined)."""
    rng = np.random.default_rng(7)
    aa = np.float32([0.02, -0.08, 0.01])
    R = np.asarray(jrot.angle_axis_to_rotmat(jnp.asarray(aa)))
    t = np.float32([0.4, 0.05, 0.1]) if scene == "planar" else np.zeros(3, np.float32)
    n = np.float32([0.1, -0.2, 1.0])
    n /= np.linalg.norm(n)
    x1 = rng.uniform(-0.4, 0.4, size=(3, 80, 2)).astype(np.float32)
    if scene == "planar":
        H = np.tile((R + np.outer(t, n) / 5.0).astype(np.float32), (3, 1, 1))
    else:
        H = np.tile(R.astype(np.float32), (3, 1, 1))
    p = np.concatenate([x1, np.ones_like(x1[..., :1])], -1) @ np.swapaxes(H, -1, -2)
    x2 = (p[..., :2] / p[..., 2:]).astype(np.float32)
    if scene == "rotation":
        H = np.asarray(jhom.dlt_homography(jnp.asarray(x1), jnp.asarray(x2)))
    out = homography.decompose_homography(_t(H), _t(x1), _t(x2))
    ref = jhom.decompose_homography(jnp.asarray(H), jnp.asarray(x1), jnp.asarray(x2))
    if scene == "planar":
        for a, b in zip(out, ref):
            _close(a, b, atol=1e-4)
    else:
        assert float(out[3].max()) < 5e-3 and float(np.asarray(ref[3]).max()) < 5e-3
        _close(out[0], np.broadcast_to(R, (3, 3, 3)), atol=2e-3)
        _close(out[0], ref[0], atol=2e-3)
