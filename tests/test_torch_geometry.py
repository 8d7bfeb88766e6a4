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
