"""Global bundle adjustment: Levenberg-Marquardt with a Schur-complement
solve (port of particlesfm_tpu/globalsfm/ba.py).

  - residuals/Jacobians: one batched pass over the padded observation tensor
    [N, K] (N tracks x K observation slots);
  - robustification: soft-L1 as IRLS weights (rho'(z) = 1/sqrt(1+z));
  - point elimination: per-track 3x3 Schur blocks, inverted in closed form;
  - reduced camera system (6V + 1 with the bordered shared focal): assembled
    explicitly and solved by one dense LU solve (solver="dense", what the
    mappers use), or solved matrix-free by block-Jacobi-preconditioned CG
    (solver="pcg");
  - gauge and constant rotations: per-parameter masks.

Every per-camera sum is a product with the observations' one-hot camera
matrix (the reference's V <= 192 path; the reference's PCG path scatters,
the port keeps the products there too), so the reduced system sums in a
fixed order on every device; no sum goes through a scatter-add, whose CUDA
order is not deterministic. The LM loop runs on the host and reads the two
costs back once per iteration for the accept and stop tests; the CG
iterations read nothing back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import rotations as rot
from ..geometry import se3
from ..ops.segment import segment_summer
from .tracks3d import TrackObs

_SCHUR_CHUNK = 8192     # tracks per chunk of the reduced-system assembly


def _mm(a, b):
    """a @ b for batches of tiny matrices, as a broadcast product and a sum:
    cuBLAS's batched GEMM spends far longer per 2x6 or 3x3 block."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(a, v):
    """a @ v for batches of tiny matrices and vectors."""
    return (a * v[..., None, :]).sum(-1)


class BAState(NamedTuple):
    q: torch.Tensor        # [V, 4]
    t: torch.Tensor        # [V, 3]
    X: torch.Tensor        # [N, 3]
    params: torch.Tensor   # [5] shared intrinsics (focal possibly refined)
    cost: torch.Tensor     # scalar robust cost
    lam: torch.Tensor      # final LM damping
    iters: int             # LM iterations actually run


def _project(q, t, params, X, obs: TrackObs):
    qo = q[obs.frame_idx]
    to = t[obs.frame_idx]
    x_cam = se3.pose_apply(qo, to, X[:, None, :])
    z = x_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return x_cam, to, z_safe


def _residuals_jacobians(q, t, params, X, obs: TrackObs, w_obs):
    """Weighted residuals r [N,K,2], J_cam [N,K,2,6], J_pt [N,K,2,3], J_f [N,K,2].

    Pose tangent d = (omega, nu): R <- Exp(omega) R, t <- t + nu; the
    shared-focal column ties fx = fy = f."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x_cam, to, z_safe = _project(q, t, params, X, obs)
    x, y = x_cam[..., 0], x_cam[..., 1]
    r = torch.stack([fx * x / z_safe + cx, fy * y / z_safe + cy], dim=-1) - obs.uv
    iz = 1.0 / z_safe
    zero = torch.zeros_like(x)
    A = torch.stack([torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
                     torch.stack([zero, fy * iz, -fy * y * iz * iz], -1)], dim=-2)
    J_rot = _mm(A, -rot.skew(x_cam - to))
    J_cam = torch.cat([J_rot, A], dim=-1)
    J_pt = _mm(A, rot.quat_to_rotmat(q)[obs.frame_idx])
    J_f = torch.stack([x / z_safe, y / z_safe], dim=-1)
    sw = torch.sqrt(w_obs)[..., None]
    return r * sw, J_cam * sw[..., None], J_pt * sw[..., None], J_f * sw


def _robust_weights(q, t, params, X, obs: TrackObs, loss_scale, use_soft_l1: bool, pm=None):
    """IRLS weights + robust cost. `pm` ([N, 1] point mask) gates observations
    of tracks excluded from the solve out of both, so the LM accept test only
    sees residuals the step optimizes."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x_cam, _, z_safe = _project(q, t, params, X, obs)
    u = fx * x_cam[..., 0] / z_safe + cx
    v = fy * x_cam[..., 1] / z_safe + cy
    r2 = (u - obs.uv[..., 0]) ** 2 + (v - obs.uv[..., 1]) ** 2
    # non-finite residuals of junk points get a huge finite value (soft-L1
    # then gives them ~zero weight) so the masked cost stays finite
    r2 = torch.nan_to_num(r2, nan=1e20, posinf=1e20)
    m = obs.mask.to(r2.dtype)
    if pm is not None:
        m = m * pm
    s2 = loss_scale * loss_scale
    if use_soft_l1:
        w = m / torch.sqrt(1.0 + r2 / s2)
        rho = 2.0 * s2 * (torch.sqrt(1.0 + r2 / s2) - 1.0)
    else:
        w = m
        rho = r2
    return w, (rho * m).sum()


def _inv3(M):
    """Batched closed-form 3x3 inverse (adjugate), [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], dim=-2)
    return adj / det[..., None, None]


def default_free_masks(num_views: int, refine_rotation: bool = True, anchor=(0, 1),
                       device="cpu"):
    """[V, 6] free-parameter mask: pin view anchor[0]'s pose and one tvec
    component (anchor[2], default x) of view anchor[1]; optionally freeze
    every rotation (the translation-only first phase)."""
    a0, a1 = int(anchor[0]), int(anchor[1])
    comp = int(anchor[2]) if len(anchor) > 2 else 0
    free = torch.ones((num_views, 6), dtype=torch.float32, device=device)
    free[a0] = 0.0
    free[a1, 3 + comp] = 0.0
    if not refine_rotation:
        free[:, :3] = 0.0
    return free


def bundle_adjust(
    q: torch.Tensor,            # [V, 4]
    t: torch.Tensor,            # [V, 3]
    params: torch.Tensor,       # [5] shared intrinsics
    X: torch.Tensor,            # [N, 3]
    obs: TrackObs,              # mask already gated
    free_mask: torch.Tensor,    # [V, 6] 1.0 = free parameter
    point_mask: torch.Tensor,   # [N] 1.0 = optimize this track
    max_iterations: int = 30,
    pcg_iters: int = 50,
    loss_scale: float = 1.0,
    use_soft_l1: bool = True,
    init_lam: float = 1e-4,
    refine_focal: bool = False,
    solver: str = "dense",
    function_tolerance: float = 1e-6,
    focal_bounds: Optional[torch.Tensor] = None,   # [2] trust region for f
) -> BAState:
    """LM bundle adjustment; optionally solves the shared focal jointly (a
    bordered scalar column of the reduced system).

    solver="dense" assembles the reduced camera system and solves it
    exactly; solver="pcg" runs `pcg_iters` conjugate-gradient iterations on
    it, matrix-free, preconditioned by the inverse camera diagonal blocks
    (and 1/S_ff for the focal row).

    Stops after 2 consecutive accepted steps whose relative improvement is
    below `function_tolerance` (Ceres' function_tolerance), 24 consecutive
    rejections, or `max_iterations` steps. With `focal_bounds` the focal
    step is clamped into the bounds before the points are back-substituted.
    """
    dev, dt = X.device, X.dtype
    V = q.shape[0]
    N, K = obs.frame_idx.shape
    fidx = obs.frame_idx
    pm = point_mask[:, None].to(dt)
    fm = free_mask
    f_free = 1.0 if refine_focal else 0.0
    fflat = fidx.reshape(N * K)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    free_vec = torch.cat([fm.reshape(6 * V), torch.full((1,), f_free, dtype=dt, device=dev)])

    cam_sum = segment_summer(fflat, V, dt)     # one-hot camera matrix, built once

    def per_cam(x):
        """Sum of per-observation values x [N, K, ...] into their cameras."""
        return cam_sum(x.reshape((N * K,) + x.shape[2:]))

    def reduced_system(Wcp, Hpp_inv):
        """-sum_n W_n Hpp_n^-1 W_n^T over tracks: the off-diagonal Schur part,
        as [6V, 6V] in (camera, parameter) order."""
        S = torch.zeros(6 * V, 6 * V, dtype=dt, device=dev)
        for s in range(0, N, _SCHUR_CHUNK):
            oh = torch.nn.functional.one_hot(fidx[s:s + _SCHUR_CHUNK], V).to(dt)   # [C, K, V]
            G = oh.transpose(1, 2) @ Wcp[s:s + _SCHUR_CHUNK].reshape(-1, K, 18)
            G = G.reshape(-1, V, 6, 3)                            # [C, V, 6, 3]
            GH = _mm(G, Hpp_inv[s:s + _SCHUR_CHUNK, None])
            C = G.shape[0]
            Gm = G.permute(1, 2, 0, 3).reshape(6 * V, 3 * C)
            GHm = GH.permute(1, 2, 0, 3).reshape(6 * V, 3 * C)
            S = S - GHm @ Gm.T
        return S

    def pcg(dHcc, Wcp, Hpp_inv, S_cf, S_ff, rhs_c, rhs_f):
        """`pcg_iters` block-Jacobi-preconditioned CG iterations on the
        joint (camera, focal) reduced system, from zero."""
        def schur_matvec(xc, xf):
            xc = xc * fm
            xf = xf * f_free
            y = _mv(dHcc, xc)
            u = _mv(Wcp.transpose(-1, -2), xc[fidx]).sum(1)       # [N, 3]
            y = y - per_cam(_mv(Wcp, _mv(Hpp_inv, u)[:, None]))
            y = y + S_cf * xf
            yf = (S_cf * xc).sum() + S_ff * xf
            return y * fm, yf * f_free

        Minv = torch.linalg.inv(dHcc + 1e-8 * eye6)
        Sff_inv = 1.0 / torch.clamp(S_ff, min=1e-12)

        def precond(xc, xf):
            return _mv(Minv, xc) * fm, xf * Sff_inv * f_free

        def safe(d):
            return torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d)

        xc = torch.zeros(V, 6, dtype=dt, device=dev)
        xf = torch.zeros((), dtype=dt, device=dev)
        Ac, Af = schur_matvec(xc, xf)
        rc, rf = rhs_c - Ac, rhs_f - Af
        zc, zf = precond(rc, rf)
        pc, pf = zc, zf
        rz = (rc * zc).sum() + rf * zf
        for _ in range(pcg_iters):
            Apc, Apf = schur_matvec(pc, pf)
            alpha = rz / safe((pc * Apc).sum() + pf * Apf)
            xc = xc + alpha * pc
            xf = xf + alpha * pf
            rc = rc - alpha * Apc
            rf = rf - alpha * Apf
            zc, zf = precond(rc, rf)
            rz_new = (rc * zc).sum() + rf * zf
            beta = rz_new / safe(rz)
            pc = zc + beta * pc
            pf = zf + beta * pf
            rz = rz_new
        return xc, xf * f_free

    def lm_step(q, t, X, params, lam):
        w_obs, cost0 = _robust_weights(q, t, params, X, obs, loss_scale, use_soft_l1, pm)
        r, Jc, Jp, Jf = _residuals_jacobians(q, t, params, X, obs, w_obs)
        Jct = Jc.transpose(-1, -2)                                 # [N, K, 6, 2]
        Hcc = per_cam(_mm(Jct, Jc))
        gc = per_cam(_mv(Jct, r))
        Hcf = per_cam(_mv(Jct, Jf))
        Jpt = Jp.transpose(-1, -2)
        Hpp = _mm(Jpt, Jp).sum(1)
        gp = _mv(Jpt, r).sum(1)
        Wcp = _mm(Jct, Jp)                                         # [N, K, 6, 3]
        Hff = (Jf * Jf).sum()
        gf = (Jf * r).sum()
        Wfp = (Jf[..., :, None] * Jp).sum((1, 2))                  # [N, 3]

        dHcc = Hcc + lam * eye6
        dHpp = Hpp + lam * eye3
        dHff = Hff + lam
        Hpp_inv = _inv3(dHpp)

        HpiWfp = _mv(Hpp_inv, Wfp)
        S_cf = Hcf - per_cam(_mv(Wcp, HpiWfp[:, None]))
        S_cf = S_cf * fm * f_free
        S_ff = (dHff - (Wfp * HpiWfp).sum()) * f_free + (1.0 - f_free)
        hp = _mv(Hpp_inv, gp)
        rhs_c = (-gc + per_cam(_mv(Wcp, hp[:, None]))) * fm
        rhs_f = (-gf + (Wfp * hp).sum()) * f_free

        if solver == "dense":
            S = reduced_system(Wcp, Hpp_inv)
            S = S + torch.block_diag(*dHcc)
            Sfull = torch.cat([torch.cat([S, S_cf.reshape(6 * V, 1)], dim=1),
                               torch.cat([S_cf.reshape(1, 6 * V), S_ff.reshape(1, 1)], dim=1)],
                              dim=0)
            rhs = torch.cat([rhs_c.reshape(6 * V), rhs_f.reshape(1)])
            # gauge/constant parameters: identity rows/cols, zero rhs
            Sfull = Sfull * free_vec[:, None] * free_vec[None, :] + torch.diag(1.0 - free_vec)
            rhs = rhs * free_vec
            sol = torch.linalg.solve_ex(Sfull, rhs[:, None])[0][:, 0]
            dc = sol[:6 * V].reshape(V, 6)
            df = sol[6 * V] * f_free
        else:
            dc, df = pcg(dHcc, Wcp, Hpp_inv, S_cf, S_ff, rhs_c, rhs_f)
        if refine_focal and focal_bounds is not None:
            # focal trust region: clamp the step before back-substitution
            df = torch.clamp(params[0] + df, focal_bounds[0], focal_bounds[1]) - params[0]

        # back-substitute points: dp = Hpp^-1 (-gp - Wcp^T dc - Wfp df)
        wtdc = _mv(Wcp.transpose(-1, -2), dc[fidx]).sum(1)
        dp = _mv(Hpp_inv, -gp - wtdc - Wfp * df) * pm

        dq = rot.angle_axis_to_quat(dc[:, :3])
        q_new = rot.quat_normalize(rot.quat_multiply(dq, q))
        t_new = t + dc[:, 3:]
        X_new = X + dp
        params_new = params + torch.stack([df, df, *([torch.zeros_like(df)] * 3)])
        _, cost1 = _robust_weights(q_new, t_new, params_new, X_new, obs, loss_scale,
                                   use_soft_l1, pm)
        accept = cost1 < cost0
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        params = torch.where(accept, params_new, params)
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-10),
                          torch.clamp(lam * 3.0, max=1e8))
        impr = (cost0 - cost1) / torch.clamp(cost0, min=1e-30)
        return q, t, X, params, lam, accept, impr < function_tolerance

    lam = torch.tensor(init_lam, dtype=dt, device=dev)
    it = stall = rej = 0
    while it < max_iterations and stall < 2 and rej < 24:
        q, t, X, params, lam, accept, small = lm_step(q, t, X, params, lam)
        accept, small = (bool(v) for v in torch.stack([accept, small]).cpu())
        stall = (stall + 1 if small else 0) if accept else stall
        rej = 0 if accept else rej + 1
        it += 1
    _, final_cost = _robust_weights(q, t, params, X, obs, loss_scale, use_soft_l1, pm)
    return BAState(q=q, t=t, X=X, params=params, cost=final_cost, lam=lam, iters=it)


def refine_shared_focal(q, t, params, X, obs: TrackObs, point_mask):
    """Closed-form Gauss-Newton update of the shared focal length (fx = fy = f)
    with poses and points fixed."""
    cx, cy = params[2], params[3]
    x_cam, _, z_safe = _project(q, t, params, X, obs)
    z = x_cam[..., 2]
    valid = obs.mask & (z > 1e-6) & point_mask[:, None].bool()
    a = x_cam[..., :2] / z_safe[..., None]
    b = obs.uv - torch.stack([cx.expand(z.shape), cy.expand(z.shape)], -1)
    w = valid.to(x_cam.dtype)[..., None]
    f = (w * a * b).sum() / torch.clamp((w * a * a).sum(), min=1e-12)
    out = params.clone()
    out[0] = f
    out[1] = f
    return out
