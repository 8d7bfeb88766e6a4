"""Procedural 3D training scenes for the motion-segmentation network (port
of particlesfm_tpu/motionseg/synth3d.py; numpy only, the same generator gives
the same bytes).

Random camera paths over random static structure give trajectories with true
parallax, rigid objects on independent motions give dynamic trajectories,
and a coarse rendered depth map feeds the network's backprojection features.
Labels are exact by construction.
"""
from __future__ import annotations

import numpy as np


def _look_at(center, target, up=(0.0, 1.0, 0.0)):
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross((1.0, 0.0, 0.0), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)          # world->cam rows


def generate_scene(rng, L=10, num_static=768, num_dyn_max=320,
                   height=240, width=424, depth_hw=(30, 53)):
    """One training sample: (traj [N,L,2] in [0,1], depth [L,h,w], valid [N,L],
    label [N], traj_valid [N]) with N = num_static + num_dyn_max."""
    f = rng.uniform(0.7, 1.6) * width
    cx, cy = width / 2.0, height / 2.0

    # camera path: random smooth arc with jitter + slow rotation drift
    speed = rng.uniform(0.02, 0.35)
    direction = rng.normal(size=3)
    direction[2] *= 0.4
    direction /= np.linalg.norm(direction)
    centers = np.cumsum(
        np.tile(direction * speed, (L, 1))
        + rng.normal(0, 0.02 * speed + 1e-4, (L, 3)),
        axis=0,
    )
    # look target: usually ahead, sometimes steeply down/up (aerial-style
    # sequences like Sintel's or the ray-cast test scenes)
    tdir = rng.normal(size=3)
    tdir[2] = abs(tdir[2]) + 0.3
    if rng.random() < 0.3:
        tdir = np.array([rng.normal(0, 0.3), rng.choice([-1.0, 1.0]) * 2.0, 1.0])
    tdir /= np.linalg.norm(tdir)
    look_target = tdir * rng.uniform(4.0, 10.0)
    Rs, ts = [], []
    for c in centers:
        R = _look_at(c, look_target + rng.normal(0, 0.01, 3))
        Rs.append(R)
        ts.append(-R @ c)
    Rs, ts = np.stack(Rs), np.stack(ts)

    def project(X):
        """[.., 3] world -> (uv [.., 2], z [..]) per frame index arrays."""
        xc = np.einsum("lij,nj->lni", Rs, X) + ts[:, None]
        z = xc[..., 2]
        zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
        u = f * xc[..., 0] / zs + cx
        v = f * xc[..., 1] / zs + cy
        return np.stack([u, v], -1), z

    # static structure: points in a frustum-shaped slab with varied depth
    depth_near, depth_far = rng.uniform(2.5, 4.0), rng.uniform(7.0, 16.0)
    zs = rng.uniform(depth_near, depth_far, num_static)
    xs = rng.uniform(-0.8, 0.8, num_static) * zs * (width / (2 * f))* 2.2
    ys = rng.uniform(-0.8, 0.8, num_static) * zs * (height / (2 * f)) * 2.2
    X_static = np.stack([xs, ys, zs], 1)
    uv_s, z_s = project(X_static)                  # [L, Ns, 2], [L, Ns]

    # dynamic objects: small rigid clusters with independent motion
    num_obj = rng.integers(0, 4)
    dyn_pts, dyn_vel = [], []
    for _ in range(num_obj):
        n = rng.integers(30, 120)
        c0 = np.array([
            rng.uniform(-1.5, 1.5), rng.uniform(-1.0, 1.0),
            rng.uniform(depth_near, depth_far * 0.8),
        ])
        pts = c0 + rng.normal(0, rng.uniform(0.05, 0.35), (n, 3))
        vel = rng.normal(0, 1, 3)
        vel /= np.linalg.norm(vel)
        vel *= rng.uniform(0.05, 0.5)              # world units / frame
        dyn_pts.append(pts)
        dyn_vel.append(vel)
    Nd = sum(len(p) for p in dyn_pts)
    N = num_static + num_dyn_max

    traj = np.zeros((N, L, 2), np.float32)
    valid = np.zeros((N, L), bool)
    label = np.zeros(N, np.float32)

    in_img_s = (
        (uv_s[..., 0] >= 0) & (uv_s[..., 0] < width)
        & (uv_s[..., 1] >= 0) & (uv_s[..., 1] < height) & (z_s > 0.2)
    )
    traj[:num_static] = uv_s.transpose(1, 0, 2)
    valid[:num_static] = in_img_s.T

    row = num_static
    for pts, vel in zip(dyn_pts, dyn_vel):
        take = min(len(pts), N - row)
        if take <= 0:
            break
        for li in range(L):
            Xl = pts[:take] + vel * li
            uv_d, z_d = project(Xl)
            ok = (
                (uv_d[li, :, 0] >= 0) & (uv_d[li, :, 0] < width)
                & (uv_d[li, :, 1] >= 0) & (uv_d[li, :, 1] < height)
                & (z_d[li] > 0.2)
            )
            traj[row : row + take, li] = uv_d[li]
            valid[row : row + take, li] = ok
        label[row : row + take] = 1.0
        row += take

    # image-space impostors: objects at scene depth moving with constant PIXEL
    # velocity (decoupled from parallax) — the classic "painted-on" dynamic
    # pattern produced by flow-space object composites
    if rng.random() < 0.5 and row < N:
        n_imp = min(int(rng.integers(20, 80)), N - row)
        base = np.stack([
            rng.uniform(0.1 * width, 0.9 * width, n_imp),
            rng.uniform(0.1 * height, 0.9 * height, n_imp),
        ], 1)
        # velocity = mean static pixel motion + a clearly-separated offset;
        # without the separation the label is genuinely ambiguous (uniform
        # parallax fields also move at near-constant pixel velocity) and the
        # noisy supervision stalls training
        sv = np.where(in_img_s[:, :, None], uv_s, np.nan)
        static_vel = np.nanmedian(np.diff(sv, axis=0), axis=(0, 1))
        static_vel = np.where(np.isfinite(static_vel), static_vel, 0.0)
        off = rng.normal(0, 1, 2)
        off = off / max(np.linalg.norm(off), 1e-6) * rng.uniform(3.0, 8.0)
        vel = static_vel + off
        for li in range(L):
            uv = base + vel * li
            ok = ((uv[:, 0] >= 0) & (uv[:, 0] < width)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < height))
            traj[row : row + n_imp, li] = uv
            valid[row : row + n_imp, li] = ok
        label[row : row + n_imp] = 1.0
        row += n_imp

    # simulated tracker attrition: random observation dropout + early death
    drop = rng.random((N, L)) < rng.uniform(0.0, 0.15)
    valid &= ~drop
    death = rng.integers(3, L + 1, N)
    valid &= np.arange(L)[None, :] < death[:, None]
    traj_valid = valid.sum(1) >= 3
    valid &= traj_valid[:, None]

    # coarse rendered depth: splat static points' depth onto a grid, fill holes
    h, w = depth_hw
    depth = np.zeros((L, h, w), np.float32)
    for li in range(L):
        grid = np.full((h, w), np.nan, np.float32)
        obs = in_img_s[li]
        gu = np.clip((uv_s[li, obs, 0] / width * w).astype(int), 0, w - 1)
        gv = np.clip((uv_s[li, obs, 1] / height * h).astype(int), 0, h - 1)
        grid[gv, gu] = z_s[li, obs]
        med = np.nanmedian(grid)
        if not np.isfinite(med):
            med = (depth_near + depth_far) / 2
        grid = np.where(np.isfinite(grid), grid, med)
        inv = 1.0 / np.maximum(grid, 1e-3)
        inv = (inv - inv.min()) / max(inv.max() - inv.min(), 1e-6)
        depth[li] = inv
    if rng.random() < 0.3:
        # degraded-depth robustness: constant relative depth (pipelines without
        # a depth net fall back to a flat map)
        depth[:] = rng.uniform(0.3, 0.7)
    # normalize trajectories to [0, 1]
    traj[..., 0] /= width
    traj[..., 1] /= height
    traj = np.where(valid[..., None], traj, 0.0).astype(np.float32)
    return traj, depth, valid, label, traj_valid


def synth3d_batch(rng, B=4, **kw):
    out = [generate_scene(rng, **kw) for _ in range(B)]
    return {
        "traj": np.stack([o[0] for o in out]),
        "depth": np.stack([o[1] for o in out]),
        "valid": np.stack([o[2] for o in out]),
        "label": np.stack([o[3] for o in out]),
        "traj_valid": np.stack([o[4] for o in out]),
    }
