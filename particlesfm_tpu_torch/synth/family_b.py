"""Held-out scene family B: box-world corridor scenes (cross-domain eval only).

The reference proves generalization by training on FlyingThings3D and
evaluating on Sintel/ScanNet — disjoint domains
(upstream motion_seg/train_seq.py -> evaluation_evo/eval_sintel.py).
Under zero egress the stand-in is a SECOND procedural family that shares *no*
generative component with the training family (synth/render.py), used only for
evaluation:

  | axis            | family A (training)                | family B (held out)              |
  |-----------------|------------------------------------|----------------------------------|
  | geometry        | Fourier height-field + spheres     | flat floor + walls + cuboids     |
  | depth structure | smooth, mostly-continuous          | piecewise planar, sharp edges    |
  | texture         | smooth 3-D sinusoid bands          | quantized cell noise + checkers  |
  | shading         | none (albedo only)                 | Lambertian directional + ambient |
  | camera          | down-looking arc over terrain      | eye-height forward walk + yaw    |
  | movers          | translating spheres                | translating boxes                |
  | photometry      | clean                              | exposure drift + sensor noise    |

Ground truth (flow/depth/dynamic/poses) is exact by construction, computed the
same way as family A (material points re-projected), so the eval harness and
file contracts are shared. Shading is view-independent and the nuisances are
applied after ground-truth extraction, so GT flow remains photometrically
consistent up to exactly the nuisances being tested.

A copy of particlesfm_tpu/synth/family_b.py: the same seed renders the same
frames and ground truth bit for bit in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# quantized procedural textures (piecewise-constant — nothing like family A's
# smooth sinusoid bands)
# ---------------------------------------------------------------------------


def _hash3(ix, iy, iz, seed):
    """Deterministic integer hash -> uint32 (vectorized)."""
    h = (ix.astype(np.int64) * 73856093
         ^ iy.astype(np.int64) * 19349663
         ^ iz.astype(np.int64) * 83492791
         ^ np.int64(seed) * 2654435761) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 1274126177) & 0xFFFFFFFF
    h ^= h >> 16
    return h


@dataclass
class CellTexture:
    """Quantized cell-noise texture: color = palette[hash(cell(p))], modulated
    by a world-axis checkerboard at a second scale. Hard edges, flat patches."""

    cell: float
    check: float
    palette: np.ndarray   # [P, 3]
    seed: int
    check_gain: float

    @staticmethod
    def random(rng, cell_lo, cell_hi):
        ncol = int(rng.integers(4, 9))
        # medium-contrast palette; trackable but quantized
        palette = rng.uniform(0.15, 0.95, (ncol, 3))
        return CellTexture(
            cell=float(rng.uniform(cell_lo, cell_hi)),
            check=float(rng.uniform(cell_lo, cell_hi) * 2.7),
            palette=palette.astype(np.float32),
            seed=int(rng.integers(1 << 30)),
            check_gain=float(rng.uniform(0.10, 0.25)),
        )

    def __call__(self, pts):
        q = np.floor(pts / self.cell).astype(np.int64)
        h = _hash3(q[..., 0], q[..., 1], q[..., 2], self.seed)
        col = self.palette[(h % len(self.palette)).astype(np.int64)]
        c = np.floor(pts / self.check).astype(np.int64).sum(axis=-1) % 2
        return np.clip(
            col * (1.0 - self.check_gain + 2 * self.check_gain * c[..., None]),
            0.0, 1.0,
        ).astype(np.float32)


# ---------------------------------------------------------------------------
# geometry: axis-aligned boxes + floor + corridor walls
# ---------------------------------------------------------------------------


@dataclass
class Box:
    lo0: np.ndarray       # [3] min corner at t=0
    hi0: np.ndarray       # [3] max corner at t=0
    vel: np.ndarray       # [3] per-frame velocity (movers translate)

    def lo(self, t):
        return self.lo0 + t * self.vel

    def hi(self, t):
        return self.hi0 + t * self.vel


def _ray_box(C, d, lo, hi):
    """Slab intersection: entry parameter s (+inf on miss) and face normal id.

    Normal id in 0..5 = (-x, +x, -y, +y, -z, +z) of the slab whose entry plane
    was hit (used for Lambertian shading)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - C) / d
        t2 = (hi - C) / d
    tmin = np.minimum(t1, t2)
    tmax = np.maximum(t1, t2)
    tn = tmin.max(axis=-1)
    tf = tmax.min(axis=-1)
    hit = (tf > np.maximum(tn, 1e-6))
    axis = tmin.argmax(axis=-1)
    sign = np.take_along_axis(t1, axis[..., None], -1)[..., 0] == np.take_along_axis(
        tmin, axis[..., None], -1)[..., 0]
    face = axis * 2 + (~sign).astype(np.int64)
    s = np.where(hit, tn, np.inf)
    return s, face


_FACE_NORMALS = np.array(
    [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    np.float64,
)


@dataclass
class BoxScene:
    """Corridor world: floor z=0, side walls y=+-half_w, far wall x=x_far,
    cuboid obstacles (some moving). Same output interface as render.Scene."""

    num_views: int
    height: int
    width: int
    K: tuple
    R: np.ndarray                # [T, 3, 3] world->cam
    t: np.ndarray                # [T, 3]
    centers: np.ndarray          # [T, 3]
    half_w: float
    x_far: float
    boxes: list = field(default_factory=list)
    box_tex: list = field(default_factory=list)
    floor_tex: CellTexture = None
    wall_tex: CellTexture = None
    light: np.ndarray = None     # [3] unit direction TOWARD the light
    ambient: float = 0.45
    exposure_amp: float = 0.06
    noise_sigma: float = 0.008
    seed: int = 0

    # -- geometry ----------------------------------------------------------

    def _rays(self, view):
        fx, fy, cx, cy = self.K
        us, vs = np.meshgrid(
            np.arange(self.width, dtype=np.float64),
            np.arange(self.height, dtype=np.float64),
        )
        rays_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], -1)
        d = rays_cam @ self.R[view]
        return self.centers[view], d

    def _cast_planes(self, C, d):
        """Nearest of floor/side-walls/far-wall: s, plane id (0 floor, 1 left,
        2 right, 3 far, 4 ceiling), normal."""
        planes = [
            (2, 0.0, 1.0),             # floor z=0, normal +z
            (1, -self.half_w, 1.0),    # left wall y=-half_w, normal +y
            (1, self.half_w, -1.0),    # right wall, normal -y
            (0, self.x_far, -1.0),     # far wall, normal -x
            (2, 3.4, -1.0),            # ceiling z=3.4, normal -z
        ]
        s_best = np.full(d.shape[:-1], np.inf)
        pid = np.full(d.shape[:-1], -1, np.int64)
        nrm = np.zeros(d.shape[:-1] + (3,))
        for i, (ax, off, sgn) in enumerate(planes):
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (off - C[ax]) / d[..., ax]
            # only count hits from the open side (normal facing the ray origin)
            ok = (s > 1e-6) & (np.sign(C[ax] - off) == sgn) & np.isfinite(s)
            s = np.where(ok, s, np.inf)
            better = s < s_best
            s_best = np.where(better, s, s_best)
            pid = np.where(better, i, pid)
            n = np.zeros(3)
            n[ax] = sgn
            nrm = np.where(better[..., None], n, nrm)
        return s_best, pid, nrm

    def hit_points(self, view):
        """points [H,W,3], box index [H,W] (-1 = static world), z-depth [H,W],
        normals [H,W,3]."""
        C, d = self._rays(view)
        s_pl, _, n_pl = self._cast_planes(C, d)
        s_best, idx, nrm = s_pl, np.full(d.shape[:-1], -1, np.int64), n_pl
        for i, bx in enumerate(self.boxes):
            s, face = _ray_box(C, d, bx.lo(view), bx.hi(view))
            better = s < s_best
            s_best = np.where(better, s, s_best)
            idx = np.where(better, i, idx)
            nrm = np.where(better[..., None], _FACE_NORMALS[face], nrm)
        pts = C + s_best[..., None] * d
        return pts, idx, s_best.astype(np.float32), nrm

    # -- outputs -----------------------------------------------------------

    def _shade(self, albedo, nrm):
        diff = np.maximum((nrm * self.light).sum(axis=-1), 0.0)
        return albedo * (self.ambient + (1.0 - self.ambient) * diff)[..., None]

    def render(self, view):
        pts, idx, _, nrm = self.hit_points(view)
        img = np.where(
            (np.abs(pts[..., 2]) < 1e-6)[..., None],
            self.floor_tex(pts), self.wall_tex(pts))
        for i, bx in enumerate(self.boxes):
            m = idx == i
            if m.any():
                img[m] = self.box_tex[i](pts[m] - bx.lo(view))
        img = self._shade(img, nrm)
        # photometric nuisances: smooth exposure drift + sensor noise (applied
        # AFTER ground-truth extraction; this is the robustness being tested)
        rng = np.random.default_rng(self.seed * 1009 + view)
        expo = 1.0 + self.exposure_amp * np.sin(
            2 * np.pi * view / max(self.num_views, 1) * 1.7 + self.seed)
        img = img * expo + rng.normal(0.0, self.noise_sigma, img.shape)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def project(self, view, pts):
        fx, fy, cx, cy = self.K
        xc = pts @ self.R[view].T + self.t[view]
        u = fx * xc[..., 0] / xc[..., 2] + cx
        v = fy * xc[..., 1] / xc[..., 2] + cy
        return np.stack([u, v], axis=-1)

    def gt_flow(self, a, b):
        pts, idx, _, _ = self.hit_points(a)
        pts_b = pts.copy()
        for i, bx in enumerate(self.boxes):
            m = idx == i
            if m.any():
                pts_b[m] += (b - a) * bx.vel
        uv_b = self.project(b, pts_b)
        us, vs = np.meshgrid(
            np.arange(self.width, dtype=np.float64),
            np.arange(self.height, dtype=np.float64),
        )
        return (uv_b - np.stack([us, vs], -1)).astype(np.float32)

    def gt_depth(self, view):
        _, _, depth, _ = self.hit_points(view)
        return depth

    def gt_inverse_depth_norm(self, view):
        z = self.gt_depth(view)
        inv = 1.0 / np.maximum(z, 1e-6)
        lo, hi = inv.min(), inv.max()
        return ((inv - lo) / max(hi - lo, 1e-12)).astype(np.float32)

    def gt_dynamic(self, view):
        _, idx, _, _ = self.hit_points(view)
        moving = np.array(
            [bool(np.any(bx.vel != 0)) for bx in self.boxes] + [False])
        return moving[idx]

    def intrinsics_matrix(self):
        fx, fy, cx, cy = self.K
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    def world_to_cam(self, view):
        return np.concatenate([self.R[view], self.t[view][:, None]], axis=1)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _walk_path(rng, T, motion_scale, yaw_scale):
    """Eye-height forward walk along +x with lateral sway and yaw/pitch pans.

    world: +z up, camera looks roughly along +x (horizontal) — family A's
    camera looks DOWN at terrain; this regime exercises the vanishing-point /
    corridor geometry the training family never shows."""
    step = 0.22 * motion_scale
    u = np.arange(T, dtype=np.float64)
    ph = rng.uniform(0, 2 * np.pi, 4)
    fr = rng.uniform(0.5, 1.4, 4) * (2 * np.pi / max(T - 1, 1))
    centers = np.stack([
        step * u + 0.2 * motion_scale * np.sin(fr[0] * u + ph[0]),
        0.5 * motion_scale * np.sin(fr[1] * u + ph[1]),
        1.55 + 0.06 * motion_scale * np.sin(fr[2] * u + ph[2]),
    ], axis=1)
    # base: forward=+x, up=+z, right=-y  (rows of world->cam: right, -up, fwd)
    base = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    yaw_rate = np.deg2rad(1.2) * yaw_scale
    amps = np.minimum(yaw_rate / fr[2:4], np.deg2rad(14.0))
    Rs = np.empty((T, 3, 3))
    ts = np.empty((T, 3))
    for i in range(T):
        yaw = amps[0] * np.sin(fr[2] * u[i] + ph[2])
        pitch = 0.4 * amps[1] * np.sin(fr[3] * u[i] + ph[3])
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Rz = np.array([[cy_, -sy_, 0], [sy_, cy_, 0], [0, 0, 1]])   # yaw about z
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])       # pitch
        Rs[i] = base @ Ry @ Rz.T
        ts[i] = -Rs[i] @ centers[i]
    return Rs, ts, centers


def random_box_scene(
    rng,
    num_views=10,
    height=96,
    width=128,
    focal=None,
    num_dynamic=0,
    motion_scale=1.0,
    yaw_scale=1.0,
    num_boxes=10,
):
    """Sample a held-out-family corridor scene. Texture cell sizes adapt to the
    pixel footprint at typical viewing distance so images are matchable."""
    if focal is None:
        focal = 1.2 * max(height, width)
    Rs, ts, centers = _walk_path(rng, num_views, motion_scale, yaw_scale)
    span = 0.22 * motion_scale * num_views
    half_w = float(rng.uniform(2.2, 3.4))
    x_far = span + float(rng.uniform(6.0, 10.0))
    footprint = 3.0 / focal     # world units per pixel at ~3 m viewing distance
    cell_lo, cell_hi = 6 * footprint, 30 * footprint

    boxes, btex = [], []
    for _ in range(num_boxes):
        sz = rng.uniform(0.25, 0.9, 3) * np.array([1.0, 1.0, 1.6])
        x0 = rng.uniform(1.0, x_far - 1.5)
        y0 = rng.uniform(-half_w + 0.4, half_w - 0.4 - sz[1])
        lo = np.array([x0, y0, 0.0])
        boxes.append(Box(lo, lo + sz, np.zeros(3)))
        btex.append(CellTexture.random(rng, cell_lo, cell_hi))
    for _ in range(num_dynamic):
        sz = rng.uniform(0.35, 0.8, 3)
        x0 = rng.uniform(0.3 * span + 2.0, 0.7 * span + 4.0)
        y0 = rng.uniform(-half_w + 0.6, half_w - 0.6 - sz[1])
        z0 = rng.uniform(0.2, 1.4)
        lo = np.array([x0, y0, z0])
        vel = np.array([
            rng.uniform(-0.12, 0.12), rng.uniform(-0.10, 0.10),
            rng.uniform(-0.02, 0.02),
        ]) * motion_scale
        boxes.append(Box(lo, lo + sz, vel))
        btex.append(CellTexture.random(rng, cell_lo, cell_hi))

    light = rng.normal(size=3)
    light[2] = abs(light[2]) + 1.0      # from above
    light /= np.linalg.norm(light)
    return BoxScene(
        num_views=num_views, height=height, width=width,
        K=(focal, focal, width / 2.0, height / 2.0),
        R=Rs, t=ts, centers=centers,
        half_w=half_w, x_far=x_far,
        boxes=boxes, box_tex=btex,
        floor_tex=CellTexture.random(rng, cell_lo, cell_hi),
        wall_tex=CellTexture.random(rng, cell_lo * 1.5, cell_hi * 1.5),
        light=light,
        ambient=float(rng.uniform(0.35, 0.55)),
        exposure_amp=float(rng.uniform(0.03, 0.09)),
        noise_sigma=float(rng.uniform(0.004, 0.012)),
        seed=int(rng.integers(1 << 30)),
    )
