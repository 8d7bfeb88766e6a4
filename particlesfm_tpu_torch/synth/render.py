"""Textured synthetic world renderer: images + GT flow/depth/dynamic masks.

The in-environment replacement for the datasets the reference trains and
evaluates on (FlyingThings3D for the seg net, Sintel for the pose benchmark —
both unavailable under zero egress). A scene is a procedurally textured
height-field observed by a smoothly moving, smoothly ROTATING camera, plus
translating textured spheres as dynamic objects. Every pixel's ground truth is
exact by construction:

  - image:    ray-cast each pixel to the nearest hit (sphere or surface),
              color = procedural 3D texture at the hit point;
  - flow a→b: the hit point is a material point; static points re-project with
              camera b, sphere points translate with the sphere center first —
              so flow is consistent with the rendered photometry, and a flow
              network trained on (image_a, image_b) → flow generalizes to the
              rendered acceptance sequences;
  - depth:    z-depth of the nearest hit (inverse-depth for the MiDaS contract);
  - dynamic:  sphere-hit mask (motion-seg ground truth).

Everything is vectorized NumPy (host-side data generation). A copy of
particlesfm_tpu/synth/render.py: the same seed renders the same frames
bit for bit in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# procedural fields
# ---------------------------------------------------------------------------


@dataclass
class Fourier2D:
    """Band of 2-D sinusoids: f(x, y) = sum_k a_k sin(wx_k x + wy_k y + p_k)."""

    amp: np.ndarray    # [K]
    freq: np.ndarray   # [K, 2]
    phase: np.ndarray  # [K]

    @staticmethod
    def random(rng, num, amp_total, freq_lo, freq_hi):
        amp = rng.uniform(0.3, 1.0, num)
        amp *= amp_total / amp.sum()
        # log-uniform frequency magnitudes, random directions
        mag = np.exp(rng.uniform(np.log(freq_lo), np.log(freq_hi), num))
        ang = rng.uniform(0, 2 * np.pi, num)
        freq = np.stack([mag * np.cos(ang), mag * np.sin(ang)], axis=1)
        return Fourier2D(amp, freq, rng.uniform(0, 2 * np.pi, num))

    def __call__(self, x, y):
        out = 0.0
        for k in range(len(self.amp)):
            out = out + self.amp[k] * np.sin(
                self.freq[k, 0] * x + self.freq[k, 1] * y + self.phase[k]
            )
        return out

    def grad(self, x, y):
        gx = 0.0
        gy = 0.0
        for k in range(len(self.amp)):
            c = self.amp[k] * np.cos(
                self.freq[k, 0] * x + self.freq[k, 1] * y + self.phase[k]
            )
            gx = gx + self.freq[k, 0] * c
            gy = gy + self.freq[k, 1] * c
        return gx, gy


@dataclass
class Texture3D:
    """RGB procedural texture over 3-D points (one Fourier band per channel,
    multiple octaves so every image patch is locally distinctive)."""

    amp: np.ndarray    # [3, K]
    freq: np.ndarray   # [3, K, 3]
    phase: np.ndarray  # [3, K]

    @staticmethod
    def random(rng, num, freq_lo, freq_hi):
        amp = rng.uniform(0.4, 1.0, (3, num))
        mag = np.exp(rng.uniform(np.log(freq_lo), np.log(freq_hi), (3, num)))
        d = rng.normal(size=(3, num, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return Texture3D(amp, d * mag[..., None], rng.uniform(0, 2 * np.pi, (3, num)))

    def __call__(self, pts):
        """pts [..., 3] -> RGB [..., 3] in [0, 1]."""
        out = np.zeros(pts.shape[:-1] + (3,), np.float32)
        for c in range(3):
            v = 0.0
            for k in range(self.amp.shape[1]):
                v = v + self.amp[c, k] * np.sin(
                    pts[..., 0] * self.freq[c, k, 0]
                    + pts[..., 1] * self.freq[c, k, 1]
                    + pts[..., 2] * self.freq[c, k, 2]
                    + self.phase[c, k]
                )
            out[..., c] = v
        scale = np.abs(self.amp).sum(axis=1)  # [3]
        return 0.5 + 0.48 * out / scale


# ---------------------------------------------------------------------------
# camera path
# ---------------------------------------------------------------------------


def _rot_xyz(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def camera_path(rng, num_views, height, motion_scale=1.0, rot_scale=1.0):
    """Smooth positions + smoothly rotating down-looking orientations.

    Returns world->cam rotations R [T,3,3], translations t [T,3] (x_cam = R x + t)
    and centers C [T,3]. Rotations vary by up to ~rot_scale*12 deg over the
    sequence (the reference's Sintel sequences have real rotation; round-1
    scenes were translation-only, which made rotation averaging trivial).
    """
    T = num_views
    step = 0.30 * motion_scale
    u = np.arange(T, dtype=np.float64)
    phases = rng.uniform(0, 2 * np.pi, 6)
    freqs = rng.uniform(0.6, 1.6, 6) * (2 * np.pi / max(T - 1, 1))
    centers = np.stack(
        [
            step * u + 0.25 * motion_scale * np.sin(freqs[0] * u + phases[0]),
            0.8 * motion_scale * np.sin(freqs[1] * u + phases[1]),
            height + 0.35 * motion_scale * np.sin(freqs[2] * u + phases[2]),
        ],
        axis=1,
    )
    base = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])  # looking down -z
    # bound the per-frame rotation DELTA (what sets flow magnitude) to ~1.5 deg:
    # amp_i * freq_i <= rate, with a hard cap so long sequences stay in view
    rate = np.deg2rad(1.5) * rot_scale
    amps = np.minimum(rate / freqs[3:6], np.deg2rad(15.0))
    Rs = np.empty((T, 3, 3))
    ts = np.empty((T, 3))
    for i in range(T):
        rx = amps[0] * np.sin(freqs[3] * u[i] + phases[3])
        ry = amps[1] * np.sin(freqs[4] * u[i] + phases[4])
        rz = 0.5 * amps[2] * np.sin(freqs[5] * u[i] + phases[5])
        R = (base @ _rot_xyz(rx, ry, rz)).T  # world->cam
        Rs[i] = R
        ts[i] = -R @ centers[i]
    return Rs, ts, centers


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------


@dataclass
class Sphere:
    center0: np.ndarray   # [3] at t=0
    vel: np.ndarray       # [3] per-frame velocity
    radius: float

    def center(self, t):
        return self.center0 + t * self.vel


@dataclass
class Scene:
    num_views: int
    height: int
    width: int
    K: tuple                     # (fx, fy, cx, cy)
    R: np.ndarray                # [T, 3, 3] world->cam
    t: np.ndarray                # [T, 3]
    centers: np.ndarray          # [T, 3]
    surface: Fourier2D
    texture: Texture3D
    spheres: list = field(default_factory=list)
    sphere_textures: list = field(default_factory=list)

    # -- geometry ----------------------------------------------------------

    def _rays(self, view):
        fx, fy, cx, cy = self.K
        us, vs = np.meshgrid(
            np.arange(self.width, dtype=np.float64),
            np.arange(self.height, dtype=np.float64),
        )
        rays_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], -1)
        d = rays_cam @ self.R[view]  # rows: R^T ray
        C = self.centers[view]
        return C, d

    def _cast_surface(self, C, d, iters=30):
        """Fixed-point solve of C + s d on z = g(x, y); returns s [...]."""
        s = (0.0 - C[2]) / d[..., 2]
        for _ in range(iters):
            x = C[0] + s * d[..., 0]
            y = C[1] + s * d[..., 1]
            z = self.surface(x, y)
            s = (z - C[2]) / d[..., 2]
        return s

    def _cast_spheres(self, C, d, view):
        """Nearest sphere hit: s [...], index [...] (-1 = none)."""
        s_best = np.full(d.shape[:-1], np.inf)
        idx = np.full(d.shape[:-1], -1, np.int32)
        dd = np.sum(d * d, axis=-1)
        for i, sp in enumerate(self.spheres):
            oc = C - sp.center(view)
            b = np.sum(d * oc, axis=-1)
            c = np.sum(oc * oc, axis=-1) - sp.radius**2
            disc = b * b - dd * c
            hit = disc > 0
            s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / dd, np.inf)
            s = np.where(s > 1e-6, s, np.inf)
            better = s < s_best
            s_best = np.where(better, s, s_best)
            idx = np.where(better, i, idx)
        return s_best, idx

    def hit_points(self, view):
        """Per-pixel nearest hit: points [H,W,3], sphere index [H,W] (-1=surface),
        z-depth [H,W]."""
        C, d = self._rays(view)
        s_surf = self._cast_surface(C, d)
        s_sph, idx = self._cast_spheres(C, d, view)
        use_sph = s_sph < s_surf
        s = np.where(use_sph, s_sph, s_surf)
        idx = np.where(use_sph, idx, -1)
        pts = C + s[..., None] * d
        # rays have unit z in the camera frame, so the ray parameter s IS the
        # camera z-depth of the hit point
        return pts, idx, s.astype(np.float32)

    # -- outputs -----------------------------------------------------------

    def render(self, view):
        """[H, W, 3] uint8 image."""
        pts, idx, _ = self.hit_points(view)
        img = self.texture(pts)
        for i, sp in enumerate(self.spheres):
            m = idx == i
            if m.any():
                local = pts[m] - sp.center(view)
                img[m] = self.sphere_textures[i](local)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def project(self, view, pts):
        fx, fy, cx, cy = self.K
        xc = pts @ self.R[view].T + self.t[view]
        u = fx * xc[..., 0] / xc[..., 2] + cx
        v = fy * xc[..., 1] / xc[..., 2] + cy
        return np.stack([u, v], axis=-1)

    def gt_flow(self, a, b):
        """Exact flow a→b [H, W, 2] consistent with render(a)/render(b)."""
        pts, idx, _ = self.hit_points(a)
        pts_b = pts.copy()
        for i, sp in enumerate(self.spheres):
            m = idx == i
            if m.any():
                pts_b[m] += sp.center(b) - sp.center(a)
        uv_b = self.project(b, pts_b)
        us, vs = np.meshgrid(
            np.arange(self.width, dtype=np.float64),
            np.arange(self.height, dtype=np.float64),
        )
        return (uv_b - np.stack([us, vs], -1)).astype(np.float32)

    def gt_depth(self, view):
        """z-depth of the nearest hit [H, W] float32."""
        _, _, depth = self.hit_points(view)
        return depth

    def gt_inverse_depth_norm(self, view):
        """Per-frame min-max normalized inverse depth (MiDaS PNG contract)."""
        z = self.gt_depth(view)
        inv = 1.0 / np.maximum(z, 1e-6)
        lo, hi = inv.min(), inv.max()
        return ((inv - lo) / max(hi - lo, 1e-12)).astype(np.float32)

    def gt_dynamic(self, view):
        """[H, W] bool — pixels on a MOVING object (static spheres excluded)."""
        _, idx, _ = self.hit_points(view)
        moving = np.array(
            [bool(np.any(sp.vel != 0)) for sp in self.spheres] + [False]
        )
        return moving[idx]

    def intrinsics_matrix(self):
        fx, fy, cx, cy = self.K
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    def world_to_cam(self, view):
        return np.concatenate([self.R[view], self.t[view][:, None]], axis=1)


def random_scene(
    rng,
    num_views=10,
    height=96,
    width=128,
    focal=None,
    num_dynamic=0,
    motion_scale=1.0,
    rot_scale=1.0,
    cam_height=5.0,
    principal=None,
    num_static_obj=0,
):
    """Sample a full scene. Texture frequencies adapt to the pixel footprint so
    images are matchable at the rendered resolution (feature size ~3-12 px).

    `principal` overrides (cx, cy): rendering a small (height, width) window
    with the focal of a LARGER virtual sensor and an offset principal point
    produces training crops whose flow statistics exactly match full-sensor
    sequences at that focal — the trick that makes in-environment flow training
    at benchmark scale affordable."""
    if focal is None:
        focal = 1.2 * max(height, width)
    Rs, ts, centers = camera_path(rng, num_views, cam_height, motion_scale, rot_scale)
    surface = Fourier2D.random(rng, num=5, amp_total=rng.uniform(0.5, 1.1),
                               freq_lo=0.3, freq_hi=2.2)
    footprint = cam_height / focal  # world units per pixel at surface
    tex = Texture3D.random(
        rng, num=10, freq_lo=2 * np.pi / (40 * footprint),
        freq_hi=2 * np.pi / (6 * footprint),
    )
    spheres, stexs = [], []
    span = 0.30 * motion_scale * num_views
    # static foreground objects: spheres lifted off the surface at varied
    # heights create real DEPTH CONTRAST (the bumpy surface alone is a
    # near-plane at +-20% depth, which leaves two-view epipolar geometry
    # ill-conditioned — the differential-parallax signal that separates
    # rotation from translation scales with depth contrast; Sintel-class
    # scenes span ~20x in depth)
    for _ in range(num_static_obj):
        r = rng.uniform(0.15, 0.45) * cam_height / 5.0
        c0 = np.array(
            [rng.uniform(-0.5, span + 0.5),
             rng.uniform(-1.8, 1.8) * cam_height / 5.0,
             # depth floor ~1.6: nearer objects would push per-frame flow past
             # the trained correlation pyramid's envelope
             rng.uniform(1.6, 3.6) * cam_height / 5.0]
        )
        spheres.append(Sphere(c0, np.zeros(3), r))
        stexs.append(
            Texture3D.random(rng, num=8, freq_lo=2 * np.pi / (30 * footprint),
                             freq_hi=2 * np.pi / (5 * footprint))
        )
    for _ in range(num_dynamic):
        r = rng.uniform(0.25, 0.7) * motion_scale * cam_height / 5.0
        c0 = np.array(
            [rng.uniform(0.2 * span, 0.8 * span),
             rng.uniform(-1.0, 1.0) * motion_scale,
             rng.uniform(1.2, 2.6)]
        )
        vel = np.array(
            [rng.uniform(-0.15, 0.15), rng.uniform(-0.10, 0.10),
             rng.uniform(-0.03, 0.03)]
        ) * motion_scale
        spheres.append(Sphere(c0, vel, r))
        stexs.append(
            Texture3D.random(rng, num=8, freq_lo=2 * np.pi / (30 * footprint),
                             freq_hi=2 * np.pi / (5 * footprint))
        )
    if principal is None:
        principal = (width / 2.0, height / 2.0)
    return Scene(
        num_views=num_views, height=height, width=width,
        K=(focal, focal, principal[0], principal[1]),
        R=Rs, t=ts, centers=centers,
        surface=surface, texture=tex, spheres=spheres, sphere_textures=stexs,
    )
