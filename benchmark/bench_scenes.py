"""The benchmark's scene generator: a frozen copy of the port's renderer
(`particlesfm_tpu_torch/synth/render.py`) that renders on the device.

A scene is a procedurally textured height field seen by a smoothly moving,
rotating camera, with textured spheres (static, or moving for dynamic
scenes). Its random draws (`random_scene`, `camera_path`) are made on the
host with numpy exactly as the source makes them, so one generator state
gives the source's scene; each pixel's ray cast and texture are computed in
float64 torch on the device. Frames are uint8 [H, W, 3]; the scene keeps
the camera poses and focal the poses are judged against.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch


def _fourier(rng, num, amp_total, freq_lo, freq_hi):
    amp = rng.uniform(0.3, 1.0, num)
    amp *= amp_total / amp.sum()
    mag = np.exp(rng.uniform(np.log(freq_lo), np.log(freq_hi), num))
    ang = rng.uniform(0, 2 * np.pi, num)
    freq = np.stack([mag * np.cos(ang), mag * np.sin(ang)], axis=1)
    return amp, freq, rng.uniform(0, 2 * np.pi, num)


def _texture(rng, num, freq_lo, freq_hi):
    amp = rng.uniform(0.4, 1.0, (3, num))
    mag = np.exp(rng.uniform(np.log(freq_lo), np.log(freq_hi), (3, num)))
    d = rng.normal(size=(3, num, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return amp, d * mag[..., None], rng.uniform(0, 2 * np.pi, (3, num))


def _rot_xyz(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def camera_path(rng, num_views, height, motion_scale=1.0, rot_scale=1.0):
    """World->cam rotations R [T, 3, 3], translations t [T, 3], centers [T, 3]."""
    T = num_views
    step = 0.30 * motion_scale
    u = np.arange(T, dtype=np.float64)
    phases = rng.uniform(0, 2 * np.pi, 6)
    freqs = rng.uniform(0.6, 1.6, 6) * (2 * np.pi / max(T - 1, 1))
    centers = np.stack([
        step * u + 0.25 * motion_scale * np.sin(freqs[0] * u + phases[0]),
        0.8 * motion_scale * np.sin(freqs[1] * u + phases[1]),
        height + 0.35 * motion_scale * np.sin(freqs[2] * u + phases[2]),
    ], axis=1)
    base = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    rate = np.deg2rad(1.5) * rot_scale
    amps = np.minimum(rate / freqs[3:6], np.deg2rad(15.0))
    Rs = np.empty((T, 3, 3))
    ts = np.empty((T, 3))
    for i in range(T):
        rx = amps[0] * np.sin(freqs[3] * u[i] + phases[3])
        ry = amps[1] * np.sin(freqs[4] * u[i] + phases[4])
        rz = 0.5 * amps[2] * np.sin(freqs[5] * u[i] + phases[5])
        R = (base @ _rot_xyz(rx, ry, rz)).T
        Rs[i] = R
        ts[i] = -R @ centers[i]
    return Rs, ts, centers


@dataclass
class Scene:
    height: int
    width: int
    K: tuple                    # (fx, fy, cx, cy)
    R: np.ndarray               # [T, 3, 3] world->cam
    t: np.ndarray               # [T, 3]
    centers: np.ndarray         # [T, 3]
    surface: tuple              # Fourier (amp, freq, phase)
    texture: tuple              # texture (amp, freq, phase)
    spheres: list = field(default_factory=list)          # (center0, vel, radius)
    sphere_textures: list = field(default_factory=list)

    @property
    def num_views(self) -> int:
        return self.R.shape[0]

    def w2c(self, view) -> np.ndarray:
        return np.concatenate([self.R[view], self.t[view][:, None]], axis=1)


def random_scene(rng, num_views, height, width, focal=None, num_dynamic=0, motion_scale=1.0,
                 rot_scale=1.0, cam_height=5.0, num_static_obj=0) -> Scene:
    """The source's `random_scene` draws, in its order."""
    if focal is None:
        focal = 1.2 * max(height, width)
    Rs, ts, centers = camera_path(rng, num_views, cam_height, motion_scale, rot_scale)
    surface = _fourier(rng, 5, rng.uniform(0.5, 1.1), 0.3, 2.2)
    footprint = cam_height / focal
    tex = _texture(rng, 10, 2 * np.pi / (40 * footprint), 2 * np.pi / (6 * footprint))
    spheres, stexs = [], []
    span = 0.30 * motion_scale * num_views
    for _ in range(num_static_obj):
        r = rng.uniform(0.15, 0.45) * cam_height / 5.0
        c0 = np.array([rng.uniform(-0.5, span + 0.5),
                       rng.uniform(-1.8, 1.8) * cam_height / 5.0,
                       rng.uniform(1.6, 3.6) * cam_height / 5.0])
        spheres.append((c0, np.zeros(3), r))
        stexs.append(_texture(rng, 8, 2 * np.pi / (30 * footprint), 2 * np.pi / (5 * footprint)))
    for _ in range(num_dynamic):
        r = rng.uniform(0.25, 0.7) * motion_scale * cam_height / 5.0
        c0 = np.array([rng.uniform(0.2 * span, 0.8 * span),
                       rng.uniform(-1.0, 1.0) * motion_scale,
                       rng.uniform(1.2, 2.6)])
        vel = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.10, 0.10),
                        rng.uniform(-0.03, 0.03)]) * motion_scale
        spheres.append((c0, vel, r))
        stexs.append(_texture(rng, 8, 2 * np.pi / (30 * footprint), 2 * np.pi / (5 * footprint)))
    return Scene(height, width, (focal, focal, width / 2.0, height / 2.0), Rs, ts, centers,
                 surface, tex, spheres, stexs)


def draw_scene(rng, recipe: dict, num_views: int, height: int, width: int) -> Scene:
    """A scene from a recipe of ranges: focal as a factor of the width, the
    numbers of moving and static spheres (inclusive integer ranges), the
    camera's motion and rotation scales. Drawn in that order, then the
    scene's own draws."""
    lo, hi = recipe["focal_factor"]
    focal = width * rng.uniform(lo, hi)
    num_dynamic = int(rng.integers(recipe["num_dynamic"][0], recipe["num_dynamic"][1] + 1))
    motion_scale = float(rng.uniform(*recipe["motion_scale"]))
    rot_scale = float(rng.uniform(*recipe["rot_scale"]))
    num_static = int(rng.integers(recipe["num_static_obj"][0], recipe["num_static_obj"][1] + 1))
    return random_scene(rng, num_views, height, width, focal=focal, num_dynamic=num_dynamic,
                        motion_scale=motion_scale, rot_scale=rot_scale,
                        num_static_obj=num_static)


def _wave_sum(amp, freq, phase, coords):
    """sum_k amp_k sin(sum_j coords_j * freq_kj + phase_k), summed in k order."""
    out = 0.0
    for k in range(len(amp)):
        arg = coords[0] * float(freq[k][0])
        for j in range(1, len(coords)):
            arg = arg + coords[j] * float(freq[k][j])
        out = out + float(amp[k]) * torch.sin(arg + float(phase[k]))
    return out


def _shade(tex, pts):
    """Texture of points [..., 3] -> RGB in [0, 1] (float64); each channel's
    sum is kept in float32, as the source's output array is."""
    amp, freq, phase = tex
    coords = (pts[..., 0], pts[..., 1], pts[..., 2])
    chans = [_wave_sum(amp[c], freq[c], phase[c], coords).to(torch.float32).double()
             for c in range(3)]
    scale = np.abs(amp).sum(axis=1)
    return torch.stack([0.5 + 0.48 * chans[c] / float(scale[c]) for c in range(3)], dim=-1)


@torch.no_grad()
def render_frame(scene: Scene, view: int, device) -> torch.Tensor:
    """uint8 [H, W, 3] on `device`: nearest hit of each pixel's ray (height
    field by a 30-step fixed point, spheres analytically), textured."""
    f64 = dict(dtype=torch.float64, device=device)
    fx, fy, cx, cy = scene.K
    vs, us = torch.meshgrid(torch.arange(scene.height, **f64), torch.arange(scene.width, **f64),
                            indexing="ij")
    rays = torch.stack([(us - cx) / fx, (vs - cy) / fy, torch.ones_like(us)], -1)
    d = rays @ torch.as_tensor(scene.R[view], **f64)
    C = [float(c) for c in scene.centers[view]]
    amp, freq, phase = scene.surface
    s = (0.0 - C[2]) / d[..., 2]
    for _ in range(30):
        z = _wave_sum(amp, freq, phase, (C[0] + s * d[..., 0], C[1] + s * d[..., 1]))
        s = (z - C[2]) / d[..., 2]
    s_best = torch.full(d.shape[:-1], float("inf"), **f64)
    idx = torch.full(d.shape[:-1], -1, dtype=torch.int64, device=device)
    dd = (d * d).sum(-1)
    Ct = torch.tensor(C, **f64)
    for i, (c0, vel, r) in enumerate(scene.spheres):
        oc = Ct - torch.as_tensor(c0 + view * vel, **f64)
        b = (d * oc).sum(-1)
        c = float((oc * oc).sum()) - r ** 2
        disc = b * b - dd * c
        si = torch.where(disc > 0, (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / dd,
                         torch.full_like(b, float("inf")))
        si = torch.where(si > 1e-6, si, torch.full_like(si, float("inf")))
        better = si < s_best
        s_best = torch.where(better, si, s_best)
        idx = torch.where(better, torch.full_like(idx, i), idx)
    use_sph = s_best < s
    s = torch.where(use_sph, s_best, s)
    idx = torch.where(use_sph, idx, torch.full_like(idx, -1))
    pts = Ct + s[..., None] * d
    img = _shade(scene.texture, pts)
    for i, (c0, vel, r) in enumerate(scene.spheres):
        m = idx == i
        if bool(m.any()):
            img[m] = _shade(scene.sphere_textures[i], pts[m] - torch.as_tensor(c0 + view * vel, **f64))
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8)


def write_ppm(path: Path, frame: np.ndarray) -> None:
    h, w = frame.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(frame, np.uint8).tobytes())


@dataclass
class Sequence:
    """One rendered sequence of the pool: its frame directory, frames (host
    uint8 [T, H, W, 3]) and the scene it was rendered from."""
    image_dir: Path
    frames: np.ndarray
    scene: Scene


def seeded_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's seed (any integer, negative or
    beyond 64 bits included)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *stream])


def render_sequence(rng, recipe, num_views, height, width, out_dir: Path, device) -> Sequence:
    scene = draw_scene(rng, recipe, num_views, height, width)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = []
    for v in range(num_views):
        fr = render_frame(scene, v, device).cpu().numpy()
        write_ppm(out_dir / f"{v:06d}.ppm", fr)
        frames.append(fr)
    return Sequence(out_dir, np.stack(frames), scene)
