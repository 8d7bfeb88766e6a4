"""Motion-segmentation overlay visualization.

Counterpart of the reference's motion_seg.mp4 writer
(upstream motion_seg/main_motion_segmentation.py:114-119): trajectory
points drawn over each frame, red = dynamic, green = static. This environment
has no video codecs, so the artifacts are per-frame PNGs, an animated GIF and
an MJPEG AVI (io/avi.py — plays everywhere, needs no codec library). A copy of
particlesfm_tpu/motionseg/visualize.py.
"""
from __future__ import annotations

from pathlib import Path
import numpy as np
from PIL import Image, ImageDraw

from ..tracks.store import TrackArrays


def draw_overlay(image: np.ndarray, tracks: TrackArrays, frame: int,
                 point_radius: int = 2) -> Image.Image:
    img = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    d = ImageDraw.Draw(img)
    obs = tracks.mask[:, frame]
    xy = tracks.xy[obs, frame]
    labels = (
        tracks.labels[obs, frame]
        if tracks.labels is not None
        else np.zeros(obs.sum(), np.int8)
    )
    for (x, y), lab in zip(xy, labels):
        color = (255, 64, 64) if lab else (64, 255, 64)
        d.ellipse([x - point_radius, y - point_radius, x + point_radius, y + point_radius],
                  fill=color)
    return img


def write_overlay_video(out_dir, images: np.ndarray, tracks: TrackArrays,
                        gif_name: str = "motion_seg.gif", fps: int = 10) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    frames = []
    for t in range(min(len(images), tracks.num_frames)):
        img = draw_overlay(images[t], tracks, t)
        img.save(out / f"overlay_{t:06d}.png")
        frames.append(img)
    if frames:
        frames[0].save(out / gif_name, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
        from ..io.avi import write_mjpeg_avi

        write_mjpeg_avi(out / (Path(gif_name).stem + ".avi"), frames, fps=fps)
