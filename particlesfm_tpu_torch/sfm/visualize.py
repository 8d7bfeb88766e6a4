"""Reconstruction viewer export CLI — counterpart of upstream visualize.py.

The reference opens an interactive Open3D window (pycolmap + camera frustums,
visualize.py:15-67); headless environments get the same content two ways:
a PLY (points + red camera centers + frustum edges) for any external viewer,
and a self-contained interactive HTML viewer (html_viewer.py — vanilla WebGL
orbit/zoom/pan, data embedded, opens in any browser with no network).

A copy of particlesfm_tpu/sfm/visualize.py; rotations come from the port's
geometry/rotations.py.

Usage: python -m particlesfm_tpu_torch.sfm.visualize -i sfm/model -o model.ply \
           [-w model.html]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def frustum_points(R_c2w: np.ndarray, center: np.ndarray, scale: float = 0.2):
    """5 frustum corner points (apex + 4 image corners) in world coords."""
    corners = np.array(
        [[0, 0, 0], [-1, -0.6, 1.5], [1, -0.6, 1.5], [1, 0.6, 1.5], [-1, 0.6, 1.5]]
    ) * scale
    return (R_c2w @ corners.T).T + center


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input_model", required=True)
    ap.add_argument("-o", "--output_ply", default=None)
    ap.add_argument("-w", "--output_html", default=None,
                    help="also write a self-contained interactive HTML viewer")
    args = ap.parse_args(argv)

    from ..io import colmap_model as cm
    from ..geometry import rotations as rot

    model_dir = Path(args.input_model)
    try:
        cams, images, points = cm.read_model_binary(model_dir)
    except FileNotFoundError:
        cams, images, points = cm.read_model_text(model_dir)

    rows = []
    for p in points.values():
        x, c = p.xyz, p.rgb
        rows.append(f"{x[0]} {x[1]} {x[2]} {c[0]} {c[1]} {c[2]}")
    scale = 0.03 * (
        np.ptp([p.xyz for p in points.values()], axis=0).max() if points else 1.0
    )
    for im in images.values():
        R = rot.quat_to_rotmat(torch.as_tensor(im.qvec, dtype=torch.float32)).numpy()
        center = -R.T @ im.tvec
        for fp in frustum_points(R.T, center, scale):
            rows.append(f"{fp[0]} {fp[1]} {fp[2]} 255 0 0")
    out = args.output_ply or (str(model_dir) + ".ply")
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(rows)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    Path(out).write_text(header + "\n".join(rows) + "\n")
    print(f"wrote {out}: {len(points)} points, {len(images)} cameras")

    if args.output_html:
        from .html_viewer import frusta_from_images, write_html_viewer

        xyz = (np.asarray([p.xyz for p in points.values()], np.float32)
               if points else np.zeros((0, 3), np.float32))
        rgb = (np.asarray([p.rgb for p in points.values()], np.uint8)
               if points else np.zeros((0, 3), np.uint8))
        segs = frusta_from_images(images, rot.quat_to_rotmat, scale)
        write_html_viewer(args.output_html, xyz, rgb, segs,
                          name=str(model_dir))
        print(f"wrote {args.output_html}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
