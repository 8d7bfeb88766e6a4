"""Reconstruction export: COLMAP-format model + converted depth/pose/intrinsics,
and the legacy NVM, Bundler and VRML writers (port of
particlesfm_tpu/sfm/export.py).

Mirrors the reference's output contracts:
  - COLMAP sparse model bins (written by gmapper via Reconstruction::Write,
    upstream sfm/gmapper/src/base/reconstruction.cc:798-841);
  - `colmap_outputs_converted/{depths/*.npy+png, poses/*.txt (3x4 world2cam),
    intrinsics/*.txt}` (upstream sfm/convert.py:43-96,98-130).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry import rotations as rot, se3
from ..io import colmap_model as cm
from .mapper import Reconstruction


def _model_arrays(rec: Reconstruction):
    """Vectorized flat-observation indexing shared by the exporters.

    Replaces the per-track Python loop (3.5M inner iterations at protocol
    scale, ~15 s per model write in round 3 — half the SfM stage's tail).

    Returns a dict with, in TRACK-MAJOR flat observation order:
      tn [M] track row, img [M] frame idx, uv [M,2], p2d [M] keypoint index
      within the image (assigned in track-major order per image — identical
      layout to the old loop), plus per-track arrays over `valid_tracks`:
      tl (track length), off (flat offset), err (mean reproj error).
    """
    sel = rec.obs_mask & rec.track_valid[:, None]
    tn, sk = np.nonzero(sel)                        # track-major
    img = rec.obs_frame_idx[tn, sk].astype(np.int64)
    uv = rec.obs_uv[tn, sk].astype(np.float64)
    M = len(tn)
    order = np.argsort(img, kind="stable")          # per-image, track-major
    counts_img = np.bincount(img, minlength=rec.num_images)
    starts = np.zeros(rec.num_images + 1, np.int64)
    np.cumsum(counts_img, out=starts[1:])
    pos_sorted = np.arange(M, dtype=np.int64) - starts[img[order]]
    p2d = np.empty(M, np.int64)
    p2d[order] = pos_sorted
    valid_tracks = np.nonzero(rec.track_valid)[0]
    tl = np.bincount(tn, minlength=rec.track_valid.shape[0])[valid_tracks]
    off = np.zeros(len(valid_tracks) + 1, np.int64)
    np.cumsum(tl, out=off[1:])
    errs = rec.obs_error[tn, sk].astype(np.float64)
    err_sum = np.bincount(tn, weights=errs, minlength=rec.track_valid.shape[0])
    err_mean = err_sum[valid_tracks] / np.maximum(tl, 1)
    return dict(tn=tn, img=img, uv=uv, p2d=p2d, order=order,
                counts_img=counts_img, starts=starts,
                valid_tracks=valid_tracks, tl=tl, off=off[:-1],
                err=err_mean, M=M)


def to_colmap_model(
    rec: Reconstruction, image_names: Optional[List[str]] = None
):
    """Convert to COLMAP camera/image/point3D dicts (ids are 1-based)."""
    if image_names is None:
        image_names = [f"{i:06d}.png" for i in range(rec.num_images)]
    f = float(rec.params[0])
    camera = cm.Camera(
        id=1,
        model="SIMPLE_PINHOLE",
        width=rec.width,
        height=rec.height,
        params=np.array([f, float(rec.params[2]), float(rec.params[3])]),
    )
    A = _model_arrays(rec)
    img_s = A["img"][A["order"]]
    uv_s = A["uv"][A["order"]]
    pid_s = (A["tn"] + 1)[A["order"]]

    images = {}
    for i in range(rec.num_images):
        if not rec.registered[i]:
            continue
        s, e = A["starts"][i], A["starts"][i + 1]
        images[i + 1] = cm.Image(
            id=i + 1,
            qvec=rec.qvec[i].astype(np.float64),
            tvec=rec.tvec[i].astype(np.float64),
            camera_id=1,
            name=image_names[i],
            xys=uv_s[s:e].reshape(-1, 2),
            point3D_ids=pid_s[s:e].astype(np.int64),
        )

    points3D = {}
    img1 = A["img"] + 1
    for j, n in enumerate(A["valid_tracks"]):
        s = A["off"][j]
        e = s + A["tl"][j]
        points3D[int(n) + 1] = cm.Point3D(
            id=int(n) + 1,
            xyz=rec.points[n].astype(np.float64),
            rgb=np.array([128, 128, 128], np.uint8),
            error=float(A["err"][j]),
            image_ids=img1[s:e].astype(np.int64),
            point2D_idxs=A["p2d"][s:e].astype(np.int64),
        )
    return {1: camera}, images, points3D


def _write_model_binary_fast(rec: Reconstruction, out: Path, image_names):
    """COLMAP bin writer straight from the Reconstruction's flat arrays.

    Byte-compatible with io/colmap_model.py readers; avoids materializing one
    Python object per point (239k Point3D dataclasses + per-record struct
    packing cost ~15 s per write at protocol scale). Points are emitted
    grouped by track length so each group is ONE vectorized structured-array
    dump; record order within points3D.bin is irrelevant to the format."""
    import struct

    A = _model_arrays(rec)
    f = float(rec.params[0])
    # cameras.bin
    with open(out / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, cm.CAMERA_MODEL_IDS["SIMPLE_PINHOLE"],
                             rec.width, rec.height))
        fh.write(np.asarray([f, float(rec.params[2]), float(rec.params[3])],
                            np.float64).tobytes())
    # images.bin
    img_s = A["img"][A["order"]]
    uv_s = A["uv"][A["order"]]
    pid_s = (A["tn"] + 1)[A["order"]]
    reg = np.nonzero(rec.registered)[0]
    with open(out / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(reg)))
        for i in reg:
            fh.write(struct.pack("<i", int(i) + 1))
            fh.write(rec.qvec[i].astype("<f8").tobytes())
            fh.write(rec.tvec[i].astype("<f8").tobytes())
            fh.write(struct.pack("<i", 1))
            fh.write(image_names[i].encode() + b"\x00")
            s, e = int(A["starts"][i]), int(A["starts"][i + 1])
            fh.write(struct.pack("<Q", e - s))
            recarr = np.zeros(e - s, dtype=[("x", "<f8"), ("y", "<f8"),
                                            ("pid", "<i8")])
            recarr["x"], recarr["y"] = uv_s[s:e, 0], uv_s[s:e, 1]
            recarr["pid"] = pid_s[s:e]
            fh.write(recarr.tobytes())
    # points3D.bin — grouped by track length, one structured dump per group
    vt, tl, off = A["valid_tracks"], A["tl"], A["off"]
    img1 = (A["img"] + 1).astype("<i4")
    p2d = A["p2d"].astype("<i4")
    with open(out / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(vt)))
        for L in np.unique(tl):
            Li = int(L)
            members = np.nonzero(tl == L)[0]
            flat = off[members][:, None] + np.arange(Li)[None, :]
            dt = np.dtype([("pid", "<u8"), ("xyz", "<f8", (3,)),
                           ("rgb", "u1", (3,)), ("err", "<f8"),
                           ("tl", "<u8"), ("track", "<i4", (Li, 2))])
            g = np.zeros(len(members), dtype=dt)
            g["pid"] = vt[members] + 1
            g["xyz"] = rec.points[vt[members]].astype(np.float64)
            g["rgb"] = 128
            g["err"] = A["err"][members]
            g["tl"] = Li
            g["track"][:, :, 0] = img1[flat]
            g["track"][:, :, 1] = p2d[flat]
            fh.write(g.tobytes())


def write_colmap_model(rec: Reconstruction, out_dir, image_names=None, binary=True):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if binary:
        if image_names is None:
            image_names = [f"{i:06d}.png" for i in range(rec.num_images)]
        _write_model_binary_fast(rec, out, image_names)
        return None
    cams, images, points = to_colmap_model(rec, image_names)
    cm.write_model_text(cams, images, points, out)
    return cams, images, points


def write_converted_outputs(
    rec: Reconstruction, out_dir, image_names: Optional[List[str]] = None
) -> None:
    """Depth / pose / intrinsics files in the reference's converted layout."""
    out = Path(out_dir)
    for sub in ("depths", "poses", "intrinsics"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    if image_names is None:
        image_names = [f"{i:06d}" for i in range(rec.num_images)]
    stems = [Path(n).stem for n in image_names]
    f, cx, cy = float(rec.params[0]), float(rec.params[2]), float(rec.params[3])
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])

    import torch

    from ..geometry import rotations as rot

    R_all = rot.quat_to_rotmat(torch.as_tensor(np.asarray(rec.qvec, np.float32))).numpy()
    # one flat pass over valid observations, grouped per image (the per-image
    # [N, K] re-scan cost 48 full sweeps at protocol scale)
    sel = rec.obs_mask & rec.track_valid[:, None]
    tn_all, sk_all = np.nonzero(sel)
    img_all = rec.obs_frame_idx[tn_all, sk_all]
    order = np.argsort(img_all, kind="stable")
    counts = np.bincount(img_all, minlength=rec.num_images)
    starts = np.zeros(rec.num_images + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    tn_sorted = tn_all[order]
    for i in range(rec.num_images):
        if not rec.registered[i]:
            continue
        P = np.concatenate([R_all[i], rec.tvec[i][:, None]], axis=1)  # 3x4 world2cam
        np.savetxt(out / "poses" / f"{stems[i]}.txt", P)
        np.savetxt(out / "intrinsics" / f"{stems[i]}.txt", K)
        # sparse depth: project valid points observed in this image
        depth = np.zeros((rec.height, rec.width), np.float32)
        tracks_n = tn_sorted[starts[i]:starts[i + 1]]
        if len(tracks_n):
            X = rec.points[tracks_n]
            xc = (R_all[i] @ X.T).T + rec.tvec[i]
            z = xc[:, 2]
            u = np.round(f * xc[:, 0] / z + cx).astype(int)
            v = np.round(f * xc[:, 1] / z + cy).astype(int)
            ok = (z > 0) & (u >= 0) & (u < rec.width) & (v >= 0) & (v < rec.height)
            depth[v[ok], u[ok]] = z[ok]
        np.save(out / "depths" / f"{stems[i]}.npy", depth)


def write_nvm(path, rec: Reconstruction, image_names=None) -> None:
    """VisualSFM NVM export (reconstruction.cc:918-1040 parity): shared-focal
    header, per-image <name> <f> <qw qx qy qz> <cx cy cz> 0 0, then points."""
    if image_names is None:
        image_names = [f"{i:06d}.png" for i in range(rec.num_images)]
    f = float(rec.params[0])
    reg = np.nonzero(rec.registered)[0]
    centers = se3.camera_center(torch.as_tensor(rec.qvec), torch.as_tensor(rec.tvec)).numpy()
    lines = ["NVM_V3", "", str(len(reg))]
    img_order = {int(i): k for k, i in enumerate(reg)}
    for i in reg:
        q = rec.qvec[i]
        c = centers[i]
        lines.append(f"{image_names[i]} {f} {q[0]} {q[1]} {q[2]} {q[3]} {c[0]} {c[1]} {c[2]} 0 0")
    valid = np.nonzero(rec.track_valid)[0]
    lines += ["", str(len(valid))]
    for n in valid:
        x = rec.points[n]
        obs = _track_obs(rec, n, img_order)
        lines.append(f"{x[0]} {x[1]} {x[2]} 128 128 128 {len(obs)} " + " ".join(obs))
    Path(path).write_text("\n".join(lines) + "\n")


def write_bundler(path, rec: Reconstruction) -> None:
    """Bundler .out export (reconstruction.cc:1042-1140 parity)."""
    reg = np.nonzero(rec.registered)[0]
    valid = np.nonzero(rec.track_valid)[0]
    f = float(rec.params[0])
    lines = ["# Bundle file v0.3", f"{len(reg)} {len(valid)}"]
    # Bundler convention: y up, z towards the viewer -> flip rows 1, 2 of [R|t]
    flip = np.diag([1.0, -1.0, -1.0])
    img_order = {int(i): k for k, i in enumerate(reg)}
    for i in reg:
        R = rot.quat_to_rotmat(torch.as_tensor(rec.qvec[i], dtype=torch.float32)).numpy()
        Rb = flip @ R
        tb = flip @ rec.tvec[i]
        lines.append(f"{f} 0 0")
        for row in Rb:
            lines.append(f"{row[0]} {row[1]} {row[2]}")
        lines.append(f"{tb[0]} {tb[1]} {tb[2]}")
    for n in valid:
        x = rec.points[n]
        lines += [f"{x[0]} {x[1]} {x[2]}", "128 128 128"]
        obs = _track_obs(rec, n, img_order)
        lines.append(f"{len(obs)} " + " ".join(obs))
    Path(path).write_text("\n".join(lines) + "\n")


def _track_obs(rec: Reconstruction, n: int, img_order: dict) -> list:
    """'<image order> 0 <u> <v>' of track n's kept observations in registered images."""
    obs = []
    for k in np.nonzero(rec.obs_mask[n])[0]:
        img = int(rec.obs_frame_idx[n, k])
        if img in img_order:
            u, v = rec.obs_uv[n, k]
            obs.append(f"{img_order[img]} 0 {u} {v}")
    return obs


def write_vrml(path, rec: Reconstruction, colors=None) -> None:
    """Minimal VRML 2.0 point-cloud export (reconstruction.cc:1142-1219 parity)."""
    pts = rec.points[rec.track_valid]
    cols = (colors[rec.track_valid] / 255.0 if colors is not None
            else np.full((len(pts), 3), 0.8))
    lines = ["#VRML V2.0 utf8", "Shape { geometry PointSet {", "coord Coordinate { point ["]
    lines += [f"{p[0]} {p[1]} {p[2]}," for p in pts]
    lines += ["] }", "color Color { color ["]
    lines += [f"{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}," for c in cols]
    lines += ["] } } }"]
    Path(path).write_text("\n".join(lines) + "\n")
