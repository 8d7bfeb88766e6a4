"""COLMAP sparse-model I/O (binary + text), written from the public format spec.
(copy of particlesfm_tpu/io/colmap_model.py; numpy only).

Provides the same interop surface as the reference's readers/writers
(upstream sfm/colmap_utils/read_write_model.py): cameras/images/points3D
as namedtuple-like records, so our reconstructions can be consumed by COLMAP
tooling and the reference's converters/evaluators.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict

import numpy as np

CAMERA_MODEL_NAMES = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 3 + 1),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODEL_NAMES.items()}
INVALID_POINT3D = np.uint64(np.iinfo(np.uint64).max)


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray          # (4,) wxyz, world->cam
    tvec: np.ndarray          # (3,)
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray           # (3,)
    rgb: np.ndarray           # (3,) uint8
    error: float
    image_ids: np.ndarray     # (K,)
    point2D_idxs: np.ndarray  # (K,)


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODEL_NAMES[model_id]
            params = np.array(_read(f, "<" + "d" * np_))
            cams[cid] = Camera(cid, name, w, h, params)
    return cams


def write_cameras_binary(cams: Dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(np.asarray(cam.params, np.float64).tobytes())


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts), dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
            xys = np.stack([data["x"], data["y"]], axis=-1) if npts else np.zeros((0, 2))
            pids = data["pid"].copy() if npts else np.zeros((0,), np.int64)
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode(), xys, pids)
    return images


def write_images_binary(images: Dict[int, Image], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, np.float64).tobytes())
            f.write(np.asarray(im.tvec, np.float64).tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            npts = len(im.point3D_ids)
            f.write(struct.pack("<Q", npts))
            if npts:
                rec = np.zeros(npts, dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
                rec["x"], rec["y"] = im.xys[:, 0], im.xys[:, 1]
                rec["pid"] = im.point3D_ids
                f.write(rec.tobytes())


def read_points3D_binary(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<ddd"))
            rgb = np.array(_read(f, "<BBB"), np.uint8)
            (err,) = _read(f, "<d")
            (tl,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * tl), dtype=[("iid", "<i4"), ("p2d", "<i4")])
            pts[pid] = Point3D(pid, xyz, rgb, err, track["iid"].copy(), track["p2d"].copy())
    return pts


def write_points3D_binary(pts: Dict[int, Point3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<Q", p.id))
            f.write(np.asarray(p.xyz, np.float64).tobytes())
            f.write(np.asarray(p.rgb, np.uint8).tobytes())
            f.write(struct.pack("<d", float(p.error)))
            tl = len(p.image_ids)
            f.write(struct.pack("<Q", tl))
            if tl:
                rec = np.zeros(tl, dtype=[("iid", "<i4"), ("p2d", "<i4")])
                rec["iid"], rec["p2d"] = p.image_ids, p.point2D_idxs
                f.write(rec.tobytes())


def write_model_binary(cameras, images, points3D, out_dir) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_cameras_binary(cameras, out / "cameras.bin")
    write_images_binary(images, out / "images.bin")
    write_points3D_binary(points3D, out / "points3D.bin")


def read_model_binary(model_dir):
    d = Path(model_dir)
    return (
        read_cameras_binary(d / "cameras.bin"),
        read_images_binary(d / "images.bin"),
        read_points3D_binary(d / "points3D.bin"),
    )


def write_model_text(cameras, images, points3D, out_dir) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(x)) for x in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")
    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            obs = " ".join(
                f"{float(x)} {float(y)} {int(pid)}" for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(obs + "\n")
    with open(out / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in points3D.values():
            xyz = " ".join(repr(float(x)) for x in p.xyz)
            rgb = " ".join(str(int(x)) for x in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.id} {xyz} {rgb} {float(p.error)} {track}\n")


def read_model_text(model_dir):
    d = Path(model_dir)
    cameras, images, points = {}, {}, {}
    for line in (d / "cameras.txt").read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        cameras[cid] = Camera(cid, model, w, h, np.array([float(x) for x in parts[4:]]))
    lines = [l for l in (d / "images.txt").read_text().splitlines() if l and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        obs = lines[i + 1].split()
        xys = np.array([[float(obs[j]), float(obs[j + 1])] for j in range(0, len(obs), 3)]) if obs else np.zeros((0, 2))
        pids = np.array([int(obs[j + 2]) for j in range(0, len(obs), 3)], np.int64) if obs else np.zeros((0,), np.int64)
        images[iid] = Image(iid, qvec, tvec, cam_id, name, xys, pids)
    for line in (d / "points3D.txt").read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        pid = int(parts[0])
        xyz = np.array([float(x) for x in parts[1:4]])
        rgb = np.array([int(x) for x in parts[4:7]], np.uint8)
        err = float(parts[7])
        rest = parts[8:]
        iids = np.array([int(rest[j]) for j in range(0, len(rest), 2)], np.int32)
        p2ds = np.array([int(rest[j + 1]) for j in range(0, len(rest), 2)], np.int32)
        points[pid] = Point3D(pid, xyz, rgb, err, iids, p2ds)
    return cameras, images, points
