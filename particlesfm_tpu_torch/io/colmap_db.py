"""COLMAP SQLite database export, for external COLMAP/GLOMAP mappers
(port of particlesfm_tpu/io/colmap_db.py).

Same schema and blob encodings as the reference's database layer
(upstream sfm/colmap_utils/database.py): cameras, images, keypoints,
descriptors, matches, two_view_geometries; pair_id = 2147483647 * image_id1 +
image_id2 (database.py:113-122). The export reproduces upstream's
track->match conversion (traj_to_matches, sfm/matches_from_flow.py:51-118):
every track observation becomes a keypoint (+0.5 px COLMAP origin shift,
import_feature_matches.py:83), and each observation is matched to at most
sample_k other observations uniformly strided along its track. The database
lets the trajectories drive `colmap mapper` / `glomap mapper` unchanged
(upstream's incremental_colmap / global_glomap modes) where those binaries
exist.
"""
from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tracks.store import TrackArrays

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_from_image_ids(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


def image_ids_from_pair_id(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _blob(a, dtype):
    a = np.ascontiguousarray(a, dtype)
    return (a.shape[0], a.shape[1] if a.ndim > 1 else 1, a.tobytes())


class ColmapDatabase:
    def __init__(self, path):
        self.conn = sqlite3.connect(str(path))
        self.conn.executescript(_SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def add_camera(self, model_id, width, height, params, prior_focal=False,
                   camera_id=None):
        params = np.asarray(params, np.float64)
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, width, height, params.tobytes(), int(prior_focal)),
        )
        return cur.lastrowid

    def add_image(self, name, camera_id, image_id=None):
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, None, None, None, None, None, None, None),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id, keypoints):
        """keypoints [N, 2] pixel coords; stored as COLMAP [N, 6] affine kps."""
        kp = np.asarray(keypoints, np.float32)
        full = np.zeros((len(kp), 6), np.float32)
        full[:, :2] = kp
        full[:, 2] = 1.0
        full[:, 5] = 1.0
        r, c, b = _blob(full, np.float32)
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)", (image_id, r, c, b)
        )

    def add_descriptors(self, image_id, desc):
        r, c, b = _blob(np.asarray(desc, np.uint8), np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)", (image_id, r, c, b)
        )

    def add_matches(self, id1, id2, matches):
        m = np.asarray(matches, np.uint32)
        if id1 > id2:
            m = m[:, ::-1]
        r, c, b = _blob(m, np.uint32)
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id_from_image_ids(id1, id2), r, c, b),
        )

    def add_two_view_geometry(self, id1, id2, matches, F=None, E=None, H=None,
                              qvec=None, tvec=None, config=2):
        m = np.asarray(matches, np.uint32)
        if id1 > id2:
            m = m[:, ::-1]
        r, c, b = _blob(m, np.uint32)
        eye = np.eye(3, dtype=np.float64)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pair_id_from_image_ids(id1, id2), r, c, b, config,
                np.asarray(F if F is not None else eye, np.float64).tobytes(),
                np.asarray(E if E is not None else eye, np.float64).tobytes(),
                np.asarray(H if H is not None else eye, np.float64).tobytes(),
                np.asarray(qvec if qvec is not None else [1, 0, 0, 0], np.float64).tobytes(),
                np.asarray(tvec if tvec is not None else [0, 0, 0], np.float64).tobytes(),
            ),
        )

    def read_matches(self, id1, id2):
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id = ?",
            (pair_id_from_image_ids(id1, id2),),
        ).fetchone()
        if row is None:
            return None
        r, c, b = row
        return np.frombuffer(b, np.uint32).reshape(r, c)


def tracks_to_matches(
    tracks: TrackArrays,
    remove_dynamic: bool = True,
    sample_k: int = 20,
):
    """Track tensors -> per-image keypoints + pairwise match index lists.

    Reproduces traj_to_matches (matches_from_flow.py:51-118): dynamic-labeled
    observations are skipped; every observation matches <= sample_k other
    observations of its track, uniformly strided.
    Returns (keypoints {img: [N,2]}, matches {(i,j): [M,2] keypoint indices}).
    """
    mask = tracks.mask.copy()
    if remove_dynamic and tracks.labels is not None:
        mask &= tracks.labels == 0
    T = tracks.num_frames
    keypoints: Dict[int, List] = {t: [] for t in range(T)}
    kp_index = {}   # (track, frame) -> keypoint idx in frame
    for n in range(tracks.num_tracks):
        for t in np.nonzero(mask[n])[0]:
            kp_index[(n, int(t))] = len(keypoints[int(t)])
            keypoints[int(t)].append(tracks.xy[n, t])
    matches: Dict[Tuple[int, int], List] = {}
    for n in range(tracks.num_tracks):
        frames = np.nonzero(mask[n])[0]
        L = len(frames)
        if L < 2:
            continue
        for a_idx, a in enumerate(frames):
            others = np.delete(frames, a_idx)
            if len(others) > sample_k:
                sel = np.round(np.linspace(0, len(others) - 1, sample_k)).astype(int)
                others = others[sel]
            for b in others:
                i, j = (int(a), int(b)) if a < b else (int(b), int(a))
                fa, fb = (a, b) if a < b else (b, a)
                matches.setdefault((i, j), []).append(
                    (kp_index[(n, int(fa))], kp_index[(n, int(fb))])
                )
    kps = {t: np.asarray(v, np.float32).reshape(-1, 2) for t, v in keypoints.items()}
    mts = {k: np.unique(np.asarray(v, np.uint32), axis=0) for k, v in matches.items()}
    return kps, mts


def export_tracks_to_database(
    db_path,
    tracks: TrackArrays,
    height: int,
    width: int,
    image_names: Optional[List[str]] = None,
    remove_dynamic: bool = True,
    sample_k: int = 20,
    pairs_txt: Optional[str] = None,
):
    """Write a COLMAP database + image_match_pairs.txt from track tensors.

    Counterpart of build_database (upstream sfm/main_sfm.py:31-50) minus
    the subprocess hops: single shared SIMPLE_PINHOLE camera with the 1.2 focal
    prior, keypoints with the +0.5 px origin shift, matches as two-view
    geometries (config=2, already verified by our RANSAC upstream).
    """
    T = tracks.num_frames
    if image_names is None:
        image_names = [f"{t:06d}.png" for t in range(T)]
    db = ColmapDatabase(db_path)
    cam_id = db.add_camera(0, width, height,
                           [1.2 * max(width, height), width / 2.0, height / 2.0],
                           prior_focal=False)
    img_ids = {}
    kps, mts = tracks_to_matches(tracks, remove_dynamic, sample_k)
    for t in range(T):
        img_ids[t] = db.add_image(image_names[t], cam_id)
        db.add_keypoints(img_ids[t], kps.get(t, np.zeros((0, 2))) + 0.5)
        db.add_descriptors(img_ids[t], np.zeros((len(kps.get(t, [])), 128), np.uint8))
    pair_lines = []
    for (i, j), m in sorted(mts.items()):
        db.add_matches(img_ids[i], img_ids[j], m)
        db.add_two_view_geometry(img_ids[i], img_ids[j], m)
        pair_lines.append(f"{image_names[i]} {image_names[j]}")
    db.close()
    if pairs_txt is not None:
        Path(pairs_txt).write_text("\n".join(pair_lines) + "\n")
    return img_ids
