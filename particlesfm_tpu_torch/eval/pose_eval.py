"""Pose evaluation harness — evo-equivalent ATE/RPE protocol.
(copy of particlesfm_tpu/eval/pose_eval.py; numpy only).

Parity with the reference's evaluation scripts
(upstream evaluation_evo/eval_sintel.py, eval_scannet.py):
  - estimated poses are the converted 3x4 world2cam txts
    (colmap_outputs_converted/poses/*.txt, sfm/convert.py:43-96);
  - a sequence FAILS if fewer than 80% of frames registered (eval_sintel.py:96-98);
  - ATE = RMSE of camera centers after Sim3 Umeyama alignment (evo ape -as);
  - RPE = relative pose error at delta = 1 frame, translation scaled by the
    Sim3-aligned scale (evo rpe all pairs).

GT readers: Sintel .cam binary files (TAG + K 3x3 + world2cam 3x4 doubles) and
ScanNet per-frame 4x4 cam2world txts.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..geometry.alignment import ate_rmse, rpe

TAG_FLOAT = 202021.25


def read_sintel_cam(path):
    """Sintel .cam file -> (K [3,3], world2cam [3,4]) (sintel_io.cam_read)."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if not np.isclose(tag, TAG_FLOAT):
            raise ValueError(f"{path}: bad .cam magic {tag}")
        M = np.frombuffer(f.read(8 * 9), np.float64).reshape(3, 3)
        N = np.frombuffer(f.read(8 * 12), np.float64).reshape(3, 4)
    return M.copy(), N.copy()


def write_sintel_cam(path, K, w2c):
    with open(path, "wb") as f:
        f.write(np.float32(TAG_FLOAT).tobytes())
        f.write(np.asarray(K, np.float64).tobytes())
        f.write(np.asarray(w2c, np.float64).tobytes())


def read_scannet_pose(path):
    """ScanNet pose txt: 4x4 cam2world -> 3x4 world2cam (eval_scannet.py:33-60)."""
    c2w = np.loadtxt(path).reshape(4, 4)
    w2c = np.linalg.inv(c2w)
    return w2c[:3]


def load_pose_dir(pose_dir) -> Dict[str, np.ndarray]:
    """Estimated 3x4 world2cam txts keyed by stem."""
    out = {}
    for p in sorted(Path(pose_dir).glob("*.txt")):
        out[p.stem] = np.loadtxt(p).reshape(3, 4)
    return out


@dataclass
class SequenceResult:
    name: str
    registered: int
    total: int
    failed: bool
    ate: Optional[float] = None
    rpe_trans: Optional[float] = None
    rpe_rot_deg: Optional[float] = None


def _centers_rots(w2c_list):
    R = np.stack([p[:, :3] for p in w2c_list])
    t = np.stack([p[:, 3] for p in w2c_list])
    centers = -np.einsum("nji,nj->ni", R, t)       # -R^T t
    rots_c2w = np.swapaxes(R, 1, 2)
    return rots_c2w, centers


def evaluate_sequence(
    est_poses: Dict[str, np.ndarray],
    gt_poses: Dict[str, np.ndarray],
    name: str = "",
    min_registered_ratio: float = 0.8,
) -> SequenceResult:
    """ATE/RPE for one sequence; both inputs are stem -> 3x4 world2cam."""
    common = sorted(set(est_poses) & set(gt_poses))
    total = len(gt_poses)
    if total == 0 or len(common) < min_registered_ratio * total:
        return SequenceResult(name, len(common), total, failed=True)
    est_R, est_c = _centers_rots([est_poses[k] for k in common])
    gt_R, gt_c = _centers_rots([gt_poses[k] for k in common])
    ate = ate_rmse(est_c, gt_c, with_scale=True)
    rpe_t, rpe_r = rpe(est_R, est_c, gt_R, gt_c, delta=1)
    return SequenceResult(
        name, len(common), total, failed=False,
        ate=ate, rpe_trans=rpe_t, rpe_rot_deg=rpe_r,
    )


def summarize(results: List[SequenceResult]) -> str:
    ok = [r for r in results if not r.failed]
    lines = []
    for r in results:
        if r.failed:
            lines.append(f"{r.name}: FAILED ({r.registered}/{r.total} registered)")
        else:
            lines.append(
                f"{r.name}: ATE {r.ate:.4f}  RPE-t {r.rpe_trans:.4f}  "
                f"RPE-r {r.rpe_rot_deg:.4f}deg  ({r.registered}/{r.total})"
            )
    if ok:
        lines.append(
            f"MEAN over {len(ok)} sequences: ATE {np.mean([r.ate for r in ok]):.4f}  "
            f"RPE-t {np.mean([r.rpe_trans for r in ok]):.4f}  "
            f"RPE-r {np.mean([r.rpe_rot_deg for r in ok]):.4f}deg  "
            f"failures {len(results) - len(ok)}/{len(results)}"
        )
    return "\n".join(lines)
