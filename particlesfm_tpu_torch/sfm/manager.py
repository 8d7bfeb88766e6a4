"""Multi-model reconstruction manager (numbered-subdir output + largest pick)
(port of particlesfm_tpu/sfm/manager.py).

Counterpart of the reference's ReconstructionManager
(upstream sfm/gmapper/src/base/reconstruction_manager.h:41-78 — models
written to sub-folders "0", "1", ... ) and the largest-model selection in
compute_model_stats (upstream sfm/main_sfm.py:52-93: pick by image
count, copy its bins up next to the numbered dirs).

A disconnected sequence (cut, tracking dropout) yields several covisibility
components; the reference's global mapper reconstructs the largest and the
manager keeps every recovered model. Here: run the mapper, mask out the frames
it registered, and re-run on the remainder until nothing reconstructs.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from ..tracks.store import TrackArrays
from ..utils.config import SfmConfig
from .mapper import Reconstruction, run_global_mapper


def run_reconstruction_manager(
    tracks: TrackArrays,
    height: int,
    width: int,
    cfg: Optional[SfmConfig] = None,
    max_models: int = 4,
    params=None,
    log=print,
    focal_bound_frac=None,
    device="cuda",
) -> List[Reconstruction]:
    """Recover every reconstructable component, largest-first order not
    guaranteed (use `largest_model` to select). The mapper runs on `device`."""
    cfg = cfg or SfmConfig()
    models: List[Reconstruction] = []
    mask = tracks.mask.copy()
    for k in range(max_models):
        # labels MUST ride along: without them the mapper's seg-geometry gate
        # never fires in the pipeline (measured ATE 0.164 vs 0.017 gated at
        # protocol scale)
        sub = TrackArrays(xy=tracks.xy, mask=mask, labels=tracks.labels)
        # enough frames with enough observations left? COLMAP's mapper only
        # keeps models with >= min_model_size (10) registered images; a 5-frame
        # residual model costs a full mapper pass (fresh compile shapes) for
        # negligible value (measured 185 s on seq_06 round 5)
        frames_alive = (mask.sum(axis=0) >= cfg.min_num_matches).sum()
        # short inputs (split-sequence recovery) keep a relative bar so a
        # 12-frame video can still yield a 5-frame second component
        bar = (3 if k == 0
               else max(3, min(cfg.min_model_size, tracks.num_frames // 4)))
        if frames_alive < bar:
            break
        rec = run_global_mapper(sub, height, width, cfg, params=params, log=log,
                                focal_bound_frac=focal_bound_frac, device=device)
        if rec.num_registered < 3:
            break
        models.append(rec)
        log(f"[manager] model {k}: {rec.num_registered} images, "
            f"{int(rec.track_valid.sum())} points")
        # mask out observations in the registered frames and continue on the rest
        mask = mask & ~rec.registered[None, :]
    if not models:
        log("[manager] no reconstructable component")
    return models


def largest_model(models: List[Reconstruction]) -> Optional[Reconstruction]:
    """Reference selection rule: most registered images (main_sfm.py:58-66)."""
    if not models:
        return None
    return max(models, key=lambda m: m.num_registered)


def write_models(
    models: List[Reconstruction],
    model_dir,
    image_names=None,
    log=print,
) -> Optional[Reconstruction]:
    """Write numbered subdirs 0/, 1/, ... plus the largest model's bins at the
    top level (the reference's on-disk layout after compute_model_stats)."""
    import shutil

    from .export import write_colmap_model

    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    best = largest_model(models)
    best_k = None
    for k, rec in enumerate(models):
        write_colmap_model(rec, model_dir / str(k), image_names)
        if rec is best:
            best_k = k
    if best is not None:
        # largest-copy layout (main_sfm.py:52-93): copy the serialized bins up
        # instead of re-encoding the model (a 240k-point model costs seconds
        # to serialize; the copy is an OS file copy)
        for name in ("cameras.bin", "images.bin", "points3D.bin"):
            shutil.copyfile(model_dir / str(best_k) / name, model_dir / name)
        log(f"[manager] largest model: {best.num_registered} images")
    return best
