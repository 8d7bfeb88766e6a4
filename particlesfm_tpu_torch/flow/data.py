"""Flow training data: rendered pairs from the synth world generator (port of
particlesfm_tpu/flow/data.py; numpy only, the same seed gives the same bytes).

The in-environment stand-in for the FlyingChairs/Things data the reference's
RAFT fork was trained on. Pairs are rendered as small sensor WINDOWS of a
full-scale virtual camera (same focal as the 1024x436 acceptance protocol,
offset principal point), so the flow statistics the net trains on match the
benchmark sequences.
"""
from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass

import numpy as np


@dataclass
class FlowPairSpec:
    crop_hw: tuple = (256, 320)
    sensor_hw: tuple = (436, 1024)     # virtual full sensor (benchmark protocol)
    frames: int = 5
    # Keep stride-1 flow mostly under ~30 px (mean ~12): the first dataset cut
    # used (0.15-0.55, 0.3-1.0) which at f~1.2*1024 produced mean-104 px flow —
    # far outside the correlation pyramid's sweet spot; the net plateaued at
    # the predict-zero loss. These ranges match the acceptance sequences.
    motion_scale: tuple = (0.04, 0.22)
    rot_scale: tuple = (0.06, 0.35)
    p_dynamic: float = 0.6
    max_dynamic: int = 2
    # Fast-scene mixture: protocol sequences pair 6-13 near-field static
    # objects with motion up to 0.20, producing stride-1 flow to ~43 px and
    # stride-2 to ~85 px. The base ranges above (with 0-3 objects) leave that
    # population out of the train distribution — measured stride-2 EPE was
    # bimodal, 0.5 px in-range vs 17-20 px on pairs beyond the trained motion
    # range, and the fast acceptance sequences (mean stride-1 flow ~20 px)
    # scored 10-70x worse ATE than slow ones. Fast scenes widen coverage past
    # the protocol's own range (margin), with the near-object counts that
    # create the large-flow population.
    p_fast: float = 0.45
    fast_motion_scale: tuple = (0.12, 0.34)
    fast_rot_scale: tuple = (0.08, 0.45)
    fast_static_obj: tuple = (5, 13)


def _gen_scene_pairs(args):
    """Worker: render one scene's frames and emit (img_a, img_b, flow) pairs
    for strides 1 and 2, both directions."""
    seed, spec = args
    from ..synth import random_scene

    rng = np.random.default_rng(seed)
    h, w = spec.crop_hw
    sh, sw = spec.sensor_hw
    focal = 1.2 * sw * rng.uniform(0.85, 1.15)
    # crop window top-left (ox, oy) on the virtual sensor; the crop camera's
    # principal point in crop coordinates is sensor-center minus the offset
    ox = rng.uniform(0, sw - w)
    oy = rng.uniform(0, sh - h)
    ndyn = int(rng.integers(1, spec.max_dynamic + 1)) if rng.random() < spec.p_dynamic else 0
    if rng.random() < spec.p_fast:
        motion, rot = spec.fast_motion_scale, spec.fast_rot_scale
        nobj = (int(spec.fast_static_obj[0]), int(spec.fast_static_obj[1]))
    else:
        motion, rot = spec.motion_scale, spec.rot_scale
        nobj = (0, 4)
    sc = random_scene(
        rng,
        num_views=spec.frames,
        height=h,
        width=w,
        focal=focal,
        num_dynamic=ndyn,
        motion_scale=float(rng.uniform(*motion)),
        rot_scale=float(rng.uniform(*rot)),
        principal=(sw / 2.0 - ox, sh / 2.0 - oy),
        # match the acceptance scenes' depth-contrast statistics (static
        # foreground objects produce the near-field large-flow population)
        num_static_obj=int(rng.integers(*nobj)),
    )
    imgs = [sc.render(t) for t in range(spec.frames)]
    pairs = []
    for stride in (1, 2):
        for a in range(0, spec.frames - stride, stride):
            b = a + stride
            pairs.append((imgs[a], imgs[b], sc.gt_flow(a, b).astype(np.float16)))
            pairs.append((imgs[b], imgs[a], sc.gt_flow(b, a).astype(np.float16)))
    return pairs


def generate_dataset(num_scenes: int, spec: FlowPairSpec | None = None, seed: int = 0,
                     workers: int = 4, log=print):
    """Render `num_scenes` scenes in parallel; returns (images1 [P,H,W,3] u8,
    images2 [P,H,W,3] u8, flows [P,H,W,2] f16)."""
    spec = spec or FlowPairSpec()
    jobs = [(seed * 100003 + i, spec) for i in range(num_scenes)]
    out = []
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            for i, pairs in enumerate(pool.imap_unordered(_gen_scene_pairs, jobs)):
                out.extend(pairs)
                if (i + 1) % 10 == 0:
                    log(f"[flowdata] {i + 1}/{num_scenes} scenes, {len(out)} pairs")
    else:
        for i, job in enumerate(jobs):
            out.extend(_gen_scene_pairs(job))
    i1 = np.stack([p[0] for p in out])
    i2 = np.stack([p[1] for p in out])
    fl = np.stack([p[2] for p in out])
    return i1, i2, fl


def save_dataset(path, i1, i2, fl):
    np.savez_compressed(path, images1=i1, images2=i2, flows=fl)


def load_dataset(path):
    z = np.load(path)
    return z["images1"], z["images2"], z["flows"]
