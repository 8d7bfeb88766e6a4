"""Hold the port's selfcal, depth and motion-seg results from a GPU run
against the JAX package on the same inputs, on the CPU.

    python3 chip_smoke.py --dump DIR                # on the GPU
    python scripts/compare_chip_dump_with_jax.py DIR/slice_dump.npz

The dump holds the selfcal correspondences the card composed from the run's
flows with the card's focal from them under the reference's PRNGKey(0)
draws, the run's normalized depth of all frames (float16, as the seg stage
sees it) with the first 4 rendered frames, and the first and last chunk of
the seg stage's model input (u16 tracks) with the card's logits. Prints:

- [selfcal] JAX's estimate_shared_focal on the card's correspondences under
  PRNGKey(0) (the card's draws) against the card's focal, beside the
  reference's own spread: jit against eager, inputs scaled by 1 +- 2^-22,
  and PRNGKeys 1-4;
- [depth] the JAX depth apply against the card's depth on the 4 frames;
- [motionseg] the JAX seg apply against the card's logits on the chunks;
- [sfm] the JAX package's sfm_stage and the port's (on the CPU) on the
  seeded subset of the run's labeled tracks beside the dump (tracks.npz,
  selfcal.json), against the card's poses on the same subset: registered
  frames, Sim3 ATE of each against the renderer's poses, and the Sim3 ATE
  between the pose sets; the card's full-set result beside them; each
  package again with the track coordinates scaled by 1 + 2^-22 (its own
  movement under rounding), and the mapper's first two-view RANSAC of both
  packages on the subset's pair tensors with the reference's draws, also
  under that scaling;
- [sfm-modes] the same for the incremental mapper and for linear and
  nonlinear positions: JAX's and the port's (CPU) sfm_stage on the subset
  against the card's poses on it (registered sets, Sim3 ATE against the
  renderer and between the pose sets, focal);
- [sfm-pnp] the incremental run's last PnP call (the round where every
  candidate failed) on the card's inputs: inlier counts of the card, the
  port on the CPU and JAX with the same key, and where in the image its
  2D points lie;
- [stride2] the flow stage of each package (the port on the CPU) on the
  dump's 4 frames at flow.infer_scale=0.5 with the 4 px stride-2 fallback:
  the share of stride-2 pixels each package takes from the composition,
  and where the two decisions differ;
- [sweep] for each sequence of chip_smoke.py's [sweep] phase (the dump's
  sweep_<name>/ directories: a seeded subset of its labeled tracks, its
  selfcal.json and the card's SfM poses on the subset in sweep.npz): the
  JAX package's and the port's (CPU) sfm_stage on the subset against the
  card's poses: registered frames, Sim3 ATE against the renderer and
  between the pose sets, and BA's focal; each package again with the track
  coordinates scaled by 1 + 2^-22 (its own movement under rounding);
- [mesh] the JAX package's sharded_bundle_adjust (shard_map over 4 virtual
  CPU devices, XLA_FLAGS=--xla_force_host_platform_device_count=4, set
  here) on [slice]'s last BA problem, against the card's 4-shard result on
  it: cost, q, t and X differences.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # both packages

import numpy as np  # noqa: E402


def compare_selfcal(z) -> None:
    import jax
    import jax.numpy as jnp

    import particlesfm_tpu  # noqa: F401  (matmul precision)
    from particlesfm_tpu.globalsfm.selfcal import estimate_shared_focal

    H, W = (int(v) for v in z["sc_hw"])
    hi = max(H, W)

    def focal(key, s=1.0):
        est = estimate_shared_focal(
            jax.random.PRNGKey(key), jnp.asarray(z["sc_uv1"] * np.float32(s)),
            jnp.asarray(z["sc_uv2"] * np.float32(s)), jnp.asarray(z["sc_ok"]),
            jnp.asarray([W / 2.0 * s, H / 2.0 * s], jnp.float32), 0.3 * hi, 3.0 * hi,
            thres_px_sq=4.0)
        return float(est.focal), float(est.confidence), int(est.num_pairs)

    f_jit, conf, pairs = focal(0)
    with jax.disable_jit():
        f_eager, conf_eager, _ = focal(0)
    rounds = [focal(0, 1.0 + e) for e in (2.0 ** -22, -(2.0 ** -22))]
    f_round = [r[0] for r in rounds]
    f_keys = [focal(k)[0] for k in range(1, 5)]
    card, run = float(z["sc_focal_card"]), float(z["sc_focal_run"])
    rel = [abs(f / f_jit - 1) for f in f_round]
    print(f"[selfcal] {z['sc_ok'].shape[0]} pairs x {z['sc_ok'].shape[1]} points "
          f"({int(z['sc_ok'].sum())} kept): JAX (jit, PRNGKey(0)) focal {f_jit:.3f} px, "
          f"confidence {conf:.3f}, num_pairs {pairs}; the card with the same draws "
          f"{card:.3f} px ({card / f_jit - 1:+.3e}), confidence "
          f"{float(z['sc_conf_card']):.3f}, num_pairs {int(z['sc_pairs_card'])}; JAX "
          f"eager {f_eager:.3f} px ({f_eager / f_jit - 1:+.3e}), confidence "
          f"{conf_eager:.3f}; JAX with inputs x (1 +- 2^-22) {f_round[0]:.3f} / "
          f"{f_round[1]:.3f} px (max {max(rel):.3e}), confidence "
          f"{rounds[0][1]:.3f} / {rounds[1][1]:.3f}; JAX with "
          f"PRNGKeys 1-4 {[round(f, 3) for f in f_keys]} px; the run's own focal "
          f"(torch.Generator draws) {run:.3f} px ({run / f_jit - 1:+.3e})")


def _centers(qvec, tvec) -> np.ndarray:
    import torch

    from particlesfm_tpu_torch.geometry import se3

    return se3.camera_center(torch.as_tensor(qvec), torch.as_tensor(tvec)).numpy()


def _sfm_run(pkg: str, tr, H: int, W: int, selfcal_dir: Path, names, scale=1.0):
    """The JAX package's (`pkg` "JAX") or the port's (on the CPU) sfm_stage
    at the default config on the tracks, their coordinates scaled by
    `scale`, with `selfcal_dir`'s selfcal.json as the focal prior."""
    import shutil
    import tempfile

    from particlesfm_tpu.pipeline.stages import sfm_stage as jsfm_stage
    from particlesfm_tpu.tracks.store import TrackArrays as JTracks
    from particlesfm_tpu.utils.config import Config as JConfig
    from particlesfm_tpu_torch.pipeline.stages import sfm_stage
    from particlesfm_tpu_torch.tracks.store import TrackArrays
    from particlesfm_tpu_torch.utils.config import Config

    xy = (tr.xy * np.float32(scale)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(selfcal_dir / "selfcal.json", Path(tmp) / "selfcal.json")
        if pkg == "JAX":
            return jsfm_stage(JTracks(xy, tr.mask, tr.labels), H, W, Path(tmp), JConfig(),
                              names, log=lambda *a: None)
        return sfm_stage(TrackArrays(xy, tr.mask, tr.labels), H, W, Path(tmp), Config(),
                         "cpu", names, log=lambda *a: None)


def compare_sfm(z, dump_dir: Path) -> None:
    import json

    import jax
    import jax.numpy as jnp
    import torch

    from particlesfm_tpu.globalsfm.twoview import estimate_relative_poses as jerp
    from particlesfm_tpu_torch.geometry.alignment import ate_rmse
    from particlesfm_tpu_torch.globalsfm.twoview import estimate_relative_poses, pair_draws
    from particlesfm_tpu_torch.sfm.correspondences import build_pair_tensors
    from particlesfm_tpu_torch.tracks.store import TrackArrays
    from particlesfm_tpu_torch.utils.config import Config

    tr = TrackArrays.load(dump_dir / "tracks.npz")
    H, W = (int(v) for v in z["sfm_hw"])
    gt_c = _centers_w2c(z["sfm_gt_w2c"])
    T = len(gt_c)
    names = [f"{i:06d}.ppm" for i in range(T)]
    eps = np.float32(1 + 2.0 ** -22)      # a rounding-only change of the tracks

    sets = {"card (full set)": (z["sfm_registered"], _centers(z["sfm_qvec"], z["sfm_tvec"]),
                                float(z["sfm_params"][0])),
            "card": (z["sfm_sub_registered"], _centers(z["sfm_sub_qvec"], z["sfm_sub_tvec"]),
                     float(z["sfm_sub_params"][0]))}
    for pkg in ("JAX", "port (CPU)"):
        for tag, scale in (("", 1.0), (" x (1 + 2^-22)", eps)):
            rec = _sfm_run(pkg, tr, H, W, dump_dir, names, scale)
            sets[pkg + tag] = (rec.registered, _centers(rec.qvec, rec.tvec), float(rec.params[0]))
    print(f"[sfm] the dump's {tr.num_tracks} labeled tracks, {T} frames at {W}x{H}:")
    for name, (reg, c, f) in sets.items():
        print(f"[sfm]   {name}: {int(reg.sum())}/{T} registered, Sim3 ATE against the "
              f"renderer {ate_rmse(c[reg], gt_c[reg]):.5f}, focal {f:.2f} px (renderer "
              f"{float(z['sfm_gt_focal']):.2f}), unregistered {np.nonzero(~reg)[0].tolist()}")
    for a, b in (("JAX", "port (CPU)"), ("JAX", "card"), ("JAX", "JAX x (1 + 2^-22)"),
                 ("port (CPU)", "port (CPU) x (1 + 2^-22)")):
        (ra, ca, _), (rb, cb, _) = sets[a], sets[b]
        both = ra & rb
        print(f"[sfm]   {a} vs {b}: same registered set {bool((ra == rb).all())}, "
              f"Sim3 ATE between the pose sets {ate_rmse(ca[both], cb[both]):.3e}")

    # the mapper's first two-view RANSAC on these tracks, the reference's draws
    cfg = Config().sfm
    focal = json.loads((dump_dir / "selfcal.json").read_text())["focal"]
    pt = build_pair_tensors(tr, tr.mask.copy(), cfg.min_num_matches, seed=cfg.seed,
                            max_span=cfg.max_pair_span)
    P = len(pt.pairs)
    pp = np.float32([W / 2.0, H / 2.0])
    x1 = ((pt.uv1 - pp) / np.float32(focal)).astype(np.float32)
    x2 = ((pt.uv2 - pp) / np.float32(focal)).astype(np.float32)
    thr = np.full(P, (cfg.geometric_verification_max_error_px / focal) ** 2, np.float32)

    def counts(pkg, s):
        s = np.float32(s)
        args = (x1 * s, x2 * s, pt.mask, thr * s * s)
        if pkg == "JAX":
            return np.asarray(jerp(jax.random.PRNGKey(cfg.seed),
                                   *(jnp.asarray(a) for a in args)).num_inliers)
        return estimate_relative_poses(*(torch.from_numpy(np.ascontiguousarray(a))
                                         for a in args),
                                       u=torch.from_numpy(pair_draws(cfg.seed, P, (64, 8)))
                                       ).num_inliers.numpy()

    c = {(pkg, s): counts(pkg, s) for pkg in ("JAX", "port") for s in (1.0, eps, 2 - eps)}
    for a, b in ((("JAX", 1.0), ("port", 1.0)), (("JAX", 1.0), ("JAX", eps)),
                 (("JAX", 1.0), ("JAX", 2 - eps)), (("port", 1.0), ("port", eps))):
        d = np.abs(c[a].astype(int) - c[b])
        print(f"[sfm]   two-view RANSAC on the {P} pairs, {a[0]} x {a[1]:.8f} vs {b[0]} x "
              f"{b[1]:.8f}: inlier counts equal on {100 * (d == 0).mean():.1f}% of pairs, "
              f"max |diff| {d.max()}, mean |diff| {d.mean():.3f}")


def compare_sfm_modes(z, dump_dir: Path) -> None:
    import shutil
    import tempfile

    from particlesfm_tpu.pipeline.stages import sfm_stage as jsfm_stage
    from particlesfm_tpu.tracks.store import TrackArrays as JTracks
    from particlesfm_tpu.utils.config import Config as JConfig
    from particlesfm_tpu_torch.geometry.alignment import ate_rmse
    from particlesfm_tpu_torch.pipeline.stages import sfm_stage
    from particlesfm_tpu_torch.tracks.store import TrackArrays
    from particlesfm_tpu_torch.utils.config import Config

    tr = TrackArrays.load(dump_dir / "tracks.npz")
    H, W = (int(v) for v in z["sfm_hw"])
    gt_c = _centers_w2c(z["sfm_gt_w2c"])
    T = len(gt_c)
    names = [f"{i:06d}.ppm" for i in range(T)]

    def config(cls, mode):
        cfg = cls()
        if mode == "incremental":
            cfg.sfm.sfm_type = "incremental"
        else:
            cfg.sfm.position.method = mode
        return cfg

    for mode in ("incremental", "linear", "nonlinear"):
        if f"sfm_sub_{mode}_qvec" not in z.files:
            continue
        sets = {"card": (z[f"sfm_sub_{mode}_registered"],
                         _centers(z[f"sfm_sub_{mode}_qvec"], z[f"sfm_sub_{mode}_tvec"]),
                         float(z[f"sfm_sub_{mode}_params"][0]))}
        for pkg in ("JAX", "port (CPU)"):
            with tempfile.TemporaryDirectory() as tmp:
                shutil.copy(dump_dir / "selfcal.json", Path(tmp) / "selfcal.json")
                if pkg == "JAX":
                    rec = jsfm_stage(JTracks(tr.xy, tr.mask, tr.labels), H, W, Path(tmp),
                                     config(JConfig, mode), names, log=lambda *a: None)
                else:
                    rec = sfm_stage(tr, H, W, Path(tmp), config(Config, mode), "cpu", names,
                                    log=lambda *a: None)
            sets[pkg] = (rec.registered, _centers(rec.qvec, rec.tvec), float(rec.params[0]))
        for name, (reg, c, f) in sets.items():
            print(f"[sfm-modes] {mode}, {name}: {int(reg.sum())}/{T} registered, Sim3 ATE "
                  f"against the renderer {ate_rmse(c[reg], gt_c[reg]):.5f}, focal {f:.2f} px")
        for a, b in (("JAX", "card"), ("JAX", "port (CPU)"), ("port (CPU)", "card")):
            (ra, ca, _), (rb, cb, _) = sets[a], sets[b]
            both = ra & rb
            print(f"[sfm-modes] {mode}, {a} vs {b}: same registered set "
                  f"{bool((ra == rb).all())}, Sim3 ATE between the pose sets "
                  f"{ate_rmse(ca[both], cb[both]):.3e}")


def compare_sweep(dump_dir: Path) -> None:
    from particlesfm_tpu_torch.geometry.alignment import ate_rmse
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    eps = np.float32(1 + 2.0 ** -22)      # a rounding-only change of the tracks
    for d in sorted(dump_dir.glob("sweep_*")):
        z = np.load(d / "sweep.npz")
        tr = TrackArrays.load(d / "tracks.npz")
        H, W = (int(v) for v in z["sfm_hw"])
        gt_c = _centers_w2c(z["sfm_gt_w2c"])
        T = len(gt_c)
        names = [f"{i:06d}.ppm" for i in range(T)]
        sets = {"card": (z["sfm_sub_registered"], _centers(z["sfm_sub_qvec"], z["sfm_sub_tvec"]),
                         float(z["sfm_sub_params"][0]))}
        for pkg in ("JAX", "port (CPU)"):
            for tag, scale in (("", 1.0), (" x (1 + 2^-22)", eps)):
                rec = _sfm_run(pkg, tr, H, W, d, names, scale)
                sets[pkg + tag] = (rec.registered, _centers(rec.qvec, rec.tvec),
                                   float(rec.params[0]))
        seq = d.name[len("sweep_"):]
        for name, (reg, c, f) in sets.items():
            print(f"[sweep] {seq}, {tr.num_tracks} labeled tracks, {name}: {int(reg.sum())}/{T} "
                  f"registered, Sim3 ATE against the renderer {ate_rmse(c[reg], gt_c[reg]):.5f}, "
                  f"focal {f:.2f} px (renderer {float(z['sfm_gt_focal']):.2f})")
        for a, b in (("JAX", "card"), ("JAX", "port (CPU)"), ("port (CPU)", "card"),
                     ("JAX", "JAX x (1 + 2^-22)"), ("port (CPU)", "port (CPU) x (1 + 2^-22)"),
                     ("port (CPU) x (1 + 2^-22)", "card")):
            (ra, ca, fa), (rb, cb, fb) = sets[a], sets[b]
            both = ra & rb
            print(f"[sweep] {seq}, {a} vs {b}: same registered set {bool((ra == rb).all())}, "
                  f"Sim3 ATE between the pose sets {ate_rmse(ca[both], cb[both]):.3e}, focal "
                  f"{fa / fb - 1:+.3e}")


def compare_pnp(z) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from particlesfm_tpu.globalsfm.pnp import estimate_pose_pnp as jpnp
    from particlesfm_tpu_torch.globalsfm.pnp import estimate_pose_pnp
    from particlesfm_tpu_torch.globalsfm.twoview import threefry_key, threefry_uniform
    from particlesfm_tpu_torch.utils.config import SfmConfig

    seed = SfmConfig().seed
    X, x, m, u = z["inc_pnp_X"], z["inc_pnp_x"], z["inc_pnp_mask"], z["inc_pnp_u"]
    thr = float(z["inc_pnp_thres"])
    img = next(i for i in range(len(z["sfm_gt_w2c"]))
               if np.array_equal(threefry_uniform(threefry_key(seed + i), u.shape), u))
    port = int(estimate_pose_pnp(torch.from_numpy(X), torch.from_numpy(x), torch.from_numpy(m),
                                 thr, u=torch.from_numpy(u)).num_inliers)
    jax_n = int(jpnp(jax.random.PRNGKey(seed + img), jnp.asarray(X), jnp.asarray(x),
                     jnp.asarray(m), jnp.asarray(np.float32(thr))).num_inliers)
    f = float(z["inc_params"][0])
    H, W = (int(v) for v in z["sfm_hw"])
    uv = x[m] * f + np.float32([W / 2.0, H / 2.0])
    depth = np.linalg.norm(X[m], axis=1)
    print(f"[sfm-pnp] the incremental run's last PnP (image {img}, {int(m.sum())} 2D-3D pairs, "
          f"the first in track order): inliers card {int(z['inc_pnp_inliers'])}, port (CPU) "
          f"{port}, JAX {jax_n}; its 2D points span u {uv[:, 0].min():.0f}..{uv[:, 0].max():.0f}, "
          f"v {uv[:, 1].min():.0f}..{uv[:, 1].max():.0f} px of {W}x{H}; distance of its 3D "
          f"points from the seed camera: median {np.median(depth):.3f}, "
          f"5-95% {np.percentile(depth, 5):.3f}..{np.percentile(depth, 95):.3f}")


def compare_stride2(z) -> None:
    import tempfile

    import torch

    from particlesfm_tpu.ops import flow_ops as jops
    from particlesfm_tpu.pipeline import run as JR
    from particlesfm_tpu.pipeline import stages as JS
    from particlesfm_tpu.utils.config import Config as JConfig
    from particlesfm_tpu_torch.pipeline import run as PR
    from particlesfm_tpu_torch.pipeline import stages as PS
    from particlesfm_tpu_torch.utils.config import Config as PConfig

    images = z["images"]
    used = {}

    def config(cls):
        cfg = cls()
        cfg.flow.infer_scale = 0.5
        cfg.flow.stride2_compose_disagree_px = 4.0
        cfg.flow.selfcal = False
        return cfg

    def keep(pkg, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            used.setdefault(pkg, []).append(np.asarray(out[1].cpu() if torch.is_tensor(out[1])
                                                       else out[1]))
            return out
        return wrapped

    orig_j, orig_p = jops.stride2_compose_fallback, PS.stride2_compose_fallback
    jops.stride2_compose_fallback = keep("JAX", orig_j)
    PS.stride2_compose_fallback = keep("port (CPU)", orig_p)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = config(JConfig)
            JS.flow_stage(images.astype(np.float32), Path(tmp) / "j", cfg,
                          JR._load_raft_apply(cfg), log=lambda *a: None)
            cfg = config(PConfig)
            PS.flow_stage(images.astype(np.float32), Path(tmp) / "p", cfg, "cpu",
                          PR._load_raft_apply(cfg, "cpu"), log=lambda *a: None,
                          device_stack=PS.upload_frame_stack(images, "cpu"))
    finally:
        jops.stride2_compose_fallback, PS.stride2_compose_fallback = orig_j, orig_p
    T, H, W = images.shape[:3]
    for k, name in enumerate(("flow_f2", "flow_b2")):
        uj, up = used["JAX"][k], used["port (CPU)"][k]
        print(f"[stride2] {name} on the dump's {T} frames at {W}x{H}, infer_scale 0.5, 4 px: "
              f"fallback share JAX {100 * uj.mean():.3f}%, port (CPU) {100 * up.mean():.3f}% "
              f"of {uj.size} pixels; decisions differ on {int((uj != up).sum())} pixels")


def _centers_w2c(w2c) -> np.ndarray:
    R, t = w2c[:, :, :3], w2c[:, :, 3]
    return -np.einsum("nji,nj->ni", R, t)


def compare_mesh(z) -> None:
    import json

    import jax
    import jax.numpy as jnp

    from particlesfm_tpu.globalsfm.tracks3d import TrackObs
    from particlesfm_tpu.parallel import make_mesh
    from particlesfm_tpu.parallel.sharded_ba import sharded_bundle_adjust

    n = int(z["mesh_shards"])
    kw = json.loads(str(z["mesh_ba_kw"]))
    fb = z["mesh_ba_focal_bounds"]
    if not np.isnan(fb).any():
        kw["focal_bounds"] = jnp.asarray(fb)
    obs = TrackObs(jnp.asarray(z["mesh_ba_fidx"], jnp.int32), jnp.asarray(z["mesh_ba_uv"]),
                   jnp.asarray(z["mesh_ba_mask"]))
    st = sharded_bundle_adjust(
        make_mesh(devices=jax.devices()[:n]), jnp.asarray(z["mesh_ba_q"]),
        jnp.asarray(z["mesh_ba_t"]), jnp.asarray(z["mesh_ba_params"]),
        jnp.asarray(z["mesh_ba_X"]), obs, jnp.asarray(z["mesh_ba_free"]),
        jnp.asarray(z["mesh_ba_pm"]), **kw)
    cost, card = float(st.cost), float(z["mesh_ba_out_cost"])
    gap = {k: float(np.abs(np.asarray(getattr(st, k)) - z[f"mesh_ba_out_{k}"]).max())
           for k in ("q", "t", "X")}
    print(f"[mesh] sharded BA on [slice]'s last BA problem ({z['mesh_ba_q'].shape[0]} views, "
          f"{z['mesh_ba_X'].shape[0]} tracks), JAX on {n} virtual CPU devices vs the card's "
          f"{n} shards: cost {cost:.6e} / {card:.6e} ({abs(cost - card) / max(card, 1e-30):.2e} "
          f"relative), max |diff| q {gap['q']:.3e}, t {gap['t']:.3e}, X {gap['X']:.3e}; LM "
          f"iterations {int(st.iters)} / {int(z['mesh_ba_out_iters'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="slice_dump.npz written by chip_smoke.py --dump")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from particlesfm_tpu.pipeline.run import _load_depth_apply, _load_seg_apply
    from particlesfm_tpu.utils.config import Config

    z = np.load(args.dump)
    compare_selfcal(z)

    depth = z["depth"].astype(np.float32)                       # [T, H, W]
    cfg = Config()
    d_j = _load_depth_apply(cfg)(z["images"].astype(np.float32))
    dd = np.abs(d_j - depth[:len(d_j)])
    print(f"[depth] JAX vs card on {len(d_j)} frames at {depth.shape[2]}x{depth.shape[1]}: "
          f"max |diff| {dd.max():.3e}, share of pixels within one float16 step "
          f"(2^-11) {(dd <= 2.0 ** -11).mean():.6f}")

    seg = _load_seg_apply(cfg)
    wins = z["seg_wins"]
    for c in z["seg_chunks"]:
        traj, valid, lg = z[f"seg_traj_{c}"], z[f"seg_valid_{c}"], z[f"seg_logits_{c}"]
        lg_j = np.concatenate([        # one window at a time: windows are independent
            np.asarray(seg(jnp.asarray(traj[b:b + 1]), jnp.asarray(depth[wins[b]][None]),
                           jnp.asarray(valid[b:b + 1])))
            for b in range(len(wins))])
        real = valid.any(-1)                                    # sampled, not padding
        diff = np.abs(lg - lg_j)
        flips = ((lg > 0) != (lg_j > 0)) & (np.abs(lg_j) >= 1e-3)
        print(f"[motionseg] chunk {c}: JAX vs card on {len(wins)} windows x {lg.shape[1]} "
              f"slots ({int(real.sum())} sampled): max |logit diff| {diff[real].max():.3e} "
              f"(padded slots {diff[~real].max() if (~real).any() else 0.0:.3e}), "
              f"{int(flips[real].sum())} label flips away from the decision, dynamic share "
              f"{(lg[real] > 0).mean():.4f} (card) / {(lg_j[real] > 0).mean():.4f} (JAX)")
    if "sfm_qvec" in z.files:
        compare_sfm(z, Path(args.dump).parent)
        compare_sfm_modes(z, Path(args.dump).parent)
    if "inc_pnp_X" in z.files:
        compare_pnp(z)
    compare_stride2(z)
    compare_sweep(Path(args.dump).parent)
    if "mesh_ba_X" in z.files:
        compare_mesh(z)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
