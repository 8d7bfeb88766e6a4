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
- [motionseg] the JAX seg apply against the card's logits on the chunks.
"""
from __future__ import annotations

import argparse
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
