"""Port parity: the motion-seg trainer against the JAX package's on the same
inputs: the loss and IoU, one training step (flax's batch norms in train mode
over every axis but the last, padded tracks included), the synthetic batches,
the flow PNG16 codec, the FlyingThings3D loader and the training CLI's
checkpoints. JAX's initial variables are carried into the port. Tolerances
are stated per test.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore
from PIL import Image

from particlesfm_tpu.models.motionseg import TrajOADepth as JSeg
from particlesfm_tpu.motionseg import data as jdata
from particlesfm_tpu.motionseg import synth3d as jsynth
from particlesfm_tpu.motionseg import train as jtrain
from particlesfm_tpu_torch.io.checkpoint import (motionseg_state_dict_from_jax,
                                                 motionseg_variables_from_torch)
from particlesfm_tpu_torch.models.motionseg import TrajOADepth
from particlesfm_tpu_torch.motionseg import data as pdata
from particlesfm_tpu_torch.motionseg import synth3d as psynth
from particlesfm_tpu_torch.motionseg import train as ptrain
from particlesfm_tpu_torch.motionseg import train_cli
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

HW = (6, 8)                    # the depth maps' size in these tests


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _batch(seed=0, B=2, N=24, L=6):
    b = jdata.synthetic_motion_batch(np.random.default_rng(seed), B=B, N=N, L=L, H=HW[0],
                                     W=HW[1])
    b["valid"][:, -4:] = False             # padded track slots
    b["traj_valid"][:, -4:] = False
    return b


def test_weighted_bce_and_cls_iou_match_jax():
    """Within 1e-6 relative, padded tracks excluded through traj_valid."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 40)).astype(np.float32)
    labels = (rng.random((3, 40)) < 0.3).astype(np.float32)
    valid = rng.random((3, 40)) < 0.9
    args_j = [jnp.asarray(x) for x in (logits, labels, valid)]
    args_p = [torch.from_numpy(x) for x in (logits, labels, valid)]
    assert float(ptrain.weighted_bce(*args_p)) == pytest.approx(
        float(jtrain.weighted_bce(*args_j)), rel=1e-6)
    assert float(ptrain.cls_iou(*args_p)) == pytest.approx(float(jtrain.cls_iou(*args_j)),
                                                           rel=1e-6)


def test_motionseg_train_step_matches_jax():
    """create_train_state + one train_step of the reference (adamw 1e-4 /
    1e-4, no clip) on 2 sequences x 24 track slots (4 padded). Bounds:
    - the loss and IoU within 1e-5;
    - every parameter's gradient within 2e-2 of its norm + 1e-6: the biases
      before a batch or instance norm have zero gradient (rounding noise),
      and a ReLU input within float32 rounding of 0 takes either
      derivative; here the port's gradients sit up to 6e-3 from a float64
      evaluation of the port (through the first OAFilter's ReLU), JAX's
      4e-5;
    - the updated parameters within 1e-6 + 1% of the step wherever the
      gradients agree to 1e-3 and exceed 1e-6 (Adam's first step is +-lr by
      the gradient's sign);
    - the running statistics within 1e-5;
    - the eval loss after the step within 1e-2 (the parameters whose
      gradient is rounding noise moved by +-lr either way)."""
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jmodel = JSeg(input_hw=HW)
    state, tx = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0), jb)
    v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})

    def loss_fn(params):
        logits, upd = jmodel.apply({"params": params, "batch_stats": state.batch_stats},
                                   jb["traj"], jb["depth"], jb["valid"], train=True,
                                   mutable=["batch_stats"])
        return jtrain.weighted_bce(logits, jb["label"], jb["traj_valid"])

    gj = dict(_flat(jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))))
    new_state, mj = jtrain.train_step(jmodel, tx, state, jb)
    vj = jax.device_get({"params": new_state.params, "batch_stats": new_state.batch_stats})

    model = TrajOADepth(input_hw=HW)
    pstate, opt = ptrain.create_train_state(model, 0, b)
    model.load_state_dict(motionseg_state_dict_from_jax(v0["params"], v0["batch_stats"]),
                          strict=True)
    pstate, mp = ptrain.train_step(model, opt, pstate, b)
    assert pstate.step == int(new_state.step) == 1
    assert float(mp["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert float(mp["iou"]) == pytest.approx(float(mj["iou"]), rel=1e-5)
    vp = motionseg_variables_from_torch(model.state_dict())
    gp = dict(_flat(motionseg_variables_from_torch(
        {n: p.grad for n, p in model.named_parameters()})["params"]))
    after, before = dict(_flat(vp["params"])), dict(_flat(v0["params"]))
    assert sorted(gp) == sorted(gj) == sorted(after)
    for k, ref in _flat(vj["params"]):
        assert np.linalg.norm(gp[k] - gj[k]) <= 2e-2 * np.linalg.norm(gj[k]) + 1e-6, k
        same = (np.abs(gp[k] - gj[k]) <= 1e-3 * np.abs(gj[k])) & (np.abs(gj[k]) > 1e-6)
        err = np.abs(after[k] - ref)[same]
        assert (err <= 1e-6 + 0.01 * np.abs(ref - before[k])[same]).all(), k
    stats_p = dict(_flat(vp["batch_stats"]))
    for k, ref in _flat(vj["batch_stats"]):
        np.testing.assert_allclose(stats_p[k], ref, atol=1e-5, rtol=0, err_msg=k)
    ej = jtrain.eval_step(jmodel, new_state, jb)
    ep = ptrain.eval_step(model, pstate, b)
    assert float(ep["loss"]) == pytest.approx(float(ej["loss"]), rel=1e-2)


def test_synthetic_batches_match_jax_bytes():
    """synthetic_motion_batch and synth3d_batch from the same generator:
    byte-identical arrays, and the generators left in the same state."""
    for fn_j, fn_p, kw in ((jdata.synthetic_motion_batch, pdata.synthetic_motion_batch,
                            dict(B=2, N=16, L=5, H=4, W=6)),
                           (jsynth.synth3d_batch, psynth.synth3d_batch,
                            dict(B=2, num_static=40, num_dyn_max=20, depth_hw=HW))):
        rj, rp = np.random.default_rng(7), np.random.default_rng(7)
        bj, bp = fn_j(rj, **kw), fn_p(rp, **kw)
        assert sorted(bj) == sorted(bp)
        for k in bj:
            assert bj[k].dtype == bp[k].dtype and bj[k].tobytes() == bp[k].tobytes(), k
        assert rj.random() == rp.random()


def test_flow_png16_and_flyingthings_loader_match_jax(tmp_path):
    """The PNG16 codec writes the same file bytes and decodes the same
    values; FlyingThingsSeqDataset on a directory the test writes yields the
    same padded batches (traj cap, depth resize, normalization) in both."""
    rng = np.random.default_rng(3)
    flow = rng.uniform(-90, 90, (10, 14, 2)).astype(np.float32)
    np.testing.assert_array_equal(pdata.encode_flow_png16(flow), jdata.encode_flow_png16(flow))
    raw = pdata.encode_flow_png16(flow)
    np.testing.assert_array_equal(pdata.decode_flow_png16(raw), jdata.decode_flow_png16(raw))
    pdata.write_flow_png(tmp_path / "p.png", flow)
    jdata.write_flow_png(tmp_path / "j.png", flow)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(pdata.read_flow_png(tmp_path / "j.png"),
                                  jdata.read_flow_png(tmp_path / "j.png"))
    root = tmp_path / "ft3d"
    for s in range(3):
        d = root / f"seq{s}"
        (d / "depth").mkdir(parents=True)
        n = 30 + 5 * s
        np.savez(d / "pt.npz", traj=rng.uniform(0, 40, (n, 4, 2)).astype(np.float32))
        np.savez(d / "pad_mask.npz", mask=rng.random((n, 4)) < 0.8)
        np.save(d / "traj_label.npy", (rng.random(n) < 0.3).astype(np.float32))
        for t in range(4):
            dep = (rng.uniform(0, 1, (24, 40)) * 65535).astype(np.uint16)
            Image.fromarray(dep, mode="I;16").save(d / "depth" / f"{t:04d}.png")
    kw = dict(resolution=(12, 20), traj_max_num=32, seed=5)
    dsj, dsp = jdata.FlyingThingsSeqDataset(root, **kw), pdata.FlyingThingsSeqDataset(root, **kw)
    assert len(dsj) == len(dsp) == 3
    bj, bp = list(dsj.batches(2, 40)), list(dsp.batches(2, 40))
    assert len(bj) == len(bp) == 1
    for k in bj[0]:
        assert bj[0][k].dtype == bp[0][k].dtype and bj[0][k].tobytes() == bp[0][k].tobytes(), k


def test_train_cli_checkpoints_load_in_both_packages(tmp_path):
    """train_cli --synthetic, one epoch of two steps on the CPU: the epoch and
    best checkpoints and the metrics line; JAX's TrajOADepth loads the best
    one and its logits equal the port's within 1e-4. Then --resume from the
    repo's JAX-written checkpoint: the port starts from its weights and step."""
    out = tmp_path / "seg"
    rc = train_cli.main(["--synthetic", "--out_dir", str(out), "--epochs", "1",
                         "--steps_per_epoch", "2", "--batch_size", "2",
                         "--resolution", "48", "64", "--device", "cpu"])
    assert rc == 0
    names = sorted(p.name for p in out.iterdir())
    assert "checkpoint_best.msgpack" in names and "test_metrics.txt" in names
    assert any(n.startswith("checkpoint_e0_iou") for n in names)
    blob = msgpack_restore((out / "checkpoint_best.msgpack").read_bytes())
    assert int(blob["step"]) == 2
    b = _batch(seed=4, B=1, N=12, L=5)
    hw = (6, 8)
    lj = np.asarray(JSeg(input_hw=hw).apply(
        {"params": blob["params"], "batch_stats": blob["batch_stats"]},
        jnp.asarray(b["traj"]), jnp.asarray(b["depth"]), jnp.asarray(b["valid"])))
    model = TrajOADepth(input_hw=hw)
    model.load_state_dict(motionseg_state_dict_from_jax(blob["params"], blob["batch_stats"]))
    with torch.no_grad():
        lp = model.eval()(*(torch.from_numpy(b[k]) for k in ("traj", "depth", "valid"))).numpy()
    np.testing.assert_allclose(lp, lj, atol=1e-4, rtol=0)

    repo_ckpt = Path(__file__).resolve().parents[1] / "checkpoints" / "motionseg_synth3d.msgpack"
    out2 = tmp_path / "resumed"
    rc = train_cli.main(["--synthetic3d", "--out_dir", str(out2), "--epochs", "1",
                         "--steps_per_epoch", "1", "--batch_size", "1",
                         "--resolution", "240", "424", "--resume", str(repo_ckpt),
                         "--device", "cpu"])
    assert rc == 0
    step = int(msgpack_restore((out2 / "checkpoint_best.msgpack").read_bytes())["step"])
    assert step == int(msgpack_restore(repo_ckpt.read_bytes()).get("step", 0)) + 1
