"""Port parity: the DepthNet trainer against the JAX package's on the same inputs.

The SSI loss, one whole training step (the reference vmaps the single-image
net, so each batch norm takes one image's statistics and the running
statistics move by the batch mean of the images' updates), the rendered
frames, and the checkpoint and resume files either package writes. JAX's
initial variables are carried into the port. Tolerances are stated per test.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore, msgpack_serialize

from particlesfm_tpu.depth import train as jtrain
from particlesfm_tpu.flow.train import load_resume_state as j_load_resume
from particlesfm_tpu.models.depth import DepthNet as JDepthNet
from particlesfm_tpu.models.depth import scale_shift_invariant_loss as j_ssi
from particlesfm_tpu_torch.depth import train as ptrain
from particlesfm_tpu_torch.io.checkpoint import (conv_bn_variables_from_torch,
                                                 depth_state_dict_from_jax)
from particlesfm_tpu_torch.models.depth import DepthNet, scale_shift_invariant_loss
from particlesfm_tpu_torch.utils import optim
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def jax_vars():
    """The JAX trainer's init call (a 64x64 image, train=True)."""
    return jax.device_get(JDepthNet().init(jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                                           train=True))


def _port_net(v):
    net = DepthNet()
    net.load_state_dict(depth_state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    return net.train()


def test_ssi_loss_matches_jax():
    """Per image, with a partial mask, within 1e-6 relative."""
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 2, (3, 12, 16)).astype(np.float32)
    tgt = rng.uniform(0, 1, (3, 12, 16)).astype(np.float32)
    mask = rng.random((3, 12, 16)) < 0.8
    lp = scale_shift_invariant_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                                    torch.from_numpy(mask)).numpy()
    lj = [float(j_ssi(jnp.asarray(p), jnp.asarray(t), jnp.asarray(m)))
          for p, t, m in zip(pred, tgt, mask)]
    np.testing.assert_allclose(lp, lj, rtol=1e-6, atol=0)


def test_depth_train_step_matches_jax(jax_vars):
    """One step at batch 2, 32x32, the reference's loss_fn (vmapped
    single-image applies, the batch-stat updates averaged) and
    clip(1.0) -> adamw(2e-4, 1e-5). JAX runs at the package's float32
    precision (the trainer's "default" matmul precision is what the port's
    TF32 stands for on the card). Bounds:
    - the loss within 1e-5 relative;
    - every parameter's gradient, clipped, within 1e-4 of its norm + 1e-6
      (the biases before a batch norm have zero gradient, rounding noise);
    - the updated parameters within 1e-6 + 1% of the step wherever the two
      gradients agree to 1e-3 and exceed 1e-6 (Adam's first step is +-lr
      by the gradient's sign);
    - the new running statistics within 1e-5."""
    rng = np.random.default_rng(1)
    bi = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    bd = rng.uniform(0, 1, (2, 32, 32)).astype(np.float32)
    model = JDepthNet()
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4, weight_decay=1e-5))
    params, bs = jax_vars["params"], jax_vars["batch_stats"]

    def loss_fn(p, bs, bi, bd):
        def one(im, d):
            pred, upd = model.apply({"params": p, "batch_stats": bs}, im, train=True,
                                    mutable=["batch_stats"])
            return j_ssi(pred, d, jnp.ones_like(d)), upd["batch_stats"]

        losses, upds = jax.vmap(one)(bi, bd)
        return losses.mean(), jax.tree.map(lambda x: x.mean(0), upds)

    (lj, bs_j), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, bs, jnp.asarray(bi), jnp.asarray(bd))
    upd, _ = tx.update(gj, tx.init(params), params)
    p1 = jax.device_get(optax.apply_updates(params, upd))

    net = _port_net(jax_vars)
    opt = optim.AdamW(net.parameters(), lr=2e-4, weight_decay=1e-5)
    lp = ptrain.train_step(net, opt, torch.from_numpy(bi), torch.from_numpy(bd), 2e-4)
    assert abs(float(lp) - float(lj)) <= 1e-5 * abs(float(lj))
    g = dict(_flat(jax.device_get(gj)))
    scale = min(1.0, 1.0 / float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                             for v in g.values()))))
    g = {k: v * scale for k, v in g.items()}
    gp = dict(_flat(conv_bn_variables_from_torch(
        {n: p.grad for n, p in net.named_parameters()})[0]))
    v1 = ptrain.variables(net)
    after, before = dict(_flat(v1["params"])), dict(_flat(params))
    assert sorted(gp) == sorted(g) == sorted(after)
    for k, ref in _flat(p1):
        assert np.linalg.norm(gp[k] - g[k]) <= 1e-4 * np.linalg.norm(g[k]) + 1e-6, k
        same = (np.abs(gp[k] - g[k]) <= 1e-3 * np.abs(g[k])) & (np.abs(g[k]) > 1e-6)
        err = np.abs(after[k] - ref)[same]
        assert (err <= 1e-6 + 0.01 * np.abs(ref - before[k])[same]).all(), k
    stats_p = dict(_flat(v1["batch_stats"]))
    for k, ref in _flat(jax.device_get(bs_j)):
        np.testing.assert_allclose(stats_p[k], ref, atol=1e-5, rtol=0, err_msg=k)


def test_generate_depth_dataset_matches_jax_bytes():
    """generate_depth_dataset of both packages: byte-identical frames and
    float16 inverse depths from the same seed."""
    ij, dj = jtrain.generate_depth_dataset(1, hw=(24, 32), frames=2, seed=3, workers=1)
    ip, dp = ptrain.generate_depth_dataset(1, hw=(24, 32), frames=2, seed=3, workers=1)
    assert ij.dtype == ip.dtype and ij.tobytes() == ip.tobytes()
    assert dj.dtype == dp.dtype and dj.tobytes() == dp.tobytes()


def test_depth_train_checkpoint_and_resume_load_in_jax(jax_vars, tmp_path):
    """train() on the CPU from a cached dataset: finite losses; the best
    checkpoint {"params", "batch_stats"} and its sidecar load in JAX, whose
    eval-mode depth equals the port's within 1e-4 of its range; the resume
    file loads through JAX's load_resume_state with the {"p", "bs"} params
    and its optax chain state."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, (12, 32, 32, 3), dtype=np.uint8)
    deps = rng.uniform(0, 1, (12, 32, 32)).astype(np.float16)
    cache = tmp_path / "frames.npz"
    np.savez_compressed(cache, images=imgs, depths=deps)
    out, resume = tmp_path / "depth.msgpack", tmp_path / "resume.msgpack"
    stats = {}
    best = ptrain.train(out, steps=2, batch=2, dataset_cache=str(cache), eval_every=2,
                        resume=str(resume), device="cpu", log=lambda *a: None, stats=stats)
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 2 and np.isfinite(best)
    assert json.loads((tmp_path / "depth.msgpack.json").read_text())["step"] == 2
    blob = msgpack_restore(out.read_bytes())
    assert sorted(blob) == ["batch_stats", "params"]
    x = imgs[:1].astype(np.float32)
    dj = np.asarray(JDepthNet().apply(blob, jnp.asarray(x[0]), train=False))
    net = _port_net(blob).eval()
    with torch.no_grad():
        dp = net(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
    np.testing.assert_allclose(dp, dj, atol=1e-4 * float(np.ptp(dj)) + 1e-7, rtol=0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4, weight_decay=1e-5))
    state, opt_state, it, best_j = j_load_resume(
        resume, {"p": jax_vars["params"], "bs": jax_vars["batch_stats"]},
        tx.init(jax_vars["params"]))
    assert it == 2 and best_j == pytest.approx(best) and int(opt_state[1][0].count) == 2
    assert msgpack_serialize(jax.device_get(state["p"])) == msgpack_serialize(blob["params"])
