"""Port parity: the flow trainer against the JAX package's on the same inputs.

The port's sequence loss, its training lookup (the reference's XLA
hat-matmul lookup with autograd), RAFT's per-iteration flows, one whole
training step (loss, every gradient, the clip -> adamw update), the optax
pieces, the flax msgpack files either package writes, the resume file and
the rendered pairs. JAX's initial parameters are carried into the port
(torch cannot replay jax.random). Tolerances are stated per test.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import from_state_dict, msgpack_restore, msgpack_serialize, to_state_dict

from particlesfm_tpu.flow import data as jdata
from particlesfm_tpu.flow import infer as jinfer
from particlesfm_tpu.flow import train as jtrain
from particlesfm_tpu.models import raft as jraft
from particlesfm_tpu_torch.flow import data as pdata
from particlesfm_tpu_torch.flow import infer as pinfer
from particlesfm_tpu_torch.flow import train as ptrain
from particlesfm_tpu_torch.io.checkpoint import msgpack_serialize as port_serialize
from particlesfm_tpu_torch.io.checkpoint import (conv_bn_variables_from_torch,
                                                 raft_state_dict_from_jax)
from particlesfm_tpu_torch.models.raft import compact_raft, lookup_corr_hat
from particlesfm_tpu_torch.utils import optim
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _leaves_equal(a, b, path=""):
    """Two trees of dicts and arrays/scalars with the same keys and equal values."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's initial compact-RAFT parameters (the JAX trainer's init call)."""
    model = jraft.compact_raft(remat=True)
    return jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                                     jnp.zeros((64, 64, 3)), iters=1)["params"])


def _port_raft(params):
    model = compact_raft(remat=True)
    model.load_state_dict(raft_state_dict_from_jax(params), strict=True)
    model.lookup = lookup_corr_hat
    return model


def test_sequence_loss_and_epe_match_jax():
    """Within 1e-6 relative, pixels at |gt| >= max_flow masked in both."""
    rng = np.random.default_rng(0)
    preds = rng.normal(0, 5, (4, 2, 8, 12, 2)).astype(np.float32)
    gt = rng.normal(0, 5, (2, 8, 12, 2)).astype(np.float32)
    gt[0, :2] = 500.0
    lj = float(jtrain.sequence_loss(jnp.asarray(preds), jnp.asarray(gt)))
    lp = float(ptrain.sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt)))
    assert abs(lp - lj) <= 1e-6 * abs(lj)
    assert ptrain.epe(torch.from_numpy(preds[0]), gt) == pytest.approx(
        jtrain.epe(preds[0], gt), rel=1e-6)


def test_lookup_corr_hat_values_and_grads_match_jax():
    """Values and the gradients with respect to the maps and the coordinates
    against jax.grad of the reference's XLA lookup (raft.py:145), within
    1e-5 of each quantity's largest magnitude; coordinates include integers
    (the hats' kinks) and points off every level's map."""
    rng = np.random.default_rng(1)
    H, W, D = 16, 24, 16
    f1 = rng.normal(size=(H, W, D)).astype(np.float32)
    f2 = rng.normal(size=(H, W, D)).astype(np.float32)
    coords = rng.uniform(-3, W + 3, (H, W, 2)).astype(np.float32)
    coords[0] = np.round(coords[0])
    coords[1, :4] = [[100.0, -50.0], [-40.0, 7.5], [2.0, 3.0], [W - 1.0, H - 1.0]]
    g = rng.normal(size=(H, W, 4 * 81)).astype(np.float32)
    pyr = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    vj = np.asarray(jraft.lookup_corr(pyr, jnp.asarray(coords), 4))
    gpj, gcj = jax.grad(lambda p, c: jnp.sum(jraft.lookup_corr(p, c, 4) * g),
                        argnums=(0, 1))(pyr, jnp.asarray(coords))
    pt = [torch.tensor(np.asarray(p)[..., 0][None], requires_grad=True) for p in pyr]
    ct = torch.tensor(coords.reshape(1, H * W, 2), requires_grad=True)
    vp = lookup_corr_hat(pt, ct, 4)
    (vp * torch.from_numpy(g.reshape(1, H * W, -1))).sum().backward()
    np.testing.assert_allclose(vp.detach().numpy().reshape(H, W, -1), vj,
                               atol=1e-5 * np.abs(vj).max(), rtol=0)
    gc = np.asarray(gcj)
    np.testing.assert_allclose(ct.grad.numpy().reshape(H, W, 2), gc,
                               atol=1e-5 * np.abs(gc).max(), rtol=0)
    for lvl in range(4):
        gl = np.asarray(gpj[lvl])[..., 0]
        np.testing.assert_allclose(pt[lvl].grad.numpy()[0], gl, atol=1e-5 * np.abs(gl).max(),
                                   rtol=0)


def test_raft_all_iters_matches_jax(jax_init):
    """all_iters: each iteration's upsampled flow with its own mask, from
    JAX's initial parameters at 64x64 and 3 iterations, within 1e-4 px."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    b = np.roll(a, 2, axis=1)
    fj = np.asarray(jraft.compact_raft().apply({"params": jax_init}, jnp.asarray(a),
                                               jnp.asarray(b), iters=3, all_iters=True))
    with torch.no_grad():
        fp = _port_raft(jax_init)(torch.from_numpy(a[None]), torch.from_numpy(b[None]),
                                  iters=3, all_iters=True)[0].numpy()
    assert fp.shape == fj.shape == (3, 64, 64, 2)
    np.testing.assert_allclose(fp, fj, atol=1e-4, rtol=0)


def _jax_loss_and_grads(iters):
    """The JAX trainer's loss_fn and its gradient, jitted alone (jitted with
    the optax update, XLA moved the early encoder gradients by up to 7e-3 on
    the CPU; alone it agrees with eager JAX to 1e-6)."""
    model = jraft.compact_raft(remat=True)

    def loss_fn(p, b1, b2, bf):     # at the package's float32 precision
        preds = jax.vmap(lambda x, y: model.apply({"params": p}, x, y, iters=iters,
                                                  all_iters=True))(b1, b2)
        return jtrain.sequence_loss(jnp.moveaxis(preds, 1, 0), bf)

    return jax.jit(jax.value_and_grad(loss_fn))


def test_flow_train_step_and_resume_match_jax(jax_init, tmp_path):
    """One training step of compact RAFT (remat, the hat lookup) at 64x64
    (the smallest size with RAFT's 4 pyramid levels), 2 iterations, batch 2,
    under the trainer's 60-step one-cycle schedule. JAX runs at the
    package's float32 precision: the trainer's "default" matmul precision,
    which the port's TF32 stands for on the card, moves the early cnet
    gradients by 1e-3 on the CPU. Bounds:
    - the loss within 1e-5 relative;
    - every parameter's gradient, clipped, within 1e-4 of its norm + 1e-6
      (the biases before an instance norm have zero gradient; their
      float32 values are rounding noise);
    - the updated parameters within 1e-6 + 1% of the step wherever the two
      gradients agree to 1e-3 and exceed 1e-6 (Adam's first step is +-lr
      by the gradient's sign, which rounding decides elsewhere).
    Then JAX's resume file continues in the port: one more step from it
    matches JAX's second step to the same bounds, the gradients to 2e-2 of
    their norm (at these parameters the early encoder gradients are
    float32-limited: each package's sits 1e-3 to 6e-3 from a float64
    evaluation of the port). The port's resume file loads in JAX with equal
    leaves and the structure of JAX's own."""
    rng = np.random.default_rng(3)
    b1 = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    b2 = np.roll(b1, 3, axis=2)
    bf = np.broadcast_to(np.float32([-3.0, 0.0]), (2, 64, 64, 2)).copy()
    steps, lr, iters = 60, 2e-4, 2
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.linear_onecycle_schedule(steps, lr, pct_start=0.1),
                                 weight_decay=1e-5))
    jb = tuple(jnp.asarray(x) for x in (b1, b2, bf))
    grad_fn = _jax_loss_and_grads(iters)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))

    def step(p, s):
        loss, g = grad_fn(p, *jb)
        upd, s = update(g, s, p)
        return loss, g, optax.apply_updates(p, upd), s
    p0 = jax_init
    lj, gj, p1, s1 = step(p0, tx.init(p0))

    model = _port_raft(p0)
    sched = optim.linear_onecycle_schedule(steps, lr, pct_start=0.1)
    opt = optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-5)
    tb = tuple(torch.from_numpy(x) for x in (b1, b2, bf))

    def check(loss, grads_jax, params_jax, params_before, grad_tol):
        assert abs(float(loss) - float(lj_now)) <= 1e-5 * abs(float(lj_now))
        g = dict(_flat(grads_jax))
        scale = min(1.0, 1.0 / float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                                 for v in g.values()))))
        g = {k: v * scale for k, v in g.items()}        # clipped to a global norm of 1
        gp = dict(_flat(conv_bn_variables_from_torch(
            {n: p.grad for n, p in model.named_parameters()})[0]))
        assert sorted(gp) == sorted(g)
        after = dict(_flat(ptrain.model_state(model, opt, True)[0]))
        before = dict(_flat(params_before))
        for k, ref in _flat(params_jax):
            assert np.linalg.norm(gp[k] - g[k]) <= grad_tol * np.linalg.norm(g[k]) + 1e-6, k
            same = (np.abs(gp[k] - g[k]) <= 1e-3 * np.abs(g[k])) & (np.abs(g[k]) > 1e-6)
            err = np.abs(after[k] - ref)[same]
            assert (err <= 1e-6 + 0.01 * np.abs(ref - before[k])[same]).all(), k

    lj_now = lj
    loss = ptrain.train_step(model, opt, *tb, iters, sched(0))
    check(loss, jax.device_get(gj), jax.device_get(p1), p0, 1e-4)

    # JAX's resume file continues in the port
    path = tmp_path / "resume.msgpack"
    jtrain.save_resume_state(path, p1, s1, 1, 3.5)
    model2 = _port_raft(p0)
    opt2 = optim.AdamW(model2.parameters(), lr=lr, weight_decay=1e-5)
    params, opt_state, it, best = ptrain.load_resume_state(path)
    assert (it, best) == (1, 3.5)
    assert ptrain.load_model_state(model2, opt2, params, opt_state) == 1
    lj_now, gj2, p2, s2 = step(p1, s1)
    model, opt = model2, opt2
    loss = ptrain.train_step(model, opt, *tb, iters, sched(it))
    check(loss, jax.device_get(gj2), jax.device_get(p2), jax.device_get(p1), 2e-2)

    # the port's resume file loads in JAX: same structure and leaves as JAX's
    ppath = tmp_path / "port_resume.msgpack"
    ptrain.save_resume_state(ppath, *ptrain.model_state(model, opt, True), 2, 3.0)
    pj, sj, itj, bestj = jtrain.load_resume_state(ppath, p0, tx.init(p0))
    assert (itj, bestj) == (2, 3.0)
    own = msgpack_restore(msgpack_serialize({"opt_state": to_state_dict(s2)}))["opt_state"]
    blob = msgpack_restore(ppath.read_bytes())
    assert jax.tree_util.tree_structure(blob["opt_state"]) == \
        jax.tree_util.tree_structure(own)
    _leaves_equal(to_state_dict(sj), blob["opt_state"])
    assert int(sj[1][0].count) == int(s2[1][0].count) == 2
    _leaves_equal(pj, blob["params"])


def test_optimizer_pieces_match_optax():
    """Three clip(1.0) -> adamw updates on the same gradients (one above the
    clip norm, two below) within 1e-6 of optax's parameters, with a constant
    rate and with the schedule; the one-cycle rate at every step of a
    60-step schedule within 1e-6 relative; the BCE within 1e-6."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in p0.items()}
             for s in (2.0, 0.05, 0.2)]
    sj = optax.linear_onecycle_schedule(60, 2e-4, pct_start=0.1)
    sp = optim.linear_onecycle_schedule(60, 2e-4, pct_start=0.1)
    for c in range(62):
        assert sp(c) == pytest.approx(float(sj(c)), rel=1e-6, abs=1e-12)
    for lr_j, lr_p in ((2e-4, lambda c: 2e-4), (sj, sp)):
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr_j, weight_decay=1e-5))
        pj, st = {k: jnp.asarray(v) for k, v in p0.items()}, None
        st = tx.init(pj)
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
        opt = optim.AdamW(list(tp.values()), lr=2e-4, weight_decay=1e-5)
        for c, g in enumerate(grads):
            upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
            pj = optax.apply_updates(pj, upd)
            for k, v in tp.items():
                v.grad = torch.from_numpy(g[k].copy())
            optim.clip_by_global_norm([v.grad for v in tp.values()], 1.0)
            opt.set_lr(lr_p(c))
            opt.step()
            for k in p0:
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(pj[k]),
                                           atol=1e-6, rtol=0)
    logits = rng.normal(0, 4, 50).astype(np.float32)
    labels = (rng.random(50) < 0.4).astype(np.float32)
    np.testing.assert_allclose(
        optim.sigmoid_binary_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
        np.asarray(optax.sigmoid_binary_cross_entropy(logits, labels)), rtol=1e-6, atol=1e-7)


def test_flow_checkpoints_load_in_both_packages(jax_init, tmp_path):
    """save_flow_checkpoint: the port's file is byte for byte flax's
    msgpack_serialize of the same tree and loads in JAX with equal leaves;
    JAX's file loads strictly in the port with the same meta."""
    model = _port_raft(jax_init)
    pinfer.save_flow_checkpoint(tmp_path / "p.msgpack", model, "compact", {"iters": 5})
    params, meta = jinfer.load_flow_checkpoint(tmp_path / "p.msgpack")
    assert meta == {"variant": "compact", "iters": 5}
    _leaves_equal(params, jax_init)
    from_state_dict(jax_init, params)
    assert (tmp_path / "p.msgpack").read_bytes() == msgpack_serialize({"params": jax_init})
    assert port_serialize({"params": jax_init}) == msgpack_serialize({"params": jax_init})
    jinfer.save_flow_checkpoint(tmp_path / "j.msgpack", jax_init, "compact", {"iters": 7})
    back, meta = pinfer.load_model(tmp_path / "j.msgpack", "cpu")
    assert meta["iters"] == 7
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_gen_scene_pairs_match_jax_bytes():
    """_gen_scene_pairs of both packages: byte-identical images and flows."""
    spec = (jdata.FlowPairSpec(crop_hw=(24, 32), frames=3),
            pdata.FlowPairSpec(crop_hw=(24, 32), frames=3))
    for seed in (5, 6):
        pj = jdata._gen_scene_pairs((seed, spec[0]))
        pp = pdata._gen_scene_pairs((seed, spec[1]))
        assert len(pj) == len(pp) == 6
        for a, b in zip(pj, pp):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_flow_train_runs_and_writes_a_checkpoint_jax_loads(tmp_path):
    """train() on the CPU from a cached dataset: finite per-step losses, a
    best checkpoint and sidecar JAX loads, and a resume file that continues
    to the requested step count."""
    rng = np.random.default_rng(7)
    n, H, W = 10, 64, 72
    i1 = rng.integers(0, 255, (n, H, W, 3), dtype=np.uint8)
    fl = rng.normal(0, 2, (n, H, W, 2)).astype(np.float16)
    cache = tmp_path / "pairs.npz"
    pdata.save_dataset(cache, i1, np.roll(i1, 2, axis=2), fl)
    out, resume = tmp_path / "raft.msgpack", tmp_path / "resume.msgpack"
    kw = dict(batch=2, iters=2, dataset_cache=str(cache), eval_every=2, crop_hw=(64, 64),
              infer_iters=4, resume=str(resume), device="cpu", log=lambda *a: None)
    stats = {}
    best = ptrain.train(out, steps=2, stats=stats, **kw)
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 2
    assert np.isfinite(best) and best == min(stats["val_epe"])
    meta = json.loads((tmp_path / "raft.msgpack.json").read_text())
    assert meta["variant"] == "compact" and meta["iters"] == 4 and meta["train_iters"] == 2
    params, _ = jinfer.load_flow_checkpoint(out)
    from_state_dict(jax.device_get(jraft.compact_raft().init(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)), jnp.zeros((64, 64, 3)),
        iters=1)["params"]), params)
    stats = {}
    ptrain.train(out, steps=3, stats=stats, **kw)
    assert len(stats["losses"]) == 1
    assert ptrain.load_resume_state(resume)[2] == 3
