"""Port parity: the flow apply (mirrors particlesfm_tpu/flow/infer.py),
reduced-resolution flow (`flow.infer_scale`) in particular, and what the
flow stage makes of the apply's flows.

The compact checkpoint on 4 rendered 132x196 frames: edge-padded to 136x200,
then resized to (round(136*0.5/8)*8, round(200*0.5/8)*8) = (64, 96) by
Python's round (half to even: 8.5 -> 8, 12.5 -> 12), so the half-scale
pyramid keeps its 4 levels (8x12 at level 0). Tolerances against JAX: mean
|flow diff| <= 1e-4 px and max <= 2e-3 px, with and without the fused
photometric refinement; the pair apply on one pair at full resolution
against JAX's single-pair apply alike.
"""
import numpy as np
import pytest
import torch

from particlesfm_tpu.flow import infer as jinfer
from particlesfm_tpu_torch.flow import infer
from particlesfm_tpu_torch.pipeline.run import DEFAULT_RAFT_CKPT
from particlesfm_tpu_torch.synth import random_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CKPT = str(DEFAULT_RAFT_CKPT)
IA, IB = np.array([0, 1, 2, 1]), np.array([1, 2, 3, 0])
SCHEDULE = ((2, 2.0, 4), (2, 1.0, 2))


@pytest.fixture(scope="module")
def stack():
    sc = random_scene(np.random.default_rng(1), num_views=4, height=132, width=196,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=4)
    return np.stack([sc.render(i) for i in range(4)])


def _agree(got, want):
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert np.abs(want).mean() > 1.0                   # a real, non-trivial flow
    assert d.mean() <= 1e-4 and d.max() <= 2e-3, (d.mean(), d.max())


@pytest.mark.parametrize("refine", [None, SCHEDULE])
def test_half_scale_pairs_apply_matches_jax(stack, refine):
    want = np.asarray(jinfer.load_flow_apply_pairs(
        CKPT, iters=8, per_device=1, scale=0.5, refine_schedule=refine)(stack, IA, IB))
    apply = infer.load_flow_apply_pairs(CKPT, iters=8, scale=0.5, refine_schedule=refine,
                                        device="cpu")
    _agree(apply(stack, IA, IB).numpy(), want)


def test_net_input_size_rounds_half_to_even(monkeypatch):
    """The net sees round(Hp*scale/8)*8 x round(Wp*scale/8)*8 of the padded
    frames: 224x512 for the 436x1024 main path (440 * 0.5 / 8 = 27.5 -> 28),
    64x96 here; the flow comes back rescaled by [Wp/ws, Hp/hs]."""
    seen = []

    def net(i1, i2, iters):
        seen.append(tuple(i1.shape[1:3]))
        return torch.ones(i1.shape[:3] + (2,))

    for hw, want, gain in (((440, 1024), (224, 512), (2.0, 440 / 224)),
                           ((136, 200), (64, 96), (200 / 96, 136 / 64))):
        x = torch.zeros((1,) + hw + (3,))
        fl = infer._net_flow(net, x, x, 8, 0.5)
        assert seen[-1] == want and tuple(fl.shape[1:3]) == hw
        np.testing.assert_allclose(fl[0, 5, 5].numpy(), np.float32(gain), rtol=1e-6)


def test_single_pair_apply_matches_jax(stack):
    want = np.asarray(jinfer.load_flow_apply(CKPT)(stack[0].astype(np.float32),
                                                   stack[1].astype(np.float32)))
    got = infer.load_flow_apply_pairs(CKPT, device="cpu")(stack, [0], [1])[0].numpy()
    _agree(got, want)


@pytest.mark.parametrize("refine", [True, False])
def test_flow_stage_takes_the_apply_flows(stack, tmp_path, refine):
    """flow_stage hands on exactly the flows its apply returns for each
    direction, with the refinement on or off: it runs no refinement of its
    own (the apply is its only home), on one pair list over every
    direction."""
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.flow.selfcal = False
    cfg.flow.photometric_refine = refine
    cfg.flow.refine_schedule = [list(p) for p in SCHEDULE]
    apply = infer.load_flow_apply_pairs(
        CKPT, iters=2, scale=0.5, device="cpu",
        refine_schedule=SCHEDULE if refine else None)
    calls = []

    def recorded(st, ia, ib):
        calls.append((ia, ib))
        return apply(st, ia, ib)

    images = stack.astype(np.float32)
    got = stages.flow_stage(images, tmp_path, cfg, "cpu", recorded, log=lambda *a: None,
                            device_stack=stages.upload_frame_stack(images, "cpu"))
    ((ia, ib),) = calls
    want = apply(stack, ia, ib)
    off = 0
    for name, stride in (("flow_f", 1), ("flow_b", -1), ("flow_f2", 2), ("flow_b2", -2)):
        n = 4 - abs(stride)
        np.testing.assert_array_equal(ib[off:off + n] - ia[off:off + n], np.full(n, stride))
        assert torch.equal(got[name], want[off:off + n])
        off += n
