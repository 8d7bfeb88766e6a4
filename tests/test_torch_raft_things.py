"""RAFT at the published raft-things widths through the port's flow path.

- Flow checkpoints carry `batch_stats`: a things-width RAFT with drawn
  batch-norm statistics saves and loads back equal, running statistics
  included; `convert_raft`'s CLI output loads through `load_model`; the
  sidecar's variant picks the net, and an unknown one raises.
- The repo's seeded `raft_things_seed0` checkpoint loads strictly in the port
  and in the benchmark's plain reference (`benchmark/reference`).
- On the CPU at 64x96 the port's net, and its pair apply with the
  refinement, agree with the plain reference on those weights; the same
  reference with its weights rounded to bfloat16 does not.
- Only the raft-things motion encoder's two 3x3 convolutions of 256 input
  channels are built off cuDNN (`models.raft._Im2colConv2d`); the compact
  net keeps it.
- `run_pipeline --skip_sfm` with that checkpoint gives trajectories.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from particlesfm_tpu_torch.flow import infer
from particlesfm_tpu_torch.io.checkpoint import raft_variables_from_torch
from particlesfm_tpu_torch.models import convert_raft
from particlesfm_tpu_torch.models import raft
from particlesfm_tpu_torch.models.raft import RAFT
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.synth import random_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
THINGS = ROOT / "checkpoints" / "raft_things_seed0.msgpack"
SYNTH = ROOT / "checkpoints" / "raft_synth.msgpack"
SCHEDULE = ((2, 3.5, 7), (3, 1.5, 3))        # the benchmark configurations' refinement
# Port and reference run the same float32 operations on the CPU but for the
# motion encoder's two wide convolutions, an im2col + GEMM in the port and
# oneDNN's convolution in the reference, which sum in other orders: here the
# flows read at most 1.7e-6 px apart (mean 6e-8 px).
# The reference with its weights rounded to bfloat16 reads 7e-5 / 1e-4 px
# (mean) and 2e-4 / 5e-4 px (max), so these bounds fail it.
MEAN_PX, MAX_PX = 1e-5, 1e-4


def _reference():
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        import reference
        from reference.raft import pair_flows
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    return reference, pair_flows


def _seeded_things_raft() -> RAFT:
    """`scripts/make_seeded_raft.py`'s float32 net: drawn batch-norm
    statistics, the flow head scaled."""
    spec = importlib.util.spec_from_file_location(
        "make_seeded_raft", ROOT / "scripts" / "make_seeded_raft.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.seeded_things_raft()


def _assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_things_checkpoint_saves_and_loads_its_batch_stats(tmp_path):
    model = _seeded_things_raft()
    infer.save_flow_checkpoint(tmp_path / "t.msgpack", model, "things", {"iters": 20})
    params, stats, meta = infer.load_flow_checkpoint(tmp_path / "t.msgpack")
    assert meta == {"variant": "things", "iters": 20}
    assert set(stats["cnet"]) >= {"norm1", "layer1_0", "layer2_0", "layer3_0"}
    back, _ = infer.load_model(tmp_path / "t.msgpack", "cpu")
    assert type(back) is RAFT and back.hidden_dim == 128
    _assert_same_state(back.state_dict(), model.state_dict())
    assert float(back.cnet.norm1.running_var.min()) >= 0.5


def test_convert_cli_output_loads_through_load_model(tmp_path):
    """A released raft-things.pth, stood in for by the torch-shaped state dict
    of a things-width RAFT: the CLI writes msgpack and sidecar, and
    `load_model` builds the raft-things net from them, weights equal."""
    model = _seeded_things_raft()
    sd = convert_raft.fake_torch_state_dict_from_flax(raft_variables_from_torch(model.state_dict()))
    torch.save({f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               tmp_path / "raft-things.pth")
    out = tmp_path / "raft-things.msgpack"
    assert convert_raft.main([str(tmp_path / "raft-things.pth"), str(out)]) == 0
    assert json.loads(Path(str(out) + ".json").read_text()) == {"variant": "things", "iters": 20}
    back, meta = infer.load_model(out, "cpu")
    assert type(back) is RAFT and meta["iters"] == 20
    _assert_same_state(back.state_dict(), model.state_dict())


@pytest.mark.parametrize("path,variant,hidden,n_params,has_stats", [
    (SYNTH, "compact", 64, None, False),
    (THINGS, "things", 128, 5_257_536, True),
], ids=["raft_synth", "raft_things_seed0"])
def test_repo_flow_checkpoints_load_strictly(path, variant, hidden, n_params, has_stats):
    _, stats, meta = infer.load_flow_checkpoint(path)
    assert meta["variant"] == variant and bool(stats) == has_stats
    model, _ = infer.load_model(path, "cpu")
    assert model.hidden_dim == hidden and not model.training
    if n_params is not None:
        assert sum(p.numel() for p in model.parameters()) == n_params
        assert meta["iters"] == 20
        reference, _ = _reference()
        ref = reference.load_raft(path, variant)
        port = model.state_dict()
        for k, v in ref.state_dict().items():
            assert torch.equal(v, port[k]), k


def test_unknown_variant_raises():
    assert type(infer.model_from_meta({})) is RAFT
    assert infer.model_from_meta({}).hidden_dim == 64
    assert infer.model_from_meta({"variant": "things"}).hidden_dim == 128
    with pytest.raises(ValueError, match="'small'"):
        infer.model_from_meta({"variant": "small"})


@pytest.mark.parametrize("variant", ["compact", "things"])
def test_only_the_things_motion_encoder_leaves_cudnn(variant):
    """`BasicMotionEncoder` builds its 3x3 convolutions of 256 or more input
    channels as `_Im2colConv2d`: the raft-things motion encoder's convc2
    and conv; every convolution of the compact net stays an `nn.Conv2d` on
    cuDNN. Each wide one computes its convolution."""
    model = infer.model_from_meta({"variant": variant}).eval()
    off = {n: m for n, m in model.named_modules() if isinstance(m, raft._Im2colConv2d)}
    want = {"update_block.encoder.convc2", "update_block.encoder.conv"} if variant == "things" else set()
    assert set(off) == want
    x = torch.randn(2, 256, 5, 7, generator=torch.Generator().manual_seed(0))
    for m in off.values():
        with torch.inference_mode():
            got = m(x)
        want_y = torch.nn.functional.conv2d(x, m.weight, m.bias, padding=1)
        assert got.shape == want_y.shape
        torch.testing.assert_close(got, want_y, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def frames():
    sc = random_scene(np.random.default_rng(3), num_views=3, height=64, width=96,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    return torch.from_numpy(np.stack([sc.render(i) for i in range(3)]))


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["net", "pairs_refined"])
def test_things_flow_matches_the_plain_reference(frames, path, weights):
    """2 pairs at 64x96, 3 GRU iterations, the seeded raft-things weights:
    the port within MEAN_PX / MAX_PX of the reference; the reference with
    bfloat16-rounded weights outside them."""
    reference, pair_flows = _reference()
    ref = reference.load_raft(THINGS, "things")
    if weights == "bfloat16":
        with torch.no_grad():
            for t in ref.state_dict().values():
                if t.is_floating_point():
                    t.copy_(t.bfloat16())
    ia, ib = np.array([0, 1]), np.array([1, 2])
    x = frames.to(torch.float32)
    with torch.inference_mode():
        if path == "net":
            model, _ = infer.load_model(THINGS, "cpu")
            got, want = model(x[ia], x[ib], iters=3), ref(x[ia], x[ib], 3)
        else:
            apply = infer.load_flow_apply_pairs(THINGS, iters=3, per_device=2,
                                                refine_schedule=SCHEDULE, device="cpu")
            got = apply(frames, ia, ib)
            want = pair_flows(ref, frames[ia], frames[ib], 3, SCHEDULE, 3.0)
    assert got.shape == (2, 64, 96, 2)
    gap = (got - want).norm(dim=-1)
    if weights == "float32":
        assert float(gap.mean()) <= MEAN_PX and float((got - want).abs().max()) <= MAX_PX
    else:
        assert float(gap.mean()) > MEAN_PX and float((got - want).abs().max()) > MAX_PX


def test_pipeline_runs_the_things_checkpoint_and_gives_tracks(tmp_path):
    """`--raft_ckpt` with the seeded raft-things checkpoint, as the benchmark's
    `raft_things` configuration runs it (no other option), on a 6-view
    64x96 scene with --skip_sfm, at 3 GRU iterations for the CPU's time."""
    sc = random_scene(np.random.default_rng(0), num_views=6, height=64, width=96,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    img = tmp_path / "img"
    img.mkdir()
    for i in range(6):
        Image.fromarray(sc.render(i)).save(img / f"{i:06d}.png")
    cfg = run.config_from_args(run.build_arg_parser().parse_args(
        ["--raft_ckpt", str(THINGS), "--set", "flow.iters=3", "--skip_sfm", "--device", "cpu"]))
    run._APPLY_CACHE.clear()
    try:
        res = run.run_pipeline(img, tmp_path / "out", cfg, log=lambda *a: None, device="cpu")
        (apply,) = [v for k, v in run._APPLY_CACHE.items() if k[0] == "raft"]
    finally:
        run._APPLY_CACHE.clear()
    assert apply.refines and int(res.num_tracks) > 0
    d = np.load(tmp_path / "out" / "trajectories" / "tracks.npz")
    assert d["mask"].shape == (int(res.num_tracks), 6) and d["mask"].sum(1).min() >= 3
