"""Each frozen reference against the port on the CPU, on the repo's own
checkpoints, and the yardstick's copies against the port's originals."""
import json

import numpy as np
import pytest
import torch

import bench_yardstick as Y
import reference
from reference.depth import frame_depths
from reference.motionseg import window_logits
from reference.raft import pair_flows
from run import CODE_ROOT, HERE

CK = CODE_ROOT / "checkpoints"
SCHEDULE = ((2, 3.5, 7), (3, 1.5, 3))


def _frames(T, H, W, seed=0):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand(1, 3, H // 4, W // 4, generator=g)
    fr = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear")
    shifts = [torch.roll(fr, (i, 2 * i), dims=(2, 3)) for i in range(T)]
    return (torch.cat(shifts) * 255).permute(0, 2, 3, 1).to(torch.uint8)


def test_raft_with_refinement_equals_port():
    from particlesfm_tpu_torch.flow.infer import load_flow_apply_pairs

    stack = _frames(3, 60, 92)                 # not multiples of 8: edge padding
    ia, ib = np.array([0, 1, 2]), np.array([1, 2, 0])
    port = load_flow_apply_pairs(CK / "raft_synth.msgpack", iters=8, device="cpu",
                                 refine_schedule=SCHEDULE, refine_max_total=3.0)
    got = port(stack, ia, ib)
    with torch.inference_mode():
        ref = pair_flows(reference.load_raft(CK / "raft_synth.msgpack"), stack[ia], stack[ib],
                         8, SCHEDULE, 3.0)
    assert got.shape == ref.shape == (3, 60, 92, 2)
    assert float((got - ref).abs().max()) < 1e-4


def test_depth_equals_port():
    from particlesfm_tpu_torch.parallel.mesh import mesh_for
    from particlesfm_tpu_torch.pipeline.run import _build_depth_apply

    stack = _frames(5, 64, 96, seed=1)
    got = _build_depth_apply(CK / "depth_synth.msgpack", 32, mesh_for(torch.device("cpu")))(stack)
    with torch.inference_mode():
        ref = frame_depths(reference.load_depth(CK / "depth_synth.msgpack"), stack)
    assert float((got - ref).abs().max()) <= 2 ** -11     # one float16 step at most


def test_seg_equals_port():
    from particlesfm_tpu_torch.parallel.mesh import mesh_for
    from particlesfm_tpu_torch.pipeline.run import _build_seg_apply

    rng = np.random.default_rng(0)
    B, K, L, H, W = 2, 300, 10, 48, 80
    traj = rng.integers(0, 65536, (B, K, L, 2)).astype(np.uint16)
    valid = rng.random((B, K, L)) < 0.8
    depth = torch.rand(B, L, H, W, generator=torch.Generator().manual_seed(2))
    port = _build_seg_apply(CK / "motionseg_synth3d.msgpack", (240, 424),
                            mesh_for(torch.device("cpu")))
    got = port(traj, depth, valid)
    with torch.inference_mode():
        model = reference.load_seg(CK / "motionseg_synth3d.msgpack", (240, 424))
        ref = window_logits(model, torch.as_tensor(traj.astype(np.int32)), depth,
                            torch.as_tensor(valid))
    assert float((got - ref).abs().max()) < 1e-4


def test_lookup_bytes_equals_port():
    from particlesfm_tpu_torch.ops.corr_lookup import lookup_bytes

    g = torch.Generator().manual_seed(3)
    coords = torch.rand(2, 55 * 16, 2, generator=g) * torch.tensor([140.0, 70.0]) - 6
    shapes = [(55, 128), (27, 64), (13, 32), (6, 16)]
    assert Y.lookup_bytes(shapes, coords) == lookup_bytes(shapes, coords)


def test_raft_pair_flops_meta_equals_real():
    count = Y.raft_pair_flops(reference.load_raft(CK / "raft_synth.msgpack"), 64, 96, 2)
    model = reference.load_raft(CK / "raft_synth.msgpack")
    x = torch.zeros(1, 64, 96, 3)
    assert count == Y.count_flops(lambda: model(x, x, 2)) > 0
    # all-pairs correlation: one [HW, D] x [D, HW] product at 1/8 scale, D = 128
    hw = (64 // 8) * (96 // 8)
    assert count > 2 * hw * hw * 128
    more = Y.raft_pair_flops(reference.load_raft(CK / "raft_synth.msgpack"), 64, 96, 3)
    assert more > count


def test_raft_things_widths_build_and_count():
    """The published raft-things widths, for a configuration that runs them:
    the net builds, runs on the meta device and costs more than the compact one."""
    things = Y.raft_pair_flops(reference.RAFT("things"), 64, 96, 2)
    compact = Y.raft_pair_flops(reference.load_raft(CK / "raft_synth.msgpack"), 64, 96, 2)
    assert things > 2 * compact


def test_peaks_are_the_h100_sxm_data_sheet():
    assert Y.PEAKS["fp32_flops"] == 67e12 and Y.PEAKS["hbm_bytes"] == 3.35e12


def _smooth_flows(T, H, W, seed):
    """Smooth random flow stacks: forward, a backward that misses the round
    trip in places (occlusions), and stride-2 flows near the two-hop sum."""
    g = torch.Generator().manual_seed(seed)

    def field(n, amp):
        base = torch.randn(n, 2, 4, 5, generator=g) * amp
        return torch.nn.functional.interpolate(base, size=(H, W), mode="bicubic",
                                               align_corners=True).permute(0, 2, 3, 1)

    ff = field(T, 2.5) + torch.tensor([1.5, -0.7])
    fb = -ff + field(T, 0.6)
    ff2 = 2 * ff[:-1] + field(T - 1, 0.8)
    fb2 = -ff2 + field(T - 1, 0.6)
    return {"flow_f": ff.contiguous(), "flow_b": fb.contiguous(),
            "flow_f2": ff2.contiguous(), "flow_b2": fb2.contiguous()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_equals_port(tmp_path, seed):
    from bench_judge import track_gaps
    from reference.tracker import track

    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.pipeline.run import build_arg_parser, config_from_args

    T, H, W = 10, 48, 64
    flows = _smooth_flows(T, H, W, seed)
    cfg = config_from_args(build_arg_parser().parse_args(["--device", "cpu"]))
    got = stages.tracking_stage(flows, H, W, tmp_path, cfg, device="cpu", log=lambda m: None)
    tcfg = json.loads((HERE / "configs" / "sintel.json").read_text())["track"]
    xy, mask = track(flows, tcfg, H, W)
    assert got.num_tracks > 300 and (~mask).any()      # trajectories end and start
    gaps = track_gaps((got.xy, got.mask), (xy, mask))
    assert gaps["tracks.count_gap"] == 0 and gaps["tracks.mismatched_frac"] == 0, gaps
    assert gaps["tracks.gap_mean_px"] < 1e-3, gaps
    np.testing.assert_array_equal(got.mask, mask)
    # the program's LM reads the flow from a 6x6 window around each point's
    # start (the reference reads the whole map): the few points that travel
    # past it end a fraction of a pixel apart
    d = np.abs(got.xy - xy)[mask]
    assert (d > 1 / 32 + 1e-6).mean() < 5e-3 and d.max() < 0.5
