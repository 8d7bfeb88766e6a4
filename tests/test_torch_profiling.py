"""The port's program spans and counters (particlesfm_tpu_torch/utils/profiling.py).

Off (the default), spans and counts record nothing, mark no device stream
and leave no event in a profiler trace. On, spans nest inside the spans open
around them, counters go to the innermost open span, a span that names a
CUDA device is timed by events on its stream and never synchronises, and a
span's recorded start and end lie on the profiler's clock: within 1 ms of
its own `record_function` event. A whole CPU run of the default command with tracing
on opens every span of the flow, tracker and SfM stages inside its parent,
and writes the same bytes as a run with tracing off.
"""
import time

import numpy as np
import pytest
import torch
from PIL import Image

from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.utils import profiling

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CHILDREN = {
    "flow": ("flow.net", "flow.refine", "flow.selfcal"),
    "trajectories": ("tracks.scan", "tracks.assemble"),
    "sfm": ("sfm.pairs", "sfm.twoview", "sfm.rotations", "sfm.positions", "sfm.ba",
            "sfm.export"),
}


@pytest.fixture
def tracing():
    profiling.enable()
    yield
    profiling.disable()


class _Event:
    """A stand-in for a CUDA timing event, stamped with the host clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def marks(monkeypatch):
    """The devices the recorder marks a stream of, and its synchronise calls."""
    calls = {"mark": [], "sync": []}

    def mark(device):
        calls["mark"].append(device)
        return _Event()

    monkeypatch.setattr(profiling, "_mark", mark)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls["sync"].append(d))
    return calls


def _new(before):
    return profiling.records()[before:]


@pytest.mark.parametrize("how", ["records", "profiler"])
def test_tracing_off_records_and_emits_nothing(how, marks):
    profiling.disable()
    before = len(profiling.records())
    prof = None
    if how == "profiler":
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.__enter__()
    assert profiling.span("a") is profiling.span("b", device=torch.device("cuda", 0))
    with profiling.span("off.outer", device=torch.device("cuda", 0)):
        profiling.count("off.n", 3)
        with profiling.steps(device=torch.device("cuda", 0)) as step:
            step("off.step")
            torch.ones(4).sum()
    if prof is not None:
        prof.__exit__(None, None, None)
        names = {e.name() for e in prof.profiler.kineto_results.events()}
        assert not {n for n in names if n.startswith("off.")}, names
    assert len(profiling.records()) == before
    assert marks == {"mark": [], "sync": []}


@pytest.mark.parametrize("how", ["span", "steps"])
def test_tracing_on_nests_spans_and_counts(how, tracing, marks):
    before = len(profiling.records())
    cuda0 = torch.device("cuda", 0)
    with profiling.span("root"):
        profiling.count("n")
        with profiling.span("outer", device=torch.device("cpu")):
            if how == "span":
                with profiling.span("inner", device=cuda0):
                    profiling.count("n", 2)
                    profiling.count("m")
                with profiling.span("inner", device=cuda0):
                    time.sleep(0.002)
                    profiling.count("n")
            else:
                with pytest.raises(RuntimeError):
                    with profiling.steps(device=cuda0) as step:
                        step("inner")
                        profiling.count("n", 2)
                        profiling.count("m")
                        step("inner")
                        time.sleep(0.002)
                        profiling.count("n")
                        raise RuntimeError("a raise closes the open step")
            profiling.count("n", 5)
    recs = _new(before)
    assert [r.name for r in recs] == ["root", "outer", "inner", "inner"]
    root, outer, a, b = recs
    assert root.counters == {"n": 1} and outer.counters == {"n": 5}
    assert a.counters == {"n": 2, "m": 1} and b.counters == {"n": 1}
    for parent, r in ((root, outer), (outer, a), (outer, b)):
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert a.end_ns <= b.start_ns
    # only the inner spans name a CUDA device: two marks each, timed on them;
    # the others are timed on the host; nothing synchronises
    assert marks == {"mark": [cuda0] * 4, "sync": []}
    assert root.marks is None and outer.marks is None
    assert b.seconds() == pytest.approx(b.marks[0].elapsed_time(b.marks[1]) / 1e3)
    assert b.seconds() >= 0.002
    assert outer.seconds() == (outer.end_ns - outer.start_ns) / 1e9


@pytest.mark.parametrize("sleep_s", [0.0, 0.003])
def test_span_stamps_fall_on_the_profilers_clock(sleep_s, tracing):
    before = len(profiling.records())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("clock.warm"):         # the first event pays the set-up
            pass
        for i in range(3):
            with profiling.span(f"clock.{i}"):
                time.sleep(sleep_s)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for r in _new(before)[1:]:
        e = events[r.name]
        assert abs(r.start_ns - e.start_ns()) < 1_000_000, (r, e.start_ns())
        assert abs(r.end_ns - e.end_ns()) < 1_000_000, (r, e.end_ns())


def _scene(tmp_path):
    from particlesfm_tpu_torch.synth import random_scene

    sc = random_scene(np.random.default_rng(0), num_views=6, height=64, width=96,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    img = tmp_path / "img"
    img.mkdir()
    for i in range(6):
        Image.fromarray(sc.render(i)).save(img / f"{i:06d}.png")
    return img


def _outputs(out):
    files = [out / "trajectories" / "tracks.npz", out / "trajectories_labeled" / "tracks.npz"]
    files += sorted((out / "sfm" / "model").glob("*.bin"))
    return {f.relative_to(out): f.read_bytes() for f in files}


def test_pipeline_spans_cover_the_stages_and_change_no_output(tmp_path):
    """The default command on the 6-view 64x96 scene of test_torch_sfm_slice's
    CPU case, with tracing off and then on."""
    img = _scene(tmp_path)
    cfg = run.config_from_args(run.build_arg_parser().parse_args(
        ["--image_dir", str(img), "--output_dir", str(tmp_path / "off"),
         "--skip_path_consistency", "--sample_ratio", "4",
         "--set", "track.capacity=2048", "--device", "cpu"]))
    run._APPLY_CACHE.clear()
    profiling.disable()
    before = len(profiling.records())
    run.run_pipeline(img, tmp_path / "off", cfg, log=lambda *a: None, device="cpu")
    assert len(profiling.records()) == before
    profiling.enable()
    try:
        run.run_pipeline(img, tmp_path / "on", cfg, log=lambda *a: None, device="cpu")
    finally:
        profiling.disable()
    recs = _new(before)

    off, on = _outputs(tmp_path / "off"), _outputs(tmp_path / "on")
    assert len(off) == 5 and off.keys() == on.keys()
    for name in off:
        assert on[name] == off[name], name

    for stage, kids in CHILDREN.items():
        outer = [r for r in recs if r.name == stage]
        assert len(outer) == 1, stage
        for kid in kids:
            got = [r for r in recs if r.name == kid]
            assert got, f"no {kid} span"
            for r in got:
                assert outer[0].start_ns <= r.start_ns <= r.end_ns <= outer[0].end_ns, (r, kid)
    runs = sum(r.counters.get("sfm.mapper_runs", 0) for r in recs)
    assert runs >= 1
