"""The readers of the program's own spans and counters (`bench_spans.py`)
in a traced CPU rehearsal: each reports, except the count of host reads,
which needs a device trace; and the warm-up sequence's records, made before
the window opened, are not counted."""
import json

import pytest

import bench_spans
from run import CODE_ROOT
from test_bench_harness import _root, _run

# metric prefix -> the program's span it reads
SPANS = {s: s for s in ["flow.net", "flow.refine", "flow.selfcal", "tracks.scan",
                        "tracks.assemble", "sfm.pairs", "sfm.twoview", "sfm.rotations",
                        "sfm.positions", "sfm.ba", "sfm.export"]}
SPANS["flow.upload"] = "frame_upload"


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    from particlesfm_tpu_torch.utils import profiling

    try:
        yield _run(_root(tmp_path_factory.mktemp("spans")), workload="tiny.full", trace=1)
    finally:
        profiling.disable()


def test_every_new_metric_is_in_the_traced_line(traced):
    res, ctx = traced
    bench = json.loads((CODE_ROOT / "BENCHMARK.json").read_text())
    new = {m["name"] for m in bench["per_layer"] if m["source"] in ("program_span",
                                                                     "program_counter")}
    assert new == {f"{s}.s_per_seq" for s in SPANS} | {"sfm.mapper_runs_per_seq"}
    assert res["correct"] is True
    assert new <= set(res["metrics"])
    assert "sfm.host_reads_per_seq" not in res["metrics"]     # no device trace on the CPU
    assert res["metrics"]["sfm.mapper_runs_per_seq"]["value"] >= 1


@pytest.mark.parametrize("metric", SPANS)
def test_the_warmup_is_not_counted(traced, metric):
    from particlesfm_tpu_torch.utils import profiling

    res, ctx = traced
    span = SPANS[metric]
    lo, hi = ctx.window_ns
    mine = [r for r in profiling.records() if r.name == span]
    inside = [r for r in mine if lo <= r.start_ns < hi]
    assert len(inside) < len(mine), "the warm-up sequence made no record before the window"
    flows = [r for r in profiling.records() if r.name == "flow" and lo <= r.start_ns < hi]
    assert len(flows) == ctx.attempted == ctx.sequences
    want = sum(r.seconds() for r in inside) / ctx.sequences
    assert res["metrics"][f"{metric}.s_per_seq"]["value"] == pytest.approx(want, rel=1e-12)
    assert bench_spans.s_per_seq(ctx, span) == pytest.approx(want, rel=1e-12)
