"""The harness end to end on the CPU at a tiny size: one run prints a result
line of the expected form and comes out correct; with the timed path broken in
each way the cells can break, `correct` comes out false; the run loads no
JAX; the references import nothing of the program."""
import ast
import json
from pathlib import Path

import pytest
import torch

import run
from bench_faults import FAULTS, SFM_FAULTS
from run import CODE_ROOT, HERE

TINY = dict(height=64, width=96, frames=8)
# At 8 frames of 64x96 SfM is far rougher than at the cells' sizes: the two
# tiny scenes read a Sim3 ATE of 0.047 and 0.105 of the cameras' spread and a
# focal error up to 1.25, and with bundle adjustment skipped or cut to one LM
# step 0.32 and 0.75 (CPU). So the tiny configuration holds the ATE to 0.2
# and the focal only loosely; the other limits are the configuration's.
TINY_POSES = {"poses.ate_rel": {"max": 0.2}, "poses.focal_err": {"max": 2.0}}


def _root(tmp_path, limits=None) -> Path:
    """A checkout-like root with one tiny configuration of `sintel` and the
    real traffic mixes, cut to a pool of two."""
    bench = json.loads((CODE_ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    (tmp_path / "benchmark" / "traffic").mkdir(parents=True)
    cfg = json.loads((HERE / "configs" / "sintel.json").read_text())
    cfg.update(TINY, name="tiny")
    cfg["limits"].update(TINY_POSES)
    if limits is not None:
        cfg["limits"] = limits
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for t in ("full", "traj"):
        tr = json.loads((HERE / "traffic" / f"{t}.json").read_text())
        tr["pool"] = 2
        (tmp_path / "benchmark" / "traffic" / f"{t}.json").write_text(json.dumps(tr))
    bench["configs"] = [dict(bench["configs"][0], name="tiny", file="benchmark/configs/tiny.json")]
    bench["workloads"] = [dict(name="tiny.full", config="tiny", traffic="full", chips=1, why="t"),
                          dict(name="tiny.traj", config="tiny", traffic="traj", chips=1, why="t")]
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny.full", "tiny.traj"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _run(root, workload="tiny.full", trace=0, seed=2 ** 31 + 5):
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                      "--trace", str(trace), "--device", "cpu"])
    res, ctx, code = run.run_cell(args, root, log=lambda m: None)
    assert code == 0
    return res, ctx


@pytest.fixture(scope="module")
def good(tmp_path_factory):
    return _run(_root(tmp_path_factory.mktemp("good")))


def test_rehearsal_prints_the_result_line(good):
    res, ctx = good
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "limits"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert line["attempted"] % 2 == 0, "the window closes after whole passes over the pool"
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}      # no card: no peak_gb
    assert line["device"]["platform"] == "cpu"
    for name, row in line["limits"].items():
        assert set(row) == {"value", "limit"}
    names = set(line["limits"])
    assert {"flow.gap_mean_px", "depth.gap_mean", "seg.gap_max", "tracks.count_gap",
            "tracks.mismatched_frac", "tracks.gap_mean_px", "poses.registered_share",
            "poses.ate_rel", "poses.focal_err"} <= names


def test_no_jax_after_the_run(good):
    assert run.forbidden_modules() == []


def test_references_import_nothing_of_the_program():
    for path in list((HERE / "reference").glob("*.py")) + [HERE / "bench_judge.py",
                                                            HERE / "bench_yardstick.py",
                                                            HERE / "bench_scenes.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN + ("particlesfm_tpu_torch",), \
                    f"{path.name} imports {n}"


def test_traced_rehearsal_reads_host_metrics_only(tmp_path):
    res, ctx = _run(_root(tmp_path), workload="tiny.traj", trace=1)
    assert res["correct"] is True
    assert "breakdown" in res and res["device"]["window_s"] > 0
    # the stage spans are read; device metrics have nothing to read on the CPU
    assert {"flow.s_per_seq", "tracks.s_per_seq", "seg.s_per_seq"} <= set(res["metrics"])
    assert not {"k1_roofline", "mfu", "device.idle_pct", "sfm.s_per_seq"} & set(res["metrics"])
    assert ctx.stash["k1"], "the K1 reader saw no lookup"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from particlesfm_tpu_torch.pipeline import run as run_mod

    monkeypatch.setattr(run_mod, "_APPLY_CACHE", {})
    FAULTS[fault](monkeypatch)
    res, _ = _run(_root(tmp_path), workload="tiny.full" if fault in SFM_FAULTS else "tiny.traj")
    assert res["correct"] is False, res["limits"]
