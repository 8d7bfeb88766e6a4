"""Port parity: the viewer, overlay and timing tools (io/avi.py,
motionseg/visualize.py, sfm/colors.py, sfm/html_viewer.py, sfm/visualize.py,
utils/timer.py, utils/profiling.py `trace`).

The AVI, overlay PNG and GIF bytes equal the reference's on the same frames
and tracks; point colours are equal; the PLY numbers of `write_ply` and of
the `sfm.visualize` CLI, and the viewer's decoded HTML payloads, are within
1e-6 of the reference's (the port's float32 rotations against JAX's), on a
model the port's mapper builds from `orbit_scene`. `trace(None)` is a no-op
and `trace(dir)` writes a Chrome trace on the CPU.
"""
import base64
import json
import re
import time

import numpy as np
import pytest
import torch

from particlesfm_tpu.io import avi as javi
from particlesfm_tpu.motionseg import visualize as jvisualize
from particlesfm_tpu.sfm import colors as jcolors
from particlesfm_tpu.sfm import visualize as jsfm_visualize
from particlesfm_tpu.tracks.store import TrackArrays as JTrackArrays
from particlesfm_tpu.utils import timer as jtimer
from particlesfm_tpu_torch.io import avi
from particlesfm_tpu_torch.motionseg import visualize
from particlesfm_tpu_torch.sfm import colors
from particlesfm_tpu_torch.sfm import visualize as sfm_visualize
from particlesfm_tpu_torch.sfm.export import write_colmap_model
from particlesfm_tpu_torch.sfm.mapper import run_global_mapper
from particlesfm_tpu_torch.tracks.store import TrackArrays
from particlesfm_tpu_torch.utils import StageTimer, timer
from particlesfm_tpu_torch.utils.config import SfmConfig
from particlesfm_tpu_torch.utils.profiling import trace
from synthetic import orbit_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _frames_and_tracks(T=4, H=36, W=52, N=40):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
    xy = rng.uniform(0, [W - 1, H - 1], (N, T, 2)).astype(np.float32)
    mask = rng.random((N, T)) < 0.8
    labels = (rng.random((N, T)) < 0.4).astype(np.int8)
    return images, xy, mask, labels


def test_mjpeg_avi_bytes_equal_the_reference(tmp_path):
    images, *_ = _frames_and_tracks()
    frames = list(images) + [np.full((36, 52, 3), 77, np.uint8)]
    avi.write_mjpeg_avi(tmp_path / "a.avi", frames, fps=7, quality=85)
    javi.write_mjpeg_avi(tmp_path / "b.avi", frames, fps=7, quality=85)
    data = (tmp_path / "a.avi").read_bytes()
    assert data == (tmp_path / "b.avi").read_bytes()
    assert data[:4] == b"RIFF" and len(data) == 8 + int.from_bytes(data[4:8], "little")
    back = avi.read_mjpeg_avi_frames(tmp_path / "a.avi")
    want = javi.read_mjpeg_avi_frames(tmp_path / "b.avi")
    assert len(back) == 5 and all(np.array_equal(a, b) for a, b in zip(back, want))
    assert back[-1].shape == (36, 52, 3) and np.abs(back[-1].astype(int) - 77).max() <= 4
    with pytest.raises(ValueError):
        avi.write_mjpeg_avi(tmp_path / "c.avi", [])


@pytest.mark.parametrize("labeled", [True, False])
def test_overlay_video_bytes_equal_the_reference(tmp_path, labeled):
    images, xy, mask, labels = _frames_and_tracks()
    lab = labels if labeled else None
    visualize.write_overlay_video(tmp_path / "port", images, TrackArrays(xy, mask, lab))
    jvisualize.write_overlay_video(tmp_path / "ref", images, JTrackArrays(xy, mask, lab))
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["motion_seg.avi", "motion_seg.gif"] + [f"overlay_{t:06d}.png"
                                                           for t in range(4)]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes(), n
    img = np.asarray(visualize.draw_overlay(images[1], TrackArrays(xy, mask, lab), 1))
    assert img.shape == (36, 52, 3)
    assert len(avi.read_mjpeg_avi_frames(tmp_path / "port" / "motion_seg.avi")) == 4


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The port's mapper on a 6-view orbit scene, written as a COLMAP model."""
    d = tmp_path_factory.mktemp("model")
    sc = orbit_scene(num_views=6, num_points=80, pixel_noise=0.2, seed=11)
    rec = run_global_mapper(sc["tracks"], sc["height"], sc["width"], SfmConfig(),
                            log=lambda *a: None, device="cpu")
    write_colmap_model(rec, d / "model")
    images = np.random.default_rng(0).integers(
        0, 255, (6, sc["height"], sc["width"], 3), dtype=np.uint8)
    return rec, images, d


def _ply(path):
    text = path.read_text()
    head, body = text.split("end_header\n")
    n = int(re.search(r"element vertex (\d+)", head).group(1))
    rows = np.array([[float(v) for v in ln.split()] for ln in body.strip().splitlines()])
    assert rows.shape == (n, 6)
    return head, rows


def test_point_colors_and_write_ply_match_the_reference(model, tmp_path):
    rec, images, _ = model
    c = colors.extract_point_colors(rec, images)
    np.testing.assert_array_equal(c, jcolors.extract_point_colors(rec, images))
    for cols in (c, None):
        colors.write_ply(tmp_path / "a.ply", rec, cols)
        jcolors.write_ply(tmp_path / "b.ply", rec, cols)
        head, a = _ply(tmp_path / "a.ply")
        jhead, b = _ply(tmp_path / "b.ply")
        assert head == jhead
        assert len(a) == int(rec.track_valid.sum()) + rec.num_registered
        np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
        np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=0, atol=1e-6)


def _html_payload(path):
    html = path.read_text()
    meta = json.loads(re.search(r"const META = (\{.*?\});", html).group(1))
    f32 = [np.frombuffer(base64.b64decode(s), np.float32)
           for s in re.findall(r'b64f32\("([^"]*)"\)', html)]
    rgb = np.frombuffer(base64.b64decode(re.search(r'atob\("([^"]*)"\)', html).group(1)),
                        np.uint8)
    return meta, f32, rgb


def test_visualize_cli_matches_the_reference(model, tmp_path):
    rec, _, d = model
    outs = {}
    for name, mod in (("port", sfm_visualize), ("ref", jsfm_visualize)):
        ply, html = tmp_path / f"{name}.ply", tmp_path / f"{name}.html"
        assert mod.main(["-i", str(d / "model"), "-o", str(ply), "-w", str(html)]) == 0
        outs[name] = (_ply(ply), _html_payload(html))
    (head, a), (meta, f32, rgb) = outs["port"]
    (jhead, b), (jmeta, jf32, jrgb) = outs["ref"]
    n_pts = int(rec.track_valid.sum())
    assert head == jhead and len(a) == n_pts + 5 * rec.num_registered
    np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=0, atol=1e-6)
    assert meta["num_cameras"] == jmeta["num_cameras"] == rec.num_registered
    assert meta["name"] == jmeta["name"]
    np.testing.assert_allclose(meta["center"], jmeta["center"], rtol=0, atol=1e-6)
    assert abs(meta["radius"] - jmeta["radius"]) <= 1e-6
    np.testing.assert_array_equal(rgb, jrgb)
    assert [x.shape for x in f32] == [x.shape for x in jf32]
    for x, y in zip(f32, jf32):                    # point positions, frustum segments
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    assert len(f32[0]) == 3 * n_pts and len(f32[1]) == 8 * 2 * 3 * rec.num_registered


def test_stage_timer_matches_the_references_records(tmp_path):
    assert StageTimer is timer.StageTimer
    got, want = timer.StageTimer(), jtimer.StageTimer()
    for t in (got, want):
        with t.stage("a"):
            time.sleep(0.001)
        with t.stage("b"):
            pass
        with t.stage("a"):
            pass
        t.record("n", 3)
    assert list(got.times) == list(want.times) == ["a", "b"]
    assert got.times["a"] >= 0.001
    assert got.summary()["metrics"] == want.summary()["metrics"] == {"n": 3}
    assert got.report().count("s\n") == want.report().count("s\n") == 1
    got.dump(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text())["stage_seconds"].keys() == {"a", "b"}


def test_trace_is_a_noop_without_a_dir_and_writes_a_trace_with_one(tmp_path):
    with trace(None):
        pass
    assert not any(tmp_path.iterdir())
    with trace(tmp_path / "tr"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names
