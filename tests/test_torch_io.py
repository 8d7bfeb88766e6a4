"""Port parity: host-side modules copied or re-written for the port
(config tree and overrides, .flo files, image loading, stage timer, the
COLMAP database, the reference track.npy dict and the legacy model writers)."""
import json

import numpy as np
import pytest
from PIL import Image

from particlesfm_tpu.io import flo as jflo
from particlesfm_tpu.io.images import load_image_stack as jload_image_stack
from particlesfm_tpu.pipeline import run as jrun
from particlesfm_tpu.utils import config as jconfig
from particlesfm_tpu.utils.profiling import StageTimer as JStageTimer
from particlesfm_tpu_torch.io import flo, images
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.utils import config
from particlesfm_tpu_torch.utils.profiling import StageTimer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARGV = [
    ["--image_dir", "x", "--output_dir", "y"],
    ["--image_dir", "x", "--output_dir", "y", "--assume_static", "--skip_sfm",
     "--sample_ratio", "3", "--set", "flow.selfcal=false", "--set", "track.capacity=4096",
     "--set", "flow.refine_schedule=[[1,2.0,3]]", "--set", "sfm.ba.loss=cauchy",
     "--set", "flow.iters=12", "--set", "flow.infer_scale=1"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_config_json_and_overrides_match(tmp_path, argv):
    jcfg = jrun.config_from_args(jrun.build_arg_parser().parse_args(argv))
    tcfg = run.config_from_args(run.build_arg_parser().parse_args(argv))
    jconfig.save_config(jcfg, tmp_path / "j.json")
    config.save_config(tcfg, tmp_path / "t.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    back = config.load_config(tmp_path / "j.json")
    assert json.loads(json.dumps(config._to_dict(back))) == json.loads(
        (tmp_path / "j.json").read_text())


def test_flo_files_interchange(tmp_path):
    f = np.random.default_rng(0).normal(0, 4, (9, 13, 2)).astype(np.float32)
    flo.write_flo(tmp_path / "t.flo", f)
    jflo.write_flo(tmp_path / "j.flo", f)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(jflo.read_flo(tmp_path / "t.flo"), f)
    np.testing.assert_array_equal(flo.read_flo(tmp_path / "j.flo"), f)


def test_image_stack_ppm_and_png_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 7, 11, 3), dtype=np.uint8)
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(tmp_path / f"{i:06d}.ppm")
    stack, names = images.load_image_stack(tmp_path)
    jstack, jnames = jload_image_stack(tmp_path)
    assert names == jnames and stack.dtype == np.float32
    np.testing.assert_array_equal(stack, jstack)
    np.testing.assert_array_equal(stack, frames.astype(np.float32))
    Image.fromarray(frames[0]).save(tmp_path / "000000.png")
    (tmp_path / "000000.ppm").unlink()
    stack, _ = images.load_image_stack(tmp_path)
    np.testing.assert_array_equal(stack, jload_image_stack(tmp_path)[0])


def test_image_stack_modes_and_listing_match_reference(tmp_path):
    """Grey and RGBA frames come back as RGB, other files are skipped, and an
    empty directory raises, as in the reference loader."""
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (5, 6), dtype=np.uint8)).save(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)).save(tmp_path / "b.png")
    (tmp_path / "notes.txt").write_text("not an image")
    stack, names = images.load_image_stack(tmp_path)
    jstack, jnames = jload_image_stack(tmp_path)
    assert names == jnames == ["a.png", "b.png"] and stack.shape == (2, 5, 6, 3)
    np.testing.assert_array_equal(stack, jstack)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        images.load_image_stack(empty)


def test_stage_timer_report_matches_reference():
    t, j = StageTimer(), JStageTimer()
    for timer in (t, j):
        timer.totals.update(flow=12.5, trajectories=3.25, frame_upload=0.125)
        timer.counts.update(flow=1, trajectories=1, frame_upload=2)
    assert t.report() == j.report()


def _orbit_reconstruction():
    """One reconstruction in both packages' containers: the orbit scene's
    true poses and points, its tracks (labels on 20%), one view
    unregistered, random per-observation errors, 10% invalid tracks."""
    from particlesfm_tpu.sfm.mapper import Reconstruction as JReconstruction
    from particlesfm_tpu_torch.sfm.mapper import Reconstruction
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    from synthetic import orbit_scene

    sc = orbit_scene(num_views=6, num_points=60, pixel_noise=0.3, seed=7)
    rng = np.random.default_rng(7)
    tr = sc["tracks"]
    labels = (rng.random(tr.mask.shape) < 0.2).astype(np.int8)
    tracks = TrackArrays(xy=tr.xy, mask=tr.mask, labels=labels)
    N, T = tr.mask.shape
    registered = np.ones(T, bool)
    registered[2] = False
    kw = dict(num_images=T, registered=registered, qvec=sc["q"], tvec=sc["t"],
              params=sc["params"], height=sc["height"], width=sc["width"], points=sc["X"],
              track_valid=rng.random(N) > 0.1,
              obs_frame_idx=np.tile(np.arange(T, dtype=np.int32), (N, 1)),
              obs_uv=tr.xy, obs_mask=tr.mask,
              obs_error=rng.random((N, T)).astype(np.float32), track_row=np.arange(N))
    return tracks, JReconstruction(**kw), Reconstruction(**kw)


def test_colmap_database_matches_reference(tmp_path):
    """export_tracks_to_database: every table's rows (blobs byte for byte)
    and image_match_pairs.txt equal to the reference's writer's."""
    import sqlite3

    from particlesfm_tpu.io import colmap_db as jdb
    from particlesfm_tpu_torch.io import colmap_db

    tracks, _, _ = _orbit_reconstruction()
    names = [f"{i:06d}.jpg" for i in range(tracks.num_frames)]
    ids = {}
    for tag, mod in (("j", jdb), ("t", colmap_db)):
        ids[tag] = mod.export_tracks_to_database(
            tmp_path / f"{tag}.db", tracks, 480, 640, names, sample_k=3,
            pairs_txt=str(tmp_path / f"{tag}.txt"))
    assert ids["t"] == ids["j"]
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    tables = ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")
    rows = {}
    for tag in ("j", "t"):
        con = sqlite3.connect(tmp_path / f"{tag}.db")
        rows[tag] = {tb: con.execute(f"SELECT * FROM {tb} ORDER BY 1").fetchall() for tb in tables}
        con.close()
    for tb in tables:
        assert rows["t"][tb] == rows["j"][tb], tb
    assert len(rows["t"]["matches"]) > 5
    db = colmap_db.ColmapDatabase(tmp_path / "t.db")
    m = db.read_matches(ids["t"][0], ids["t"][1])
    db.close()
    assert m is not None and m.shape[1] == 2
    assert colmap_db.image_ids_from_pair_id(colmap_db.pair_id_from_image_ids(7, 3)) == (3, 7)


def test_reference_track_npy_round_trips(tmp_path):
    """save_reference_track_npy writes the reference's bytes; either
    package's loader reads the other's file back to the same arrays."""
    from particlesfm_tpu.io import trackio as jtrackio
    from particlesfm_tpu.tracks.store import TrackArrays as JTrackArrays
    from particlesfm_tpu_torch.io import trackio

    tracks, _, _ = _orbit_reconstruction()
    jtracks = JTrackArrays(xy=tracks.xy, mask=tracks.mask, labels=tracks.labels)
    trackio.save_reference_track_npy(tmp_path / "t.npy", tracks)
    jtrackio.save_reference_track_npy(tmp_path / "j.npy", jtracks)
    assert (tmp_path / "t.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    back = trackio.load_reference_track_npy(tmp_path / "j.npy", num_frames=tracks.num_frames)
    jback = jtrackio.load_reference_track_npy(tmp_path / "t.npy")
    for a, b in ((back.xy, jback.xy), (back.mask, jback.mask), (back.labels, jback.labels)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.xy[back.mask], tracks.xy[tracks.mask])
    np.testing.assert_array_equal(back.labels[back.mask], tracks.labels[tracks.mask])


@pytest.mark.parametrize("writer", ["write_nvm", "write_bundler", "write_vrml"])
def test_legacy_model_writers_match_reference(tmp_path, writer):
    """The NVM, Bundler and VRML writers: byte-identical files."""
    from particlesfm_tpu.sfm import export as jexport
    from particlesfm_tpu_torch.sfm import export

    _, jrec, rec = _orbit_reconstruction()
    getattr(export, writer)(tmp_path / "t", rec)
    getattr(jexport, writer)(tmp_path / "j", jrec)
    got = (tmp_path / "t").read_bytes()
    assert got == (tmp_path / "j").read_bytes()
    assert len(got.splitlines()) > 50
