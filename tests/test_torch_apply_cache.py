"""The pipeline's apply cache (pipeline/run.py `_APPLY_CACHE`, port of the
reference's `_ckpt_key`/`_memo`, particlesfm_tpu/pipeline/run.py:94-116).

A loader called again with the same checkpoint, config fields and device
returns the same object; a touched checkpoint, another `flow.iters` or
another device gives a new one. A `--root_dir` run over two copies of
test_torch_slice.py's 6-frame 64x96 scene (`--skip_sfm --device cpu`)
builds RAFT, DepthNet and the seg net once each, parses each checkpoint
once, and the second sequence's outputs equal the first's.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from particlesfm_tpu_torch.flow import infer
from particlesfm_tpu_torch.io import checkpoint
from particlesfm_tpu_torch.models.depth import DepthNet
from particlesfm_tpu_torch.models.motionseg import TrajOADepth
from particlesfm_tpu_torch.models.raft import RAFT
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.synth import random_scene
from particlesfm_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_cache():
    run._APPLY_CACHE.clear()
    yield
    run._APPLY_CACHE.clear()


@pytest.mark.parametrize("loader", ["raft", "depth", "seg"])
def test_second_call_returns_the_same_apply(loader):
    fn = {"raft": run._load_raft_apply, "depth": run._load_depth_apply,
          "seg": run._load_seg_apply}[loader]
    a = fn(Config(), CPU)
    assert a is not None and fn(Config(), CPU) is a
    assert len(run._APPLY_CACHE) == 1


def test_touched_checkpoint_gives_a_new_apply(tmp_path):
    ckpt = tmp_path / "raft.msgpack"
    shutil.copy(run.DEFAULT_RAFT_CKPT, ckpt)
    cfg = Config()
    cfg.flow.checkpoint = str(ckpt)
    a = run._load_raft_apply(cfg, CPU)
    assert run._load_raft_apply(cfg, CPU) is a
    st = os.stat(ckpt)
    os.utime(ckpt, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    b = run._load_raft_apply(cfg, CPU)
    assert b is not a and run._load_raft_apply(cfg, CPU) is b


def test_config_field_and_device_are_part_of_the_key(monkeypatch):
    """The key carries the mesh's device tuple: "cuda" is every visible card
    (two here, faked), "cuda:1" that card alone."""
    built = []

    def fake(*args, **kw):
        built.append(kw.get("mesh", args[-1] if args else None).key())
        return object()

    monkeypatch.setattr(infer, "load_flow_apply_pairs", fake)
    monkeypatch.setattr(run, "_build_depth_apply", fake)
    monkeypatch.setattr(run, "_build_seg_apply", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda, cuda1 = torch.device("cuda"), torch.device("cuda", 1)
    cfg = Config()
    a = run._load_raft_apply(cfg, CPU)
    cfg.flow.iters = 4
    b = run._load_raft_apply(cfg, CPU)
    c = run._load_raft_apply(cfg, cuda)
    d = run._load_raft_apply(cfg, cuda1)
    assert len({id(a), id(b), id(c), id(d)}) == 4
    assert run._load_raft_apply(cfg, cuda) is c
    assert run._load_raft_apply(cfg, run.mesh_for(cuda)) is c
    for fn in (run._load_depth_apply, run._load_seg_apply):
        x, y = fn(cfg, CPU), fn(cfg, cuda)
        assert x is not y and fn(cfg, CPU) is x and fn(cfg, cuda) is y
    both = ("cuda:0", "cuda:1")
    assert built == [("cpu",), ("cpu",), both, ("cuda:1",)] + [("cpu",), both] * 2


T, H, W = 6, 64, 96


@pytest.fixture
def two_sequences(tmp_path):
    sc = random_scene(np.random.default_rng(0), num_views=T, height=H, width=W,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    for seq in ("seq_a", "seq_b"):
        (tmp_path / seq / "images").mkdir(parents=True)
        for i in range(T):
            Image.fromarray(sc.render(i)).save(tmp_path / seq / "images" / f"{i:06d}.png")
    return tmp_path


def _counting(monkeypatch, cls, counts, name):
    init = cls.__init__

    def counted(self, *a, **kw):
        counts[name] = counts.get(name, 0) + 1
        init(self, *a, **kw)

    monkeypatch.setattr(cls, "__init__", counted)


def test_root_dir_run_builds_each_net_once(two_sequences, monkeypatch):
    root = two_sequences
    counts, parsed = {}, []
    for cls, name in ((RAFT, "raft"), (DepthNet, "depth"), (TrajOADepth, "seg")):
        _counting(monkeypatch, cls, counts, name)
    load = checkpoint.load_msgpack

    def counted_load(path):
        parsed.append(os.path.basename(str(path)))
        return load(path)

    monkeypatch.setattr(checkpoint, "load_msgpack", counted_load)
    monkeypatch.setattr(infer, "load_msgpack", counted_load)
    assert run.main(["--root_dir", str(root), "--skip_sfm", "--device", "cpu",
                     "--set", "track.capacity=4096"]) == 0
    assert counts == {"raft": 1, "depth": 1, "seg": 1}
    assert sorted(parsed) == sorted(p.name for p in (run.DEFAULT_RAFT_CKPT,
                                                     run.DEFAULT_DEPTH_CKPT,
                                                     run.DEFAULT_SEG_CKPT))
    a, b = (root / s / "particlesfm_tpu" for s in ("seq_a", "seq_b"))
    assert json.loads((a / "selfcal.json").read_text()) == \
        json.loads((b / "selfcal.json").read_text())
    for sub in ("trajectories", "trajectories_labeled"):
        za, zb = np.load(a / sub / "tracks.npz"), np.load(b / sub / "tracks.npz")
        assert sorted(za.files) == sorted(zb.files) and len(za["xy"]) > 100
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    assert (a / "config.json").read_bytes() == (b / "config.json").read_bytes()
