"""Plain-torch references the benchmark holds the program against.

Each module is a frozen copy of one net of the pipeline, with no kernel,
cache or batching of the program, and imports nothing of the program. The
loaders read `checkpoints/*.msgpack` (and a sidecar `.json`) themselves.
"""
from __future__ import annotations

import json
from pathlib import Path

from .checkpoint import conv_state_dict, load_msgpack, motionseg_state_dict
from .depth import DepthNet
from .motionseg import TrajOADepth
from .raft import RAFT


def load_raft(path, width: str = "compact") -> RAFT:
    blob = load_msgpack(path)
    model = RAFT(width)
    model.load_state_dict(conv_state_dict(blob["params"], blob.get("batch_stats")), strict=True)
    return model.eval()


def load_depth(path, base: int = 32) -> DepthNet:
    blob = load_msgpack(path)
    model = DepthNet(base)
    model.load_state_dict(conv_state_dict(blob["params"], blob.get("batch_stats")), strict=True)
    return model.eval()


def load_seg(path, input_hw) -> TrajOADepth:
    """The seg net at the sidecar's `input_hw` when the checkpoint has one."""
    side = Path(str(path) + ".json")
    if side.exists():
        input_hw = json.loads(side.read_text()).get("input_hw", input_hw)
    blob = load_msgpack(path)
    model = TrajOADepth(input_hw)
    model.load_state_dict(motionseg_state_dict(blob["params"], blob.get("batch_stats", {})),
                          strict=True)
    return model.eval()
