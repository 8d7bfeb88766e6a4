"""Torch RAFT checkpoint -> flax parameter trees (port of
particlesfm_tpu/models/convert_raft.py; numpy only).

Maps a released `raft-things` torch state dict (keys like
`module.fnet.layer1.0.conv1.weight`) onto the flax RAFT tree of the repo's
checkpoints, which both packages load. Convolution kernels transpose
[O, I, kh, kw] -> [kh, kw, I, O]; torch InstanceNorm2d layers are
parameter-free and map to the functional instance norm; cnet BatchNorm
running stats land in the `batch_stats` collection.

CLI:  python -m particlesfm_tpu_torch.models.convert_raft raft-things.pth out.msgpack
writes out.msgpack and its sidecar out.msgpack.json ({"variant": "things",
"iters": 20}), which `run_pipeline` loads through `--raft_ckpt out.msgpack`.
The pipeline's GRU iteration count is its own `flow.iters` (default 8),
not the sidecar's: run princeton-vl/RAFT's 20 with
`--raft_ckpt out.msgpack --set flow.iters=20`.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

# The sidecar the CLI writes beside its msgpack: `flow.infer.load_model` builds
# the raft-things widths for it, and `flow.infer`'s applies called without an
# iteration count run its `iters`, the 20 of princeton-vl/RAFT's demo.py
# (`run_pipeline` always passes its `flow.iters`).
SIDECAR = {"variant": "things", "iters": 20}


def _conv(sd, torch_name):
    w = np.asarray(sd[f"{torch_name}.weight"])
    out = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{torch_name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{torch_name}.bias"])
    return out


def _bn(sd, torch_name):
    params = {
        "scale": np.asarray(sd[f"{torch_name}.weight"]),
        "bias": np.asarray(sd[f"{torch_name}.bias"]),
    }
    stats = {
        "mean": np.asarray(sd[f"{torch_name}.running_mean"]),
        "var": np.asarray(sd[f"{torch_name}.running_var"]),
    }
    return params, stats


def _encoder(sd, prefix, batch_norm: bool):
    params: Dict = {"conv1": _conv(sd, f"{prefix}.conv1"),
                    "conv2": _conv(sd, f"{prefix}.conv2")}
    stats: Dict = {}
    if batch_norm:
        params["norm1"], stats["norm1"] = _bn(sd, f"{prefix}.norm1")
    for li in (1, 2, 3):
        for bi in (0, 1):
            tp = f"{prefix}.layer{li}.{bi}"
            name = f"layer{li}_{bi}"
            block = {"conv1": _conv(sd, f"{tp}.conv1"),
                     "conv2": _conv(sd, f"{tp}.conv2")}
            bstats = {}
            if batch_norm:
                block["norm1"], bstats["norm1"] = _bn(sd, f"{tp}.norm1")
                block["norm2"], bstats["norm2"] = _bn(sd, f"{tp}.norm2")
            if f"{tp}.downsample.0.weight" in sd:
                block["downsample"] = _conv(sd, f"{tp}.downsample.0")
                if batch_norm:
                    block["norm3"], bstats["norm3"] = _bn(sd, f"{tp}.downsample.1")
            params[name] = block
            if bstats:
                stats[name] = bstats
    return params, stats


def convert_torch_raft(state_dict) -> Dict:
    """torch state dict -> {'params': ..., 'batch_stats': ...} for models.raft.RAFT."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}
    params["fnet"], _ = _encoder(sd, "fnet", batch_norm=False)
    params["cnet"], cnet_stats = _encoder(sd, "cnet", batch_norm=True)
    if cnet_stats:
        stats["cnet"] = cnet_stats

    ub = "update_block"
    params["update_block"] = {
        "encoder": {
            "convc1": _conv(sd, f"{ub}.encoder.convc1"),
            "convc2": _conv(sd, f"{ub}.encoder.convc2"),
            "convf1": _conv(sd, f"{ub}.encoder.convf1"),
            "convf2": _conv(sd, f"{ub}.encoder.convf2"),
            "conv": _conv(sd, f"{ub}.encoder.conv"),
        },
        "gru": {
            name: _conv(sd, f"{ub}.gru.{name}")
            for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")
        },
        "flow_head": {
            "conv1": _conv(sd, f"{ub}.flow_head.conv1"),
            "conv2": _conv(sd, f"{ub}.flow_head.conv2"),
        },
        "mask_conv1": _conv(sd, f"{ub}.mask.0"),
        "mask_conv2": _conv(sd, f"{ub}.mask.2"),
    }
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def fake_torch_state_dict_from_flax(variables) -> Dict:
    """Inverse mapping (testing aid): flax variables -> torch-shaped state dict."""
    sd = {}

    def put_conv(torch_name, node):
        sd[f"{torch_name}.weight"] = np.transpose(node["kernel"], (3, 2, 0, 1))
        if "bias" in node:
            sd[f"{torch_name}.bias"] = np.asarray(node["bias"])

    def put_bn(torch_name, pnode, snode):
        sd[f"{torch_name}.weight"] = np.asarray(pnode["scale"])
        sd[f"{torch_name}.bias"] = np.asarray(pnode["bias"])
        sd[f"{torch_name}.running_mean"] = np.asarray(snode["mean"])
        sd[f"{torch_name}.running_var"] = np.asarray(snode["var"])

    p = variables["params"]
    s = variables.get("batch_stats", {})
    for enc, bn in (("fnet", False), ("cnet", True)):
        put_conv(f"{enc}.conv1", p[enc]["conv1"])
        put_conv(f"{enc}.conv2", p[enc]["conv2"])
        if bn:
            put_bn(f"{enc}.norm1", p[enc]["norm1"], s[enc]["norm1"])
        for li in (1, 2, 3):
            for bi in (0, 1):
                name = f"layer{li}_{bi}"
                tp = f"{enc}.layer{li}.{bi}"
                put_conv(f"{tp}.conv1", p[enc][name]["conv1"])
                put_conv(f"{tp}.conv2", p[enc][name]["conv2"])
                if bn:
                    put_bn(f"{tp}.norm1", p[enc][name]["norm1"], s[enc][name]["norm1"])
                    put_bn(f"{tp}.norm2", p[enc][name]["norm2"], s[enc][name]["norm2"])
                if "downsample" in p[enc][name]:
                    put_conv(f"{tp}.downsample.0", p[enc][name]["downsample"])
                    if bn:
                        put_bn(f"{tp}.downsample.1", p[enc][name]["norm3"],
                               s[enc][name]["norm3"])
    ub = p["update_block"]
    for k in ("convc1", "convc2", "convf1", "convf2", "conv"):
        put_conv(f"update_block.encoder.{k}", ub["encoder"][k])
    for k in ub["gru"]:
        put_conv(f"update_block.gru.{k}", ub["gru"][k])
    put_conv("update_block.flow_head.conv1", ub["flow_head"]["conv1"])
    put_conv("update_block.flow_head.conv2", ub["flow_head"]["conv2"])
    put_conv("update_block.mask.0", ub["mask_conv1"])
    put_conv("update_block.mask.2", ub["mask_conv2"])
    return sd


def main(argv=None):
    import argparse

    import torch

    from ..io.checkpoint import save_msgpack

    ap = argparse.ArgumentParser()
    ap.add_argument("torch_ckpt")
    ap.add_argument("out_msgpack")
    args = ap.parse_args(argv)
    sd = torch.load(args.torch_ckpt, map_location="cpu")
    sd = {k: v.numpy() for k, v in sd.items()}
    save_msgpack(args.out_msgpack, convert_torch_raft(sd))
    Path(args.out_msgpack + ".json").write_text(json.dumps(SIDECAR, indent=2))
    print(f"wrote {args.out_msgpack} and its sidecar {args.out_msgpack}.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
