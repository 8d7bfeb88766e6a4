"""Where the depth stage's peak device memory goes: one block of 4 frames at
1024x436 (the main path's block) through the run's depth apply, with the
allocator's peak read around every leaf module.

    python scripts/depth_memory.py          # needs a CUDA device

For each leaf module call: the peak allocation while it ran above what was
allocated when it started, less its output -- its transient memory (for a
convolution, cuDNN's workspace). Prints the largest, the block's own peak and
time, and the same block with cuDNN's benchmark mode on and with cuDNN off.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def block(apply, stack, rounds: int = 3):
    """The block's peak allocation above what was resident (GB) and its
    median time (ms, CUDA events)."""
    import torch

    apply(stack)                                   # warm-up: algorithm choice
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        apply(stack)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return (torch.cuda.max_memory_allocated() - base) / 1e9, float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("depth_memory: CUDA is not available", file=sys.stderr)
        return 1
    import particlesfm_tpu_torch  # noqa: F401  (TF32 policy)
    from particlesfm_tpu_torch.pipeline.run import _load_depth_apply
    from particlesfm_tpu_torch.utils.config import Config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.strip()}; "
          f"torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    apply = _load_depth_apply(Config(), dev)
    stack = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 436, 1024, 3), dtype=np.uint8)).to(dev)
    peak, ms = block(apply, stack)
    print(f"[depth-mem] block of 4 frames at 1024x436: peak {peak:.3f} GB above resident, "
          f"{ms:.2f} ms (cuDNN defaults)")

    rows = []
    state = {}

    def pre(mod, args):
        if not any(True for _ in mod.children()):
            torch.cuda.synchronize()
            state[id(mod)] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def post(mod, args, out):
        if id(mod) in state and torch.is_tensor(out):
            torch.cuda.synchronize()
            before = state.pop(id(mod))
            out_b = out.numel() * out.element_size()
            trans = torch.cuda.max_memory_allocated() - before - out_b
            rows.append((trans / 1e9, out_b / 1e9, mod.__class__.__name__,
                         tuple(args[0].shape), tuple(out.shape), repr(mod)[:80]))

    h1 = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    h2 = torch.nn.modules.module.register_module_forward_hook(post)
    try:
        apply(stack)
    finally:
        h1.remove()
        h2.remove()
    rows.sort(key=lambda r: -r[0])
    print(f"[depth-mem] {len(rows)} leaf module calls; transient = peak while the module "
          f"ran - allocated before it - its output")
    for trans, out_gb, kind, shp_in, shp_out, rep in rows[:10]:
        print(f"[depth-mem] transient {trans:7.3f} GB, output {out_gb:6.3f} GB  {kind} "
              f"{list(shp_in)} -> {list(shp_out)}  {rep}")
    print(f"[depth-mem] sum of all outputs {sum(r[1] for r in rows):.3f} GB, largest "
          f"transient {rows[0][0]:.3f} GB")

    torch.backends.cudnn.benchmark = True
    peak_b, ms_b = block(apply, stack)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled = False
    peak_n, ms_n = block(apply, stack)
    torch.backends.cudnn.enabled = True
    print(f"[depth-mem] same block with cudnn.benchmark on: peak {peak_b:.3f} GB, "
          f"{ms_b:.2f} ms; with cuDNN off: peak {peak_n:.3f} GB, {ms_n:.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
