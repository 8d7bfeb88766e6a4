"""particlesfm_tpu_torch — the PyTorch/CUDA port of particlesfm_tpu.

Mirrors the JAX package's subpackage layout module for module; the JAX
package is the reference each module is held against (tests/test_torch_*.py).
The port imports torch, numpy and the standard library only.

Device policy: entry points (`pipeline.run.run_pipeline`,
`flow.infer.load_flow_apply_pairs`, the CLI) run on CUDA unless the caller
asks for the CPU, and raise when CUDA is absent — they never fall back.
Functions that take tensors compute on the tensors' device.
"""
import torch as _torch

# The reference computes in true f32 ("highest" matmul precision,
# particlesfm_tpu/__init__.py:13). cuDNN convolutions default to TF32 on
# Hopper, which keeps ~3 decimal digits; turn it off for matmuls and convs.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device="cuda") -> _torch.device:
    """The torch device an entry point runs on; CUDA must exist if asked for."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    return dev
