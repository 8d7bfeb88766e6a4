"""CUDA kernel tests of the port: each kernel against its plain version.

Marked `cuda`; they skip without a CUDA device. This file imports torch and
the port only (no JAX), so it runs on a GPU machine without the reference:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from particlesfm_tpu_torch.models.raft import build_corr_pyramid
from particlesfm_tpu_torch.ops import corr_lookup as cl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,H8,W8,levels,radius", [
    (8, 55, 128, 4, 4),      # the main path's block at 1024x436
    (3, 13, 21, 4, 4),       # odd sizes: level 3 is 1x2
    (2, 16, 24, 2, 1),
    (1, 9, 10, 1, 3),
])
def test_corr_lookup_kernel_matches_plain(cuda, B, H8, W8, levels, radius):
    g = torch.Generator(device=cuda).manual_seed(0)
    f1 = torch.randn(B, 64, H8, W8, generator=g, device=cuda)
    f2 = torch.randn(B, 64, H8, W8, generator=g, device=cuda)
    pyr = build_corr_pyramid(f1, f2, levels)
    P = H8 * W8
    coords = torch.rand(B, P, 2, generator=g, device=cuda) * torch.tensor(
        [W8 + 8.0, H8 + 8.0], device=cuda) - 4.0
    far = torch.rand(B, P, generator=g, device=cuda) < 0.2
    coords[far] = torch.tensor([-1e4, 3e4], device=cuda)
    before = cl.launches
    got = cl.lookup_corr(pyr, coords, radius)
    assert cl.launches == before + 1
    want = cl.lookup_corr_plain(pyr, coords, radius)
    torch.cuda.synchronize()
    scale = float(pyr[0].abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert bool((got[far] == 0).all())


def test_corr_lookup_kernel_rejects_bad_input(cuda):
    pyr = [torch.zeros(1, 4, 2, 2, device=cuda)]
    with pytest.raises(ValueError):
        cl.lookup_corr_cuda(pyr, torch.zeros(1, 4, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        cl.lookup_corr_cuda(pyr * 5, torch.zeros(1, 4, 2, device=cuda))
