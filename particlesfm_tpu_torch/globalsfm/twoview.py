"""Random minimal samples for batched RANSAC
(port of particlesfm_tpu/globalsfm/twoview.py:153-161).

The uniform draws are an input: callers pass the reference's draws to
reproduce its hypotheses, or draws from a seeded `torch.Generator`. Torch's
generators cannot replay `jax.random` streams; `threefry_split` and
`threefry_uniform` recompute them in numpy (threefry2x32 with JAX's
partitionable counters, its default since JAX 0.5).
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 hash of counters (x1, x2) under the key
    (k1, k2); uint32 arrays that broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = x1 ^ ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r)))
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def threefry_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2**32: uint32 [2]."""
    return np.array([0, seed], np.uint32)


def threefry_split(keys: np.ndarray, num: int) -> np.ndarray:
    """`jax.random.split(key, num)` of each key in `keys` [..., 2]:
    uint32 [..., num, 2]."""
    keys = np.asarray(keys, np.uint32)
    count = np.arange(num, dtype=np.uint32)
    b1, b2 = _threefry2x32(keys[..., 0:1], keys[..., 1:2], np.zeros_like(count), count)
    return np.stack([b1, b2], -1)


def threefry_uniform(keys: np.ndarray, shape) -> np.ndarray:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)) of each key in
    `keys` [..., 2]: [..., *shape]."""
    keys = np.asarray(keys, np.uint32)
    count = np.arange(int(np.prod(shape)), dtype=np.uint32)
    b1, b2 = _threefry2x32(keys[..., 0:1], keys[..., 1:2], np.zeros_like(count), count)
    mant = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = mant.view(np.float32) - np.float32(1.0)
    return u.reshape(keys.shape[:-1] + tuple(shape))


def sample_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Random indices of valid entries, per pair.

    u: [P, S, k] uniform draws in [0, 1); mask: [P, M] bool. Returns
    [P, S, k] int64 indices into M, each a valid entry of its pair (index 0
    of the valid-first order when a pair has no valid entry)."""
    # valid-first order; stable, as jnp.argsort is, so ties keep index order
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    count = torch.clamp(mask.sum(-1), min=1).to(u.dtype)
    idx = (u * count[:, None, None]).to(torch.int64)
    P = u.shape[0]
    return torch.gather(order, 1, idx.reshape(P, -1)).reshape(idx.shape)


def uniform_draws(shape, u=None, generator=None, device=None) -> torch.Tensor:
    """`u` when given (checked against `shape`), else U[0, 1) draws of
    `shape` from `generator` on `device`."""
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"injected draws have shape {tuple(u.shape)}, "
                             f"expected {tuple(shape)}")
        return u
    return torch.rand(shape, generator=generator, device=device)
