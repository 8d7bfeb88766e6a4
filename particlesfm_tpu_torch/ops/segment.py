"""Deterministic per-camera sums: products with one-hot camera matrices.

The reference sums per-observation values into their cameras with one-hot
contractions (ba.py, global_positioning.py). On CUDA a scatter-add
(`index_add_`, `index_put_(accumulate=True)`) sums in atomic order, so the
same inputs can give sums that differ in the last bit, and the mapper feeds
such sums into hard decisions. A matrix product sums in a fixed order, so
these helpers form the one-hot matrices chunk by chunk and multiply.
"""
from __future__ import annotations

import torch

_CHUNK_ROWS = 1 << 20


def segment_summer(idx: torch.Tensor, num: int, dtype):
    """`segment_sum` over a fixed idx [M]: the one-hot matrices are built
    once, and the returned function sums any values [M, ...] of `dtype`."""
    onehots = [torch.nn.functional.one_hot(idx[s:s + _CHUNK_ROWS], num).to(dtype).T
               for s in range(0, idx.shape[0], _CHUNK_ROWS)]

    def summed(values: torch.Tensor) -> torch.Tensor:
        flat = values.reshape(idx.shape[0], -1)
        out = torch.zeros(num, flat.shape[1], dtype=dtype, device=values.device)
        for c, oh in enumerate(onehots):
            out = out + oh @ flat[c * _CHUNK_ROWS:(c + 1) * _CHUNK_ROWS]
        return out.reshape((num,) + values.shape[1:])
    return summed


def segment_sum(idx: torch.Tensor, values: torch.Tensor, num: int) -> torch.Tensor:
    """out[s] = sum of values[m] over m with idx[m] == s. idx [M] int,
    values [M, ...]; returns [num, ...]."""
    return segment_summer(idx, num, values.dtype)(values)


def row_segment_sum(idx: torch.Tensor, w: torch.Tensor, num: int) -> torch.Tensor:
    """out[n, s] = sum_k w[n, k] [idx[n, k] == s]. idx, w [N, K]; returns [N, num]."""
    N, K = idx.shape
    rows = max(1, _CHUNK_ROWS // max(K, 1))
    outs = []
    for s in range(0, N, rows):
        oh = torch.nn.functional.one_hot(idx[s:s + rows], num).to(w.dtype)   # [C, K, num]
        outs.append((w[s:s + rows, None, :] @ oh)[:, 0])
    return torch.cat(outs) if outs else torch.zeros(0, num, dtype=w.dtype, device=w.device)
