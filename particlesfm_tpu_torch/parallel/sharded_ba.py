"""Mesh-sharded bundle adjustment (port of particlesfm_tpu/parallel/sharded_ba.py).

The track axis of the BA problem is split into contiguous blocks, one per
mesh entry. Each shard eliminates its own points (the O(N) work) and only
the reduced camera-system pieces ([V, 6, 6]-scale) and the costs are summed
over the shards: the communication pattern of distributed sparse-Schur BA
(cameras replicated, points partitioned).

The reference runs the shards under `shard_map` with `jax.lax.psum`. Here
every shard is a thread of this process running `bundle_adjust` on its
device, and `_ShardSum` is the in-process psum. The shards take turns: one
thread runs at a time, from one reduction to the next, as the one host
thread of the reference issues every device's work (host threads that ran
at once would trade the interpreter lock at every torch call). Shard s
deposits its tensor and hands the turn to shard s + 1; the last shard sums
the deposits in shard order on its device (then all-reduces the sum over
the `torch.distributed` process group when one is initialised) and hands
the turn back to shard 0; each shard takes a copy of the one result when
its turn comes. The copies are bit-identical, so every shard's host loop
takes the same accept and stop decisions. CUDA launches are asynchronous,
so shards on different cards still overlap on the devices.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..globalsfm.ba import BAState, bundle_adjust
from ..globalsfm.tracks3d import TrackObs
from .mesh import Mesh, axis_devices

BARRIER_TIMEOUT_S = 600.0


class _ShardSum:
    """psum over shard threads that take turns, with the result on each
    shard's device. A shard that raises, or waits longer than `timeout` for
    its turn, breaks the ring: every waiting shard then raises
    threading.BrokenBarrierError."""

    def __init__(self, devices, timeout: float):
        self.devices = devices
        self.deposits = [None] * len(devices)
        self.result = None
        self.timeout = timeout
        self.turn = 0
        self.broken = False
        self.cond = threading.Condition()
        self.group = _process_group()

    def wait_turn(self, shard: int) -> None:
        with self.cond:
            if not self.cond.wait_for(lambda: self.turn == shard or self.broken,
                                      self.timeout):
                self.broken = True
                self.cond.notify_all()
            if self.broken:
                raise threading.BrokenBarrierError

    def pass_turn(self, shard: int) -> None:
        """Hand the turn on from `shard` (after the last, back to shard 0)."""
        with self.cond:
            self.turn = (shard + 1) % len(self.devices)
            self.cond.notify_all()

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()

    def reducer(self, shard: int):
        def psum(x: torch.Tensor) -> torch.Tensor:
            self.deposits[shard] = x
            if shard == len(self.devices) - 1:
                total = self.deposits[0]
                for d in self.deposits[1:]:
                    total = total + d.to(total.device)
                if self.group:
                    import torch.distributed as dist

                    dist.all_reduce(total)
                self.result = total
            self.pass_turn(shard)
            self.wait_turn(shard)
            return self.result.to(self.devices[shard], copy=True)
        return psum


def _process_group() -> bool:
    """Whether a torch.distributed process group spans this call."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _pad_tracks(X, obs: TrackObs, point_mask, pad: int):
    """Append `pad` tracks that contribute nothing: X at the origin,
    point_mask 0, every observation slot masked off."""
    if not pad:
        return X, obs, point_mask
    K = obs.frame_idx.shape[1]
    X = torch.cat([X, X.new_zeros(pad, 3)])
    point_mask = torch.cat([point_mask, point_mask.new_zeros(pad)])
    obs = TrackObs(
        frame_idx=torch.cat([obs.frame_idx, obs.frame_idx.new_zeros(pad, K)]),
        uv=torch.cat([obs.uv, obs.uv.new_zeros(pad, K, 2)]),
        mask=torch.cat([obs.mask, obs.mask.new_zeros(pad, K)]))
    return X, obs, point_mask


def sharded_bundle_adjust(
    mesh: Mesh,
    q, t, params, X, obs: TrackObs, free_mask, point_mask,
    axes: tuple = ("data", "model"),
    **kwargs,
) -> BAState:
    """bundle_adjust with the tracks split over the given mesh axes.

    The shards are the mesh entries along `axes` in mesh order, times the
    processes of an initialised `torch.distributed` group: process r runs
    shards r * local .. (r + 1) * local - 1 of the same (whole) problem,
    which every process passes. The track axis is padded to a multiple of
    the shard count with tracks that contribute nothing, each shard runs
    `bundle_adjust(..., reduce_fn=psum)` in a thread of its own on its
    device, and X is gathered back in track order (on the device of X)
    without the padding; poses, intrinsics and costs are shard 0's.

    With one shard in all this is `bundle_adjust`. An exception in any
    shard breaks the ring of turns and is raised here; a shard that waits
    longer than BARRIER_TIMEOUT_S for its turn raises too.
    """
    devices = axis_devices(mesh, axes)
    local = len(devices)
    world, rank = 1, 0
    if _process_group():
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
    nd = local * world
    if nd <= 1:
        return bundle_adjust(q, t, params, X, obs, free_mask, point_mask, **kwargs)

    N = X.shape[0]
    Xp, obsp, pmp = _pad_tracks(X, obs, point_mask, (-N) % nd)
    per = Xp.shape[0] // nd
    summer = _ShardSum(devices, BARRIER_TIMEOUT_S)
    results, errors = [None] * local, [None] * local
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

    def block(x, s):
        lo = (rank * local + s) * per
        return x[lo:lo + per].to(devices[s])

    def run(s: int):
        dev = devices[s]
        try:
            summer.wait_turn(s)
            with torch.set_grad_enabled(grad), torch.inference_mode(inference), \
                    (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                results[s] = bundle_adjust(
                    q.to(dev), t.to(dev), params.to(dev), block(Xp, s),
                    TrackObs(*(block(v, s) for v in obsp)), free_mask.to(dev),
                    block(pmp, s), reduce_fn=summer.reducer(s), **_on(kwargs, dev))
            summer.pass_turn(s)
        except BaseException as e:        # noqa: BLE001  (re-raised by the caller)
            errors[s] = e
            summer.abort()

    threads = [threading.Thread(target=run, args=(s,), name=f"ba-shard-{s}", daemon=True)
               for s in range(local)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    failed = [e for e in errors if e is not None]
    if failed:
        # the shard's own error, not the broken-ring errors it caused in the others
        cause = next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                     None)
        if cause is not None:
            raise cause
        raise RuntimeError(f"sharded_bundle_adjust: a shard waited more than "
                           f"{summer.timeout:.0f} s for its turn") from failed[0]
    X_out = torch.cat([r.X.to(devices[0]) for r in results])
    if world > 1:
        import torch.distributed as dist

        parts = [torch.empty_like(X_out) for _ in range(world)]
        dist.all_gather(parts, X_out)
        X_out = torch.cat(parts)
    st = results[0]
    return BAState(q=st.q.to(q.device), t=st.t.to(t.device), X=X_out[:N].to(X.device),
                   params=st.params.to(params.device), cost=st.cost.to(X.device),
                   lam=st.lam.to(X.device), iters=st.iters)


def _on(kwargs: dict, dev) -> dict:
    """kwargs with tensors (focal_bounds) moved to `dev`."""
    return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kwargs.items()}
