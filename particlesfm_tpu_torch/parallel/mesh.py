"""Device mesh and sharding helpers (port of particlesfm_tpu/parallel/mesh.py).

The reference is one controller driving a `jax.sharding.Mesh` of devices.
The port keeps that model inside one process: a mesh is an array of torch
devices with named axes, and data-parallel work runs one shard per mesh
entry, issued from the one host thread (CUDA launches are asynchronous, so
shards on different cards overlap). Entries may repeat: a mesh of
`[cpu] * 8` stands in for the reference's 8 virtual CPU devices, and
`[cuda:0] * 4` runs the sharded code on one card.

Axes used across the package:
  data  — independent work items: frames, flow pairs, motion-seg windows;
  model — intra-problem sharding: the track axis of bundle adjustment.

The data-parallel rule, for every net the pipeline runs over a mesh, is
`Mesh.map_blocks`: rows in blocks of `per`, block g on entry g % size, the
ragged tail unpadded, results gathered on entry 0. `Mesh.replicate` builds
one net per distinct device and `Mesh.place` puts a shared input there.

Across processes, `init_distributed` starts a `torch.distributed` process
group; only bundle adjustment's reductions cross it (parallel/sharded_ba.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Torch devices in an array of the mesh's shape, with named axes.

    `shape` maps each axis name to its size, as `jax.sharding.Mesh.shape`
    does; `flat` lists the devices in mesh order (entry 0 first)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs {devices.ndim} axis "
                             f"names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.flat = [torch.device(d) for d in devices.flat]

    @property
    def size(self) -> int:
        return len(self.flat)

    def distinct(self) -> list:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.flat))

    def replicate(self, build) -> dict:
        """{device: build(device)} over the distinct devices: one replica of
        a net (or any per-device state) for each."""
        return {d: build(d) for d in self.distinct()}

    def place(self, x: torch.Tensor) -> dict:
        """{device: x on device} over the distinct devices, for an input
        every block may read (a tensor already there is not copied)."""
        return self.replicate(x.to)

    def map_blocks(self, fn, n: int, per: int):
        """The mesh's one data-parallel rule: rows [g*per, (g+1)*per) of n
        go to entry g % size as `fn(device, lo, hi)`; the last block is
        ragged, not padded. Every block is issued from this thread before
        any result is gathered (CUDA launches are asynchronous, so blocks on
        different cards overlap); the results (a tensor or a tuple of
        tensors per block) are concatenated in row order on entry 0."""
        outs = [fn(self.flat[g % self.size], lo, min(lo + per, n))
                for g, lo in enumerate(range(0, n, per))]
        first = self.flat[0]
        if torch.is_tensor(outs[0]):
            return torch.cat([o.to(first) for o in outs])
        return tuple(torch.cat([o[j].to(first) for o in outs]) for j in range(len(outs[0])))

    def key(self) -> tuple:
        """The device tuple, as a hashable key (str of each entry)."""
        return tuple(str(d) for d in self.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.key()})"


class Placement(NamedTuple):
    """Where an array's dimensions go: the mesh axis each dimension is split
    over (None: not split). `spec == ()` is fully replicated."""
    mesh: Mesh
    spec: tuple


def make_mesh(shape: Optional[Sequence[int]] = None, axes: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """A mesh over `devices` (default: every visible CUDA device). Defaults
    to a 1-D 'data' mesh over all of them. Raises when CUDA is absent and
    no devices are given, as entry points do."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "CUDA is not available; pass devices=[torch.device('cpu')] (or any "
                "list of devices) to build a mesh without it")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, {len(devices)} given")
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = devices[i]
    return Mesh(arr.reshape(tuple(shape)), axes)


def mesh_for(device) -> Mesh:
    """The mesh an entry point given `device` runs on: every visible card
    for a bare "cuda", else a one-entry mesh of the device itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh()
    return make_mesh(devices=[dev])


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> Placement:
    """Split the leading dimension over `axis`, replicate the rest."""
    return Placement(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def axis_devices(mesh: Mesh, axes: Sequence[str]) -> list:
    """The devices along `axes` (the other axes at index 0), in mesh order:
    one per shard of an array split over those axes."""
    idx = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    return [torch.device(d) for d in mesh.devices[idx].flat]


def sharded_map_frames(fn, mesh: Mesh, *arrays, axis: str = "data"):
    """Map `fn` over the leading (frame, pair, window) axis, data-parallel
    over the devices along `axis`: `fn` takes a block (its rows of each
    array, on its device) and returns a tensor or a tuple of tensors, one
    row per input row. `Mesh.map_blocks` over those devices with
    ceil(n / devices) rows a block."""
    along = make_mesh(devices=axis_devices(mesh, (axis,)))
    arrays = [torch.as_tensor(a) for a in arrays]
    n = arrays[0].shape[0]
    return along.map_blocks(lambda d, lo, hi: fn(*(a[lo:hi].to(d) for a in arrays)),
                            n, -(-n // along.size))


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "nccl") -> None:
    """Start the `torch.distributed` process group that sharded bundle
    adjustment's reductions cross (`parallel/sharded_ba.py` all-reduces each
    in-process sum over it).

    With no arguments the rendezvous is `env://` (what `torchrun` sets:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); otherwise `coordinator` is
    "host:port" of rank 0 and every process passes the same num_processes
    and its own process_id. The gloo backend runs on CPU tensors."""
    import torch.distributed as dist

    if coordinator is None:
        dist.init_process_group(backend=backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs num_processes and process_id")
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
