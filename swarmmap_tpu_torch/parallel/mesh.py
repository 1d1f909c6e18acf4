"""Device lists as meshes, for multi-agent scaling.

Port of swarmmap_tpu/parallel/mesh.py.  The JAX package shards agents
(and the server BA's observations) over a `jax.sharding.Mesh` that one
controller drives; here one process drives a list of `torch.device`s the
same way.  A shard is the agents, or the observations, that sit on one
entry of the list.  A collective is a copy of each shard's partial to the
lead device (the first entry), combined there in shard order 0, 1, ...,
n-1, so two runs give the same bits; no float atomics cross shards and
`torch.distributed` is not used.  A repeated entry (`["cuda:0"] * 4`,
`["cpu"] * 8`) makes the copies no-ops, so the sharded code runs, and is
tested, on one device.  Each shard's work is enqueued before any host
read, so shards on different cards would overlap.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Mesh(NamedTuple):
    """A 1-D mesh: `devices` (one entry per shard, in shard order, repeats
    allowed) and its axis name."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]

    def size(self) -> int:
        """The number of shards (JAX's `mesh.devices.size`)."""
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """Where collectives combine their partials and results land."""
        return self.devices[0]


def visible_devices() -> list[torch.device]:
    """Every visible card, cuda:0 .. cuda:n-1 (the default device list)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices) -> list[torch.device]:
    devs = visible_devices() if devices is None else [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError('no CUDA device: pass devices=["cpu", ...] to run on the CPU')
    return devs


def agent_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'agents' axis: the first n_devices of `devices`
    (by default every visible card)."""
    devs = _devices(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(tuple(devs), ("agents",))


def obs_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'obs' axis for observation-sharded server BA
    (ops.ba.bundle_adjust_sharded).  Takes the largest power-of-two count
    of the devices, so the power-of-two-padded observation bucket always
    divides."""
    devs = _devices(devices)
    n = len(devs) if n_devices is None else min(n_devices, len(devs))
    n = 1 << (n.bit_length() - 1)  # largest power of two <= n
    return Mesh(tuple(devs[:n]), ("obs",))


def _split(x, n: int, devices):
    """Tensor leaves -> n contiguous chunks of the leading axis, chunk i on
    devices[i]; tuples (NamedTuples too) map leaf by leaf."""
    if isinstance(x, torch.Tensor):
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} must divide mesh size {n}")
        return [c.to(d) for c, d in zip(torch.chunk(x, n), devices)]
    parts = [_split(v, n, devices) for v in x]
    return [type(x)(*(p[i] for p in parts)) if hasattr(x, "_fields")
            else type(x)(p[i] for p in parts) for i in range(n)]


def shard_agents(mesh: Mesh, tree) -> list:
    """A batched-over-agents tree of tensors (a NamedTuple such as
    `pipeline.TrackInputs`) -> one tree per shard: contiguous chunks of the
    leading axis, each on its device (JAX's `P("agents")` placement).  The
    leading axis must divide the mesh size."""
    return _split(tree, mesh.size(), mesh.devices)


def psum(parts: list, lead: torch.device):
    """Sum of per-shard partials (tensors, or tuples of them) in shard
    order, on `lead`.  One partial is returned as it is."""
    if isinstance(parts[0], tuple):
        sums = [psum(list(xs), lead) for xs in zip(*parts)]
        return type(parts[0])(*sums) if hasattr(parts[0], "_fields") else tuple(sums)
    acc = parts[0].to(lead)
    for x in parts[1:]:
        acc = acc + x.to(lead)
    return acc


def all_gather(parts: list, lead: torch.device) -> torch.Tensor:
    """Per-shard tensors concatenated along the leading axis in shard
    order, on `lead`.  One part is returned as it is."""
    if len(parts) == 1:
        return parts[0].to(lead)
    return torch.cat([x.to(lead) for x in parts])

