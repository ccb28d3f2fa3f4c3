"""Meshes of the port (functions, not constants: importing this module
opens no process group).

Port of ``repro.launch.mesh``. The reference's production mesh is 256 or
512 placeholder host devices (``XLA_FLAGS``); here it is a ``DeviceMesh``
over a ``"fake"`` process group of 256 or 512 ranks in one process
(``torch.testing._internal.distributed.fake_pg``): its collectives move
nothing and tensors on it are ``meta`` stand-ins, so nothing is
allocated. A process holds one default group, so the dry run owns its
process, as the reference's does for ``XLA_FLAGS``.
"""
from __future__ import annotations

import math

import torch

PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}
PRODUCTION_SHAPES = {False: (16, 16), True: (2, 16, 16)}


def _default_group(backend: str, world_size: int, store_factory) -> None:
    """Make the default process group ``backend`` over ``world_size``
    ranks, this process rank 0, replacing another one of this process."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == backend \
                and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group(backend, store=store_factory(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod.

    Axes: "data" (batch / fsdp), "model" (tensor / expert parallel), and for
    multi-pod a leading "pod" axis that shards batch only. The mesh's
    device type is "cuda" (nothing touches a card: every tensor on it is a
    ``meta`` stand-in), so DTensor lowers a shard-to-shard move to an
    all-to-all, as on the cards, where a "cpu" mesh would gather.
    """
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = PRODUCTION_SHAPES[multi_pod]
    n = math.prod(shape)
    _default_group("fake", n, FakeStore)
    return DeviceMesh("cuda", torch.arange(n).view(shape),
                      mesh_dim_names=PRODUCTION_AXES[multi_pod])


def make_host_mesh(device=None):
    """Degenerate 1x1 ("data", "model") mesh over one real device: gloo on
    the CPU, nccl on the card (default ``cuda``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    _default_group("nccl" if device.type == "cuda" else "gloo", 1,
                   dist.HashStore)
    return DeviceMesh(device.type, [[0]], mesh_dim_names=("data", "model"))
