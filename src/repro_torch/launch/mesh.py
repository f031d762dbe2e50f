"""Mesh builders (``repro.launch.mesh``), on ``torch.distributed``.

The reference's axis names and shapes: the production mesh is 16x16 =
256 devices, ``("data", "model")``; multi-pod adds a leading ``pod`` axis
(2x16x16 = 512).  Each builder is a FUNCTION, so importing this module
starts no process group.

* ``make_production_mesh`` runs on the ``fake`` backend: this process
  plays rank 0 of 256 (or 512), collectives return at once, and the
  tensors are ``meta`` tensors, so nothing is allocated: the dry run.
* ``make_test_mesh`` builds a CPU mesh over the ``gloo`` process group
  its caller started (one process a device).
* ``make_card_mesh`` builds the 1x1 mesh of one GPU over NCCL (NCCL takes
  one rank a device, so one card holds a world of one).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models.layers import MeshInfo

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """The ``fake`` backend for ``world_size`` ranks (a fresh one if
    another world size was running)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    n = 1
    for s in shape:
        n *= s
    init_fake_process_group(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """Small CPU mesh over the running ``gloo`` process group of
    ``pod * data * model`` (or ``data * model``) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh: start the gloo process group "
                           "first (torch.distributed.init_process_group)")
    if pod:
        return init_device_mesh("cpu", (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def make_card_mesh():
    """The 1x1 ``("data", "model")`` mesh of this process's GPU over NCCL,
    starting a world of one (its rendezvous an in-process ``HashStore``)
    if none runs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.HashStore(),
                                world_size=1, rank=0)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def mesh_info(mesh, global_batch: Optional[int] = None) -> MeshInfo:
    """Build MeshInfo; batch axes are dropped when the global batch does not
    divide them (e.g. long_500k batch=1 -> replicate)."""
    axes = tuple(mesh.mesh_dim_names)
    batch_axes: Tuple[str, ...] = tuple(a for a in axes if a != "model")
    if global_batch is not None:
        n = 1
        for a in batch_axes:
            n *= mesh.shape[axes.index(a)]
        if global_batch % n != 0:
            batch_axes = ()
    model_axis = "model" if "model" in axes else None
    return MeshInfo(mesh=mesh, batch_axes=batch_axes, model_axis=model_axis)
