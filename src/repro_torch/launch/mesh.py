"""Meshes of the port (``repro/launch/mesh.py``).

``make_production_mesh`` gives the production topology as an
``AbstractMesh``: names and sizes only, which is all the rule resolver and
the dry run read (no 256 processes exist).  ``make_test_mesh`` gives a
``DeviceMesh`` over the initialised default process group: NCCL ranks on
the card, or gloo ranks on the CPU when the caller asks for it.
"""

from __future__ import annotations

from .._device import DeviceLike, resolve_device
from ..dist.sharding import AbstractMesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16 x 16 = 256 chips (data, model).  Multi-pod: 2 x 16 x
    16 = 512 chips (pod, data, model)."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 4,
                   device: DeviceLike = None):
    """A (data, model) ``DeviceMesh`` over the default process group,
    which must already be initialised with ``data * model`` ranks (NCCL
    for the card, the default; gloo for ``device="cpu"``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs an initialised default "
                           "process group")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
