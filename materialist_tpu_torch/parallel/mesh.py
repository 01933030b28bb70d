"""Device meshes over the caller's process group (counterpart of
``materialist_tpu/parallel/mesh.py``).

Rendering shards over the sample axis ("spp": data-parallel Monte-Carlo
estimates, a mean all-reduce) and/or the film rows ("px": for films where
each device's memory matters). Materials and envmap stay replicated; the
gradients are all-reduced. The caller starts the process group
(``torch.distributed.init_process_group``, or ``dryrun.run_ranks``): a
mesh is never a silent world of one.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    return dist.get_world_size()


def _checked(n: int) -> int:
    world = _world()
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of "
                         f"{world} ranks")
    return n


def make_mesh(n_devices: int = None, axis: str = "spp",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named ``axis`` over every rank of the process group
    (``n_devices``, if given, must be its size)."""
    n = _checked(_world() if n_devices is None else n_devices)
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def make_mesh_2d(n_px: int, n_spp: int,
                 device_type: str = "cuda") -> DeviceMesh:
    """(n_px, n_spp) mesh with axes ("px", "spp")."""
    _checked(n_px * n_spp)
    return init_device_mesh(device_type, (n_px, n_spp),
                            mesh_dim_names=("px", "spp"))
