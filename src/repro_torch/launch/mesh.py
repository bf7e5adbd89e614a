"""Production mesh construction over ``torch.distributed``'s ``DeviceMesh``.

Importing this module touches no process group; the functions need one to
exist (``torch.distributed.init_process_group``), whose world holds at least
the mesh's ranks.  The dry-run starts a fake process group of 256 or 512
ranks (``launch/dryrun.py``); a real run starts NCCL with one rank a GPU.

Mesh shapes:
  single-pod : (16, 16)      axes ('data', 'model')        = 256 ranks
  multi-pod  : (2, 16, 16)   axes ('pod', 'data', 'model') = 512 ranks

The device type comes from the caller and defaults to ``"cuda"``.
"""

from __future__ import annotations

import math

import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {have}; start a process "
            f"group of at least {n} ranks first — the dry-run starts the fake one: "
            f"init_process_group('fake', store=FakeStore(), rank=0, world_size={n}) "
            "(launch/dryrun.py does this)")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda"):
    """A mesh of the first ``prod(shape)`` ranks of the process group (e.g.
    (2, 2) on four ``gloo`` ranks in the tests)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def best_mesh_for(n_devices: int, model_parallel: int = 1, multi_pod: bool = False,
                  device_type: str = "cuda"):
    """Elastic fallback: factor whatever ranks survive a failure into the
    nearest valid (pod, data, model) mesh (scale-down restart path)."""
    mp = min(model_parallel, n_devices)
    while n_devices % mp:
        mp -= 1
    rest = n_devices // mp
    if multi_pod and rest % 2 == 0 and rest > 2:
        shape, axes = (2, rest // 2, mp), ("pod", "data", "model")
    else:
        shape, axes = (rest, mp), ("data", "model")
    return make_mesh(shape, axes, device_type)
