"""Meshes over the ranks of a ``torch.distributed`` job (the JAX package's
``launch/mesh.py``).

``make_local_mesh`` lays a ``DeviceMesh`` with axes ``("data", "model")``
over every rank of the default process group, one device a rank (rank r on
``cuda:r % device_count``).  The caller starts the group first
(``torch.distributed.init_process_group``: NCCL on the card, gloo on the
CPU; ``launch/train.py --distributed`` does it from torchrun's
environment).

Production meshes (the reference's dry run over 256 and 512 chips):
Single pod  : (16, 16)      axes ("data", "model")
Multi pod   : (2, 16, 16)   axes ("pod", "data", "model")
``make_production_mesh`` builds them over a job of that many ranks, real
or faked in one process (torch's ``fake`` backend: ``launch/dryrun.py``,
where CUDA is named without a card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def fake_job() -> bool:
    """True in a job faked in one process: the default process group is
    torch's ``fake`` backend (``launch/dryrun.py``), whose collectives
    return at once; a mesh there names CUDA without a card."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_backend() == "fake"


def _device_type(device_type: Optional[str]) -> str:
    """CUDA unless the caller names another; raises without it."""
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available() and not fake_job():
        raise RuntimeError("a mesh on cuda needs a CUDA device; pass device_type='cpu' to lay it over the CPU")
    return device_type


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group before building a mesh")
    return dist.get_world_size()


def make_local_mesh(model: Optional[int] = None, data: Optional[int] = None, device_type: Optional[str] = None):
    """A (data, model) ``DeviceMesh`` over every rank; (world, 1) by
    default, as the reference's."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _device_type(device_type)
    n = _world()
    if model is None:
        model = 1
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh over {n} ranks")
    if dev == "cuda" and not fake_job():
        import torch.distributed as dist

        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev, (data, model), mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over a job of 256 or 512
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world()
    if n != shape[0] * shape[1] * (shape[2] if multi_pod else 1):
        raise RuntimeError(f"the production mesh {shape} needs {256 * (2 if multi_pod else 1)} ranks, the job has {n} "
                           "(a dry run fakes such a job: python -m repro_torch.launch.dryrun)")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)
