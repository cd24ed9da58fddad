"""Device meshes (port of ``repro.launch.mesh``), over
``torch.distributed.device_mesh.init_device_mesh`` with the reference's axis
names: ``("data", "model")`` on one pod, ``("pod", "data", "model")`` across
pods.

A ``DeviceMesh`` needs a process group of as many ranks as it has devices
(``torch.distributed.init_process_group``, or ``torchrun``'s environment).
The sharding rules read only a mesh's shape and axis names, so
:func:`abstract_mesh` stands in for a mesh of any size in one process (the
tests check the (16, 16) and (2, 16, 16) layouts that way).  Every mesh here
is built by a function, never at import.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or processes: what
    ``distributed.sharding`` reads of a ``DeviceMesh``."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.mesh_dim_names} differ "
                             "in rank")


def abstract_mesh(shape, axes) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    current process group (initialised before; its world size must be the
    product of ``shape``), on the cards unless ``device_type="cpu"`` (gloo)."""
    dev_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
    data=16, model=16) = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(model: int | None = None, *, device_type: str = "cuda"):
    """(data, model) over every rank of the process group, ``model``
    defaulting to 1."""
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into a model axis of {model}")
    return make_mesh((n // model, model), ("data", "model"), device_type=device_type)


def mesh_axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh_axis_names(mesh).index(name)])


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch: ('pod', 'data') when pod exists."""
    return tuple(a for a in mesh_axis_names(mesh) if a in ("pod", "data"))
