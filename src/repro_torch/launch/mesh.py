"""Device meshes (port of ``repro.launch.mesh``).

A mesh has named axes: ``("data", "model")`` on one pod of 16 x 16 = 256
devices, ``("pod", "data", "model")`` on two pods (2, 16, 16) = 512.  Two
kinds of mesh serve the port:

- :class:`MeshSpec`, axis names and sizes and nothing else.  The sharding
  plan (``distributed.sharding``) and the dry-run (``launch.dryrun``)
  need no device, so they take one of these on any host;
- a ``torch.distributed.device_mesh.DeviceMesh`` over an initialised
  process group (:func:`init_mesh`), on which the steps run for real.

Both answer ``.axis_names`` and ``.shape`` as the reference's mesh does
(:func:`axis_sizes` reads either).  No function here builds a
single-device mesh silently: a real mesh needs a process group of exactly
its size.  :func:`process_group` opens a one-process group without a TCP
port (a ``HashStore``), which is how one card runs the distributed code
path.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

__all__ = ["MeshSpec", "make_production_mesh", "init_mesh", "mesh_ctx",
           "dp_axes", "batch_axes", "axis_sizes", "mesh_size",
           "process_group", "submesh"]


@dataclass(frozen=True)
class MeshSpec:
    """A device-free mesh: ``sizes`` per axis in ``names`` order."""
    sizes: tuple
    names: tuple

    def __post_init__(self):
        if len(self.sizes) != len(self.names):
            raise ValueError(f"mesh sizes {self.sizes} and axes "
                             f"{self.names} differ in length")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, (int(s) for s in self.sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a :class:`MeshSpec`, a ``DeviceMesh`` or any
    object with the reference mesh's ``.shape`` mapping and
    ``.axis_names``."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


_AMBIENT: list = []


@contextlib.contextmanager
def mesh_ctx(mesh):
    """Make ``mesh`` the ambient mesh (``distributed.sharding.
    ambient_mesh``) for the body, as ``jax.set_mesh`` does for the
    reference."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def init_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group; raises when there is none or when its world size is
    not the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"mesh {shape}: no process group is initialised "
                           f"(torch.distributed.init_process_group, or "
                           f"launch.mesh.process_group for one process)")
    if dist.get_world_size() != n:
        raise ValueError(f"need {n} ranks for mesh {shape}, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``: a ``DeviceMesh`` when a process
    group of that size is up, else a :class:`MeshSpec` (the plan and the
    dry-run need no devices)."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        return init_mesh(shape, axes, device_type)
    return MeshSpec(shape, axes)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel / FSDP axes of a mesh (everything but 'model')."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def submesh(mesh, axes: tuple):
    """The 1-D ``DeviceMesh`` over ``axes`` of a ``DeviceMesh``: the axis
    itself, or several flattened into one (FSDP over ``("pod", "data")``,
    the reference's ``dp_axes``; a batch-1 decode cache over ``("data",
    "model")``)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[axes]._flatten("_".join(axes))


def batch_axes(mesh):
    """Spec entry for the global-batch dimension."""
    axes = dp_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


@contextlib.contextmanager
def process_group(device=None):
    """A one-process group for the body (NCCL for a CUDA ``device``, the
    default, gloo for ``"cpu"``), over an in-memory ``HashStore``, so no
    TCP port is opened; destroyed on exit.  Yields the device type."""
    import torch
    import torch.distributed as dist
    from .. import resolve_device
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    try:
        yield dev.type
    finally:
        dist.destroy_process_group()
