"""Production mesh construction; the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.DeviceMesh`` over the default process group,
which the caller starts (``init_process_group`` with its address, world size
and rank); nothing here starts one. Planning for a device count beyond the
live world size gives an :class:`AbstractMesh`, axis names and sizes with no
process group behind them, on which every sharding rule runs (the
reference's ``jax.sharding.AbstractMesh`` branch). The meshes live on the
card unless ``device`` names another type (``"cpu"`` for a gloo or fake
group).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import Device, resolve_device
from repro_torch.distributed import MeshContext


class AbstractMesh:
    """A mesh's axis names and sizes, in order, without devices: ``shape``
    (an ordered mapping), ``axis_names`` and ``size``."""

    def __init__(self, shape: Sequence[Tuple[str, int]]):
        self.shape = OrderedDict(shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({dict(self.shape)})"


def live_world_size() -> int:
    """The default group's world size; 0 when no group is started."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def _device_mesh(device: Device, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    world = live_world_size()
    if n > world:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the default process "
                           f"group has {world}")
    mesh = torch.arange(n).reshape(shape)
    return DeviceMesh(resolve_device(device).type, mesh, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: Device = None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``, over the default group's first ranks; raises when the group
    has fewer, as ``jax.make_mesh`` raises without the devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device, shape, axes)


def make_mesh_context(*, multi_pod: bool = False, device: Device = None) -> MeshContext:
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return MeshContext(mesh=mesh, data_axes=data_axes, model_axis="model")


def make_elastic_mesh_context(n_devices: Optional[int] = None,
                              model_parallel: Optional[int] = None, *,
                              device: Device = None) -> MeshContext:
    """Best mesh for an arbitrary device count (elastic re-mesh).

    Picks the largest model-parallel degree of 16, 8, 4 and 2 that divides
    the device count (16 is one NVLink domain's reach in the reference's
    single-pod ICI); the remaining devices become data parallel, the policy
    ``repro_torch.launch.elastic`` applies after a resize. ``n_devices``
    defaults to the live world size. A count the default group holds gives a
    ``DeviceMesh`` on ``device`` (the card unless named); a larger one an
    :class:`AbstractMesh`, for capacity planning.
    """
    world = live_world_size()
    n = n_devices or world
    if n <= 0:
        raise ValueError("no device count given and no process group started")
    if model_parallel is None:
        model_parallel = 1
        for cand in (16, 8, 4, 2):
            if n % cand == 0:
                model_parallel = cand
                break
    data = n // model_parallel
    if n <= world:
        mesh = _device_mesh(device, (data, model_parallel), ("data", "model"))
    else:
        mesh = AbstractMesh((("data", data), ("model", model_parallel)))
    return MeshContext(mesh=mesh, data_axes=("data",), model_axis="model")
