"""Elastic scaling: re-mesh + checkpoint reshard + batch/LR rescale; the
counterpart of ``repro.launch.elastic``.

When the healthy device count changes (node failure or capacity growth), the
controller: (1) picks a new mesh via ``make_elastic_mesh_context`` (largest
model-parallel degree dividing the new count), (2) restores the latest
checkpoint with the new mesh's shardings (restore is metadata-driven, so a
checkpoint of either package, from any source mesh, works), (3) rescales
global batch to keep per-device batch constant and applies linear LR
scaling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch import Device, resolve_device
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import MeshContext
from repro_torch.distributed.sharding import mesh_shape, mesh_size
from repro_torch.launch.mesh import make_elastic_mesh_context


@dataclass
class ElasticPlan:
    mesh_ctx: MeshContext
    global_batch: int
    learning_rate: float
    reason: str

    @property
    def n_devices(self) -> int:
        return mesh_size(self.mesh_ctx.mesh)


def plan_resize(
    old_devices: int,
    new_devices: int,
    old_global_batch: int,
    old_lr: float,
    *,
    model_parallel: Optional[int] = None,
    device: Device = None,
) -> ElasticPlan:
    """Compute the post-resize execution plan (a ``DeviceMesh`` on
    ``device`` when the default group holds ``new_devices`` ranks, else a
    planning mesh)."""
    ctx = make_elastic_mesh_context(new_devices, model_parallel, device=device)
    per_device = max(old_global_batch // max(old_devices, 1), 1)
    data_ways = ctx.data_size
    new_batch = per_device * mesh_size(ctx.mesh)
    # Keep batch divisible by the data axis.
    new_batch = max((new_batch // data_ways) * data_ways, data_ways)
    new_lr = old_lr * new_batch / max(old_global_batch, 1)
    return ElasticPlan(
        mesh_ctx=ctx,
        global_batch=new_batch,
        learning_rate=new_lr,
        reason=f"resize {old_devices}->{new_devices} devices "
               f"(mesh {mesh_shape(ctx.mesh)})",
    )


def apply_resize(plan: ElasticPlan, cfg, run: RunConfig, ckpt_dir, *, device: Device = None):
    """Restore the latest checkpoint onto the plan's mesh (reshard-on-load):
    a ``TrainState`` on ``device`` (the card unless named; the mesh's device
    type) and the checkpoint's step. On a mesh of more than one device its
    tensors are DTensors on ``state_shardings``, each rank reading its own
    shard of every leaf and allocating nothing more. The plan's mesh must
    be a ``DeviceMesh``."""
    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
    from repro_torch.train.state import (abstract_train_state, empty_train_state,
                                         load_state_tree, state_shardings, state_tree,
                                         tree_shardings)

    dev = resolve_device(device)
    mesh = plan.mesh_ctx.mesh
    if not hasattr(mesh, "device_type"):
        raise ValueError(f"{mesh!r} is a planning mesh; restore onto a DeviceMesh")
    if mesh.device_type != dev.type:
        raise ValueError(f"the plan's mesh is on {mesh.device_type}, not {dev.type}")
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    target = abstract_train_state(cfg)
    shardings = state_shardings(target, plan.mesh_ctx, run)
    tree, step = restore_checkpoint(path, state_tree(target, cfg), tree_shardings(shardings, cfg))
    empty = empty_train_state(cfg, device=dev,
                              shardings=shardings if plan.n_devices > 1 else None)
    return load_state_tree(empty, tree, cfg), step
