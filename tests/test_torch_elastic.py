"""``repro_torch.launch.elastic`` against ``repro.launch.elastic``: the
resize arithmetic of tests/test_ft.py (whose reference case raises on jax
0.9, so the numbers are pinned here), and ``apply_resize`` as
``tests/test_ft.py::test_elastic_restore_across_meshes``: a checkpoint saved
by either package, restored onto a one-rank gloo mesh, equal leaf for leaf
and step for step to what was saved; on a fake 2 x 2 group (which moves no
data, but each rank reads its own blocks from the files) each rank's shards
equal the saved tensors' blocks. Each group is destroyed on the way out."""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.train import init_train_state as jax_init_train_state
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.distributed import current_mesh
from repro_torch.launch.elastic import ElasticPlan, apply_resize, plan_resize
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.distributed.sharding import local_shape_and_offset
from repro_torch.train.state import (abstract_train_state, init_train_state, state_shardings,
                                     state_tree)
from test_torch_train import _as_np_tree, _leaves, _port_leaves


@contextlib.contextmanager
def gloo_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world, rank):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("old,new,batch,lr,want", [
    (8, 4, 64, 1e-3, (32, 5e-4)),  # tests/test_ft.py: shrink
    (4, 8, 32, 5e-4, (64, 1e-3)),  # and grow
    (256, 24, 512, 1e-3, (48, 9.375e-05)),  # data 3 x model 8
    (1, 1, 8, 1e-3, (8, 1e-3)),
])
def test_plan_resize(old, new, batch, lr, want):
    plan = plan_resize(old, new, old_global_batch=batch, old_lr=lr)
    assert isinstance(plan, ElasticPlan) and isinstance(plan.mesh_ctx.mesh, AbstractMesh)
    assert plan.n_devices == new
    assert plan.global_batch == want[0]
    assert plan.learning_rate == pytest.approx(want[1])
    assert plan.reason.startswith(f"resize {old}->{new} devices")


def test_plan_keeps_the_batch_a_multiple_of_the_data_axis():
    plan = plan_resize(4, 24, old_global_batch=2, old_lr=1e-3)  # 1 a device; data 3
    assert plan.mesh_ctx.data_size == 3 and plan.global_batch == 24


@pytest.mark.parametrize("saved_by", ["repro", "repro_torch"])
@pytest.mark.parametrize("zero,fsdp", [(False, False), (True, True)])
def test_apply_resize_restores_every_leaf(tmp_path, saved_by, zero, fsdp):
    jcfg = jax_tiny(jax_get_config("tinyllama-1.1b"))
    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    if saved_by == "repro":
        jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
        jstate = jstate._replace(step=jstate.step + 3)
        jax_save(tmp_path, 3, jstate)
        want = _leaves(_as_np_tree(jstate))
    else:
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        for m in state.opt.mu.values():
            m.normal_(generator=torch.Generator().manual_seed(1))
        state = state._replace(step=state.step + 3)
        save_checkpoint(tmp_path, 3, state_tree(state, cfg))
        want = _port_leaves(state_tree(state, cfg))
    with gloo_group():
        plan = plan_resize(1, 1, old_global_batch=8, old_lr=1e-3, device="cpu")
        restored, step = apply_resize(plan, cfg, RunConfig(zero=zero, fsdp=fsdp), tmp_path,
                                      device="cpu")
        assert current_mesh() is None
    assert step == 3 and int(restored.step) == 3
    got = _port_leaves(state_tree(restored, cfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert restored.params.embed.dtype == getattr(torch, cfg.dtype)
    assert all(p.requires_grad for p in restored.params.parameters())


def test_apply_resize_needs_a_device_mesh(tmp_path):
    plan = plan_resize(1, 8, old_global_batch=8, old_lr=1e-3)
    with pytest.raises(ValueError, match="planning mesh"):
        apply_resize(plan, tiny_variant(get_config("tinyllama-1.1b")), RunConfig(), tmp_path,
                     device="cpu")


def test_apply_resize_without_a_checkpoint(tmp_path):
    with gloo_group():
        plan = plan_resize(1, 1, old_global_batch=8, old_lr=1e-3, device="cpu")
        with pytest.raises(FileNotFoundError):
            apply_resize(plan, tiny_variant(get_config("tinyllama-1.1b")), RunConfig(),
                         tmp_path, device="cpu")
        assert current_mesh() is None


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
@pytest.mark.parametrize("rank", [0, 3])
def test_apply_resize_reads_each_rank_its_own_shards(tmp_path, arch, rank):
    """A 2 x 2 mesh, ZeRO and FSDP: every parameter and moment is a DTensor
    whose local shard is the saved tensor's block at this rank's offset."""
    cfg = tiny_variant(get_config(arch))
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    for m in (*state.opt.mu.values(), *state.opt.nu.values()):
        m.normal_(generator=torch.Generator().manual_seed(1))
    save_checkpoint(tmp_path, 5, state_tree(state._replace(step=state.step + 5), cfg))
    run = RunConfig(zero=True, fsdp=True)
    with fake_group(4, rank):
        plan = plan_resize(4, 4, old_global_batch=8, old_lr=1e-3, model_parallel=2,
                           device="cpu")
        mesh = plan.mesh_ctx.mesh
        restored, step = apply_resize(plan, cfg, run, tmp_path, device="cpu")
        sh = state_shardings(abstract_train_state(cfg), plan.mesh_ctx, run)
        coord = mesh.get_coordinate()
        assert list(coord) == [rank // 2, rank % 2]
        saved = dict(state.params.named_parameters())
        for got, want, specs in (
                (dict(restored.params.named_parameters()), saved, sh.params),
                (restored.opt.mu, state.opt.mu, sh.opt.mu),
                (restored.opt.nu, state.opt.nu, sh.opt.nu)):
            assert got.keys() == want.keys()
            for name, t in got.items():
                assert isinstance(t, DTensor), name
                local, offset = local_shape_and_offset(t.shape, mesh, specs[name].spec, coord)
                block = want[name].detach()[tuple(slice(o, o + n)
                                                  for o, n in zip(offset, local))]
                assert torch.equal(t.to_local(), block), name
        if arch == "tinyllama-1.1b":  # by hand: (d, H*D) wq, d over data, H*D over model
            wq = dict(restored.params.named_parameters())["layers.0.attn.wq"]
            assert tuple(wq.to_local().shape) == (64, 64)
            assert torch.equal(wq.to_local(), saved["layers.0.attn.wq"].detach()[
                64 * (rank // 2):64 * (rank // 2 + 1), 64 * (rank % 2):64 * (rank % 2 + 1)])
        assert step == 5 and int(restored.step.to_local()) == 5
