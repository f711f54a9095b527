"""The port's sharding layer (``repro_torch.distributed``, ``launch/mesh``,
``launch/specs``, ``train/state``'s shardings) against ``repro``'s rules.

The rules are pure functions of axis names, sizes and shapes, so they are
held to the reference's on every leaf of every architecture at full size
(parameters on ``meta``; the reference's tree from ``jax.eval_shape``), on the
production meshes and the elastic ones, through the reference's own test
``FakeMesh``.  The reference builds ``NamedSharding``s, which need a real
mesh, so its rules run here with ``NamedSharding`` replaced, for the test,
by a plain record of (mesh, spec).  Placements and local shards are checked
on fake process groups, which move no data; values on a one-rank gloo group
and on meshes of four gloo processes.
Every process group a test starts is destroyed on its way out."""

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.distributed.sharding as ref_sharding
import repro.launch.specs as ref_specs
import repro.train.state as ref_state
from repro.configs import RunConfig as JaxRun
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import MeshContext as RefContext
from repro_torch.configs import SHAPES, RunConfig, get_config, list_archs, tiny_variant
from repro_torch.distributed import MeshContext, constrain, set_mesh_context, spec_for_path
from repro_torch.distributed.sharding import (P, _sanitize, local_shape_and_offset,
                                              mesh_shape, param_sharding_rules, placements)
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch.mesh import (AbstractMesh, make_elastic_mesh_context,
                                     make_mesh_context)
from repro_torch.models.convert import STACKED
from repro_torch.train.state import (abstract_train_state, distribute_state,
                                     init_train_state, state_shardings)
from repro_torch.train.step import _grads, train_step

ARCHS = sorted(list_archs())
ELASTIC = (1, 2, 4, 8, 12, 24, 256)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          **{f"elastic{n}": dict(mesh_shape(make_elastic_mesh_context(n).mesh))
             for n in ELASTIC}}


class FakeMesh:  # tests/test_distributed.py's
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def ref_ctx(shape):
    c = RefContext.__new__(RefContext)
    c.mesh = FakeMesh(shape)
    c.data_axes = tuple(a for a in ("pod", "data") if a in shape)
    c.model_axis = "model"
    return c


def port_ctx(shape):
    return MeshContext(AbstractMesh(tuple(shape.items())),
                       data_axes=tuple(a for a in ("pod", "data") if a in shape))


def spec(ref_spec):
    """A reference PartitionSpec as the port's."""
    return P(*ref_spec)


@pytest.fixture
def plain_named_sharding(monkeypatch):
    """The reference's NamedSharding as a record, so that its rules run on
    a FakeMesh."""
    record = lambda mesh, spec: SimpleNamespace(mesh=mesh, spec=spec)  # noqa: E731
    monkeypatch.setattr(ref_sharding, "NamedSharding", record)
    monkeypatch.setattr(ref_specs, "NamedSharding", record)
    monkeypatch.setattr(jax.sharding, "NamedSharding", record)


@contextlib.contextmanager
def fake_group(world, rank=0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def gloo_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- tests/test_distributed.py's three passing cases ------------------------------


@pytest.mark.parametrize("case", ["sanitize_drops_nondivisible", "sanitize_drops_missing_axis",
                                  "param_rules"])
def test_reference_cases(case):
    if case == "sanitize_drops_nondivisible":
        c = port_ctx({"data": 4, "model": 8})
        assert _sanitize(c, (16, 10), P("data", "model")) == P("data")
    elif case == "sanitize_drops_missing_axis":
        c = port_ctx({"data": 4, "model": 4})
        assert _sanitize(c, (16, 16), P(("pod", "data"), "model")) == P("data", "model")
    else:
        assert spec_for_path(("embed",), (1000, 64)) == P("model", None)
        assert spec_for_path(("layers", "attn", "wq"), (4, 64, 128)) == P(None, None, "model")
        assert spec_for_path(("layers", "attn", "wo"), (4, 128, 64)) == P(None, "model", None)
        assert spec_for_path(("layers", "moe", "moe_wi"), (4, 8, 64, 128)) == \
            P(None, "model", None, None)
        assert spec_for_path(("final_norm",), (64,)) == P()


def test_spec_compares_as_partition_spec():
    assert P("data", None) == P("data") == ("data", None, None)
    assert P() == P(None) and P(("pod", "data")) != P("data")
    assert P(*JP(("pod", "data"), "model")) == P(("pod", "data"), "model")


# -- every leaf of every architecture ---------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_abstract_state(arch):
    return ref_state.abstract_train_state(jax_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_abstract_state(arch):
    return abstract_train_state(get_config(arch))


def ref_leaves(tree):
    """{reference path: leaf} of a pytree of dicts."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, SimpleNamespace))[0]:
        out[tuple(p.key for p in path)] = leaf
    return out


def ref_path(cfg, name):
    """(reference path, layer dims) of a port parameter name."""
    parts = name.split(".")
    if parts[0] not in STACKED:
        return tuple(parts), 0
    return (parts[0], *parts[2:]), 2 if cfg.family == "hybrid" and parts[0] == "layers" else 1


def dropped(ref_spec, shape, lead):
    entries = list(ref_spec) + [None] * (len(shape) - len(ref_spec))
    return P(*entries[lead:])


def per_layer(ref_spec, base_spec, shape, lead, rc):
    """The port's spec for a reference leaf's (``ref_spec``, a zero_extend
    of ``base_spec``) per-layer tensor: the layer entries dropped; where the
    reference's zero_extend chose a layer axis, the reference's zero_extend
    run on the per-layer shape instead."""
    entries = list(ref_spec) + [None] * (len(shape) - len(ref_spec))
    if any(e is not None for e in entries[:lead]):
        base = SimpleNamespace(mesh=rc.mesh, spec=JP(*dropped(base_spec, shape, lead)))
        return spec(ref_sharding.zero_extend(base, tuple(shape[lead:]), rc).spec)
    return P(*entries[lead:])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_on_every_leaf(arch, mesh, plain_named_sharding):
    cfg = get_config(arch)
    rc, pc = ref_ctx(MESHES[mesh]), port_ctx(MESHES[mesh])
    ref_params = ref_leaves(ref_abstract_state(arch).params)
    ref_rules = ref_leaves(ref_sharding.param_sharding_rules(
        ref_abstract_state(arch).params, rc))
    port = param_sharding_rules(port_abstract_state(arch).params, pc)
    named = dict(port_abstract_state(arch).params.named_parameters())
    assert port.keys() == named.keys()
    seen = set()
    for name, sharding in port.items():
        path, lead = ref_path(cfg, name)
        shape = tuple(ref_params[path].shape)
        assert shape[lead:] == tuple(named[name].shape), name
        want = ref_sharding._sanitize(rc, shape, ref_sharding.spec_for_path(path, shape))
        assert spec(ref_rules[path].spec) == spec(want)
        assert sharding.spec == dropped(want, shape, lead), (name, sharding.spec, want)
        seen.add(path)
    assert seen == set(ref_params)


@pytest.mark.parametrize("zero,fsdp", [(False, False), (True, False), (False, True),
                                       (True, True)])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "elastic24"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_shardings_equal_reference(arch, mesh, zero, fsdp, plain_named_sharding):
    """Parameters (FSDP), moments (ZeRO) and the scalars, leaf for leaf: the
    reference's zero_extend runs on its stacked leaves, and where it puts
    the data axes on the layer axis, which the per-layer tensor lacks, the
    reference's zero_extend of the per-layer shape decides."""
    cfg = get_config(arch)
    rc, pc = ref_ctx(MESHES[mesh]), port_ctx(MESHES[mesh])
    ref = ref_state.state_shardings(ref_abstract_state(arch), rc,
                                    JaxRun(zero=zero, fsdp=fsdp))
    port = state_shardings(port_abstract_state(arch), pc, RunConfig(zero=zero, fsdp=fsdp))
    ref_params, ref_mu, ref_nu = (ref_leaves(t) for t in (ref.params, ref.opt.mu, ref.opt.nu))
    base = ref_leaves(ref_sharding.param_sharding_rules(ref_abstract_state(arch).params, rc))
    shapes = ref_leaves(ref_abstract_state(arch).params)
    for name in port.params:
        path, lead = ref_path(cfg, name)
        shape = tuple(shapes[path].shape)
        for got, ref_spec in ((port.params, ref_params), (port.opt.mu, ref_mu),
                              (port.opt.nu, ref_nu)):
            want = per_layer(ref_spec[path].spec, base[path].spec, shape, lead, rc)
            assert got[name].spec == want, (name, got[name].spec, want)
    assert port.step.spec == spec(ref.step.spec) == P()
    assert port.opt.count.spec == spec(ref.opt.count.spec) == P()


def test_moe_experts_are_expert_parallel():
    """The per-layer (E, d, ffe) moe_wi keeps the reference's expert axis,
    where a rule on its own 3-dim shape would shard d."""
    pc = port_ctx(MESHES["16x16"])
    rules = param_sharding_rules(port_abstract_state("deepseek-moe-16b").params, pc)
    assert rules["layers.0.moe.moe_wi"].spec == P("model", None, None)
    assert rules["layers.0.moe.moe_wo"].spec == P("model", None, None)
    assert spec_for_path(("moe_wi",), (64, 2048, 2816)) == P(None, "model", None)
    assert rules["embed"].spec == P("model", None)
    assert rules["layers.0.attn.wq"].spec == P(None, "model")


def test_zero_extend_on_the_layer_axis_moves_into_the_layer():
    """yi-9b's 48 layers divide 16 data ranks: the reference shards the
    stacked layer axis of wq over data; the per-layer (4096, 4096) wq is
    sharded over data on its own first dim instead (ZeRO: moments too), so
    FSDP and ZeRO still divide it by the data size."""
    pc = port_ctx(MESHES["16x16"])
    sh = state_shardings(port_abstract_state("yi-9b"), pc, RunConfig(zero=True, fsdp=True))
    assert sh.params["layers.0.attn.wq"].spec == P("data", "model")
    assert sh.opt.mu["layers.0.attn.wq"].spec == P("data", "model")
    assert sh.params["layers.0.norm1"].spec == P("data")
    assert sh.params["embed"].spec == P("model", "data")
    sh = state_shardings(port_abstract_state("yi-9b"), pc, RunConfig(zero=True, fsdp=False))
    assert sh.params["layers.0.attn.wq"].spec == P(None, "model")
    assert sh.opt.nu["layers.0.attn.wq"].spec == P("data", "model")


# -- meshes, placements and local shards -----------------------------------------


def test_elastic_meshes_beyond_the_group_are_plans():
    for n, (data, model) in {1: (1, 1), 2: (1, 2), 12: (3, 4), 24: (3, 8), 256: (16, 16),
                             6: (3, 2), 7: (7, 1)}.items():
        ctx = make_elastic_mesh_context(n)
        assert isinstance(ctx.mesh, AbstractMesh)
        assert dict(ctx.mesh.shape) == {"data": data, "model": model}
        assert ctx.mesh.size == n and (ctx.data_size, ctx.model_size) == (data, model)
    assert dict(make_elastic_mesh_context(32, model_parallel=4).mesh.shape) == \
        {"data": 8, "model": 4}
    with pytest.raises(ValueError, match="no process group"):
        make_elastic_mesh_context()


def test_production_mesh_needs_its_ranks():
    with fake_group(16):
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_mesh_context(device="cpu")
        ctx = make_elastic_mesh_context(device="cpu")
        assert mesh_shape(ctx.mesh) == {"data": 1, "model": 16}
        assert isinstance(make_elastic_mesh_context(64).mesh, AbstractMesh)


@pytest.mark.parametrize("multi_pod,rank", [(False, 0), (False, 37), (False, 255),
                                            (True, 37), (True, 300), (True, 511)])
def test_local_shards_on_a_fake_group(multi_pod, rank):
    """Each rank's local shape and offset equal what the spec means, by
    hand: a tuple entry's axes major to minor."""
    world = 512 if multi_pod else 256
    with fake_group(world, rank):
        ctx = make_mesh_context(multi_pod=multi_pod, device="cpu")
        coord = ctx.mesh.get_coordinate()
        pod, data, model = ((rank // 256, rank % 256 // 16, rank % 16) if multi_pod
                            else (0, rank // 16, rank % 16))
        assert list(coord) == ([pod, data, model] if multi_pod else [data, model])
        ways = 32 if multi_pod else 16
        cases = {  # (shape, spec) -> (local shape, offset)
            ((64, 32), P(("pod", "data"), "model")):
                ((64 // ways, 2), ((pod * 16 + data) * (64 // ways), model * 2)),
            ((32000, 2048), P("model", None)): ((2000, 2048), (model * 2000, 0)),
            ((64, 2048, 2816), P("model", ("pod", "data"), None)):
                ((4, 2048 // ways, 2816), (model * 4, (pod * 16 + data) * (2048 // ways), 0)),
        }
        for (shape, sp), want in cases.items():
            sp = _sanitize(ctx, shape, sp)
            t = torch.distributed.tensor.distribute_tensor(
                torch.empty(shape, device="meta"), ctx.mesh, placements(ctx.mesh, sp))
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
            got = compute_local_shape_and_global_offset(shape, ctx.mesh, t.placements)
            assert (tuple(got[0]), tuple(got[1])) == want
            assert tuple(t.to_local().shape) == want[0]
            assert local_shape_and_offset(shape, ctx.mesh, sp, coord) == want


def test_placements_follow_mesh_order():
    mesh = AbstractMesh((("pod", 2), ("data", 16), ("model", 16)))
    assert placements(mesh, P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert placements(mesh, P(None, "data")) == (Replicate(), Shard(1), Replicate())
    # An axis of one device keeps its Shard: the placements are the spec's.
    one = AbstractMesh((("data", 1), ("model", 16)))
    assert placements(one, P("data", "model")) == (Shard(0), Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        placements(mesh, P(("data", "pod")))
    with pytest.raises(ValueError, match="twice"):
        placements(mesh, P("model", "model"))


# -- constrain ----------------------------------------------------------------------


def global_view(local, mesh, placements_, shape):
    """A DTensor of global ``shape`` whose local shard is ``local``."""
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert constrain(x, ("pod", "data"), "model", None) is x
    set_mesh_context(port_ctx(MESHES["16x16"]))
    try:  # a plain tensor, too, comes back as it is
        assert constrain(x, ("pod", "data"), "model", None) is x
    finally:
        set_mesh_context(None)


def test_constrain_redistributes_to_the_sanitized_spec():
    with fake_group(256):
        ctx = make_mesh_context(device="cpu")
        set_mesh_context(ctx)
        try:
            q = global_view(torch.zeros(2, 64, 32, 128), ctx.mesh, [Shard(0), Replicate()],
                            (32, 64, 32, 128))
            out = constrain(q, ("pod", "data"), None, "model", None)
            assert tuple(out.placements) == (Shard(0), Shard(2))
            assert tuple(out.to_local().shape) == (2, 64, 2, 128)
            # 4 KV heads on a 16-way model axis stay replicated.
            k = global_view(torch.zeros(2, 64, 4, 128), ctx.mesh, [Shard(0), Replicate()],
                            (32, 64, 4, 128))
            out = constrain(k, ("pod", "data"), None, "model", None)
            assert tuple(out.placements) == (Shard(0), Replicate())
        finally:
            set_mesh_context(None)


# -- the kernel wrappers on DTensors --------------------------------------------------


def test_kernel_wrappers_run_on_the_local_shard():
    """Heads (and batch) sharded pass through on the local shard; a dim the
    kernel reduces over, sharded, raises."""
    g = torch.Generator().manual_seed(0)
    with fake_group(256):
        ctx = make_mesh_context(device="cpu")
        mesh = ctx.mesh

        def dt(local, pl, shape):
            return global_view(local, mesh, pl, shape)

        heads = [Shard(0), Shard(2)]
        q = torch.randn(1, 16, 2, 32, generator=g)
        k = torch.randn(1, 16, 1, 32, generator=g)
        v = torch.randn(1, 16, 1, 32, generator=g)
        out = ops.flash_attention(dt(q, heads, (16, 16, 32, 32)), dt(k, heads, (16, 16, 16, 32)),
                                  dt(v, heads, (16, 16, 16, 32)))
        assert tuple(out.placements) == tuple(heads)
        torch.testing.assert_close(out.to_local(), ops.flash_attention(q, k, v),
                                   rtol=0, atol=0)
        x, w = torch.randn(1, 16, 64, generator=g), torch.randn(64, generator=g)
        rows = [Shard(0), Shard(1)]
        y = ops.fused_rmsnorm(dt(x, rows, (16, 256, 64)), dt(w, [Replicate()] * 2, (64,)))
        assert torch.equal(y.to_local(), ops.fused_rmsnorm(x, w))
        with pytest.raises(ValueError, match="reduces over it"):
            ops.fused_rmsnorm(dt(x, [Shard(0), Shard(2)], (16, 16, 1024)),
                              dt(w, [Replicate()] * 2, (64,)))
        with pytest.raises(ValueError, match="reduces over it"):
            seq = [Shard(0), Shard(1)]
            ops.flash_attention(dt(q, seq, (16, 256, 2, 32)), dt(k, seq, (16, 256, 1, 32)),
                                dt(v, seq, (16, 256, 1, 32)))
        with pytest.raises(ValueError, match="differently"):
            ops.flash_attention(dt(q, heads, (16, 16, 32, 32)),
                                dt(torch.randn(1, 16, 16, 32), [Shard(0), Replicate()],
                                   (16, 16, 16, 32)),
                                dt(torch.randn(1, 16, 16, 32), [Shard(0), Replicate()],
                                   (16, 16, 16, 32)))
        cache = torch.randn(1, 24, 1, 32, generator=g)
        dec = ops.flash_decode(dt(q[:, :1], heads, (16, 1, 32, 32)),
                               dt(cache, heads, (16, 24, 16, 32)),
                               dt(cache, heads, (16, 24, 16, 32)),
                               torch.arange(16, dtype=torch.int32) + 5)
        assert torch.equal(dec.to_local(), ops.flash_decode(
            q[:, :1], cache, cache, torch.tensor([5 + mesh.get_coordinate()[0]],
                                                 dtype=torch.int32)))
        with pytest.raises(ValueError, match="reduces over it"):
            ops.flash_decode(dt(q[:, :1], heads, (16, 1, 32, 32)),
                             dt(cache, [Shard(0), Shard(1)], (16, 384, 1, 32)),
                             dt(cache, [Shard(0), Shard(1)], (16, 384, 1, 32)),
                             torch.full((16,), 9, dtype=torch.int32))
        xdt = torch.randn(1, 2, 1, 8, 4, generator=g)
        cum = torch.randn(1, 2, 1, 8, generator=g).cumsum(-1)
        bm, cm = torch.randn(1, 2, 8, 16, generator=g), torch.randn(1, 2, 8, 16, generator=g)
        y, st = ops.ssd_chunk_dual(dt(xdt, heads, (16, 2, 16, 8, 4)),
                                   dt(cum, heads, (16, 2, 16, 8)),
                                   dt(bm, [Shard(0), Replicate()], (16, 2, 8, 16)),
                                   dt(cm, [Shard(0), Replicate()], (16, 2, 8, 16)))
        want = ops.ssd_chunk_dual(xdt, cum, bm, cm)
        assert torch.equal(y.to_local(), want[0]) and torch.equal(st.to_local(), want[1])
        assert tuple(st.shape) == (16, 2, 16, 16, 4)
        with pytest.raises(ValueError, match="reduces over it"):
            ops.ssd_chunk_dual(dt(xdt, heads, (16, 2, 16, 8, 4)), dt(cum, heads, (16, 2, 16, 8)),
                               dt(bm, [Shard(0), Shard(3)], (16, 2, 8, 256)),
                               dt(cm, [Shard(0), Shard(3)], (16, 2, 8, 256)))


# -- a train step on a one-rank gloo mesh -------------------------------------------


def tiny_batch(cfg):
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m", "deepseek-moe-16b"])
def test_mesh_train_step_equals_the_plain_step(arch):
    """seq_shard, zero and fsdp on; the parameters and moments distributed
    by state_shardings; the plain kernel versions; f32: the loss, every
    gradient and, after AdamW, every parameter and moment equal the step's
    without a mesh, exactly."""
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    run = RunConfig(attention_impl="flash", remat="full", zero=True, fsdp=True,
                    seq_shard=True, warmup_steps=1)
    batch = tiny_batch(cfg)
    plain = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss0, _, grads0 = _grads(plain.params, cfg, run, batch)
    plain, metrics0 = train_step(plain, batch, cfg, run)
    with gloo_group():
        ctx = make_elastic_mesh_context(1, device="cpu")
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        state = distribute_state(state, state_shardings(state, ctx, run))
        assert isinstance(state.params.embed, DTensor)
        set_mesh_context(ctx)
        try:
            loss1, _, grads1 = _grads(state.params, cfg, run, batch)
            state, metrics1 = train_step(state, batch, cfg, run)
        finally:
            set_mesh_context(None)
        assert torch.equal(full(loss1), loss0)
        for k in grads0:
            assert torch.equal(full(grads1[k]), grads0[k]), k
        for k in metrics0:
            assert torch.equal(full(metrics1[k]), metrics0[k]), k
        for (k, p), q in zip(plain.params.named_parameters(), state.params.parameters()):
            assert torch.equal(full(q), p), k
        for k in plain.opt.mu:
            assert torch.equal(full(state.opt.mu[k]), plain.opt.mu[k]), k
            assert torch.equal(full(state.opt.nu[k]), plain.opt.nu[k]), k
        assert int(full(state.step)) == 1


# -- a train step on four gloo ranks ------------------------------------------------

# Each mesh's run is one group of four processes (tests/torch_mesh_worker.py);
# 2x2 shards batch, sequence, heads and SSD chunks; on 1x4 qwen3's 2 KV heads
# and zamba2's 2 SSD chunks do not divide the model axis, so they are
# gathered before the split.
FOUR_RANKS = {"2x2": ("tinyllama-1.1b", "mamba2-130m", "deepseek-moe-16b"),
              "1x4": ("qwen3-8b", "zamba2-2.7b")}
# Tolerances: the row-parallel products and the gloo all-reduces add partial
# sums in another order than one process does, so the loss is held to 1e-6
# of itself, each gradient and moment to 1e-5 of its largest element, and
# each parameter after AdamW to 2 learning rates (tests/test_torch_train.py's
# rule: an element whose gradient is near 0 steps by the gradient's rounding).
LOSS_TOL, GRAD_TOL, PARAM_LR = 1e-6, 1e-5, 2.0


@pytest.fixture(scope="module")
def four_rank_steps(tmp_path_factory):
    """Both meshes' runs, started together, as {mesh: {arch: result}}."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    out = tmp_path_factory.mktemp("four_ranks")
    procs = {mesh: subprocess.Popen(
        [sys.executable, str(root / "torch_mesh_worker.py"), *mesh.split("x"),
         str(out / f"{mesh}.json"), *archs], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for mesh, archs in FOUR_RANKS.items()}
    logs = {}
    for mesh, proc in procs.items():
        try:
            logs[mesh] = proc.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
    results = {}
    for mesh, proc in procs.items():
        assert proc.returncode == 0, logs[mesh][-6000:]
        results[mesh] = json.loads((out / f"{mesh}.json").read_text())
    return results


@pytest.mark.parametrize("mesh,arch", [(m, a) for m, archs in FOUR_RANKS.items()
                                       for a in archs])
def test_mesh_train_step_on_four_gloo_ranks(four_rank_steps, mesh, arch):
    """seq_shard, zero and fsdp on a mesh of four processes: the residual
    stream is sharded over the batch and the sequence, the kernel wrappers
    run on those shards, and the loss, gradients and AdamW step equal the
    step without a mesh within the tolerances above."""
    r = four_rank_steps[mesh][arch]
    assert "error" not in r, r.get("error")
    data, model = map(int, mesh.split("x"))
    assert r["mesh"] == {"data": data, "model": model}
    seq = "(Shard(dim=0), Shard(dim=1))"  # batch over data, sequence over model
    assert r["placements"]["residual"] == [seq]
    assert r["placements"]["fused_rmsnorm"] and seq in r["placements"]["fused_rmsnorm"]
    if arch == "mamba2-130m":  # 2 chunks over 2 model ranks
        assert r["placements"]["ssd_chunk_dual"] == [seq]
    if arch == "qwen3-8b":  # 2 KV heads on 4 model ranks: heads whole
        assert r["placements"]["flash_attention"] == ["(Shard(dim=0), Replicate())"]
    if mesh == "2x2" and arch != "mamba2-130m":
        assert r["placements"]["flash_attention"] == ["(Shard(dim=0), Shard(dim=2))"]
    err = r["errors"]
    assert err.pop("step") == 0.0
    for k, v in err.items():
        tol = (LOSS_TOL if k == "loss" or k.startswith("metric")
               else PARAM_LR if k.startswith("param") else GRAD_TOL)
        assert v <= tol, (k, v, tol)


# -- specs -------------------------------------------------------------------------


def meta_leaves(tree):
    if isinstance(tree, dict):
        return {k: meta_leaves(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def jax_leaves(tree):
    if isinstance(tree, dict):
        return {k: jax_leaves(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert meta_leaves(specs.input_specs(cfg, SHAPES[shape])) == \
        jax_leaves(ref_specs.input_specs(jcfg, REF_SHAPES[shape]))
    assert specs.model_flops_estimate(cfg, SHAPES[shape]) == \
        ref_specs.model_flops_estimate(jcfg, REF_SHAPES[shape])
    assert cfg.supports_long_context == jcfg.supports_long_context


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_equal_reference(arch, shape, plain_named_sharding):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rc, pc = ref_ctx(MESHES["16x16"]), port_ctx(MESHES["16x16"])
    port = specs.input_specs(cfg, SHAPES[shape])
    ref = ref_specs.input_specs(jcfg, REF_SHAPES[shape])
    pb, rb = specs.batch_shardings(port, pc), ref_specs.batch_shardings(ref, rc)
    for k in port:
        if k != "cache":
            assert pb[k].spec == spec(rb[k].spec), k
    if "cache" in port:
        pcache = specs.cache_shardings(port["cache"], pc)
        rcache = ref_specs.cache_shardings(ref["cache"], rc)
        assert pcache.keys() == rcache.keys()
        for k in pcache:
            assert pcache[k].spec == spec(rcache[k].spec), k
