"""The ``torch.export`` front end over every architecture and over the
functional collectives.

Each architecture's tiny forward (f32, B 2, S 64, ``chunked`` attention in
chunks of 16; the reference's weights through ``models/convert.py``; a
frontend of 16 positions for the audio and vlm families) lowers with no ATen
op left unmapped, and its entry FLOPs stand beside the reference's compiled
HLO of the same forward at a pinned ratio.  Where the ratio is not 1 the
difference is one of naming and structure, op by op (whisper-base's is
pinned below): XLA prints ``exponential``, ``sine`` and ``cosine``, which
the reference's cost model does not know (0 FLOPs), where the port prints
``exp``, ``sin`` and ``cos``; the reference's layer scan slices every
layer's weights out of the stacked tensors (``dynamic-slice``, its output
elements counted), which the port's per-layer tensors do not need; XLA
rewrites ``x ** 2`` to a multiply and fuses chains the export keeps apart.

A function calling ``torch.distributed._functional_collectives`` on a fake
16-rank group lowers to HLO collectives with the group's ranks and
``num_partitions`` 16, so the roofline's NVLink term counts their bytes.
"""

import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import RunConfig as JaxRun
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.configs import tiny_variant as jax_tiny
from repro.core.hlo.costs import HLOCostModel as RefCost
from repro.core.hlo.parser import parse_hlo as ref_parse
from repro.models import init_params as jax_init_params
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.models.transformer import lm_logits as jax_lm_logits
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.core.hlo import H100_SXM, lower_exported
from repro_torch.core.hlo.costs import HLOCostModel as PortCost
from repro_torch.core.hlo.roofline import collective_stats
from repro_torch.models import forward_hidden
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import lm_logits
from test_torch_hlo import REF_CHIP, dot_flops

SEQ = 64

# Port entry FLOPs / reference entry FLOPs of each tiny forward (jax 0.9 on
# the CPU, torch 2.13).  starcoder2-15b is within 0.1 %.
RATIOS = {
    "deepseek-moe-16b": 1.000909, "mamba2-130m": 0.964036,
    "phi-3-vision-4.2b": 0.999596, "phi3.5-moe-42b-a6.6b": 0.998363,
    "qwen3-8b": 0.999186, "starcoder2-15b": 0.999049, "tinyllama-1.1b": 0.999201,
    "whisper-base": 0.996727, "yi-9b": 0.999201, "zamba2-2.7b": 0.982560,
}
# whisper-base's gap (-445,452 FLOPs, -0.33 %), opcode by opcode: port
# FLOPs less the reference's, each op weighted by its executions.
WHISPER_GAP = {
    "add": -45260, "and": -128, "clamp": 2304, "compare": -8576, "cos": 20480,
    "dynamic-slice": -722192, "dynamic-update-slice": 20480, "exp": 366080,
    "maximum": -3584, "multiply": -181296, "power": 135168, "reduce": 130944,
    "reduce-window": -135168, "scatter": -20480, "select": -24704, "sin": 20480,
}


class Forward(torch.nn.Module):
    def __init__(self, model, cfg, run):
        super().__init__()
        self.model, self.cfg, self.run = model, cfg, run

    def forward(self, tokens, frontend=None):
        x, _ = forward_hidden(self.model, self.cfg, self.run, tokens, frontend)
        return lm_logits(self.model, self.cfg, x)


@functools.lru_cache(maxsize=None)
def modules(arch):
    """(reference module, port module) of the arch's tiny forward."""
    jcfg = dataclasses.replace(jax_tiny(jax_get_config(arch)), dtype="float32")
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, SEQ))
    frontend = None
    if cfg.frontend_len:
        frontend = np.random.default_rng(1).standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jrun = JaxRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)
    run = RunConfig(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)

    def forward(p, t, f):
        x, _ = jax_forward_hidden(p, jcfg, jrun, t, f)
        return jax_lm_logits(p, jcfg, x)

    jf = None if frontend is None else jnp.asarray(frontend)
    text = jax.jit(forward).lower(params, jnp.asarray(tokens), jf).compile().as_text()
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    args = (torch.as_tensor(tokens),)
    if frontend is not None:
        args += (torch.as_tensor(frontend),)
    ep = torch.export.export(Forward(model, cfg, run), args)
    return ref_parse(text), lower_exported(ep)


def flops_by_opcode(module, cost):
    """FLOPs per opcode over one run: fusions opened, while bodies times
    their trips."""
    out = Counter()

    def visit(name, mult):
        comp = module.computations[name]
        for op in comp.ops:
            if op.opcode in ("fusion", "call"):
                for called in op.called_computations:
                    visit(called, mult)
            elif op.opcode == "while":
                visit(op.body_computation, mult * cost.while_trip_count(op))
            else:
                out[op.opcode] += mult * cost.op_flops(op, comp)

    visit(module.entry_name, 1.0)
    return out


def test_ratios_cover_every_architecture():
    assert sorted(RATIOS) == sorted(list_archs())


@pytest.mark.parametrize("arch", sorted(RATIOS))
def test_tiny_forward_lowers_every_op(arch):
    """No op unmapped; dot FLOPs equal to the reference's; entry FLOPs at
    the pinned ratio."""
    ref, port = modules(arch)
    assert port.unmapped == ()
    ref_cost, port_cost = RefCost(ref, REF_CHIP), PortCost(port, H100_SXM)
    assert dot_flops(port, port_cost)[1] == dot_flops(ref, ref_cost)[1]
    ratio = port_cost.module_flops() / ref_cost.module_flops()
    assert round(ratio, 6) == RATIOS[arch]


def test_whisper_gap_op_by_op():
    ref, port = modules("whisper-base")
    mine = flops_by_opcode(port, PortCost(port, H100_SXM))
    theirs = flops_by_opcode(ref, RefCost(ref, REF_CHIP))
    gap = {k: mine[k] - theirs[k] for k in sorted(set(mine) | set(theirs))
           if mine[k] != theirs[k]}
    assert gap == WHISPER_GAP
    total = PortCost(port, H100_SXM).module_flops() - RefCost(ref, REF_CHIP).module_flops()
    assert sum(gap.values()) == total == -445452


def test_starcoder2_gelu_is_the_tanh_chain():
    """The tanh GELU lowers to jax.nn.gelu's chain: one tanh per element,
    as many as XLA's, and 8 elementwise ops around it."""
    ref, port = modules("starcoder2-15b")
    mine = flops_by_opcode(port, PortCost(port, H100_SXM))
    theirs = flops_by_opcode(ref, RefCost(ref, REF_CHIP))
    assert mine["tanh"] == theirs["tanh"] == 4 * 2 * (2 * SEQ * 256)


# -- functional collectives on a fake group -------------------------------------


@pytest.fixture
def fake_group():
    """A 16-rank fake process group, destroyed on the way out."""
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=16)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


class TensorParallelMLP(torch.nn.Module):
    """One rank of a column-then-row-parallel MLP: (B,S,d) @ (d, ff/16),
    then @ (ff/16, d), partial sums all-reduced."""

    def __init__(self, group):
        super().__init__()
        self.group = group

    def forward(self, x, w1, w2):
        y = torch.relu(x @ w1) @ w2
        return funcol.all_reduce(y, "sum", self.group)


class Collectives(torch.nn.Module):
    def __init__(self, group):
        super().__init__()
        self.group = group

    def forward(self, x):
        g = funcol.all_gather_tensor(x, 0, self.group)
        r = funcol.reduce_scatter_tensor(g, "sum", 0, self.group)
        a = funcol.all_to_all_single(x, None, None, self.group)
        return r, a


def test_tensor_parallel_mlp_makes_one_all_reduce(fake_group):
    b, s, d, ff = 2, 8, 64, 256
    args = (torch.ones(b, s, d), torch.ones(d, ff // 16), torch.ones(ff // 16, d))
    module = lower_exported(torch.export.export(TensorParallelMLP(fake_group), args))
    assert module.unmapped == () and module.num_partitions == 16
    (op,) = module.collective_ops()
    assert op.opcode == "all-reduce"
    assert op.replica_group_size(module.num_partitions) == 16
    stats = collective_stats(module, H100_SXM)
    assert stats.counts == {"all-reduce": 1}
    assert stats.total_bytes == b * s * d * 4  # the (B,S,d) f32 output, once
    assert stats.ring_seconds == pytest.approx(2 * 15 / 16 * b * s * d * 4 / H100_SXM.link_bw)


def test_every_collective_lowers(fake_group):
    x = torch.ones(16, 8)
    module = lower_exported(torch.export.export(Collectives(fake_group), (x,)))
    assert module.unmapped == () and module.num_partitions == 16
    assert sorted(op.opcode for op in module.collective_ops()) == [
        "all-gather", "all-to-all", "reduce-scatter"]
    assert all("replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}" in op.attrs
               for op in module.collective_ops())
    stats = collective_stats(module, H100_SXM)
    # all-gather reads the (16, 8) shard, reduce-scatter the (256, 8)
    # gathered tensor, all-to-all the shard.
    assert stats.bytes_by_op == {"all-gather": 512.0, "reduce-scatter": 8192.0,
                                 "all-to-all": 512.0}


class ManyOps(torch.nn.Module):
    """The ops the lowering maps that no model of the repo reaches."""

    def forward(self, x, idx):
        y = torch.nn.functional.leaky_relu(x, 0.2) + torch.relu(x)
        y = y + torch.nn.functional.hardtanh(x) + torch.flip(x, (0,)) + torch.exp2(x)
        y = y + torch.nn.functional.gelu(x)  # exact: erf
        y = torch.nn.functional.pad(y, (1, 1), value=0.5)[:, 1:-1]
        y = y.index_put((idx,), torch.ones(2, 8))
        y = y.scatter_add(0, idx[:, None].expand(2, 8), torch.ones(2, 8))
        top, _ = torch.topk(y, 3, dim=-1)
        norm = torch.nn.functional.layer_norm(y, (8,), torch.ones(8), torch.zeros(8))
        return norm, top, torch.argsort(y, dim=-1), torch.cumsum(y, 1)


def test_ops_no_model_reaches_are_mapped():
    assert not dist.is_initialized()
    ep = torch.export.export(ManyOps(), (torch.randn(4, 8), torch.tensor([0, 2])))
    module = lower_exported(ep)
    assert module.unmapped == () and module.num_partitions == 1
    opcodes = Counter(op.opcode for op in module.entry.ops)
    for opcode in ("select", "clamp", "reverse", "exp", "erf", "pad", "scatter",
                   "sort", "reduce-window", "fusion"):
        assert opcodes[opcode] >= 1, opcode
    (fusion,) = [op for op in module.entry.ops if op.opcode == "fusion"]
    cost = PortCost(module, H100_SXM)
    # mean, centre, square, var, rsqrt, normalize, scale, shift over 4 x 8.
    assert cost.op_flops(fusion, module.entry) == 32 + 32 + 32 + 32 + 4 * 4 + 32 + 32 + 32
