"""The dry run's traced graphs against the reference's compiled HLO: the dot
FLOPs of each family's tiny cells on one rank.

Each cell (tiny variant, B 2, S 64, ``chunked`` attention in chunks of 16,
two SSD chunks; the dry run's run config otherwise) is traced by
``repro_torch.launch.dryrun.trace_cell`` on a one-rank fake group and a
1 x 1 mesh, and compiled by the reference as its dry run jits it, on one
CPU device.  Prefill and decode cells have the reference's dot FLOPs
exactly.  Train cells are pinned as ratios, and every gap is listed dot by
dot (FLOPs of one dot: executions, port less reference):

* with remat "none" the ssm and hybrid families have 8 dots of 32,768
  FLOPs fewer, and the moe family one of 2,048: XLA's gradients of the
  SSD einsums ``bcjn,bcjh,bcjhp->bchnp`` / ``bcijh,bcjhp->bcihp`` with
  respect to their decay operands, and of the combine weights
  ``gsk,gske,gskc->gsec`` with respect to the gates, are dots whose every
  dim but one is a batch dim, which PyTorch's einsum backward computes as
  a multiply and a sum (those FLOPs count there, not as dots);
* the rest comes with remat "full", for the hybrid family only: the
  port's recompute (``torch.utils.checkpoint``, stopping early at the last
  saved tensor the backward needs) is not XLA's rematerialization of the
  same group (two Mamba layers and the shared block) after its
  simplifications; it has two ``in_proj`` products (2 x 128 x 128 x 552
  FLOPs each) and 20 smaller dots fewer, 45,088,768 FLOPs in all.
  (Products the recompute makes and no backward reads, such as the moe
  family's last combine product, are dead code the tracer removes, as XLA
  does.)
"""

import dataclasses
import functools
import os
from collections import Counter

import pytest

from repro_torch.configs import get_config, tiny_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hlo import H100_SXM, lower_graph
from repro_torch.core.hlo.costs import HLOCostModel as PortCost
from repro_torch.distributed import MeshContext
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _device_mesh

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402 (sets XLA_FLAGS on import)
import jax  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import tiny_variant as jax_tiny  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.core.hlo.costs import HLOCostModel as RefCost  # noqa: E402
from repro.core.hlo.parser import parse_hlo as ref_parse  # noqa: E402
from repro.launch.specs import input_specs as ref_input_specs  # noqa: E402
from repro.models import decode_step as ref_decode_step  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro.train.state import abstract_train_state as ref_abstract_state  # noqa: E402
from test_torch_hlo import REF_CHIP, dot_flops  # noqa: E402

# The reference's dry run forces 512 host devices at import; give the
# process its flags back before jax starts a backend.
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

FAMILIES = {"dense": "tinyllama-1.1b", "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "moe": "deepseek-moe-16b", "audio": "whisper-base", "vlm": "phi-3-vision-4.2b"}
SEQ, BATCH, CHUNK = 64, 2, 16
# Port dot FLOPs / reference dot FLOPs of each tiny train cell (remat
# "full"), and the gaps (module docstring), dot FLOPs: executions.
TRAIN_RATIOS = {"tinyllama-1.1b": 1.0, "mamba2-130m": 0.999065, "zamba2-2.7b": 0.93131,
                "deepseek-moe-16b": 0.999995, "whisper-base": 1.0,
                "phi-3-vision-4.2b": 1.0}
SSD_GRADS = {32768.0: -8}
TRAIN_GAPS = {
    "none": {"mamba2-130m": SSD_GRADS, "zamba2-2.7b": SSD_GRADS,
             "deepseek-moe-16b": {2048.0: -1}},
    "full": {"mamba2-130m": SSD_GRADS,
             "zamba2-2.7b": {32768.0: -8, 131072.0: -2, 524288.0: -4, 1048576.0: -6,
                             18087936.0: -2},
             "deepseek-moe-16b": {2048.0: -1}},
}


def overrides(remat=None):
    return dict({"attention_chunk": CHUNK}, **({"remat": remat} if remat else {}))


@functools.lru_cache(maxsize=None)
def reference(arch, kind, remat=None):
    """The reference's compiled HLO of the cell, parsed."""
    cfg = jax_tiny(jax_get_config(arch))
    shape = JaxShape("tiny", seq_len=SEQ, global_batch=BATCH, kind=kind)
    run = ref_dryrun.default_run_config(cfg, shape, overrides(remat))
    specs = ref_input_specs(cfg, shape)
    state = ref_abstract_state(cfg)
    if kind == "train":
        lowered = jax.jit(ref_make_train_step(cfg, run)).lower(state, specs)
    elif kind == "prefill":
        def step(params, tokens, frontend=None):
            return ref_prefill(params, cfg, run, tokens, frontend=frontend)
        lowered = jax.jit(step).lower(state.params, specs["tokens"], specs.get("frontend"))
    else:
        def step(params, cache, tokens):
            return ref_decode_step(params, cfg, run, cache, tokens)
        lowered = jax.jit(step).lower(state.params, specs["cache"], specs["tokens"])
    return ref_parse(lowered.compile().as_text())


@functools.lru_cache(maxsize=None)
def traced(arch, kind, remat=None):
    """(the port's traced cell on one rank, lowered; the graph)."""
    cfg = tiny_variant(get_config(arch))
    shape = ShapeConfig("tiny", seq_len=SEQ, global_batch=BATCH, kind=kind)
    run = dryrun.default_run_config(cfg, shape, overrides(remat))
    with dryrun.fake_group(1):
        ctx = MeshContext(mesh=_device_mesh("cpu", (1, 1), ("data", "model")))
        gm, _ = dryrun.trace_cell(cfg, shape, run, ctx, "cpu")
        return lower_graph(gm), gm


def dots(module, cost):
    """FLOPs of one dot: its executions over one run."""
    counts = cost.execution_counts()
    out = Counter()
    for comp in module.computations.values():
        for op in comp.ops:
            if op.opcode == "dot":
                out[cost.op_flops(op, comp)] += counts.get(comp.name, 0.0)
    return out


def test_families_cover_the_models():
    assert sorted(get_config(a).family for a in FAMILIES.values()) == sorted(FAMILIES)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(FAMILIES.values()))
def test_serve_cells_have_the_reference_dot_flops(arch, kind):
    ref = reference(arch, kind)
    port, _ = traced(arch, kind)
    assert port.unmapped == ()
    assert dot_flops(port, PortCost(port, H100_SXM))[1] == \
        dot_flops(ref, RefCost(ref, REF_CHIP))[1] > 0


@pytest.mark.parametrize("arch", sorted(FAMILIES.values()))
def test_train_cells_at_pinned_ratios(arch):
    ref = reference(arch, "train", "full")  # the train cells' remat
    port, _ = traced(arch, "train", "full")
    assert port.unmapped == ()
    ratio = dot_flops(port, PortCost(port, H100_SXM))[1] / dot_flops(ref, RefCost(ref, REF_CHIP))[1]
    assert round(ratio, 6) == TRAIN_RATIOS[arch]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", sorted(TRAIN_GAPS["full"]))
def test_train_gaps_dot_by_dot(arch, remat):
    ref = reference(arch, "train", remat)
    port, _ = traced(arch, "train", remat)
    mine, theirs = dots(port, PortCost(port, H100_SXM)), dots(ref, RefCost(ref, REF_CHIP))
    gap = {f: mine[f] - theirs[f] for f in set(mine) | set(theirs) if mine[f] != theirs[f]}
    assert gap == TRAIN_GAPS[remat].get(arch, {})


MATMULS = ("aten.mm.default", "aten.bmm.default", "aten.addmm.default",
           "aten.baddbmm.default")


def matmuls(gm):
    return sum(str(n.target) in MATMULS for n in gm.graph.nodes)


def test_traced_remat_reruns_the_blocks_matmuls():
    """``tests/test_torch_remat.py``'s rule in the traced train graph of the
    dense family: remat "full" runs every matmul of the blocks' forward
    once more in backward but the loss's logits product and, stopping
    early, each block's last product."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import _loss_fn

    arch = FAMILIES["dense"]
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    shape = ShapeConfig("tiny", seq_len=SEQ, global_batch=BATCH, kind="train")
    run = dryrun.default_run_config(cfg, shape, overrides("none"))

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += str(func) in MATMULS
            return func(*args, **(kwargs or {}))

    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((BATCH, SEQ), dtype=torch.long)
    with torch.no_grad(), Count():
        _loss_fn(state.params, cfg, run, {"tokens": tokens, "labels": tokens})
    forward = Count.n
    rerun = forward - 1 - cfg.n_layers
    assert matmuls(traced(arch, "train", "full")[1]) == \
        matmuls(traced(arch, "train", "none")[1]) + rerun
