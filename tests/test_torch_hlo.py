"""The port's accelerator-graph analyzer (``repro_torch.core.hlo``) against
``repro.core.hlo`` on the same HLO texts — tests/test_hlo.py's fixtures,
tests/test_api.py's ``WHILE_HLO`` and text JAX compiles here (a dot, an
MLP, a ``fori_loop`` over a captured matmul, a ``scan``): the parsed IR field
for field, per-op FLOPs, bytes and seconds, trip and execution counts, CP
path, LCD chains and ``from_hlo(...).to_dict()``, all exactly equal.  The
reference is handed a ``TPUChip`` carrying the H100's numbers, so that the
seconds compare exactly; its port names map MXU → TC, ICI → NVLink and its
arch tpu-v5e → h100.

Then the ``torch.export`` front end on the same computations written in
torch: dot and module FLOPs equal to the reference's on JAX's HLO, the trip
counts and the LCD's carried index; and the tiny tinyllama forward on the
reference's own weights (``models/convert.py``), whose dot FLOPs equal the
reference's op for op, with no ATen op left unmapped."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.cond import cond as torch_cond
from torch._higher_order_ops.while_loop import while_loop

import repro.core.hlo.critical_path as ref_cp
import repro.core.hlo.hotspots as ref_hotspots
import repro.core.hlo.lcd as ref_lcd
import repro.core.hlo.roofline as ref_roofline
import repro_torch.core.hlo as port_hlo
import repro_torch.core.hlo.critical_path as port_cp
import repro_torch.core.hlo.hotspots as port_hotspots
import repro_torch.core.hlo.lcd as port_lcd
import repro_torch.core.hlo.roofline as port_roofline
from repro.configs import RunConfig as JaxRun
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.core.analysis.report import AnalysisReport as RefReport
from repro.core.hlo.costs import HLOCostModel as RefCost
from repro.core.hlo.machine import TPUChip
from repro.core.hlo.parser import parse_hlo as ref_parse
from repro.models import init_params as jax_init_params
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.models.transformer import lm_logits as jax_lm_logits
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.core.analysis.report import AnalysisReport as PortReport
from repro_torch.core.hlo import H100_SXM, lower_exported
from repro_torch.core.hlo.costs import HLOCostModel as PortCost
from repro_torch.core.hlo.export import core_aten
from repro_torch.core.hlo.parser import parse_hlo as port_parse
from repro_torch.models import forward_hidden
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import lm_logits
from test_api import WHILE_HLO
from test_hlo import SIMPLE_HLO

CPU = torch.device("cpu")
# The H100's numbers in the reference's chip type.
REF_CHIP = TPUChip(name=H100_SXM.name, peak_flops=H100_SXM.peak_flops,
                   hbm_bw=H100_SXM.hbm_bw, ici_bw=H100_SXM.link_bw,
                   ici_links=H100_SXM.links, vmem_bytes=H100_SXM.smem_bytes_per_sm,
                   hbm_bytes=H100_SXM.hbm_bytes)
PORT_NAMES = {"MXU": "TC", "HBM": "HBM", "ICI": "NVLink"}
TUPLE_COMMENTS = ("ENTRY %e (p: s32[]) -> s32[] {\n  %w = (s32[], f32[4,4]{1,0}, "
                  "/*index=2*/f32[8]) while(%t), condition=%c, body=%b\n}")
KNOWN_TRIPS = SIMPLE_HLO.replace(
    "while(%init), condition=%cond, body=%body",
    'while(%init), condition=%cond, body=%body, '
    'backend_config={"known_trip_count":{"n":"7"}}')


# -- the computations, in JAX and in torch --------------------------------------

def jax_dot(x, w):
    return x @ w


def jax_mlp(x, w1, b1, w2):
    return jnp.tanh(x @ w1 + b1) @ w2


def jax_fori(x, w):
    return jax.lax.fori_loop(0, 16, lambda i, x: jnp.tanh(x @ w), x)


def jax_scan(x, ws):
    return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]


class TorchDot(torch.nn.Module):
    def forward(self, x, w):
        return x @ w


class TorchMLP(torch.nn.Module):
    def forward(self, x, w1, b1, w2):
        return torch.tanh(x @ w1 + b1) @ w2


class TorchFori(torch.nn.Module):
    """``fori_loop(0, 16, ...)`` over a captured matmul: the counter first,
    then the carried value, as in JAX's loop tuple."""

    def forward(self, x, w):
        return while_loop(lambda i, x: i < 16,
                          lambda i, x: (i + 1, torch.tanh(x @ w)),
                          (torch.tensor(0), x))[1]


class TorchScan(torch.nn.Module):
    """``scan`` over 8 stacked weights as a while loop that reads ``ws[i]``."""

    def forward(self, x, ws):
        return while_loop(
            lambda i, x: i < 8,
            lambda i, x: (i + 1, torch.tanh(x @ ws.index_select(0, i.reshape(1))[0])),
            (torch.tensor(0), x))[1]


# name: (JAX function, torch module, input shapes, dtype)
COMPUTATIONS = {
    "dot": (jax_dot, TorchDot, [(8, 64), (64, 32)], "float32"),
    "mlp": (jax_mlp, TorchMLP, [(8, 64), (64, 128), (128,), (128, 32)], "float32"),
    "mlp_bf16": (jax_mlp, TorchMLP, [(8, 64), (64, 128), (128,), (128, 32)], "bfloat16"),
    "fori": (jax_fori, TorchFori, [(8, 64), (64, 64)], "float32"),
    "scan": (jax_scan, TorchScan, [(8, 64), (8, 64, 64)], "float32"),
}
TRIPS = {"fori": 16, "scan": 8}


@functools.lru_cache(maxsize=None)
def jax_text(name):
    fn, _, shapes, dtype = COMPUTATIONS[name]
    args = [jax.ShapeDtypeStruct(s, getattr(jnp, dtype)) for s in shapes]
    return jax.jit(fn).lower(*args).compile().as_text()


@functools.lru_cache(maxsize=None)
def exported(name):
    _, module, shapes, dtype = COMPUTATIONS[name]
    rng = np.random.default_rng(0)
    args = tuple(torch.as_tensor(rng.standard_normal(s, dtype=np.float32)).to(getattr(torch, dtype))
                 for s in shapes)
    return torch.export.export(module(), args)


TEXTS = {"simple": lambda: SIMPLE_HLO, "known_trips": lambda: KNOWN_TRIPS,
         "tuple_comments": lambda: TUPLE_COMMENTS, "while_api": lambda: WHILE_HLO,
         **{f"jax_{n}": functools.partial(jax_text, n) for n in COMPUTATIONS}}


def both(text):
    return ref_parse(text), port_parse(text)


def op_fields(op, comp):
    lhs = comp.op_by_name(op.operands[0]) if op.operands else None
    return (op.name, op.opcode, [(s.dtype, s.dims, s.elements, s.bytes) for s in op.shapes],
            op.operands, op.attrs, op.is_root, op.raw, op.result_bytes, op.is_collective,
            op.called_computations, op.body_computation, op.condition_computation,
            op.known_trip_count, op.replica_group_size(4),
            op.dot_contracting(lhs.shapes[0] if lhs is not None and lhs.shapes else None))


def module_fields(module):
    return (module.name, module.entry_name, module.num_partitions,
            {name: (c.name, [p.name for p in c.params], c.root and c.root.name,
                    [op_fields(op, c) for op in c.ops])
             for name, c in module.computations.items()},
            [op.name for op in module.collective_ops()])


def dot_flops(module, cost):
    """(op FLOPs, executions) of every dot, and their trip-aware sum."""
    counts = cost.execution_counts()
    dots = sorted((cost.op_flops(op, comp), counts.get(comp.name, 0.0))
                  for comp in module.computations.values()
                  for op in comp.ops if op.opcode == "dot")
    return dots, sum(f * n for f, n in dots)


def per_run(dots):
    """The FLOPs of each dot execution of one run, sorted."""
    return sorted(f for f, n in dots for _ in range(int(n)))


def as_port(report):
    """A reference report's dict under the port's names."""
    d = report.to_dict()
    d["arch"] = {"tpu-v5e": "h100"}[d["arch"]]
    d["ports"] = [PORT_NAMES[p] for p in d["ports"]]
    for key in ("port_pressure", "balanced_port_load"):
        d[key] = {PORT_NAMES[p]: v for p, v in d[key].items()}
    for key in ("bottleneck_port", "balanced_bottleneck"):
        d[key] = PORT_NAMES.get(d[key], d[key])
    return d


# -- parser, costs, CP, LCD, report on the same texts ----------------------------


@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_equal_field_for_field(name):
    ref, port = both(TEXTS[name]())
    assert module_fields(port) == module_fields(ref)
    assert port.unmapped == ()


@pytest.mark.parametrize("name", list(TEXTS))
def test_costs_equal_per_op(name):
    ref, port = both(TEXTS[name]())
    for trips in (True, False):
        rc = RefCost(ref, REF_CHIP, count_while_trips=trips)
        pc = PortCost(port, H100_SXM, count_while_trips=trips)
        for cname, comp in ref.computations.items():
            pcomp = port.computations[cname]
            for op, pop in zip(comp.ops, pcomp.ops):
                assert (pc.op_flops(pop, pcomp), pc.op_bytes(pop, pcomp),
                        pc.op_seconds(pop, pcomp)) == \
                    (rc.op_flops(op, comp), rc.op_bytes(op, comp), rc.op_seconds(op, comp))
                if op.opcode == "while":
                    assert pc.while_trip_count(pop) == rc.while_trip_count(op)
            assert pc.computation_flops(cname) == rc.computation_flops(cname)
        for scheduled in (False, True):
            assert pc.execution_counts(scheduled) == rc.execution_counts(scheduled)
        assert (pc.module_flops(), pc.module_bytes()) == (rc.module_flops(), rc.module_bytes())


@pytest.mark.parametrize("name", list(TEXTS))
def test_critical_path_and_lcd_equal(name):
    text = TEXTS[name]()
    ref, port = ref_cp.hlo_critical_path(text, REF_CHIP), port_cp.hlo_critical_path(text)
    assert port.seconds == ref.seconds
    assert [dataclasses.astuple(n) for n in port.path] == \
        [dataclasses.astuple(n) for n in ref.path]
    assert port.render() == ref.render()
    ref, port = ref_lcd.hlo_loop_carried(text, REF_CHIP), \
        port_lcd.hlo_loop_carried(text, device=CPU)
    assert [dataclasses.astuple(c) for c in port.chains] == \
        [dataclasses.astuple(c) for c in ref.chains]
    assert port.render() == ref.render()


@pytest.mark.parametrize("name", [n for n in TEXTS if n != "tuple_comments"])
def test_from_hlo_to_dict_equal(name):
    text = TEXTS[name]()
    ref = RefReport.from_hlo(text, chip=REF_CHIP, arch="tpu-v5e")
    for source in (text, port_parse(text)):
        port = PortReport.from_hlo(source, device=CPU)
        assert port.to_dict() == as_port(ref)
    assert port.render("text") == PortReport.from_dict(as_port(ref)).render("text")


@pytest.mark.parametrize("name", list(TEXTS))
def test_roofline_collectives_and_hotspots_equal(name):
    text = TEXTS[name]()
    ref, port = both(text)
    ref_counts = RefCost(ref, REF_CHIP).execution_counts()
    for counts in (None, ref_counts):
        assert dataclasses.asdict(port_roofline.collective_stats(port, H100_SXM, counts)) == \
            dataclasses.asdict(ref_roofline.collective_stats(ref, REF_CHIP, counts))
    if name != "tuple_comments":
        ref_row = ref_roofline.roofline_report(text, name="t", chip=REF_CHIP,
                                               model_flops=1e6).row()
        port_row = port_roofline.roofline_report(text, name="t", model_flops=1e6).row()
        ref_row["dominant"] = PORT_NAMES[ref_row["dominant"]]
        assert port_row == ref_row
    for kw in ({}, {"min_bytes": 0, "top_k": 5}):
        assert [dataclasses.astuple(h) for h in port_hotspots.memory_hotspots(text, **kw)] == \
            [dataclasses.astuple(h) for h in ref_hotspots.memory_hotspots(text, **kw)]
    assert port_hotspots.cpu_bf16_artifact_bytes(text, min_bytes=0) == \
        ref_hotspots.cpu_bf16_artifact_bytes(text, min_bytes=0)


def test_engine_model_is_the_h100s():
    assert port_hlo.H100_SXM.port_pressure(989.4e12, 3.35e12, 450e9) == \
        {"TC": 1.0, "HBM": 1.0, "NVLink": 1.0}
    assert (H100_SXM.links, H100_SXM.sm_count, H100_SXM.smem_bytes_per_sm,
            H100_SXM.hbm_bytes) == (18, 132, 228 * 1024, 80 * 10**9)
    for group in (1, 2, 8):
        for opcode in ("all-reduce", "all-gather-start", "reduce-scatter",
                       "all-to-all", "collective-permute", "send"):
            assert H100_SXM.collective_model_seconds(opcode, 1e9, group) == \
                REF_CHIP.collective_model_seconds(opcode, 1e9, group)


def test_op_index_follows_appended_ops():
    module = port_parse(SIMPLE_HLO)
    comp = module.entry
    assert comp.op_by_name("dot") is comp.ops[-1]
    extra = dataclasses.replace(comp.ops[0], name="late")
    comp.ops.append(extra)
    assert comp.op_by_name("late") is extra
    comp.ops.append(dataclasses.replace(comp.ops[1], name="dot"))
    assert comp.op_by_name("dot") is comp.ops[-3]  # the first of that name


# -- the torch.export front end --------------------------------------------------


@pytest.mark.parametrize("name", list(COMPUTATIONS))
def test_export_flops_equal_reference_on_jax_hlo(name):
    ref = ref_parse(jax_text(name))
    port = lower_exported(exported(name))
    assert port.unmapped == ()
    rc, pc = RefCost(ref, REF_CHIP), PortCost(port, H100_SXM)
    assert dot_flops(port, pc) == dot_flops(ref, rc)
    assert pc.module_flops() == rc.module_flops()
    if name in TRIPS:
        (loop,) = [op for op in port.entry.ops if op.opcode == "while"]
        assert pc.while_trip_count(loop) == TRIPS[name] == \
            rc.while_trip_count(next(op for c in ref.computations.values()
                                     for op in c.ops if op.opcode == "while"))
        ref_lcd_res = ref_lcd.hlo_loop_carried(ref, REF_CHIP)
        port_lcd_res = port_lcd.hlo_loop_carried(port, device=CPU)
        assert port_lcd_res.longest.tuple_index == ref_lcd_res.longest.tuple_index == 1
        assert port_lcd_res.longest.trip_count == TRIPS[name]
        assert sorted(c.tuple_index for c in port_lcd_res.chains) == \
            sorted(c.tuple_index for c in ref_lcd_res.chains)


def test_while_body_tuple_layout():
    """Carried values first, then the captured inputs passing through."""
    module = lower_exported(exported("fori"))
    (loop,) = [op for op in module.entry.ops if op.opcode == "while"]
    body = module.computations[loop.body_computation]
    assert body.root.opcode == "tuple" and len(body.params) == 1
    reads = {int(op.attrs.split("=")[1]): op.name for op in body.ops
             if op.opcode == "get-tuple-element"}
    assert sorted(reads) == [0, 1, 2]
    assert body.root.operands[2] == reads[2]  # the captured weight, unchanged
    dot = next(op for op in body.ops if op.opcode == "dot")
    assert dot.operands == (reads[1], reads[2])
    cond = module.computations[loop.condition_computation]
    assert cond.root.opcode == "compare" and "direction=LT" in cond.root.attrs
    assert any(op.opcode == "constant" and "constant(16)" in op.raw for op in cond.ops)


def test_roofline_from_exported_counts_like_pytorch():
    from torch.utils.flop_counter import FlopCounterMode

    ep = exported("mlp")
    report = port_roofline.roofline_from_exported(ep, name="mlp")
    with FlopCounterMode(display=False) as counter:
        ep.module()(*(torch.ones(s) for s in COMPUTATIONS["mlp"][2]))
    assert report.ca_raw_flops == counter.get_total_flops() == \
        dot_flops(lower_exported(ep), PortCost(lower_exported(ep), H100_SXM))[1]
    assert report.hlo_flops == report.ca_raw_flops and report.ca_raw_bytes == 0.0
    assert set(report.terms) == {"TC", "HBM", "NVLink"} and report.dominant in report.terms
    assert report.memory_per_device is None
    assert "(TC)" in report.render() and report.row()["compute_s"] == report.terms["TC"]
    # A loop: its body counted once by PyTorch's counter, corrected by the
    # trip-aware estimate, as the reference corrects XLA's cost_analysis().
    loop = port_roofline.roofline_from_exported(exported("fori"), model_flops=2 * 8 * 64 * 64 * 16)
    assert loop.ca_raw_flops == 2 * 8 * 64 * 64
    assert 0.9 < loop.useful_ratio < 1.1


def test_from_hlo_takes_an_exported_program():
    ep = exported("fori")
    report = PortReport.from_hlo(ep, device=CPU)
    assert report.to_dict() == PortReport.from_hlo(lower_exported(ep), device=CPU).to_dict()
    assert report.kind == "hlo" and report.arch == "h100" and report.lcd_block > 0
    assert report.kernel_name == "exported"
    assert max(report.lcd_chains, key=lambda c: c.length).carried_by == 1


class WithTrunc(torch.nn.Module):
    def forward(self, x):
        return torch.trunc(x) * 2


class WithCond(torch.nn.Module):
    def forward(self, x):
        return torch_cond(x.sum() > 0, lambda x: torch.tanh(x @ x), lambda x: x + 1, (x,))


def test_opcode_table_names_opcodes_the_cost_model_knows():
    """Every opcode the lowering prints is one the cost model (the
    reference's opcode sets) costs, or one XLA prints whose FLOPs the
    reference counts as 0 as well: a misspelt name would count 0 silently."""
    from repro.core.hlo import costs as ref_costs
    from repro_torch.core.hlo import export

    costed = ref_costs._ELEMENTWISE | ref_costs._TRANSCENDENTAL | ref_costs._FREE | {
        "reduce", "gather", "dot", "convolution", "fusion", "while", "conditional",
        "reduce-window", "sort", "scatter", "dynamic-update-slice"}
    zero_flops = {"copy", "convert", "concatenate", "broadcast", "reverse", "pad"}
    assert set(export._OPCODES.values()) <= costed | zero_flops
    assert "compare" in ref_costs._ELEMENTWISE and "bitcast" in ref_costs._FREE
    assert not export._VIEWS & set(export._OPCODES)


def test_unmapped_op_keeps_its_name_and_counts_no_flops():
    module = lower_exported(torch.export.export(WithTrunc(), (torch.ones(4, 4),)))
    assert module.unmapped == ("aten.trunc.default",)
    (op,) = [op for op in module.entry.ops if op.opcode == "trunc"]
    cost = PortCost(module, H100_SXM)
    assert cost.op_flops(op, module.entry) == 0.0
    assert cost.op_bytes(op, module.entry) == 2 * 16 * 4


def test_cond_becomes_conditional():
    module = lower_exported(torch.export.export(WithCond(), (torch.ones(4, 4),)))
    (op,) = [op for op in module.entry.ops if op.opcode == "conditional"]
    assert len(module.computations) == 3 and module.unmapped == ()
    # The reference's parser reads the first branch of branch_computations.
    assert PortCost(module, H100_SXM).op_flops(op, module.entry) == 2 * 4 * 4 * 4 + 4 * 16


def test_symbolic_shapes_raise():
    batch = torch.export.Dim("batch", min=2, max=64)
    ep = torch.export.export(TorchDot(), (torch.ones(8, 64), torch.ones(64, 32)),
                             dynamic_shapes=({0: batch}, None))
    with pytest.raises(ValueError, match="symbolic shape"):
        lower_exported(ep)


# -- the tiny tinyllama forward on the reference's weights ----------------------


class Forward(torch.nn.Module):
    def __init__(self, model, cfg, run):
        super().__init__()
        self.model, self.cfg, self.run = model, cfg, run

    def forward(self, tokens):
        x, _ = forward_hidden(self.model, self.cfg, self.run, tokens)
        return lm_logits(self.model, self.cfg, x)


# The core-ATen ops of the tiny forward's export (torch 2.13), by sequence
# length: a torch whose decompositions differ fails here instead of counting
# a new op as 0 FLOPs.
TINY_OPS = {
    32: {"_assert_tensor_metadata", "_to_copy", "add", "amax", "arange", "bmm", "cat",
         "clamp", "clone", "cos", "div", "embedding", "exp", "expand", "full", "gt",
         "maximum", "mean", "mm", "mul", "permute", "pow", "reciprocal", "rsqrt",
         "scalar_tensor", "sigmoid", "sin", "slice", "split_with_sizes", "sub", "sum",
         "unsqueeze", "view", "where"},
    37: {"_assert_tensor_metadata", "_softmax", "_to_copy", "add", "arange",
         "bitwise_and", "bitwise_not", "bmm", "cat", "clone", "cos", "div", "embedding",
         "expand", "full", "le", "mean", "mm", "mul", "permute", "pow", "reciprocal",
         "rsqrt", "scalar_tensor", "sigmoid", "sin", "split_with_sizes", "sub",
         "unsqueeze", "view", "where"},
}


@functools.lru_cache(maxsize=None)
def tiny_forward(dtype, seq):
    jcfg = dataclasses.replace(jax_tiny(jax_get_config("tinyllama-1.1b")), dtype=dtype)
    cfg = dataclasses.replace(tiny_variant(get_config("tinyllama-1.1b")), dtype=dtype)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, seq))
    jrun = JaxRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)
    run = RunConfig(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)

    def forward(p, t):
        x, _ = jax_forward_hidden(p, jcfg, jrun, t)
        return jax_lm_logits(p, jcfg, x)

    text = jax.jit(forward).lower(params, jnp.asarray(tokens)).compile().as_text()
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    ep = torch.export.export(Forward(model, cfg, run), (torch.as_tensor(tokens),))
    return text, core_aten(ep)


@pytest.mark.parametrize("seq", [32, 37], ids=["chunked", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_tinyllama_dot_flops_equal_reference(dtype, seq):
    """S 32 takes the chunked attention (two chunks of 16), S 37 the naive
    one (a softmax). The reference scans its layers (a while of 2 trips);
    the export unrolls them. Each dot's FLOPs times its executions equal
    the reference's, execution for execution: its batched dots are rank 4
    where the export's bmm is rank 3, over the same elements."""
    text, ep = tiny_forward(dtype, seq)
    ref, port = ref_parse(text), lower_exported(ep)
    assert port.unmapped == ()
    ref_dots, ref_total = dot_flops(ref, RefCost(ref, REF_CHIP))
    port_dots, port_total = dot_flops(port, PortCost(port, H100_SXM))
    assert port_total == ref_total
    assert per_run(port_dots) == per_run(ref_dots)
    assert core_aten(ep) is ep  # decomposed once, not again
    ops = {n.target.overloadpacket.__name__ for gm in ep.graph_module.modules()
           if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
           if n.op == "call_function" and hasattr(n.target, "overloadpacket")}
    assert ops == TINY_OPS[seq]
    report = PortReport.from_hlo(ep, device=CPU)
    assert report.tp_block > 0 and report.cp_block > 0 and report.lcd_chains == ()
