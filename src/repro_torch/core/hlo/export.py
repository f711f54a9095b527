"""``torch.export`` front end: an ``ExportedProgram`` as the HLO IR.

PyTorch has no HLO, so where ``repro.core.hlo`` reads the text XLA lowers a
jitted function to, the port reads the graph PyTorch itself produces:
:func:`lower_exported` decomposes the program to core ATen
(``ep.run_decompositions()``) and prints each FX node as the HLO op that
computes the same thing, then parses that text with
:func:`~repro_torch.core.hlo.parser.parse_hlo`.  The cost model, critical
path, LCD, hot spots and roofline then run on it unchanged.

What the lowering decides:

* ``mm``/``bmm`` become ``dot`` with their contracting (and batch) dims in
  the attrs ``HLOOp.dot_contracting`` reads; ``addmm``/``baddbmm`` become a
  ``dot`` and an ``add``, as XLA lowers a biased linear; ``convolution``
  becomes ``convolution`` (plus an ``add`` for a bias).  A (log-)softmax
  becomes a ``fusion`` over XLA's reduce / subtract / exp / reduce / divide,
  one kernel in eager PyTorch as in XLA.
* Elementwise, transcendental and compare ops take XLA's names
  (``sigmoid`` → ``logistic``, ``sub`` → ``subtract``, ``where`` →
  ``select``, ``lt``/``eq``/... → ``compare``), reductions become
  ``reduce``, ``embedding``/``index`` become ``gather``, a dtype-changing
  ``_to_copy`` becomes ``convert`` and ``clone`` ``copy``.
* Views are free ``bitcast`` ops: in eager PyTorch they move no bytes.
* Bytes differ from XLA's on purpose.  The graph has no fusions, so each op
  reads its operands and writes its result, which is what eager PyTorch
  does; XLA's text fuses elementwise chains and counts a fusion's operands
  and result once.
* ``higher_order.while_loop`` becomes a ``while`` whose body takes one tuple
  parameter, reads the carried values by ``get-tuple-element`` and returns
  a ``tuple``.  The closure-captured ``additional_inputs`` are appended as
  tuple elements that pass through unchanged, as XLA lowers a
  ``fori_loop``'s captured operands, so the LCD's search by tuple index
  applies unchanged.  A Python scalar a ``compare`` reads becomes a
  ``constant`` op beside it, so the trip count of ``i < 16`` is inferred as
  it is for XLA's text.  ``higher_order.cond`` becomes ``conditional``.
* Ops XLA lowers to a chain print that chain: ``gelu`` (tanh) as
  ``jax.nn.gelu``'s multiplies, adds and ``tanh``, (exact) as its ``erf``
  and elementwise ops; ``leaky_relu`` as compare, multiply and select;
  ``exp2`` as a multiply and ``exp``.  ``cumsum`` becomes ``reduce-window``,
  ``sort``/``argsort``/``topk`` ``sort``, ``slice_scatter``
  ``dynamic-update-slice``, ``index_put``/``scatter_add`` ``scatter``,
  ``flip`` ``reverse``, ``constant_pad_nd`` ``pad``, and
  ``native_layer_norm`` a ``fusion`` over its reduce / subtract / multiply
  / rsqrt chain.
* The functional collectives (``torch.distributed._functional_collectives``)
  become ``all-reduce``, ``all-gather``, ``reduce-scatter`` and
  ``all-to-all`` with ``replica_groups`` of their group's ranks, and
  ``wait_tensor`` a free ``bitcast``.  The module carries ``num_partitions``
  equal to the default group's world size, so the roofline's collective
  term sees the program as one rank of it.
* An ATen op outside the table keeps its name as its opcode: like an opcode
  the reference does not know, it counts 0 FLOPs, and its bytes are counted
  as any op's.  Those names are listed in ``module.unmapped``.
* Symbolic shapes raise ``ValueError``: export with static shapes.
"""

from __future__ import annotations

import operator
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import fx

from repro_torch.core.hlo.parser import HLOModule, parse_hlo

_DTYPES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred",
}

# ATen op (overload packet name) -> HLO opcode, for ops whose operands are
# the tensor arguments in order and whose result is the node's value.
_OPCODES = {
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "reciprocal": "divide", "maximum": "maximum",
    "minimum": "minimum", "clamp_min": "maximum", "clamp_max": "minimum",
    "abs": "abs", "neg": "negate", "sign": "sign", "where": "select",
    "logical_and": "and", "bitwise_and": "and", "logical_or": "or",
    "bitwise_or": "or", "logical_xor": "xor", "bitwise_xor": "xor",
    "logical_not": "not", "bitwise_not": "not", "clamp": "clamp",
    "floor": "floor", "ceil": "ceil", "pow": "power",
    "remainder": "remainder", "fmod": "remainder",
    "exp": "exp", "expm1": "expm1", "log": "log", "log1p": "log1p",
    "tanh": "tanh", "rsqrt": "rsqrt", "sqrt": "sqrt", "sigmoid": "logistic",
    "sin": "sin", "cos": "cos", "atan2": "atan2", "erf": "erf",
    "sum": "reduce", "mean": "reduce", "amax": "reduce", "amin": "reduce",
    "max": "reduce", "min": "reduce", "prod": "reduce", "any": "reduce",
    "all": "reduce", "argmax": "reduce", "argmin": "reduce",
    "var": "reduce", "var_mean": "reduce",
    "embedding": "gather", "index": "gather", "index_select": "gather",
    "gather": "gather", "clone": "copy", "copy": "copy", "lift_fresh_copy": "copy",
    "cat": "concatenate", "arange": "iota", "scalar_tensor": "constant",
    "full": "broadcast", "full_like": "broadcast", "zeros": "broadcast",
    "zeros_like": "broadcast", "ones": "broadcast", "ones_like": "broadcast",
    "empty": "broadcast", "empty_like": "broadcast",
    "empty_strided": "broadcast", "fill": "broadcast",
    "relu": "maximum", "hardtanh": "clamp", "flip": "reverse",
    "constant_pad_nd": "pad", "cumsum": "reduce-window", "sort": "sort",
    "argsort": "sort", "topk": "sort", "slice_scatter": "dynamic-update-slice",
    "select_scatter": "dynamic-update-slice",
    "index_put": "scatter", "scatter_add": "scatter", "scatter": "scatter",
    "scatter_reduce": "scatter", "index_add": "scatter",
}
# Elementwise chains XLA emits for one ATen op: (opcode, operand) steps,
# each operand "x" (the op's input) or "prev" (the step before); a float is
# a scalar constant.  The last step is the node's value.
_GELU_TANH = (("multiply", "x", "x"), ("multiply", "prev", "x"),
              ("multiply", "prev", 0.044715), ("add", "x", "prev"),
              ("multiply", "prev", 0.7978845608028654), ("tanh", "prev"),
              ("add", "prev", 1.0), ("multiply", "prev", 0.5),
              ("multiply", "x", "prev"))
_GELU_ERF = (("multiply", "x", 0.7071067811865476), ("erf", "prev"),
             ("add", "prev", 1.0), ("multiply", "x", "prev"),
             ("divide", "prev", 2.0))
_EXP2 = (("multiply", "x", 0.6931471805599453), ("exp", "prev"))
# _c10d_functional op -> HLO collective; the group name is the last arg.
_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
# Views alias their input: free, as XLA's bitcast.
_VIEWS = {"view", "_unsafe_view", "permute", "expand", "unsqueeze", "squeeze",
          "slice", "select", "alias", "t", "transpose", "split",
          "split_with_sizes", "unbind", "as_strided", "wait_tensor"}
_COMPARE = {"eq": "EQ", "ne": "NE", "lt": "LT", "le": "LE", "gt": "GT",
            "ge": "GE"}
# Nodes that compute nothing (shape assertions).
_SKIP = {"_assert_tensor_metadata", "_assert_scalar", "_assert_async",
         "sym_constrain_range", "sym_constrain_range_for_size"}
_MM = "lhs_contracting_dims={1}, rhs_contracting_dims={0}"
_BMM = ("lhs_batch_dims={0}, lhs_contracting_dims={2}, rhs_batch_dims={0}, "
        "rhs_contracting_dims={1}")


def _type(val) -> str:
    """HLO type syntax of a node's value: one shape or a tuple of shapes."""
    if isinstance(val, (tuple, list)):
        return "(" + ", ".join(_type(v) for v in val) + ")"
    if not isinstance(val, torch.Tensor):
        raise ValueError(f"symbolic or non-tensor value {val!r} in the exported "
                         f"graph; export with static shapes")
    dims = []
    for d in val.shape:
        if not isinstance(d, int):
            raise ValueError(f"symbolic shape {tuple(val.shape)} in the exported "
                             f"graph; export with static shapes")
        dims.append(str(d))
    dtype = _DTYPES.get(val.dtype)
    if dtype is None:
        raise ValueError(f"dtype {val.dtype} has no HLO type in this lowering")
    return f"{dtype}[{','.join(dims)}]"


def _packet(target) -> Optional[str]:
    """``aten.add.Tensor`` -> ``add``; None for a non-ATen target."""
    packet = getattr(target, "overloadpacket", None)
    return getattr(packet, "__name__", None) if packet is not None else None


def _nodes_in(args) -> List[fx.Node]:
    out: List[fx.Node] = []
    for a in args:
        if isinstance(a, fx.Node):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(_nodes_in(a))
    return out


def _group_ranks(group_name: str) -> List[int]:
    """The global ranks of the process group a functional collective names."""
    from torch.distributed.distributed_c10d import (_resolve_process_group,
                                                    get_process_group_ranks)
    return get_process_group_ranks(_resolve_process_group(group_name))


def _num_partitions() -> int:
    """The default group's world size; 1 without one."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _literal(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return repr(value)


class _Lowering:
    """Prints the HLO text of one exported program, computation by
    computation; ``unmapped`` collects the ATen ops kept under their own
    names."""

    def __init__(self):
        self.computations: List[str] = []
        self.names: set = set()
        self.unmapped: Dict[str, None] = {}

    def _comp_name(self, base: str) -> str:
        name, k = base, 1
        while name in self.names:
            k += 1
            name = f"{base}.{k}"
        self.names.add(name)
        return name

    # -- one computation ----------------------------------------------------

    def computation(self, gm: fx.GraphModule, name: str, entry: bool = False,
                    passthrough: int = -1, root_is_value: bool = False) -> None:
        """Lower ``gm`` as computation ``name``.  The entry takes its
        placeholders as parameters; the others take one tuple parameter
        ``p`` and read placeholder i as element i.  ``passthrough`` >= 0
        appends placeholders from that index on to the root tuple (a while
        body's captured inputs); ``root_is_value`` makes the returned value
        itself the root (a while condition)."""
        lines: List[str] = []
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if entry:
            params = ", ".join(f"{n.name}: {_type(n.meta['val'])}" for n in placeholders)
            for i, n in enumerate(placeholders):
                lines.append(f"%{n.name} = {_type(n.meta['val'])} parameter({i})")
        else:
            ptype = _type([n.meta["val"] for n in placeholders])
            params = f"p: {ptype}"
            lines.append(f"%p = {ptype} parameter(0)")
            for i, n in enumerate(placeholders):
                lines.append(f"%{n.name} = {_type(n.meta['val'])} "
                             f"get-tuple-element(%p), index={i}")
        out_node = next(n for n in gm.graph.nodes if n.op == "output")
        for node in gm.graph.nodes:
            if node.op == "call_function":
                lines.extend(self.node(gm, node))
        outs = out_node.args[0]
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        if passthrough >= 0:
            outs += placeholders[passthrough:]
        if root_is_value:
            target = f"%{outs[0].name} = "
            lines = [("ROOT " + l) if l.startswith(target) else l for l in lines]
            result = _type(outs[0].meta["val"])
        else:
            result = _type([o.meta["val"] for o in outs])
            operands = ", ".join(f"%{o.name}" for o in outs)
            lines.append(f"ROOT %{name}.root = {result} tuple({operands})")
        head = "ENTRY " if entry else ""
        self.computations.append(
            f"{head}%{name} ({params}) -> {result} {{\n  "
            + "\n  ".join(lines) + "\n}\n")

    # -- one node -----------------------------------------------------------

    def node(self, gm: fx.GraphModule, node: fx.Node) -> List[str]:
        target, name = node.target, node.name
        val = node.meta.get("val")
        if target is operator.getitem:
            return [f"%{name} = {_type(val)} get-tuple-element(%{node.args[0].name}), "
                    f"index={node.args[1]}"]
        if target is torch.ops.higher_order.while_loop:
            return self.while_loop(gm, node)
        if target is torch.ops.higher_order.cond:
            return self.cond(gm, node)
        packet = _packet(target)
        if packet in _SKIP or (val is None and not node.users):
            return []
        rtype = _type(val)
        operands = _nodes_in(list(node.args) + list(node.kwargs.values()))

        def op(opcode: str, ops: Sequence[fx.Node], attrs: str = "",
               op_name: str = name, args: Optional[str] = None) -> str:
            text = args if args is not None else ", ".join(f"%{o.name}" for o in ops)
            return f"%{op_name} = {rtype} {opcode}({text})" + (f", {attrs}" if attrs else "")

        if packet in ("mm", "bmm"):
            return [op("dot", operands, _MM if packet == "mm" else _BMM)]
        if packet in ("addmm", "baddbmm"):
            bias, a, b = node.args[:3]
            dot = f"{name}.dot"
            return [op("dot", [a, b], _MM if packet == "addmm" else _BMM, op_name=dot),
                    op("add", [], args=f"%{dot}, %{bias.name}")]
        if packet == "convolution":
            x, w, bias = node.args[:3]
            window = "x".join(str(d) for d in w.meta["val"].shape[2:])
            if bias is None:
                return [op("convolution", [x, w], f"window={{size={window}}}")]
            conv = f"{name}.conv"
            return [op("convolution", [x, w], f"window={{size={window}}}", op_name=conv),
                    op("add", [], args=f"%{conv}, %{bias.name}")]
        if packet in _COMPARE:
            lines, ops = [], []
            for i, a in enumerate(node.args[:2]):
                if isinstance(a, fx.Node):
                    ops.append(f"%{a.name}")
                else:  # a Python scalar: the constant XLA would print
                    const = f"{name}.c{i}"
                    dtype = _type(node.args[0].meta["val"]).split("[")[0]
                    lines.append(f"%{const} = {dtype}[] constant({_literal(a)})")
                    ops.append(f"%{const}")
            return lines + [op("compare", [], f"direction={_COMPARE[packet]}",
                               args=", ".join(ops))]
        if packet == "_to_copy":
            src = operands[0].meta["val"]
            return [op("convert" if src.dtype != val.dtype else "copy", operands)]
        if packet == "scalar_tensor":
            return [op("constant", [], args=_literal(node.args[0]))]
        if packet in _VIEWS:
            return [op("bitcast", operands[:1])]
        if packet in _COLLECTIVES:
            ranks = ",".join(str(r) for r in _group_ranks(node.args[-1]))
            return [op(_COLLECTIVES[packet], operands[:1],
                       f"replica_groups={{{{{ranks}}}}}")]
        if packet == "gelu":
            exact = node.kwargs.get("approximate", "none") == "none"
            return self.chain(name, rtype, operands[0], _GELU_ERF if exact else _GELU_TANH)
        if packet == "exp2":
            return self.chain(name, rtype, operands[0], _EXP2)
        if packet == "leaky_relu":
            slope = node.args[1] if len(node.args) > 1 else 0.01
            x, (dtype, dims) = operands[0].name, rtype.split("[", 1)
            return [f"%{name}.zero = {dtype}[] constant(0)",
                    f"%{name}.ge = pred[{dims} compare(%{x}, %{name}.zero), direction=GE",
                    f"%{name}.slope = {dtype}[] constant({_literal(slope)})",
                    f"%{name}.mul = {rtype} multiply(%{x}, %{name}.slope)",
                    op("select", [], args=f"%{name}.ge, %{x}, %{name}.mul")]
        if packet == "native_layer_norm":
            return [op("fusion", operands, f"kind=kLoop, calls=%"
                       f"{self.layer_norm(name, node)}")]
        if packet in ("_softmax", "_log_softmax"):
            return [op("fusion", operands[:1], f"kind=kLoop, calls=%"
                       f"{self.softmax(name, val, node.args[1], packet == '_log_softmax')}")]
        opcode = _OPCODES.get(packet) if packet is not None else None
        if opcode is None:
            label = str(target) if packet is not None else getattr(target, "__name__",
                                                                    str(target))
            self.unmapped[label] = None
            opcode = re.sub(r"[^\w\-]", "_", packet or label)
        if opcode == "reduce":
            operands = operands[:1]
        return [op(opcode, operands)]

    def softmax(self, name: str, val: torch.Tensor, dim: int, log: bool) -> str:
        """The fused computation of a (log-)softmax over ``dim``, as XLA
        prints it; eager PyTorch runs it as one kernel, which the fusion's
        bytes (operand and result once) count.  Returns its name."""
        comp = self._comp_name(f"{name}.body")
        rtype = _type(val)
        dims = list(val.shape)
        dims[dim % len(dims)] = 1
        rowtype = f"{rtype.split('[')[0]}[{','.join(str(d) for d in dims)}]"
        lines = [f"%x = {rtype} parameter(0)",
                 f"%max = {rowtype} reduce(%x)",
                 f"%shifted = {rtype} subtract(%x, %max)",
                 f"%exp = {rtype} exp(%shifted)",
                 f"%sum = {rowtype} reduce(%exp)"]
        if log:
            lines += [f"%log = {rowtype} log(%sum)",
                      f"ROOT %out = {rtype} subtract(%shifted, %log)"]
        else:
            lines.append(f"ROOT %out = {rtype} divide(%exp, %sum)")
        self.computations.append(f"%{comp} (x: {rtype}) -> {rtype} {{\n  "
                                 + "\n  ".join(lines) + "\n}\n")
        return comp

    @staticmethod
    def chain(name: str, rtype: str, x: fx.Node, steps) -> List[str]:
        """The ops of an elementwise chain (``_GELU_TANH``, ...) on ``x``, the
        last one named ``name``; scalar operands become constants."""
        dtype = rtype.split("[")[0]
        lines, prev = [], None
        for i, (opcode, *args) in enumerate(steps):
            step = name if i == len(steps) - 1 else f"{name}.{i}"
            ops = []
            for j, a in enumerate(args):
                if a == "x":
                    ops.append(f"%{x.name}")
                elif a == "prev":
                    ops.append(f"%{prev}")
                else:
                    lines.append(f"%{step}.k{j} = {dtype}[] constant({_literal(a)})")
                    ops.append(f"%{step}.k{j}")
            lines.append(f"%{step} = {rtype} {opcode}({', '.join(ops)})")
            prev = step
        return lines

    def layer_norm(self, name: str, node: fx.Node) -> str:
        """The fused computation of ``native_layer_norm`` (out, mean, rstd)
        over the normalized trailing dims, with its weight and bias when
        given.  Returns its name."""
        comp = self._comp_name(f"{name}.body")
        x, shape, weight, bias = node.args[:4]
        val = node.meta["val"]
        xtype, mtype = _type(val[0]), _type(val[1])
        params = [f"x: {xtype}"]
        lines = [f"%x = {xtype} parameter(0)",
                 f"%mean = {mtype} reduce(%x)",
                 f"%centered = {xtype} subtract(%x, %mean)",
                 f"%square = {xtype} multiply(%centered, %centered)",
                 f"%var = {mtype} reduce(%square)",
                 f"%rstd = {mtype} rsqrt(%var)",
                 f"%norm = {xtype} multiply(%centered, %rstd)"]
        out = "norm"
        for i, (w, opcode) in enumerate(((weight, "multiply"), (bias, "add"))):
            if isinstance(w, fx.Node):
                wtype = _type(w.meta["val"])
                params.append(f"w{i}: {wtype}")
                lines += [f"%w{i} = {wtype} parameter({len(params) - 1})",
                          f"%{opcode} = {xtype} {opcode}(%{out}, %w{i})"]
                out = opcode
        rtype = _type(list(val))
        lines.append(f"ROOT %out = {rtype} tuple(%{out}, %mean, %rstd)")
        self.computations.append(f"%{comp} ({', '.join(params)}) -> {rtype} {{\n  "
                                 + "\n  ".join(lines) + "\n}\n")
        return comp

    def _tuple_operand(self, name: str, nodes: Sequence[fx.Node]) -> str:
        return (f"%{name} = {_type([n.meta['val'] for n in nodes])} "
                f"tuple({', '.join(f'%{n.name}' for n in nodes)})")

    def while_loop(self, gm: fx.GraphModule, node: fx.Node) -> List[str]:
        cond_node, body_node, carried, extra = node.args[:4]
        carried, extra = list(carried), list(extra)
        cond = self._comp_name(cond_node.target)
        body = self._comp_name(body_node.target)
        self.computation(getattr(gm, cond_node.target), cond, root_is_value=True)
        self.computation(getattr(gm, body_node.target), body,
                         passthrough=len(carried))
        state = carried + extra
        rtype = _type([n.meta["val"] for n in state])
        init = f"{node.name}.init"
        return [self._tuple_operand(init, state),
                f"%{node.name} = {rtype} while(%{init}), condition=%{cond}, body=%{body}"]

    def cond(self, gm: fx.GraphModule, node: fx.Node) -> List[str]:
        pred, true_node, false_node, operands = node.args[:4]
        operands = list(operands)
        branches = []
        for branch in (true_node, false_node):
            cname = self._comp_name(branch.target)
            self.computation(getattr(gm, branch.target), cname)
            branches.append(cname)
        args = f"{node.name}.operands"
        return [self._tuple_operand(args, operands),
                f"%{node.name} = {_type(node.meta['val'])} conditional(%{pred.name}, "
                f"%{args}), branch_computations={{%{branches[0]}, %{branches[1]}}}"]


def core_aten(ep: "torch.export.ExportedProgram") -> "torch.export.ExportedProgram":
    """``ep`` decomposed to core ATen: ``ep.run_decompositions()``, unless
    every ATen op of its graphs is already a core one (a program decomposed
    once is returned as it is; decomposing again retraces the graph)."""
    for gm in ep.graph_module.modules():
        if not isinstance(gm, fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            target = node.target
            if node.op == "call_function" and isinstance(target, torch._ops.OpOverload) \
                    and torch.Tag.core not in target.tags and _packet(target) not in _SKIP \
                    and target.namespace != "_c10d_functional":
                return ep.run_decompositions()
    return ep


def lower_exported(ep: "torch.export.ExportedProgram",
                   name: str = "exported") -> HLOModule:
    """The HLO IR of ``ep``, decomposed to core ATen first."""
    return lower_graph(core_aten(ep).graph_module, name)


def graph_text(gm: fx.GraphModule, name: str = "traced") -> Tuple[str, Tuple[str, ...]]:
    """(HLO text, unmapped ATen ops) of a core-ATen ``GraphModule`` whose
    nodes carry their values in ``meta["val"]`` (an exported program's, or
    a ``make_fx`` trace's), its placeholders the entry's parameters."""
    lowering = _Lowering()
    lowering.computation(gm, lowering._comp_name("main"), entry=True)
    header = f"HloModule {name}, num_partitions={_num_partitions()}"
    return header + "\n\n" + "\n".join(lowering.computations), tuple(lowering.unmapped)


def lower_graph(gm: fx.GraphModule, name: str = "traced") -> HLOModule:
    """The HLO IR of ``gm`` (:func:`graph_text`, parsed), its unmapped ATen
    ops in ``module.unmapped``."""
    text, unmapped = graph_text(gm, name)
    module = parse_hlo(text)
    module.unmapped = unmapped
    return module


def as_module(source) -> HLOModule:
    """HLO text, a parsed :class:`HLOModule` or an ``ExportedProgram``, as
    the IR."""
    if isinstance(source, HLOModule):
        return source
    if isinstance(source, torch.export.ExportedProgram):
        return lower_exported(source)
    return parse_hlo(source)
