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
* An ATen op outside the table keeps its name as its opcode: like an opcode
  the reference does not know, it counts 0 FLOPs, and its bytes are counted
  as any op's.  Those names are listed in ``module.unmapped``.
* Symbolic shapes raise ``ValueError``: export with static shapes.
"""

from __future__ import annotations

import operator
import re
from typing import Dict, List, Optional, Sequence

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
    "gather": "gather", "clone": "copy", "copy": "copy",
    "cat": "concatenate", "arange": "iota", "scalar_tensor": "constant",
    "full": "broadcast", "full_like": "broadcast", "zeros": "broadcast",
    "zeros_like": "broadcast", "ones": "broadcast", "ones_like": "broadcast",
    "empty": "broadcast", "empty_like": "broadcast",
    "empty_strided": "broadcast", "fill": "broadcast",
}
# Views alias their input: free, as XLA's bitcast.
_VIEWS = {"view", "_unsafe_view", "permute", "expand", "unsqueeze", "squeeze",
          "slice", "select", "alias", "t", "transpose", "split",
          "split_with_sizes", "unbind", "as_strided"}
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
                    and torch.Tag.core not in target.tags and _packet(target) not in _SKIP:
                return ep.run_decompositions()
    return ep


def lower_exported(ep: "torch.export.ExportedProgram",
                   name: str = "exported") -> HLOModule:
    """The HLO IR of ``ep``, decomposed to core ATen first."""
    ep = core_aten(ep)
    lowering = _Lowering()
    lowering.computation(ep.graph_module, lowering._comp_name("main"), entry=True)
    text = f"HloModule {name}\n\n" + "\n".join(lowering.computations)
    module = parse_hlo(text)
    module.unmapped = tuple(lowering.unmapped)
    return module


def as_module(source) -> HLOModule:
    """HLO text, a parsed :class:`HLOModule` or an ``ExportedProgram``, as
    the IR."""
    if isinstance(source, HLOModule):
        return source
    if isinstance(source, torch.export.ExportedProgram):
        return lower_exported(source)
    return parse_hlo(source)
