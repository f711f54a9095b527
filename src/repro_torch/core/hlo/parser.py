"""Parser for XLA HLO text, and the IR every accelerator-graph analysis
reads (a copy of ``repro.core.hlo.parser``).

This is the accelerator analogue of the assembly front-ends in
``repro_torch.core.isa``: HLO is the "assembly" a compiler schedules onto a
chip's engines.  The parser extracts computations, ops, result shapes,
operand def-use links, and the attributes the analyses need (replica
groups, called computations, dot contraction dims).  HLO text stays a valid
input; a ``torch.export`` program reaches the same IR through
:mod:`repro_torch.core.hlo.export`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "bf16": 2, "f16": 2,
    "f32": 4, "f64": 8, "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
)


@dataclass(frozen=True)
class Shape:
    dtype: str
    dims: Tuple[int, ...]

    @property
    def elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def bytes(self) -> int:
        return int(self.elements * _DTYPE_BYTES.get(self.dtype, 4))


_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\](?:\{[^}]*\})?")


def parse_shapes(text: str) -> Tuple[Shape, ...]:
    """Parse one shape or a tuple of shapes from HLO type syntax."""
    shapes = []
    for m in _SHAPE_RE.finditer(text):
        dtype = m.group(1)
        if dtype not in _DTYPE_BYTES:
            continue
        dims = tuple(int(d) for d in m.group(2).split(",") if d != "")
        shapes.append(Shape(dtype=dtype, dims=dims))
    return tuple(shapes)


@dataclass
class HLOOp:
    name: str
    opcode: str
    shapes: Tuple[Shape, ...]
    operands: Tuple[str, ...]
    attrs: str = ""
    is_root: bool = False
    raw: str = ""

    @property
    def result_bytes(self) -> int:
        return sum(s.bytes for s in self.shapes)

    @property
    def is_collective(self) -> bool:
        base = self.opcode.replace("-start", "").replace("-done", "")
        return base in COLLECTIVE_OPS

    @property
    def called_computations(self) -> Tuple[str, ...]:
        names = []
        for key in ("calls=", "to_apply=", "body=", "condition=", "branch_computations="):
            for m in re.finditer(re.escape(key) + r"\{?%?([\w.\-]+)", self.attrs):
                names.append(m.group(1))
        return tuple(names)

    def _attr_computation(self, key: str) -> Optional[str]:
        m = re.search(re.escape(key) + r"%?([\w.\-]+)", self.attrs)
        return m.group(1) if m else None

    @property
    def body_computation(self) -> Optional[str]:
        return self._attr_computation("body=")

    @property
    def condition_computation(self) -> Optional[str]:
        return self._attr_computation("condition=")

    @property
    def known_trip_count(self) -> Optional[int]:
        """XLA-recorded trip count (backend_config) for while ops."""
        m = re.search(r"known_trip_count[^0-9]*(\d+)", self.attrs)
        return int(m.group(1)) if m else None

    def replica_group_size(self, num_partitions: int) -> int:
        """Number of participants per replica group."""
        m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=", self.attrs)
        if m:
            return int(m.group(2))
        m = re.search(r"replica_groups=\{\{([\d,]+)\}", self.attrs)
        if m:
            return len(m.group(1).split(","))
        return num_partitions

    def dot_contracting(self, lhs_shape: Optional[Shape]) -> int:
        """Product of the LHS contracting dims of a dot (for FLOP counts)."""
        m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", self.attrs)
        if not m or lhs_shape is None:
            return 0
        k = 1
        for d in m.group(1).split(","):
            if d != "":
                k *= lhs_shape.dims[int(d)]
        return k


@dataclass
class HLOComputation:
    name: str
    ops: List[HLOOp] = field(default_factory=list)
    params: List[HLOOp] = field(default_factory=list)

    @property
    def root(self) -> Optional[HLOOp]:
        for op in self.ops:
            if op.is_root:
                return op
        return self.ops[-1] if self.ops else None

    def op_by_name(self, name: str) -> Optional[HLOOp]:
        # The first op of that name, as a scan of ``ops`` finds it; the index
        # is rebuilt when ops were appended since it was made.  A lowered
        # torch.export graph holds thousands of ops, and every cost query
        # looks up each operand.
        index = self.__dict__.get("_by_name")
        if index is None or index[0] != len(self.ops):
            table: Dict[str, HLOOp] = {}
            for op in self.ops:
                table.setdefault(op.name, op)
            index = self.__dict__["_by_name"] = (len(self.ops), table)
        return index[1].get(name)


@dataclass
class HLOModule:
    name: str
    computations: Dict[str, HLOComputation]
    entry_name: str
    num_partitions: int = 1
    #: ATen ops a ``torch.export`` lowering kept under their own names (no
    #: HLO counterpart in its table); empty for parsed HLO text.
    unmapped: Tuple[str, ...] = ()

    @property
    def entry(self) -> HLOComputation:
        return self.computations[self.entry_name]

    def collective_ops(self, computation: Optional[str] = None) -> List[HLOOp]:
        comps = (
            [self.computations[computation]] if computation
            else list(self.computations.values())
        )
        return [op for c in comps for op in c.ops if op.is_collective]


_COMP_HEADER_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.*\{\s*$")
# Result type matched non-greedily up to the first " opcode(" — robust to
# tuple types containing "/*index=N*/" comments.
_OP_RE = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)$"
)
_OPERAND_RE = re.compile(r"%([\w.\-]+)")


def _split_op_line(rest: str) -> Tuple[str, str]:
    """Split ``operands), attrs`` at the closing paren of the operand list."""
    depth = 1
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return rest[:i], rest[i + 1:]
    return rest, ""


def parse_hlo(text: str) -> HLOModule:
    module_name = "module"
    num_partitions = 1
    m = re.search(r"HloModule\s+([\w.\-]+)", text)
    if m:
        module_name = m.group(1)
    m = re.search(r"num_partitions=(\d+)", text)
    if m:
        num_partitions = int(m.group(1))

    computations: Dict[str, HLOComputation] = {}
    entry_name = ""
    current: Optional[HLOComputation] = None

    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        if current is None:
            hm = _COMP_HEADER_RE.match(stripped)
            if hm and "=" not in stripped.split("(")[0]:
                current = HLOComputation(name=hm.group(2))
                if hm.group(1):
                    entry_name = hm.group(2)
                continue
            continue
        if stripped == "}":
            computations[current.name] = current
            current = None
            continue
        om = _OP_RE.match(stripped)
        if not om:
            continue
        is_root = bool(om.group(1))
        name = om.group(2)
        shapes = parse_shapes(om.group(3))
        opcode = om.group(4)
        operand_str, attrs = _split_op_line(om.group(5))
        operands = tuple(_OPERAND_RE.findall(operand_str)) if opcode != "parameter" else ()
        op = HLOOp(
            name=name, opcode=opcode, shapes=shapes, operands=operands,
            attrs=attrs.strip().lstrip(","), is_root=is_root, raw=stripped,
        )
        current.ops.append(op)
        if opcode == "parameter":
            current.params.append(op)

    if current is not None:  # unterminated trailing computation
        computations[current.name] = current
    if not entry_name and computations:
        entry_name = list(computations)[-1]
    return HLOModule(
        name=module_name,
        computations=computations,
        entry_name=entry_name,
        num_partitions=num_partitions,
    )
