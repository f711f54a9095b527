"""Instruction-form model shared by the x86 and AArch64 front-ends.

This follows OSACA's notion of an *instruction form*: a mnemonic plus the
shapes of its operands (register class / immediate / memory reference).  The
analyses (throughput, critical path, loop-carried dependencies) only ever see
these normalized objects, never raw assembly text.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Operands
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Register:
    """An architectural register, normalized to its widest aliasing name.

    ``name``  -- canonical name used for dependency tracking (e.g. ``rax`` for
                 ``eax``/``ax``/``al``; ``v0`` for ``d0``/``s0``/``q0``).
    ``cls``   -- coarse register class: ``gpr`` | ``fpr`` | ``vec`` | ``flag``.
    ``width`` -- access width in bits as written in the assembly (64 for
                 ``d0``, 128 for ``q0``, ...). Only informational.
    """

    name: str
    cls: str = "gpr"
    width: int = 64

    def __str__(self) -> str:  # pragma: no cover - debugging nicety
        return self.name


@dataclass(frozen=True)
class Immediate:
    value: int

    def __str__(self) -> str:  # pragma: no cover
        return f"#{self.value}"


@dataclass(frozen=True)
class Label:
    name: str

    def __str__(self) -> str:  # pragma: no cover
        return self.name


@dataclass(frozen=True)
class MemoryRef:
    """``offset(base, index, scale)`` (x86) / ``[base, index|imm]`` (AArch64).

    ``post_index``/``pre_index`` mark AArch64 writeback forms, which update the
    base register and therefore make it a *destination* of the instruction.
    """

    base: Optional[Register] = None
    index: Optional[Register] = None
    scale: int = 1
    offset: int = 0
    post_index: bool = False
    pre_index: bool = False

    @property
    def address_registers(self) -> Tuple[Register, ...]:
        regs = []
        if self.base is not None:
            regs.append(self.base)
        if self.index is not None:
            regs.append(self.index)
        return tuple(regs)

    def __str__(self) -> str:  # pragma: no cover
        parts = [r.name for r in self.address_registers]
        return f"mem[{'+'.join(parts)}{'+' if parts else ''}{self.offset}]"


# ---------------------------------------------------------------------------
# Instruction form
# ---------------------------------------------------------------------------


@dataclass
class InstructionForm:
    mnemonic: str
    operands: Tuple[object, ...] = ()
    # Dependency sets (canonical register names).
    source_registers: Tuple[str, ...] = ()
    dest_registers: Tuple[str, ...] = ()
    # Memory behaviour: at most one load and one store per instruction form in
    # the kernels we model (true for both ISAs' loop code).
    loads: Tuple[MemoryRef, ...] = ()
    stores: Tuple[MemoryRef, ...] = ()
    is_branch: bool = False
    is_dep_breaking: bool = False  # zero idioms: xorps %x,%x / movi v0, #0
    line_number: int = 0
    raw: str = ""
    comment: str = ""
    # Memo for :meth:`operand_signature`; operands never change after
    # parsing, and the signature is probed on every DB lookup.
    _sig_memo: Optional[str] = field(default=None, repr=False, compare=False)

    # Filled by the machine model during analysis.
    def operand_signature(self) -> str:
        """A short signature used for instruction-database lookup.

        ``r`` = gpr, ``f`` = scalar FP reg, ``v`` = vector reg, ``i`` =
        immediate, ``m`` = memory, ``l`` = label.
        """
        memo = self._sig_memo
        if memo is not None:
            return memo
        sig = []
        for op in self.operands:
            if isinstance(op, Register):
                sig.append({"gpr": "r", "fpr": "f", "vec": "v", "flag": "c"}[op.cls])
            elif isinstance(op, Immediate):
                sig.append("i")
            elif isinstance(op, MemoryRef):
                sig.append("m")
            elif isinstance(op, Label):
                sig.append("l")
            else:  # pragma: no cover - defensive
                sig.append("?")
        memo = "".join(sig)
        self._sig_memo = memo
        return memo

    @property
    def key(self) -> str:
        return f"{self.mnemonic}:{self.operand_signature()}"

    def __str__(self) -> str:  # pragma: no cover
        return self.raw.strip() or self.mnemonic


@dataclass
class Kernel:
    """A marked loop body: the unit of analysis."""

    instructions: Tuple[InstructionForm, ...]
    isa: str  # "x86" | "aarch64"
    name: str = "kernel"
    source_lines: Tuple[int, int] = (0, 0)

    def __len__(self) -> int:
        return len(self.instructions)

    def __iter__(self):
        return iter(self.instructions)

    def without_branches(self) -> "Kernel":
        return Kernel(
            instructions=tuple(i for i in self.instructions if not i.is_branch),
            isa=self.isa,
            name=self.name,
            source_lines=self.source_lines,
        )


# ---------------------------------------------------------------------------
# Marker extraction (shared helper)
# ---------------------------------------------------------------------------

OSACA_START = "OSACA-BEGIN"
OSACA_END = "OSACA-END"

# IACA byte markers.  ``movl $111, %ebx`` + ``.byte 100,103,144`` marks the
# start, ``movl $222, %ebx`` + the same byte triplet marks the end.  For ARM
# OSACA uses the analogous ``mov x1, #111`` pattern.
_IACA_START_HINTS = ("$111", "#111")
_IACA_END_HINTS = ("$222", "#222")


def extract_marked_region(lines: Sequence[str]) -> Tuple[int, int]:
    """Return (start, end) line indices of the marked kernel body.

    Supports OSACA comment markers (``# OSACA-BEGIN`` / ``# OSACA-END``), IACA
    byte markers on both ISAs, and falls back to innermost-loop detection
    (label ... conditional branch back to the same label).
    """
    start = end = None
    for i, line in enumerate(lines):
        if OSACA_START in line:
            start = i + 1
        elif OSACA_END in line:
            end = i
    if start is not None and end is not None and start < end:
        return start, end

    # IACA byte markers: marker mov, then .byte line; kernel starts after.
    pending = None
    for i, line in enumerate(lines):
        stripped = line.strip()
        if any(h in stripped for h in _IACA_START_HINTS) and stripped.startswith(("mov", "movl")):
            pending = "start"
        elif any(h in stripped for h in _IACA_END_HINTS) and stripped.startswith(("mov", "movl")):
            if start is not None:
                end = i
            pending = None
        elif stripped.startswith(".byte") and pending == "start":
            start = i + 1
            pending = None
    if start is not None and end is not None and start < end:
        return start, end

    # Fallback: innermost loop = last label that a later branch jumps back to.
    label_pos = {}
    best = None
    for i, line in enumerate(lines):
        stripped = line.strip()
        if stripped.endswith(":") and not stripped.startswith("."):
            label_pos[stripped[:-1]] = i
        elif stripped.endswith(":"):
            label_pos[stripped[:-1]] = i
        tokens = stripped.replace(",", " ").split()
        if tokens and tokens[0].startswith(("b", "j")) and len(tokens) >= 2:
            target = tokens[-1]
            if target in label_pos and label_pos[target] < i:
                span = (label_pos[target] + 1, i + 1)
                if best is None or (span[1] - span[0]) < (best[1] - best[0]):
                    best = span
    if best is not None:
        return best
    return 0, len(lines)
