"""x86-64 AT&T-syntax assembly parser (icc/ifort/gcc ``-S`` output style).

AT&T operand order: sources first, destination last.  SSE/ALU two-operand
forms read-modify-write the destination; AVX three-operand forms do not.
"""

from __future__ import annotations

import re
from typing import List, Optional

from repro_torch.core.isa.instruction import (
    Immediate,
    InstructionForm,
    Kernel,
    Label,
    MemoryRef,
    Register,
    extract_marked_region,
)

_GPR64 = {f"r{n}" for n in ("ax", "bx", "cx", "dx", "si", "di", "bp", "sp")} | {
    f"r{i}" for i in range(8, 16)
}
# alias -> (canonical 64-bit name, access width in bits).  Every legacy
# sub-register names the same architectural register for dependency tracking.
_GPR_ALIAS = {}
for _base in ("ax", "bx", "cx", "dx", "si", "di", "bp", "sp"):
    _GPR_ALIAS[f"e{_base}"] = (f"r{_base}", 32)
    _GPR_ALIAS[_base] = (f"r{_base}", 16)
for _low, _full in (("al", "rax"), ("bl", "rbx"), ("cl", "rcx"),
                    ("dl", "rdx"), ("ah", "rax"), ("bh", "rbx"),
                    ("ch", "rcx"), ("dh", "rdx"), ("sil", "rsi"),
                    ("dil", "rdi"), ("bpl", "rbp"), ("spl", "rsp")):
    _GPR_ALIAS[_low] = (_full, 8)
for _i in range(8, 16):
    _GPR_ALIAS[f"r{_i}d"] = (f"r{_i}", 32)
    _GPR_ALIAS[f"r{_i}w"] = (f"r{_i}", 16)
    _GPR_ALIAS[f"r{_i}b"] = (f"r{_i}", 8)

_VEC_RE = re.compile(r"^(x|y|z)mm(\d+)$")

_BRANCH_RE = re.compile(r"^(jmp|ja|jae|jb|jbe|jc|je|jg|jge|jl|jle|jna|jne|jno|jnp|jns|jnz|jo|jp|js|jz|call|ret|loop)")
_NO_DEST = {"cmp", "cmpq", "cmpl", "cmpb", "cmpw", "test", "testq", "testl", "nop",
            "ucomisd", "ucomiss", "comisd", "comiss", "prefetcht0", "prefetcht1", "prefetchnta"}
# Pure-move mnemonics: destination is written, not read.
_MOVES = re.compile(r"^v?(mov|lea|broadcast|cvt|pmov)")
_RMW_SUFFIXES = ("q", "l", "w", "b", "")


def _parse_register(tok: str) -> Optional[Register]:
    tok = tok.strip().lstrip("%")
    if not tok:
        return None
    m = _VEC_RE.match(tok)
    if m:
        # xmm/ymm/zmm alias the same architectural register.
        return Register(name=f"xmm{m.group(2)}", cls="fpr",
                        width={"x": 128, "y": 256, "z": 512}[m.group(1)])
    if tok in _GPR64:
        return Register(name=tok, cls="gpr", width=64)
    if tok in _GPR_ALIAS:
        name, width = _GPR_ALIAS[tok]
        return Register(name=name, cls="gpr", width=width)
    if tok == "rip":
        return Register(name="rip", cls="gpr", width=64)
    return None


_MEM_RE = re.compile(r"^(-?(?:0x[0-9a-fA-F]+|\d+))?\(([^)]*)\)$")


def _parse_memory(tok: str) -> Optional[MemoryRef]:
    m = _MEM_RE.match(tok.strip())
    if not m:
        return None
    offset = int(m.group(1), 0) if m.group(1) else 0
    inner = [p.strip() for p in m.group(2).split(",")]
    base = _parse_register(inner[0]) if inner and inner[0] else None
    index = _parse_register(inner[1]) if len(inner) > 1 and inner[1] else None
    scale = int(inner[2]) if len(inner) > 2 and inner[2] else 1
    return MemoryRef(base=base, index=index, scale=scale, offset=offset)


def _split_operands(body: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


_ZERO_IDIOM_RE = re.compile(
    r"^v?(xor|pxor|xorps|xorpd|pxord)\w*\s+(\S+),\s*(\S+)(,\s*(\S+))?\s*$"
)


def _is_zero_idiom(code: str) -> bool:
    m = _ZERO_IDIOM_RE.match(code)
    if not m:
        return False
    ops = [m.group(2).rstrip(","), m.group(3).rstrip(",")]
    if m.group(5):
        ops.append(m.group(5))
    return len(set(ops)) == 1


def parse_line_x86(line: str, line_number: int = 0) -> Optional[InstructionForm]:
    raw = line
    code = line.split("#")[0].strip()
    if not code or code.startswith((".", "/")) or code.endswith(":"):
        return None
    m = re.match(r"^(\S+)\s*(.*)$", code)
    mnemonic = m.group(1).lower()
    body = m.group(2).strip()
    toks = _split_operands(body)

    operands: List[object] = []
    for tok in toks:
        if tok.startswith("$"):
            try:
                operands.append(Immediate(int(tok[1:], 0)))
            except ValueError:
                operands.append(Immediate(0))
            continue
        reg = _parse_register(tok)
        if reg is not None:
            operands.append(reg)
            continue
        mem = _parse_memory(tok)
        if mem is not None:
            operands.append(mem)
            continue
        operands.append(Label(tok))

    is_branch = bool(_BRANCH_RE.match(mnemonic))
    loads: List[MemoryRef] = []
    stores: List[MemoryRef] = []
    sources: List[str] = []
    dests: List[str] = []

    if is_branch or mnemonic in _NO_DEST:
        for op in operands:
            if isinstance(op, Register):
                sources.append(op.name)
            elif isinstance(op, MemoryRef):
                loads.append(op)
                sources.extend(r.name for r in op.address_registers)
    elif operands:
        *srcs, dst = operands
        if isinstance(dst, MemoryRef):
            stores.append(dst)
            sources.extend(r.name for r in dst.address_registers)
        elif isinstance(dst, Register):
            dests.append(dst.name)
            # Two-operand RMW forms read the destination too (not moves).
            if len(operands) == 2 and not _MOVES.match(mnemonic):
                sources.append(dst.name)
        for op in srcs:
            if isinstance(op, Register):
                sources.append(op.name)
            elif isinstance(op, MemoryRef):
                # lea computes the effective address without touching memory:
                # pure address arithmetic, no load µ-op, no load-latency
                # vertex — its address registers are plain sources.
                if not mnemonic.startswith("lea"):
                    loads.append(op)
                sources.extend(r.name for r in op.address_registers)

    is_dep_breaking = _is_zero_idiom(code)
    if is_dep_breaking:
        sources = [s for s in sources if s not in dests]

    return InstructionForm(
        mnemonic=mnemonic,
        operands=tuple(operands),
        source_registers=tuple(sources),
        dest_registers=tuple(dests),
        loads=tuple(loads),
        stores=tuple(stores),
        is_branch=is_branch,
        is_dep_breaking=is_dep_breaking,
        line_number=line_number,
        raw=raw,
    )


def parse_x86(asm: str, name: str = "kernel") -> Kernel:
    """Parse marked x86-64 AT&T assembly into a :class:`Kernel`."""
    lines = asm.splitlines()
    start, end = extract_marked_region(lines)
    instrs: List[InstructionForm] = []
    for idx in range(start, end):
        form = parse_line_x86(lines[idx], line_number=idx + 1)
        if form is not None:
            instrs.append(form)
    return Kernel(instructions=tuple(instrs), isa="x86", name=name,
                  source_lines=(start + 1, end))
