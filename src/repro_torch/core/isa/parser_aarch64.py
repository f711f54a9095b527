"""AArch64 (A64) assembly parser producing :class:`InstructionForm` streams.

Coverage targets GCC/armclang output for HPC loop kernels: data processing,
scalar/vector FP, loads/stores with immediate / register(+shift) offsets and
pre-/post-index writeback, compare and branch.  Unknown mnemonics still parse
(operands are classified structurally), so the instruction database remains
the single source of truth for costs.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.isa.instruction import (
    Immediate,
    InstructionForm,
    Kernel,
    Label,
    MemoryRef,
    Register,
    extract_marked_region,
)

_GPR_RE = re.compile(r"^(x|w)(\d+|zr)$")
_FPR_RE = re.compile(r"^(b|h|s|d|q)(\d+)$")
_VEC_RE = re.compile(r"^v(\d+)(\.\w+)?$")
_WIDTH = {"b": 8, "h": 16, "s": 32, "d": 64, "q": 128}

_STORE_MNEMONICS = {"str", "strb", "strh", "stur", "stp", "st1", "st2"}
_LOAD_MNEMONICS = {"ldr", "ldrb", "ldrh", "ldur", "ldp", "ld1", "ld2", "ldrsw"}
# Loads writing *all* their register operands (pair / structure forms):
# ``ldp x0, x1, [sp]`` defines both x0 and x1.
_MULTI_DEST_LOADS = {"ldp", "ldnp", "ldxp", "ldaxp", "ld1", "ld2", "ld3", "ld4"}
_BRANCH_RE = re.compile(r"^(b|br|bl|blr|cbz|cbnz|tbz|tbnz|b\.\w+|bne|beq|bgt|blt|bge|ble|bhi|bls)$")
# Mnemonics whose first operand is *not* a destination.
_NO_DEST = {"cmp", "cmn", "tst", "prfm", "nop"} | _STORE_MNEMONICS


def _parse_register(tok: str) -> Optional[Register]:
    tok = tok.strip()
    m = _GPR_RE.match(tok)
    if m:
        if m.group(2) == "zr":
            # xzr/wzr: reads-as-zero, writes discarded.  Parsed as a register
            # (operand signatures stay stable) but excluded from dependency
            # extraction below — the zero register never carries a value.
            return Register(name="xzr", cls="gpr",
                            width=64 if m.group(1) == "x" else 32)
        return Register(name=f"x{m.group(2)}", cls="gpr", width=64 if m.group(1) == "x" else 32)
    if tok == "sp":
        return Register(name="sp", cls="gpr", width=64)
    m = _FPR_RE.match(tok)
    if m:
        return Register(name=f"v{m.group(2)}", cls="fpr", width=_WIDTH[m.group(1)])
    m = _VEC_RE.match(tok)
    if m:
        return Register(name=f"v{m.group(1)}", cls="vec", width=128)
    return None


def _parse_immediate(tok: str) -> Optional[Immediate]:
    tok = tok.strip().lstrip("#")
    try:
        return Immediate(int(tok, 0))
    except ValueError:
        return None


def _split_operands(body: str) -> List[str]:
    """Split an operand string on commas not inside brackets or braces
    (``{v0.2d, v1.2d}`` structure register lists stay one token)."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


_SHIFT_RE = re.compile(r"(lsl|lsr|asr|sxtw|uxtw|sxtx)\s*#?(\d+)?", re.IGNORECASE)


def _parse_memory(tok: str, post_imm: Optional[str]) -> Optional[MemoryRef]:
    tok = tok.strip()
    if not tok.startswith("["):
        return None
    pre_index = tok.endswith("!")
    inner = tok.strip("!").strip()[1:-1]
    parts = [p.strip() for p in inner.split(",")]
    base = _parse_register(parts[0]) if parts else None
    index = None
    scale = 1
    offset = 0
    for part in parts[1:]:
        reg = _parse_register(part)
        if reg is not None:
            index = reg
            continue
        m = _SHIFT_RE.match(part)
        if m:
            amount = int(m.group(2) or 0)
            scale = 1 << amount if m.group(1).lower() == "lsl" else 1
            continue
        imm = _parse_immediate(part)
        if imm is not None:
            offset = imm.value
    post_index = post_imm is not None
    if post_imm is not None:
        imm = _parse_immediate(post_imm)
        offset = imm.value if imm else 0
    return MemoryRef(
        base=base, index=index, scale=scale, offset=offset,
        post_index=post_index, pre_index=pre_index,
    )


_ZERO_IDIOMS = (
    re.compile(r"^eor\s+(\S+),\s*(\S+),\s*\2", re.IGNORECASE),
    re.compile(r"^movi?\s+\S+,\s*#?0(?!\d)", re.IGNORECASE),
)


def parse_line_aarch64(line: str, line_number: int = 0) -> Optional[InstructionForm]:
    raw = line
    code = line.split("//")[0]
    comment_idx = code.find("#")
    comment = ""
    # ``#`` introduces immediates too; only treat as comment when preceded by
    # whitespace and followed by a non-digit.
    if comment_idx > 0 and code[comment_idx - 1].isspace():
        tail = code[comment_idx + 1:].lstrip()
        if tail and not tail[0].isdigit() and not tail[0] == "-":
            comment = tail.strip()
            code = code[:comment_idx]
    code = code.strip()
    if not code or code.startswith((".", "//", ";")) or code.endswith(":"):
        return None

    m = re.match(r"^(\S+)\s*(.*)$", code)
    mnemonic = m.group(1).lower()
    body = m.group(2).strip()

    toks = _split_operands(body)
    operands: List[object] = []
    loads: List[MemoryRef] = []
    stores: List[MemoryRef] = []
    is_store = mnemonic in _STORE_MNEMONICS
    is_load = mnemonic in _LOAD_MNEMONICS
    is_branch = bool(_BRANCH_RE.match(mnemonic))

    i = 0
    while i < len(toks):
        tok = toks[i]
        if tok.startswith("["):
            post_imm = None
            if i + 1 < len(toks) and _parse_immediate(toks[i + 1]) is not None and tok.endswith("]"):
                post_imm = toks[i + 1]
                i += 1
            mem = _parse_memory(tok, post_imm)
            if mem is not None:
                operands.append(mem)
                (stores if is_store else loads).append(mem)
            i += 1
            continue
        if tok.startswith("{"):
            # Structure register list: ``{v0.2d, v1.2d}`` — one register
            # operand per listed element.
            for sub in tok.strip("{}").split(","):
                reg = _parse_register(sub)
                if reg is not None:
                    operands.append(reg)
            i += 1
            continue
        reg = _parse_register(tok)
        if reg is not None:
            operands.append(reg)
            i += 1
            continue
        imm = _parse_immediate(tok)
        if imm is not None:
            operands.append(imm)
            i += 1
            continue
        if _SHIFT_RE.match(tok):
            i += 1
            continue
        operands.append(Label(tok))
        i += 1

    # Dependency extraction ------------------------------------------------
    sources: List[str] = []
    dests: List[str] = []
    regs = [op for op in operands if isinstance(op, Register)]
    if is_branch or mnemonic in _NO_DEST:
        sources.extend(r.name for r in regs)
    elif mnemonic in _MULTI_DEST_LOADS:
        # Pair/structure loads write every register operand, not just the
        # first: ``ldp x0, x1, [sp]`` defines both x0 and x1.
        dests.extend(r.name for r in regs)
    elif regs:
        dests.append(regs[0].name)
        sources.extend(r.name for r in regs[1:])
    for memref in loads + stores:
        sources.extend(r.name for r in memref.address_registers)
        if memref.post_index or memref.pre_index:
            if memref.base is not None:
                dests.append(memref.base.name)

    # The zero register carries no value: writes are discarded (no def, so
    # no dependency edges hang off it) and reads are constant-zero.
    sources = [s for s in sources if s != "xzr"]
    dests = [d for d in dests if d != "xzr"]

    is_dep_breaking = any(p.match(code) for p in _ZERO_IDIOMS)
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
        comment=comment,
    )


def parse_aarch64(asm: str, name: str = "kernel") -> Kernel:
    """Parse marked AArch64 assembly into a :class:`Kernel`."""
    lines = asm.splitlines()
    start, end = extract_marked_region(lines)
    instrs: List[InstructionForm] = []
    for idx in range(start, end):
        form = parse_line_aarch64(lines[idx], line_number=idx + 1)
        if form is not None:
            instrs.append(form)
    return Kernel(instructions=tuple(instrs), isa="aarch64", name=name,
                  source_lines=(start + 1, end))
