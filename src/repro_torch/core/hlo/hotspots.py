"""Memory hot-spot listing from an accelerator graph — the dry-run
"profiler".

Lists the largest tensors a module materializes (per computation, with
execution context), which is where the §Perf memory-term iterations start.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.hlo.export import as_module


@dataclass
class Hotspot:
    computation: str
    op_name: str
    opcode: str
    bytes: int
    shape: str

    def render(self) -> str:
        return (f"{self.bytes / 2**30:8.2f} GiB  {self.opcode:<24} "
                f"{self.computation}/{self.op_name}  {self.shape}")


def memory_hotspots(source, top_k: int = 20,
                    min_bytes: int = 64 * 1024 * 1024) -> List[Hotspot]:
    """``source``: HLO text / module / ExportedProgram.  Largest result
    buffers."""
    module = as_module(source)
    spots: List[Hotspot] = []
    for comp in module.computations.values():
        for op in comp.ops:
            if op.opcode in ("parameter", "tuple", "get-tuple-element"):
                continue
            b = op.result_bytes
            if b >= min_bytes:
                shape_str = ", ".join(
                    f"{s.dtype}{list(s.dims)}" for s in op.shapes[:3])
                spots.append(Hotspot(
                    computation=comp.name, op_name=op.name, opcode=op.opcode,
                    bytes=int(b), shape=shape_str))
    spots.sort(key=lambda h: -h.bytes)
    return spots[:top_k]


def render_hotspots(source, top_k: int = 15) -> str:
    spots = memory_hotspots(source, top_k=top_k)
    if not spots:
        return "no buffers above threshold"
    return "\n".join(h.render() for h in spots)


def cpu_bf16_artifact_bytes(source, min_bytes: int = 128 * 1024 * 1024) -> int:
    """Bytes of f32 ``convert``-of-bf16 buffers — a CPU-backend lowering
    artifact (no native bf16 dot on CPU, so XLA converts operands to f32 and
    hoists the conversions out of loops).  An accelerator's matrix units
    (the H100's tensor cores) consume bf16 natively, so these buffers do not
    exist on the target; the dry-run reports memory with and without
    them."""
    module = as_module(source)
    total = 0
    seen = set()
    for comp in module.computations.values():
        for op in comp.ops:
            if op.opcode != "convert" or not op.shapes:
                continue
            s = op.shapes[0]
            if s.dtype != "f32" or s.bytes < min_bytes:
                continue
            src = comp.op_by_name(op.operands[0]) if op.operands else None
            src_dtype = src.shapes[0].dtype if src and src.shapes else "bf16"
            if src_dtype != "bf16":
                continue
            key = (s.dtype, s.dims)
            if key in seen:
                continue  # fusions clone converts; count unique buffers once
            seen.add(key)
            total += s.bytes
    return int(total)
