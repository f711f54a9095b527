from repro_torch.core.isa.instruction import (
    Immediate,
    InstructionForm,
    Kernel,
    Label,
    MemoryRef,
    Register,
)
from repro_torch.core.isa.parser_aarch64 import parse_aarch64
from repro_torch.core.isa.parser_x86 import parse_x86

__all__ = [
    "Immediate",
    "InstructionForm",
    "Kernel",
    "Label",
    "MemoryRef",
    "Register",
    "parse_aarch64",
    "parse_x86",
]
