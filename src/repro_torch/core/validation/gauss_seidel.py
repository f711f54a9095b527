"""Gauss-Seidel validation kernels (paper §III-A, Tables I & II).

``GS_TX2_ASM`` is the ThunderX2 assembly transcribed verbatim from the paper's
Table II (gfortran 8.2, -mcpu=thunderx2t99 -funroll-loops -Ofast, 4x unroll).
``GS_CLX_ASM`` / ``GS_ZEN_ASM`` are the corresponding 4x-unrolled scalar
x86 kernels reconstructed per DESIGN.md §2.1: 12 loads, 12 adds + 4 muls,
4 stores, 3 pointer bumps, fused cmp+jne, with the compiler's alternating
re-association of the 4-term stencil sum across unrolled copies
(dep-second / dep-first / dep-second / dep-first).
"""

from __future__ import annotations

from dataclasses import dataclass

GS_TX2_ASM = """
# OSACA-BEGIN
.L20:
    ldr     d31, [x15, x18, lsl 3]
    ldr     d0, [x15, 8]
    mov     x14, x15
    add     x16, x15, 24
    ldr     d2, [x15, x30, lsl 3]
    add     x15, x15, 32
    fadd    d1, d31, d0
    fadd    d3, d1, d30
    fadd    d4, d3, d2
    fmul    d5, d4, d9
    str     d5, [x14], 8
    ldr     d6, [x14, x18, lsl 3]
    ldr     d16, [x14, 8]
    add     x13, x14, 8
    ldr     d7, [x14, x30, lsl 3]
    fadd    d17, d6, d16
    fadd    d18, d17, d5
    fadd    d19, d18, d7
    fmul    d20, d19, d9
    str     d20, [x15, -24]
    ldr     d21, [x13, x18, lsl 3]
    ldr     d23, [x14, 16]
    ldr     d22, [x13, x30, lsl 3]
    fadd    d24, d21, d23
    fadd    d25, d24, d20
    fadd    d26, d25, d22
    fmul    d27, d26, d9
    str     d27, [x14, 8]
    ldr     d30, [x15]
    ldr     d28, [x16, x18, lsl 3]
    ldr     d29, [x16, x30, lsl 3]
    fadd    d31, d28, d30
    fadd    d2, d31, d27
    fadd    d0, d2, d29
    fmul    d30, d0, d9
    str     d30, [x15, -8]
    cmp     x7, x15
    bne     .L20
# OSACA-END
"""

# x86 reconstruction: %rsi = row k-1, %rax = row k (in-place), %rdx = row k+1,
# %xmm9 = 0.25, %xmm0 = loop-carried previous result phi(i-1,k).
# Copies alternate dep-second (prev enters 2nd add) / dep-first (1st add).
GS_CLX_ASM = """
# OSACA-BEGIN
..B2.7:
    movsd     (%rsi,%rbx,8), %xmm1
    movsd     8(%rax,%rbx,8), %xmm2
    movsd     (%rdx,%rbx,8), %xmm3
    vaddsd    %xmm2, %xmm1, %xmm4
    vaddsd    %xmm0, %xmm4, %xmm5
    vaddsd    %xmm3, %xmm5, %xmm6
    vmulsd    %xmm9, %xmm6, %xmm0
    movsd     %xmm0, (%rax,%rbx,8)
    movsd     8(%rsi,%rbx,8), %xmm1
    movsd     16(%rax,%rbx,8), %xmm2
    movsd     8(%rdx,%rbx,8), %xmm3
    vaddsd    %xmm1, %xmm0, %xmm4
    vaddsd    %xmm2, %xmm4, %xmm5
    vaddsd    %xmm3, %xmm5, %xmm6
    vmulsd    %xmm9, %xmm6, %xmm0
    movsd     %xmm0, 8(%rax,%rbx,8)
    movsd     16(%rsi,%rbx,8), %xmm1
    movsd     24(%rax,%rbx,8), %xmm2
    movsd     16(%rdx,%rbx,8), %xmm3
    vaddsd    %xmm2, %xmm1, %xmm4
    vaddsd    %xmm0, %xmm4, %xmm5
    vaddsd    %xmm3, %xmm5, %xmm6
    vmulsd    %xmm9, %xmm6, %xmm0
    movsd     %xmm0, 16(%rax,%rbx,8)
    movsd     24(%rsi,%rbx,8), %xmm1
    movsd     32(%rax,%rbx,8), %xmm2
    movsd     24(%rdx,%rbx,8), %xmm3
    vaddsd    %xmm1, %xmm0, %xmm4
    vaddsd    %xmm2, %xmm4, %xmm5
    vaddsd    %xmm3, %xmm5, %xmm6
    vmulsd    %xmm9, %xmm6, %xmm0
    movsd     %xmm0, 24(%rax,%rbx,8)
    addq      $32, %rsi
    addq      $32, %rax
    addq      $32, %rdx
    cmpq      %r13, %rax
    jne       ..B2.7
# OSACA-END
"""

# Zen: gfortran -mavx2 -mfma -Ofast; same structure, Zen latencies differ.
GS_ZEN_ASM = GS_CLX_ASM.replace("..B2.7", ".L7")


@dataclass(frozen=True)
class Table1Row:
    arch: str
    unroll: int
    measured_mlups: float
    measured_cy_per_it: float
    tp: float
    lcd: float
    cp: float


TABLE1 = {
    "tx2": Table1Row("tx2", 4, 118.9, 18.50, 2.46, 18.00, 25.00),
    "csx": Table1Row("csx", 4, 178.3, 14.02, 2.19, 14.00, 18.00),
    "zen": Table1Row("zen", 4, 194.4, 11.83, 2.00, 11.50, 15.00),
}


def table1_row(arch: str) -> Table1Row:
    return TABLE1[arch]
