"""Time edited copies of the port's K1 (RMSNorm), K2 (flash attention) and
K4 (SSD) sources beside the sources as they are, on one CUDA device:

    python3 benchmarks/torch_kernel_variants.py [--only PREFIX ...]

``--only`` keeps the variants whose names start with one of the prefixes
(``fa`` for K2's, ``rms``, ``ssd``).

Each variant is a source of ``src/repro_torch/kernels/csrc`` with text
replacements, compiled with the port's own nvcc flags into
``build/variants/`` (all at once) and reached through the port's wrappers,
whose ``_build.entry`` is routed to the variant's library. A variant whose
replaced text is no longer in the source raises. Every variant is checked
against the plain version, as ``chip_smoke.py`` checks it, before it is
timed. Times are ``chip_smoke.time_ms`` (device time, L2 flushed by writing
64 MB), in two rounds in opposite orders. K1 also gets yardsticks on the same inputs:
``out.copy_(x)`` of the same bytes and ``F.rms_norm``, and the kernel, the
copy and ``F.rms_norm`` again with the L2 emptied by reading 64 MB (clean
lines) instead. K2's variants run at ``chip_smoke.py``'s timing shapes (bf16)
beside ``scaled_dot_product_attention`` on the same inputs, whose kernels
are named. One JSON line per measurement.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")
OUT = os.path.join(ROOT, "build", "variants")
EXP2 = "sc[hf][e] = ok ? sc[hf][e] * exp2f(d * kLog2e) : 0.f;"
WPR = "int wpr = rows <= kFewRows ? kWarps : 1;"
# The K1 register kernel with one TX or TW element a register (Vec) in place
# of packed 32-bit words.
UNPACKED = [
    ("Words<TX, VEC> xv[VPL];", "Vec<TX, VEC> xv[VPL];"),
    ("Words<TW, VEC> wv[VPL];", "Vec<TW, VEC> wv[VPL];"),
    ("reinterpret_cast<const Words<TX, VEC>*>(xr + c)", "reinterpret_cast<const Vec<TX, VEC>*>(xr + c)"),
    ("reinterpret_cast<const Words<TW, VEC>*>(w + c)", "reinterpret_cast<const Vec<TW, VEC>*>(w + c)"),
    ("for (auto& u : xv[k].v) u = 0u;", "for (auto& u : xv[k].v) u = from_f32<TX>(0.f);"),
    ("const float f = elem<TX>(xv[k].v, i);", "const float f = repro::to_f32(xv[k].v[i]);"),
    ("(elem<TX>(xv[k].v, i) * r) * elem<TW>(wv[k].v, i)",
     "(repro::to_f32(xv[k].v[i]) * r) * repro::to_f32(wv[k].v[i])"),
]
VARIANTS = {
    "ssd": ("ssd_scan", []),
    "ssd_4warps": ("ssd_scan", [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")]),
    "ssd_expf": ("ssd_scan", [(EXP2, "sc[hf][e] = ok ? sc[hf][e] * expf(d) : 0.f;")]),
    "rms": ("rmsnorm", []),
    "rms_unpacked": ("rmsnorm", UNPACKED),
    "rms_2warps": ("rmsnorm", [(WPR, "int wpr = rows <= kFewRows ? kWarps : 2;")]),
    "rms_4warps": ("rmsnorm", [(WPR, "int wpr = kWarps;")]),
    "rms_1warp_few_rows": ("rmsnorm", [(WPR, "int wpr = 1;")]),
    "fa": ("flash_attention", []),
    # Two consumer warpgroups (128 queries) a CTA and one CTA an SM at every
    # head dim, D 32 and 64 too.
    "fa_2wg": ("flash_attention", [("static constexpr int CONSUMERS = D <= 64 ? 1 : 2;",
                                    "static constexpr int CONSUMERS = 2;"),
                                   ("static constexpr int CTAS = D <= 64 ? 2 : 1;",
                                    "static constexpr int CTAS = 1;")]),
    "fa_2stages": ("flash_attention", [("constexpr int kStages = 4; ", "constexpr int kStages = 2; ")]),
    # Tiles of 128 keys (two stages, to fit D 128's shared memory).
    "fa_bk128": ("flash_attention", [("constexpr int kBK = 64; ", "constexpr int kBK = 128;"),
                                     ("constexpr int kStages = 4; ", "constexpr int kStages = 2; ")]),
}
SSD_SHAPES = ((4, 2, 80, 256, 64, 64), (4, 2, 24, 256, 64, 128))  # zamba2, mamba2-130m
# (b, s, t, h, kv, d, causal): chip_smoke.py's K2 timing shapes.
FA_SHAPES = ((4, 512, 512, 32, 4, 64, True), (4, 512, 512, 32, 32, 80, True),
             (4, 512, 512, 16, 16, 128, True), (4, 512, 512, 32, 8, 128, True),
             (4, 512, 512, 32, 4, 128, True), (4, 512, 512, 48, 4, 128, True),
             (4, 1088, 1088, 32, 32, 96, True), (4, 1500, 1500, 8, 8, 64, False),
             (4, 64, 1500, 8, 8, 64, False), (4, 64, 64, 8, 8, 64, True),
             (4, 448, 448, 8, 8, 64, True), (4, 448, 1500, 8, 8, 64, False))
RMS_SHAPES = ((2048, 2048), (4, 2048), (2048, 2560), (4, 5120), (2048, 5120), (2048, 768),
              (2048, 1536))


def build_all():
    """Compile every variant in parallel; returns name -> (library, registers)."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, (base, reps) in VARIANTS.items():
        with open(os.path.join(_build.CSRC, f"{base}.cu")) as f:
            text = f.read()
        for old, new in reps:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in {base}.cu")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in out.splitlines()
                if "Used" in line and "registers" in line]
        regs += sorted({line.strip() for line in out.splitlines()
                        if "spill" in line and not line.strip().startswith("0 bytes")})
        built[name] = (ctypes.CDLL(lib), regs)
    return built


def read_flush_ms(fn, reps=20):
    """Device ms per call of ``fn`` with the L2 emptied by reading 64 MB."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    buf = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            buf.sum()
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "reduce" not in e.name)
    return us / 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    only = sys.argv[sys.argv.index("--only") + 1:] if "--only" in sys.argv else []
    for name in [n for n in VARIANTS if only and not n.startswith(tuple(only))]:
        del VARIANTS[name]
    built = build_all()
    for name, (_, regs) in built.items():
        print(json.dumps({"variant": name, "registers": regs}))
    route = {}

    def entry(lib_name, symbol, argtypes):
        fn = getattr(built[route[lib_name]][0], symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    _build.entry = entry
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(VARIANTS)
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            base = VARIANTS[name][0]
            route[base] = name
            if base == "ssd_scan":
                for b, nc, h, q, p, n in SSD_SHAPES:
                    xdt = torch.randn(b, nc, q, h, p, generator=gen, device="cuda") * 0.1
                    cum = -torch.cumsum(torch.rand(b, nc, q, h, generator=gen, device="cuda"), 2)
                    proj = torch.randn(b, nc, q, 2 * n + 8, generator=gen, device="cuda") * 0.3
                    args = (xdt.permute(0, 1, 3, 2, 4), cum.permute(0, 1, 3, 2),
                            proj[..., 8:8 + n].bfloat16(), proj[..., 8 + n:].bfloat16())
                    got, want = ssd.ssd_intra_chunk_cuda(*args), ssd.ssd_intra_chunk_plain(*args)
                    err = max(chip_smoke.compare(name, [b, nc, h, q, p, n], g, w,
                                                 tol=chip_smoke.SSD_TOL)["max_abs_err"]
                              for g, w in zip(got, want))
                    ms = chip_smoke.time_ms(lambda: ssd.ssd_intra_chunk_cuda(*args))[0]
                    print(json.dumps({"variant": name, "round": rnd, "shape": [b, nc, h, q, p, n],
                                      "ms": ms, "max_abs_err": err}), flush=True)
            elif base == "flash_attention":
                for b, s, t, h, kv, d, causal in FA_SHAPES:
                    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                    k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda").bfloat16()
                            for _ in range(2))
                    err = chip_smoke.compare(name, [b, s, t, h, kv, d, causal],
                                             fa.flash_attention_cuda(q, k, v, causal=causal),
                                             fa.flash_attention_plain(q, k, v, causal=causal),
                                             )["max_abs_err"]
                    row = {"variant": name, "round": rnd, "shape": [b, s, t, h, kv, d, causal],
                           "max_abs_err": err,
                           "ms": chip_smoke.time_ms(
                               lambda: fa.flash_attention_cuda(q, k, v, causal=causal))[0]}
                    if name == "fa" and rnd == 0:
                        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                            qt, kt, vt, is_causal=causal, enable_gqa=True)
                        row.update(library_ms=chip_smoke.time_ms(lib)[0],
                                   library_kernels=chip_smoke.kernel_names(lib))
                    print(json.dumps(row), flush=True)
            else:
                for rows, d in RMS_SHAPES:
                    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
                    w = torch.randn(d, generator=gen, device="cuda").bfloat16()
                    out = torch.empty_like(x)
                    err = chip_smoke.compare(name, [rows, d], rms.rmsnorm_rows_cuda(x, w),
                                             rms.rmsnorm_rows_plain(x, w))["max_abs_err"]
                    row = {"variant": name, "round": rnd, "shape": [rows, d], "max_abs_err": err,
                           "bound_ms": 2 * x.numel() * x.element_size() / chip_smoke.PEAK_BYTES * 1e3,
                           "ms": chip_smoke.time_ms(lambda: rms.rmsnorm_rows_cuda(x, w))[0]}
                    if name == "rms":
                        lib = lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-5)  # noqa: E731
                        row.update(
                            copy_ms=chip_smoke.time_ms(lambda: out.copy_(x))[0],
                            library_ms=chip_smoke.time_ms(lib)[0],
                            read_flush_ms=read_flush_ms(lambda: rms.rmsnorm_rows_cuda(x, w)),
                            read_flush_copy_ms=read_flush_ms(lambda: out.copy_(x)),
                            read_flush_library_ms=read_flush_ms(lib))
                    print(json.dumps(row), flush=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
