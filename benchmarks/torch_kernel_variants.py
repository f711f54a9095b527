"""Time edited copies of the port's K1 (RMSNorm), K2 (flash attention), K3
(flash decode) and K4 (SSD) sources beside the sources as they are, on one
CUDA device:

    python3 benchmarks/torch_kernel_variants.py [--parent DIR] [--host]
        [--only PREFIX ... | --names NAME ...]

``--only`` keeps the variants whose names start with one of the prefixes
(``fa`` for K2's, ``da`` for K3's, ``rms``, ``ssd``); ``--names`` keeps the
variants of those names alone (``fa``, ``fa_parent``). ``--parent DIR`` adds
``fa_parent``, ``da_parent`` and ``ssd_parent``: K2's, K3's and K4's sources
(and headers) of an earlier commit, unpacked into DIR, e.g. ``git archive
COMMIT src/repro_torch/kernels/csrc | tar -x -C build/parent`` and then
``--parent build/parent/src/repro_torch/kernels/csrc``; they take the same C
entry points (a K3 from before its clustered launch, with a scratch at bf16
too, through ``parent_decode``). A parent variant skips the head dims its
source does not take (D 224 before the Zamba2-7B rows).

Each variant is a source of ``src/repro_torch/kernels/csrc`` with text
replacements (and, as a third item, constants of the kernel's Python module
it sets while it runs), compiled with the port's own nvcc flags into
``build/variants/`` (all at once) and reached through the port's wrappers,
whose ``_build.entry`` is routed to the variant's library. A variant whose
replaced text is no longer in the source raises. Every variant is checked
against the plain version, as ``chip_smoke.py`` checks it, before it is
timed, but for K4's ``ABLATIONS``, which drop a part of the kernel and are
only timed. Times are ``chip_smoke.time_ms`` (device time, L2 flushed by writing
64 MB), in two rounds in opposite orders. K1 also gets yardsticks on the same inputs:
``out.copy_(x)`` of the same bytes and ``F.rms_norm``, and the kernel, the
copy and ``F.rms_norm`` again with the L2 emptied by reading 64 MB (clean
lines) instead. K2's and K3's variants run at ``chip_smoke.py``'s timing
shapes (bf16) beside ``scaled_dot_product_attention`` on the same inputs,
whose kernels are named; K3's also with the host's microseconds per call
(the wrapper's enqueue, no sync). ``--host`` measures only that, for K3's
variants at tinyllama-1.1b's decode shape, in 24 rounds of alternating
order, with the garbage collector off, in a process that runs no profiler
(which leaves the host's calls slower after it). K4's run at its two serve shapes with bf16
and f32 B/C. One JSON line per measurement.
"""

from __future__ import annotations

import ctypes
import gc
import importlib
import json
import math
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
da = importlib.import_module("repro_torch.kernels.decode_attention")
OUT = os.path.join(ROOT, "build", "variants")
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
    # Two stages in the ring in place of three.
    "ssd_2stages": ("ssd_scan", [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    "da": ("decode_attention", []),
    # D 80 as five boxes of 16 columns (32-byte rows, 32-byte swizzle), as
    # K2 loads it, in place of one unswizzled box.
    "da_boxes16": ("decode_attention", [
        ("static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : D;",
         "static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;"),
        ("static constexpr uint32_t MASK = W == 64 ? 7 : W == 32 ? 3 : 0;",
         "static constexpr uint32_t MASK = W == 64 ? 7 : W == 32 ? 3 : 1;")]),
    # Two waves of CTAs in the split rule (more, shorter splits).
    "da_waves2": ("decode_attention", [], {"MIN_WAVES": 2}),
    "rms": ("rmsnorm", []),
    "rms_unpacked": ("rmsnorm", UNPACKED),
    "rms_2warps": ("rmsnorm", [(WPR, "int wpr = rows <= kFewRows ? kWarps : 2;")]),
    "rms_4warps": ("rmsnorm", [(WPR, "int wpr = kWarps;")]),
    "rms_1warp_few_rows": ("rmsnorm", [(WPR, "int wpr = 1;")]),
    "fa": ("flash_attention", []),
    # Two consumer warpgroups (128 queries) a CTA and one CTA an SM at every
    # head dim, D 32 and 64 too.
    "fa_2wg": ("flash_attention", [("static constexpr int CONSUMERS = D <= 64 || WIDE ? 1 : 2;",
                                    "static constexpr int CONSUMERS = WIDE ? 1 : 2;"),
                                   ("static constexpr int CTAS = D <= 64 ? 2 : 1;",
                                    "static constexpr int CTAS = 1;")]),
    "fa_2stages": ("flash_attention", [("constexpr int kStages = 4; ", "constexpr int kStages = 2; ")]),
    # Tiles of 128 keys (two stages, to fit D 128's shared memory; one above
    # it).
    "fa_bk128": ("flash_attention", [("constexpr int kBK = 64; ", "constexpr int kBK = 128;"),
                                     ("constexpr int kStages = 4; ", "constexpr int kStages = 2; "),
                                     ("STAGES = D <= 128 ? kStages : 3;",
                                      "STAGES = D <= 128 ? kStages : 1;")]),
}
# K4 with one part dropped, timed but not checked (their output is wrong by
# design): what each part adds to the kernel's time.
ABLATIONS = {
    "ssd_drop_state": ("ssd_scan", [("const bool owns_state = state && kT * wg < n;",
                                     "const bool owns_state = false;")]),
    "ssd_drop_mx": ("ssd_scan", [(
        "        repro::wgmma_rs_tb<P>(yacc, mh[ks], xh);\n"
        "        repro::wgmma_rs_tb<P>(yacc, ml[ks], xh);\n"
        "        repro::wgmma_rs_tb<P>(yacc, mh[ks], xl);\n", "")]),
    "ssd_drop_split": ("ssd_scan", [("for (int i = sp; i < kT * P / 4; i += kSplitters) {",
                                     "for (int i = sp; i < 0; i += kSplitters) {")]),
    "ssd_drop_decay": ("ssd_scan", [
        ("sacc[4 * nb + e] = ok ? sacc[4 * nb + e] * exp2f(d * kLog2e) : 0.f;",
         "sacc[4 * nb + e] = ok ? sacc[4 * nb + e] : 0.f;"),
        ("if (it < rb && kT * (rb + 1) <= q) {", "if (false) {")]),
    "ssd_drop_scores": ("ssd_scan", [(
        "        repro::wgmma_ss<kT>(sacc, repro::gmma_desc(c_tile + k * S::CBOX + off, 16, 1024, 1),\n"
        "                            repro::gmma_desc(bt + k * S::BBOX + off, 16, 1024, 1), ks > 0);\n",
        "")]),
    "ssd_drop_ystore": ("ssd_scan", [("      if (ia < q)\n        *reinterpret_cast<float2*>(yb",
                                      "      if (ia < 0)\n        *reinterpret_cast<float2*>(yb"),
                                     ("      if (ib < q)\n        *reinterpret_cast<float2*>(yb",
                                      "      if (ib < 0)\n        *reinterpret_cast<float2*>(yb")]),
}
VARIANTS.update(ABLATIONS)
# zamba2, mamba2-130m; zamba2-7b's call a group (56 of its 112 heads, 4 chunks).
SSD_SHAPES = ((4, 2, 80, 256, 64, 64), (4, 2, 24, 256, 64, 128), (4, 4, 56, 256, 64, 64))
# (b, s, t, h, kv, d, causal): chip_smoke.py's K2 timing shapes.
FA_SHAPES = ((4, 512, 512, 32, 4, 64, True), (4, 512, 512, 32, 32, 80, True),
             (4, 512, 512, 16, 16, 128, True), (4, 512, 512, 32, 8, 128, True),
             (4, 512, 512, 32, 4, 128, True), (4, 512, 512, 48, 4, 128, True),
             (4, 1088, 1088, 32, 32, 96, True), (4, 1500, 1500, 8, 8, 64, False),
             (4, 64, 1500, 8, 8, 64, False), (4, 64, 64, 8, 8, 64, True),
             (4, 448, 448, 8, 8, 64, True), (4, 448, 1500, 8, 8, 64, False),
             (4, 1024, 1024, 32, 32, 224, True))  # zamba2-7b's shared attention
WIDE_SCALE = {224: (224 / 2) ** -0.5}  # the model's own softmax scale at D 224
# (b, t, h, kv, d, length): chip_smoke.py's K3 timing shapes (the
# mid-generation cache of each served shape; whisper-base's cross cache
# whole, phi-3-vision's at a length past its T).
_T, _MID = chip_smoke.PROMPT_LEN + chip_smoke.NEW_TOKENS, \
    chip_smoke.PROMPT_LEN + chip_smoke.NEW_TOKENS // 2
DA_SHAPES = ((4, _T, 32, 4, 64, _MID), (4, _T, 32, 32, 80, _MID), (4, _T, 16, 16, 128, _MID),
             (4, _T, 32, 8, 128, _MID), (4, _T, 32, 4, 128, _MID), (4, _T, 48, 4, 128, _MID),
             (4, chip_smoke.WHISPER_FRAMES, 8, 8, 64, chip_smoke.WHISPER_FRAMES),
             (4, chip_smoke.WHISPER_T, 8, 8, 64,
              chip_smoke.WHISPER_T - chip_smoke.WHISPER_NEW // 2),
             (4, chip_smoke.PHI_SEQ, 32, 32, 96, chip_smoke.PHI_SEQ + chip_smoke.NEW_TOKENS // 2),
             # zamba2-7b's cache mid-answer, at batch 4 and at the cell's 64
             (4, 1280, 32, 32, 224, 1152), (64, 1280, 32, 32, 224, 1152))
# Sources of an earlier commit: variant -> base (``--parent``).
PARENT_VARIANTS = {"fa_parent": "flash_attention", "da_parent": "decode_attention",
                   "ssd_parent": "ssd_scan"}
RMS_SHAPES = ((2048, 2048), (4, 2048), (2048, 2560), (4, 5120), (2048, 5120), (2048, 768),
              (2048, 1536))


def build_all(parent=None):
    """Compile every variant in parallel; returns name -> (library, registers).
    A variant of PARENT_VARIANTS is the source of that name in ``parent``,
    built against the headers there."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, (base, reps, *_) in VARIANTS.items():
        csrc = parent if name in PARENT_VARIANTS else str(_build.CSRC)
        with open(os.path.join(csrc, f"{base}.cu")) as f:
            text = f.read()
        for old, new in reps:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in {base}.cu")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, src]
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


def parent_decode(q, k, v, lengths):
    """The parent commit's K3 (``da_parent``) through its C entry point: its
    split rule (at most 2 waves of CTAs, no cluster cap, 32 heads a CTA) and
    a scratch (B,H,splits,D+2) at either type."""
    b, _, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    ctas = b * n_kv * -(-(h // n_kv) // 32)
    n, split_len = da._cut(t, max(1, min(-(-t // da.BLOCK_K), -(-2 * da.SMS // ctas))))
    out = torch.empty_like(q)
    scratch = torch.empty((b, h, n, d + 2), dtype=torch.float32, device=q.device)
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    fn = _build.entry("decode_attention", f"repro_decode_attention_{da.DTYPES[q.dtype]}",
                      [P, P, P, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L, I, F, F, P])
    _build.check("decode_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, n_kv, h // n_kv, t, d, n, split_len, q.stride(0), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), out.stride(0), 0, 1.0 / math.sqrt(d), 0.0,
        _build.stream()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    only = sys.argv[sys.argv.index("--only") + 1:] if "--only" in sys.argv else []
    if "--names" in sys.argv:  # these variants and no other
        keep = sys.argv[sys.argv.index("--names") + 1:]
        only = [n for n in keep if n in VARIANTS or n in PARENT_VARIANTS]
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    if parent is not None:
        VARIANTS.update({name: (base, []) for name, base in PARENT_VARIANTS.items()})
    exact = "--names" in sys.argv
    for name in [n for n in VARIANTS if only and not (n in only if exact
                                                      else n.startswith(tuple(only)))]:
        del VARIANTS[name]
    built = build_all(parent)
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
    if "--host" in sys.argv:
        b, t, h, kv, d, length = DA_SHAPES[0]
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        lengths = torch.full((b,), length, dtype=torch.int32, device="cuda")
        gc.disable()  # no collection pauses inside the timed batches
        for rnd in range(24):
            for name in [n for n in (names if rnd % 2 == 0 else names[::-1])
                         if VARIANTS[n][0] == "decode_attention"]:
                route["decode_attention"] = name
                call = parent_decode if name == "da_parent" else da.decode_attention_cuda
                print(json.dumps({"variant": name, "round": rnd, "shape": list(DA_SHAPES[0]),
                                  "host_us": chip_smoke.host_us(lambda: call(q, k, v, lengths))}),
                      flush=True)
        print(json.dumps({"ok": True}))
        return 0
    defaults = {k: getattr(da, k) for v in VARIANTS.values() if len(v) > 2 for k in v[2]}
    # A parent whose K3 is the clustered launch takes the present wrapper.
    old_decode = parent is not None and "decode_cluster_kernel" not in open(
        os.path.join(parent, "decode_attention.cu")).read()

    def takes(name, d):
        """Whether variant ``name``'s source takes head dim ``d``."""
        return d != 224 or name not in PARENT_VARIANTS
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            base = VARIANTS[name][0]
            route[base] = name
            for k, val in defaults.items():  # module constants a variant overrides
                setattr(da, k, VARIANTS[name][2].get(k, val) if len(VARIANTS[name]) > 2 else val)
            if base == "ssd_scan":
                for (b, nc, h, q, p, n), dtype in [(sh, dt) for dt in (torch.bfloat16, torch.float32)
                                                   for sh in SSD_SHAPES]:
                    plain_ms = None
                    xdt = torch.randn(b, nc, q, h, p, generator=gen, device="cuda") * 0.1
                    cum = -torch.cumsum(torch.rand(b, nc, q, h, generator=gen, device="cuda"), 2)
                    proj = torch.randn(b, nc, q, 2 * n + 8, generator=gen, device="cuda") * 0.3
                    args = (xdt.permute(0, 1, 3, 2, 4), cum.permute(0, 1, 3, 2),
                            proj[..., 8:8 + n].to(dtype), proj[..., 8 + n:].to(dtype))
                    shape = [b, nc, h, q, p, n, str(dtype).removeprefix("torch.")]
                    err = None
                    if name not in ABLATIONS:
                        got = ssd.ssd_intra_chunk_cuda(*args)
                        want = ssd.ssd_intra_chunk_plain(*args)
                        err = max(chip_smoke.compare(name, shape, g, w,
                                                     tol=chip_smoke.SSD_TOL)["max_abs_err"]
                                  for g, w in zip(got, want))
                    ms = chip_smoke.time_ms(lambda: ssd.ssd_intra_chunk_cuda(*args))[0]
                    if name == "ssd" and rnd == 0 and h == 56:
                        plain_ms = chip_smoke.time_ms(lambda: ssd.ssd_intra_chunk_plain(*args),
                                                      reps=3)[0]
                    print(json.dumps({"variant": name, "round": rnd, "shape": shape,
                                      "ms": ms, "max_abs_err": err, "plain_ms": plain_ms}),
                          flush=True)
            elif base == "decode_attention":
                call = (parent_decode if name == "da_parent" and old_decode
                        else da.decode_attention_cuda)
                for b, t, h, kv, d, length in [sh for sh in DA_SHAPES if takes(name, sh[4])]:
                    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
                    k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda").bfloat16()
                            for _ in range(2))
                    lengths = torch.full((b,), length, dtype=torch.int32, device="cuda")
                    kw = {"scale": WIDE_SCALE[d]} if d in WIDE_SCALE else {}
                    run = lambda: call(q, k, v, lengths, **kw)  # noqa: E731
                    err = chip_smoke.compare(name, [b, t, h, kv, d, length], run(),
                                             da.decode_attention_plain(q, k, v, lengths, **kw),
                                             )["max_abs_err"]
                    row = {"variant": name, "round": rnd, "shape": [b, t, h, kv, d, length],
                           "max_abs_err": err, "ms": chip_smoke.time_ms(run)[0],
                           "host_us": chip_smoke.host_us(run)}
                    if name == "da" and rnd == 0 and d in WIDE_SCALE:
                        row["plain_ms"] = chip_smoke.time_ms(
                            lambda: da.decode_attention_plain(q, k, v, lengths, **kw))[0]
                    if name == "da" and rnd == 0:
                        nv = min(length, t)
                        qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :nv], v[:, :nv]))
                        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                            qt, kt, vt, enable_gqa=True, **kw)
                        row.update(library_ms=chip_smoke.time_ms(lib)[0],
                                   library_kernels=chip_smoke.kernel_names(lib))
                    print(json.dumps(row), flush=True)
            elif base == "flash_attention":
                for b, s, t, h, kv, d, causal in [sh for sh in FA_SHAPES if takes(name, sh[5])]:
                    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                    k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda").bfloat16()
                            for _ in range(2))
                    kw = {"scale": WIDE_SCALE[d]} if d in WIDE_SCALE else {}
                    err = chip_smoke.compare(name, [b, s, t, h, kv, d, causal],
                                             fa.flash_attention_cuda(q, k, v, causal=causal, **kw),
                                             fa.flash_attention_plain(q, k, v, causal=causal,
                                                                      **kw),
                                             )["max_abs_err"]
                    row = {"variant": name, "round": rnd, "shape": [b, s, t, h, kv, d, causal],
                           "max_abs_err": err,
                           "ms": chip_smoke.time_ms(
                               lambda: fa.flash_attention_cuda(q, k, v, causal=causal, **kw))[0]}
                    if name == "fa" and rnd == 0 and d in WIDE_SCALE:
                        row["plain_ms"] = chip_smoke.time_ms(
                            lambda: fa.flash_attention_plain(q, k, v, causal=causal, **kw),
                            reps=3)[0]
                    if name == "fa" and rnd == 0:
                        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                            qt, kt, vt, is_causal=causal, enable_gqa=True, **kw)
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
