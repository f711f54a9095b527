"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA device (it exits non-zero without one, and when the rest of
the repository is not beside it). It

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds the four CUDA kernels of ``src/repro_torch/kernels/csrc`` with
   ``nvcc``, in parallel, and prints the build time and register use;
3. holds each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the serve paths' shapes (RMSNorm at every width the paths
   norm, attention at head dims 64, 80 and deepseek-moe-16b's 128 (H = K =
   16, G 1 at decode) with softcap, query offset, window and D 32 and 96
   beside them; without the causal mask at whisper-base's encoder (1500
   frames) and cross-attention (64 queries against 1500 keys) and a ragged
   S != T; phi-3-vision's prefill (1088 positions, D 96, H = K = 32); the
   bf16 attention kernel's tile edges (S and T of 1000 and 1499, a window
   smaller than a KV tile with a query offset, D 32 at G 12, D 80 and 96
   across swizzle boxes, q, k and v as strided slices of one fused
   projection); the decode caches of both, whisper's cross cache whole and phi-3-vision's at
   lengths past its T; RMSNorm at d 4096 and 6144 and over qwen3-8b's q/k
   rows of 128, attention and decode at D 128 with G 4 (qwen3-8b), 8
   (yi-9b) and 12 (starcoder2-15b); the SSD step on both of its
   paths, bf16 B/C on the tensor cores and f32 B/C on the CUDA cores, at the
   zamba2-2.7b and mamba2-130m shapes, the bf16 path also against the exact
   f32 form, and its wrapper at P and N the kernel cuts into pieces) and at
   ragged shapes, and times the kernel, the
   plain version and the one PyTorch library call that computes the same
   function, where there is one (timed only; the port never calls it; the
   kernels SDPA launched are named beside attention's times),
   against the least time the card could take (``bound_ms``), with the
   card's clocks read after each timing;
4. serves random prompts through ``ServeEngine.generate`` at full width
   and depth (bf16, random weights from seed 0): tinyllama-1.1b,
   zamba2-2.7b and deepseek-moe-16b with 8 requests of 512 tokens at batch
   4 and 64 new tokens, mamba2-130m with 4 such requests and 16 new tokens,
   whisper-base with 8 requests of 64 tokens and 192 new ones over 1500
   seeded frame embeddings, phi-3-vision-4.2b with 8 requests of 512
   tokens and 64 new ones after 576 seeded patch embeddings, and yi-9b,
   qwen3-8b and starcoder2-15b with 8 requests of 512 tokens and 64 new.
   For each it checks the exact kernel launches of that run, and, but for
   deepseek-moe-16b and starcoder2-15b, that a decode step's logits match
   prefill's on the same prefix, and (tinyllama, zamba2, whisper-base,
   phi-3-vision, yi-9b, qwen3-8b) that the kernel path matches the plain
   path in f32 and bf16; deepseek-moe-16b's and starcoder2-15b's kernel
   paths are held to their chunked paths in f32, prefill and one decode
   step, at a cut depth (``PHASES`` says why), starcoder2-15b's decode also
   to its prefill;
5. runs the analyzer (``repro_torch.api.analyze``, each call a wave of one)
   on the card and on the host over the Gauss-Seidel kernel of each of the
   five machine models x unroll {1, 2, 4} x predictors {all, tp+cp+lcd, tp}
   x diagnose, eight randomized kernels per machine and a 512-instruction
   kernel per ISA: the two reports must be equal, the card's run must run
   every CP and LCD pass of the wave engine on the card, with CUDA kernels
   in its trace (the water-filling and the simulator run on the host on
   either side), and the Gauss-Seidel kernels at unroll 4 must meet the
   paper's Table I and the simulator's pins; it prints the wall times of
   the Gauss-Seidel kernels at unroll 4 and of the 512-instruction kernels
   on both sides, with the card's launches, copies and device ms per
   analysis. The analyzer launches none of the four kernels of phase 3;
6. runs waves through ``analyze_kernels(use_cache=False)`` on the card and
   on the host, and the per-kernel loop on the host: W8, W64 and W256
   (benchmarks/run.py's ``batched_analysis`` waves on tx2), R256 on each
   machine (256 randomized kernels), L64 on tx2 and csx (64 kernels of
   449..512 instructions, which the 32 MiB budget splits into chunks) and a
   ragged wave (1 beside 512 instructions). The three must be equal slot
   for slot, and every pass of the card's wave must run on the card; it
   prints per wave the kernels, distinct kernels, chunks, CP and LCD
   levels, launches, copies, device ms and the wall ms on both sides;
7. serves requests through ``AnalysisService`` on the card and on the host:
   benchmarks/run.py's ``analysis_service`` trace (256 requests over four
   kernels, batches of 16), 256 distinct randomized kernels over tx2, csx
   and zen in batches of 64, and a seeded chaos trace (virtual clock, fault
   rate 0.05, queue depth 8) whose envelopes, counters and cache stats must
   be equal; last, one real-clock request whose deadline the worker thread
   trips on a 512-instruction kernel must come back degraded or timed out,
   and once its worker has been joined a fresh request on the card must
   equal the host's;
8. calibrates tx2, csx and zen on the card and on the host: the results
   must be equal field for field;
9. analyzes accelerator graphs on the h100 target (``api.analyze(...,
   arch="h100")``) on the card and on the host, whose reports must be
   equal: tests/test_api.py's and tests/test_hlo.py's HLO texts (their
   while bodies' LCD sweeps on the card, CUDA kernels in the trace); the
   tinyllama-1.1b forward at full width and depth (bf16, 4 x 512 tokens,
   chunked attention, seed-0 weights) exported with ``torch.export`` on
   the card, with no ATen op unmapped, the analyzer's dot FLOPs equal to
   ``FlopCounterMode``'s, and the exported forward's device time at or
   above the roofline bound; and a ``while_loop`` of 16 trips of
   tanh(x @ W) at 4096 x 4096 bf16, whose trip count must be 16 and whose
   LCD must be carried by x;
10. runs ibench (``populate_entry``: serial-chain latency and stacked
   parallel-chain throughput) on the card for its default ops, and its dry
   run, which must print the reference's table;
11. trains (``repro_torch.train``): (a) the autograd Functions of K1 and K2
   (``ops.FusedRMSNorm``, ``ops.FlashAttention``: the kernel forward, a
   hand-written backward in PyTorch) against autograd through the plain
   formulas (``rmsnorm_rows_plain``, ``layers.naive_attention``) in f32 and
   bf16 at the slice's shapes and beside them (non-causal at whisper-base's
   encoder and cross shapes, phi-3-vision's), each backward timed; (d) the
   Function of K4 (``ops.SSDChunkDual``) against autograd through the exact
   f32 form at zamba2-2.7b's and mamba2-130m's training shapes, f32 and
   bf16 B/C, each backward timed against its bound; (b, e) one step's loss
   and gradients of tinyllama-1.1b, mamba2-130m, zamba2-2.7b,
   deepseek-moe-16b and phi-3-vision-4.2b at full width, each cut in depth,
   and of whisper-base whole, in f32 with TF32 off,
   on the kernel path against the ``chunked`` path, every parameter with a
   gradient (every expert of every MoE layer, and an aux loss above 0);
   (c, f) ``train_loop`` in bf16 at full width and depth of tinyllama-1.1b,
   mamba2-130m and zamba2-2.7b, 8 steps of 4 x 512 tokens on the Markov
   pipeline, whisper-base on 4 x 448 tokens beside 1500 frames and
   phi-3-vision-4.2b on 4 x (576 patches + 512 tokens), with the loss
   falling on the run and on a held-out batch (for mamba2-130m and
   phi-3-vision the held-out loss is recorded; whisper-base records both
   and gates on a batch's loss falling under steps on it, ``TRAIN_RUNS``
   says why) and
   exact kernel launches per step, and 4 steps of deepseek-moe-16b cut to
   its dense layer and 3 MoE layers; then each run's step ms, tokens/s,
   forward and backward ms, device busy and idle share, peak memory and the
   step's bound; last, for tinyllama-1.1b and mamba2-130m, a checkpoint
   saved, restored into a fresh state, and one more step from each, equal;
12. shards: (a) on a one-rank NCCL group and a 1 x 1 ("data", "model")
   ``DeviceMesh``, ``launch.elastic.apply_resize`` restores a checkpoint
   of tinyllama-1.1b after one step, saved by the phase, onto the mesh,
   every leaf equal to the checkpoint's bit for bit, then one train step at
   full width and depth (bf16, 4 x 512 tokens, K1 and K2 through their
   Functions) runs with the state distributed by ``state_shardings`` (each
   tensor a DTensor, ``Shard`` on the mesh's axes of one device as on any
   other) under the mesh context, with ``seq_shard``, ``zero`` and
   ``fsdp`` on: its loss and gradients must
   equal the same step's on the same state without a mesh, with exact
   launches; its step ms and device idle share are printed, and the group
   is destroyed; (b) a capacity plan, arithmetic only: each
   architecture's per-device bytes of ``state_shardings`` (ZeRO and FSDP)
   on the 16 x 16 and 2 x 16 x 16 meshes beside its whole state; (c) the
   sharded train step of every architecture (tiny, f32) on meshes of four
   gloo processes of the host, 2 x 2 and 1 x 4, with this machine's torch
   (``tests/torch_mesh_worker.py``): the residual stream sharded over batch
   and sequence, the loss, gradients and AdamW step held to the step
   without a mesh with ``tests/test_torch_distributed.py``'s tolerances;
13. dry-runs: (a) ``python -m repro_torch.launch.dryrun --jobs 4`` on the
   host, each cell in a process of its own on a 256-rank (16 x 16) fake
   group with the card's device type, traces tinyllama-1.1b's train_4k,
   prefill_32k and decode_32k cells and mamba2-130m's long_500k for one
   rank at full size (yi-9b's long_500k must print SKIP), then
   ``roofline_table`` reads the rows; each row's TC / HBM / NVLink terms,
   dominant port, memory estimate, collectives by opcode and trace seconds
   are printed, and a failed cell or an unmapped op fails the phase; (b)
   beside it, on a one-rank NCCL group and a 1 x 1 mesh, the dry run
   traces phase 11's tinyllama-1.1b step (bf16, 4 x 512 tokens) under its
   own run config (``chunked``, remat "full", ZeRO, FSDP, sequence
   sharding), then the step runs on the card: the traced arguments' bytes
   must equal the live state's and batch's, and the measured step at
   least the traced roofline's bound; the allocator's peak is printed
   beside the traced arg + temp + out bytes;
14. prints each phase's seconds, a JSON line of per-kernel numbers and,
   last, the JSON result line.

Any failed check raises, so the script exits non-zero before the last line.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
REQUESTS, PROMPT_LEN, BATCH, NEW_TOKENS = 8, 512, 4, 64
# whisper-base: 30 s of audio is 1500 encoder frames; 64 prompt tokens and
# 192 new ones stay inside its published 448-token decoder context.
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW = 1500, 64, 192
WHISPER_T = WHISPER_PROMPT + WHISPER_NEW
# phi-3-vision-4.2b: 576 patch embeddings before a 512-token prompt.
PHI_PATCHES = 576
PHI_SEQ = PHI_PATCHES + PROMPT_LEN
WHISPER_CONTEXT = 448  # whisper-base's decoder context: its training sequence
# Serve phases, each on prompts of PROMPT_LEN tokens (or ``prompt_len``) at
# batch BATCH: the model at full width and depth (layers, d_model), the
# requests and new tokens, whether the kernel path is held to the plain
# path, and the kernel launches of one prefill (K1 at every norm, K2 at
# every attention layer or shared-block invocation, K4 at every Mamba
# layer); a decode step launches as many K1, K3 where the prefill launched
# K2, and no K4, unless ``per_step`` says otherwise. ``frontend`` models
# take a seeded frontend (B, frontend_len, d_model), N(0, 0.02) in bf16.
# ``bf16_decode_tol`` bounds the bf16 logits of a decode step against
# prefill's (absolute). tinyllama keeps the 0.1 of tests/test_models.py.
# zamba2 is held to 0.2: on the H100 its kernel path reads 0.155 and the
# plain path, which rounds as the reference does, 0.193 (prefill and decode
# run their products through different cuBLAS kernels, and 63 blocks carry
# the rounding on), so 0.1 holds at zamba2's depth for no path that rounds
# as the reference does; f32 holds every path to 2e-3. The plain path's gap
# is logged beside the check. phi-3-vision-4.2b is held to 0.3 on the same
# grounds: its kernel path reads 0.213 and its plain path 0.251 on the
# H100 (32 layers at d 3072 after 576 patches), f32 5.6e-5.
PHASES = (
    dict(arch="tinyllama-1.1b", layers=22, d_model=2048, requests=REQUESTS,
         new_tokens=NEW_TOKENS, against_plain=True, bf16_decode_tol=0.1,
         per_prefill={"fused_rmsnorm": 45, "flash_attention": 22, "ssd_chunk_dual": 0}),
    dict(arch="zamba2-2.7b", layers=54, d_model=2560, requests=REQUESTS,
         new_tokens=NEW_TOKENS, against_plain=True, bf16_decode_tol=0.2,
         per_prefill={"fused_rmsnorm": 2 * 54 + 2 * 9 + 1, "flash_attention": 9,
                      "ssd_chunk_dual": 54}),
    dict(arch="mamba2-130m", layers=24, d_model=768, requests=BATCH, new_tokens=16,
         against_plain=False, bf16_decode_tol=None,
         per_prefill={"fused_rmsnorm": 2 * 24 + 1, "flash_attention": 0, "ssd_chunk_dual": 24}),
    # 16.4 B parameters, 32.8 GB in bf16. The decode-matches-prefill check
    # does not hold for moe by the reference's own semantics: capacity
    # follows the routing group, 60 slots an expert at prefill (a group of
    # 512 tokens) against 1 at a decode step (the batch's 4 tokens), so a
    # decode step drops routed assignments that prefill keeps. In its place
    # the kernel path is held to the chunked path, one prefill and one
    # decode step in f32, at the depth ``paths_layers`` (the dense layer and
    # 3 MoE layers; the full model in f32 would not fit beside its bf16
    # copy).
    dict(arch="deepseek-moe-16b", layers=28, d_model=2048, requests=REQUESTS,
         new_tokens=NEW_TOKENS, against_plain=False, bf16_decode_tol=None, paths_layers=4,
         per_prefill={"fused_rmsnorm": 2 * 28 + 1, "flash_attention": 28, "ssd_chunk_dual": 0}),
    # An encoder of 6 layers over 1500 frames (K1 at 2 norms a layer and
    # enc_final_norm, K2 non-causal a layer), a decoder of 6 (K1 at norm1,
    # norm3, norm2 and the final norm; K2 causal and cross a layer at
    # prefill, K3 against the self and the cross cache at a decode step).
    dict(arch="whisper-base", layers=6, d_model=512, requests=REQUESTS,
         prompt_len=WHISPER_PROMPT, new_tokens=WHISPER_NEW, frontend=WHISPER_FRAMES,
         against_plain=True, bf16_decode_tol=0.1,
         per_prefill={"fused_rmsnorm": 2 * 6 + 1 + 3 * 6 + 1, "flash_attention": 6 + 2 * 6,
                      "ssd_chunk_dual": 0},
         per_step={"fused_rmsnorm": 3 * 6 + 1, "flash_attention": 0, "flash_decode": 2 * 6,
                   "ssd_chunk_dual": 0}),
    # 3.82 B parameters, 7.64 GB in bf16. The engine sizes the cache for
    # prompt + new tokens as the reference's does, which leaves out the 576
    # patches: the 1088 slots of prefill hold, and every decode step writes
    # the last slot (the reference's clamp, ROADMAP substrate notes). The
    # decode-matches-prefill check sizes its cache to hold the step.
    dict(arch="phi-3-vision-4.2b", layers=32, d_model=3072, requests=REQUESTS,
         new_tokens=NEW_TOKENS, frontend=PHI_PATCHES, against_plain=True, bf16_decode_tol=0.3,
         per_prefill={"fused_rmsnorm": 2 * 32 + 1, "flash_attention": 32, "ssd_chunk_dual": 0}),
    # The dense models of the largest head dim: D 128 at G 8 (yi-9b, 8.83 B
    # parameters), G 4 (qwen3-8b, 8.19 B, whose q/k norms add two K1 a layer
    # over rows of 128: models/layers.py, attention_block) and G 12
    # (starcoder2-15b, 15.96 B, GELU). Their bf16 decode is held on the
    # grounds of zamba2's: on the H100 yi-9b's kernel path read 0.319 and
    # its plain path, which rounds as the reference does, 0.440 (48 layers
    # at d 4096; the same in three runs), qwen3-8b's 0.241 and 0.371 (two
    # runs), so each bound is 1.2 times its plain path's reading. yi-9b and
    # qwen3-8b keep an f32 copy beside the bf16 one (35 and 33 GB); that of
    # starcoder2-15b (64 GB beside its 32) would not fit, so its f32 checks
    # run at 4 layers of its full width through ``paths_layers``.
    dict(arch="yi-9b", layers=48, d_model=4096, requests=REQUESTS, new_tokens=NEW_TOKENS,
         against_plain=True, bf16_decode_tol=0.53,
         per_prefill={"fused_rmsnorm": 2 * 48 + 1, "flash_attention": 48, "ssd_chunk_dual": 0}),
    dict(arch="qwen3-8b", layers=36, d_model=4096, requests=REQUESTS, new_tokens=NEW_TOKENS,
         against_plain=True, bf16_decode_tol=0.45,
         per_prefill={"fused_rmsnorm": 2 * 36 + 1 + 2 * 36, "flash_attention": 36,
                      "ssd_chunk_dual": 0}),
    dict(arch="starcoder2-15b", layers=40, d_model=6144, requests=REQUESTS,
         new_tokens=NEW_TOKENS, against_plain=False, bf16_decode_tol=None, paths_layers=4,
         per_prefill={"fused_rmsnorm": 2 * 40 + 1, "flash_attention": 40, "ssd_chunk_dual": 0}),
)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}  # (rtol, atol)
SSD_TOL = (1e-4, 1e-4)  # f32 sums over 256 keys and 128 state dims (test_kernels.py)
# Logits (of magnitude ~1) of a serve model in f32 with TF32 off differ
# between two paths only in summation order across its layers; bf16 is held
# to the tolerance of tests/test_models.py's decode-matches-prefill check.
LOGIT_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-1}


def log(*args):
    print(*args, flush=True)


def require(ok, what):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

_FLUSH = None


def time_ms(fn, reps=20, warmup=3):
    """Per-call times of ``fn`` in ms, with L2 flushed before each call so
    that inputs come from device memory: ``device``, the summed duration of
    the CUDA kernels (and memsets/copies) it ran, from a torch.profiler
    trace; ``span``, CUDA events around each call, which also counts the
    host's launch overhead where the host is slower than the device. A trace
    that holds no device activity (the profiler has returned one, rarely,
    on its first use in a process) is taken again, up to three times, and
    then ``device`` falls back to ``span``, with a line that says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    global _FLUSH
    if _FLUSH is None:  # a normal tensor, also when first made under inference mode
        with torch.inference_mode(False):
            _FLUSH = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        _FLUSH.bitwise_not_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    span = sum(s.elapsed_time(e) for s, e in events) / reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                _FLUSH.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA and "bitwise_not" not in e.name)
        if device_us > 0:
            return device_us / 1e3 / reps, span
    log(json.dumps({"timing": "the profiler traced no device activity in three tries; "
                              "device time taken from CUDA events", "span_ms": span}))
    return span, span


def timing(shape, kernel, plain, library, *, flops, nbytes, peak):
    """Times of a kernel, its plain version and the library call on one
    input, beside the least time the card could take for the same work: the
    larger of ``flops`` at ``peak`` and ``nbytes`` (each input read once, each
    output written once) at the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {"shape": shape, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        row[key], row[key.replace("ms", "span_ms")] = (None, None) if fn is None else time_ms(fn)
    row["clocks"] = clocks()
    return row


def host_us(fn, calls=100, batches=5):
    """Host microseconds per call of ``fn``: the enqueue of ``calls`` calls
    back to back, before one synchronize (a wrapper's Python, ctypes and
    launch cost, where the device keeps up); the least of ``batches`` such
    batches, since other work on a shared host only adds time."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches (a library
    call's backend, read from a torch.profiler trace), in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return list(dict.fromkeys(n[:120] for n in names))


def clocks():
    """The card's SM and memory clocks (MHz) and its active clock-limit
    reasons, as nvidia-smi reads them now; the query's error text where this
    driver does not know a field."""
    fields = "clocks.sm,clocks.mem,clocks_throttle_reasons.active"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    text = (out.stdout if out.returncode == 0 else out.stderr or out.stdout).strip()
    return text.splitlines()[0] if text else f"nvidia-smi exit {out.returncode}"


def device_time(fn, calls, inference=True):
    """Device time per call of ``fn`` from a torch.profiler trace: the summed
    duration of the CUDA kernels it ran, and the top kernels by time. None
    when the trace holds no device activity. ``fn`` runs in inference mode
    unless ``inference`` is False."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    if not by_name:
        return None, None
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return sum(by_name.values()), {k[:80]: v for k, v in top.items()}


def entry_label(line):
    """'kernel<dtype, ints>' from ptxas's 'Compiling entry function' line,
    read off the mangled name: its length-prefixed identifier that ends in
    '_kernel', bf16 or f32, and its integer template arguments."""
    mangled = line.split("'")[1] if "'" in line else line
    name, i = mangled, 0
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if digits is None:
            i += 1
            continue
        start = i + len(digits.group())
        ident = mangled[start:start + int(digits.group())]
        if ident.endswith("_kernel"):
            name = ident
            break
        i = start + len(ident)
    dtype = "bf16" if "nv_bfloat16" in mangled else "f32"
    ints = re.findall(r"Li(\d+)E", mangled)
    return f"{name}<{', '.join([dtype, *ints])}>"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def compare(name, shape, out, want, tol=None):
    rtol, atol = tol or TOL[want.dtype]
    err = (out.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    ok = bool(torch.isfinite(out.float()).all()) and bool((err <= limit).all())
    row = {"shape": shape, "dtype": str(want.dtype).removeprefix("torch."),
           "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol, "ok": ok}
    require(ok, f"{name} {row} disagrees with its plain version")
    return row


def check_kernels(port):
    ops, F = port["ops"], torch.nn.functional
    fa, da, rms, ssd = port["fa"], port["da"], port["rms"], port["ssd"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    results = {}

    # K1: rows = B*S at prefill, B at decode, at every width the serve paths
    # norm: tinyllama 2048; zamba2 2560 (norm1, final_norm) and 5120
    # (ssm_norm, the shared block's norms); mamba2-130m 768 and 1536;
    # whisper-base 512 (encoder rows B*1500, decoder rows B*64) and
    # phi-3-vision 3072 (rows B*(576 + 512)); yi-9b and qwen3-8b 4096,
    # starcoder2-15b 6144, and qwen3-8b's q and k norms over rows of 128
    # (B*S*32 and B*S*8 at prefill, B*32 and B*8 at decode).
    # d = 2050 is not in 16-byte vectors and takes the one-element loop;
    # d = 8200 is wider than the register kernel holds (8192) and takes the
    # loop that reads the row twice.
    widths = (2048, 2560, 5120, 768, 1536, 4096, 6144)
    slice_rows = [(BATCH * WHISPER_FRAMES, 512), (BATCH * WHISPER_PROMPT, 512), (BATCH, 512),
                  (BATCH * (PHI_PATCHES + PROMPT_LEN), 3072), (BATCH, 3072),
                  (BATCH * PROMPT_LEN * 32, 128), (BATCH * PROMPT_LEN * 8, 128),
                  (BATCH * 32, 128), (BATCH * 8, 128)]
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in [(r, d) for d in widths for r in (BATCH * PROMPT_LEN, BATCH)] + \
                slice_rows + [(7, 2050), (3, 8200)]:
            x, w = rnd(rows, d, dtype=dtype), rnd(d, dtype=dtype)
            checks.append(compare("fused_rmsnorm", [rows, d], ops.fused_rmsnorm(x, w),
                                  rms.rmsnorm_rows_plain(x, w)))
    timings = []
    # tinyllama's prefill and decode rows, then every other width at prefill.
    # whisper-base's and phi-3-vision's rows: serve prefill and decode, and
    # whisper's decoder at its training length.
    for rows, d in [(BATCH * PROMPT_LEN, 2048), (BATCH, 2048)] + \
            [(BATCH * PROMPT_LEN, d) for d in widths[1:]] + slice_rows + \
            [(BATCH * WHISPER_CONTEXT, 512)]:
        x = rnd(rows, d, dtype=torch.bfloat16)
        w = rnd(d, dtype=torch.bfloat16)
        timings.append(timing(
            [rows, d], lambda: ops.fused_rmsnorm(x, w),
            lambda: rms.rmsnorm_rows_plain(x, w),
            lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-5),
            flops=4 * x.numel(), nbytes=nbytes(x, w, x), peak=PEAK_F32_FLOPS))
    results["fused_rmsnorm"] = dict(checks=checks, timings=timings)

    # K2: tinyllama's prefill (D 64, GQA 8:1), zamba2's shared attention
    # (D 80, 32 KV heads, window 4096), ragged S = T (77, 100, 5), a window
    # of 17, phi-3-vision's D 96, D 32 and 128, a logit softcap, a query
    # offset (40 queries at positions 90.. against 130 keys), and
    # deepseek-moe-16b's prefill (D 128, H = K = 16); without the causal
    # mask, whisper-base's encoder (S = T = 1500: 23 KV tiles and a ragged one
    # of 28 keys), its cross-attention (64 queries against 1500 keys, no
    # query offset) and a small ragged case (37 queries, 130 keys, D 96);
    # and phi-3-vision's prefill (576 patches + 512 tokens, D 96, H = K = 32).
    # (b, s, t, h, kv, d, window, q_offset, softcap[, causal])
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, t, h, kv, d, win, qoff, cap, *causal in (
                (BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, 0, 0, 0.0, False),
                (BATCH, WHISPER_PROMPT, WHISPER_FRAMES, 8, 8, 64, 0, 0, 0.0, False),
                (2, 37, 130, 8, 2, 96, 0, 0, 0.0, False),
                (BATCH, PHI_SEQ, PHI_SEQ, 32, 32, 96, 0, 0, 0.0),
                (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 4, 64, 0, 0, 0.0),
                (3, 77, 77, 32, 4, 64, 0, 0, 0.0),
                (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 32, 80, 4096, 0, 0.0),
                (3, 77, 77, 32, 32, 80, 0, 0, 0.0), (2, 100, 100, 8, 8, 80, 17, 0, 0.0),
                (2, 100, 100, 8, 2, 96, 0, 0, 0.0), (2, 100, 100, 8, 2, 128, 0, 0, 0.0),
                (2, 5, 5, 8, 2, 32, 0, 0, 0.0), (2, 100, 100, 32, 4, 64, 0, 0, 30.0),
                (2, 40, 130, 32, 4, 64, 0, 90, 0.0), (2, 40, 130, 8, 8, 80, 33, 90, 30.0),
                (BATCH, PROMPT_LEN, PROMPT_LEN, 16, 16, 128, 0, 0, 0.0),
                # D 128 at G 4 (qwen3-8b), 8 (yi-9b) and 12 (starcoder2-15b).
                (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 8, 128, 0, 0, 0.0),
                (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 4, 128, 0, 0, 0.0),
                (BATCH, PROMPT_LEN, PROMPT_LEN, 48, 4, 128, 0, 0, 0.0),
                # The bf16 kernel's tiles (128 queries, 64 keys, swizzle
                # boxes of 64, 32 or 16 dims): S and T multiples of neither,
                # causal and not, at D 64, 96 (64 + 32) and 80 (five boxes
                # of 16); a window smaller than one KV tile with a query
                # offset; G 12 at D 32 (one box of 32) and G 8 at D 80.
                (2, 1000, 1000, 8, 2, 64, 0, 0, 0.0),
                (2, 1000, 1499, 8, 8, 96, 0, 0, 0.0, False),
                (2, 1000, 1499, 16, 2, 80, 0, 0, 0.0),
                (2, 300, 700, 16, 4, 64, 40, 400, 0.0),
                (2, 200, 333, 12, 1, 32, 0, 133, 0.0),
                (2, 200, 333, 12, 1, 32, 0, 0, 0.0, False),
                (2, 333, 333, 16, 2, 80, 50, 0, 30.0)):
            q, k, v = rnd(b, s, h, d, dtype=dtype), rnd(b, t, kv, d, dtype=dtype), \
                rnd(b, t, kv, d, dtype=dtype)
            kw = dict(causal=causal == [], window=win, q_offset=qoff, softcap=cap)
            checks.append(compare("flash_attention",
                                  [b, s, t, h, kv, d, win, qoff, cap, kw["causal"]],
                                  ops.flash_attention(q, k, v, **kw),
                                  fa.flash_attention_plain(q, k, v, **kw)))
            del q, k, v
        # q, k and v as strided head slices of one fused projection, the
        # layout a fused QKV split would give models/layers.py: rows
        # (H + 2K) * D apart, which TMA reads in place.
        for b, s, h, kv, d in ((BATCH, PROMPT_LEN, 32, 4, 64), (2, 77, 24, 8, 96)):
            y = rnd(b, s, (h + 2 * kv) * d, dtype=dtype)
            q = y[..., :h * d].view(b, s, h, d)
            k = y[..., h * d:(h + kv) * d].view(b, s, kv, d)
            v = y[..., (h + kv) * d:].view(b, s, kv, d)
            checks.append(compare("flash_attention", [b, s, s, h, kv, d, "fused qkv view"],
                                  ops.flash_attention(q, k, v),
                                  fa.flash_attention_plain(q, k, v)))
            del y, q, k, v
    timings = []
    dt = torch.bfloat16
    # (b, s, t, h, kv, d, causal): the served prefills, then whisper-base's
    # encoder and cross-attention, which see every key.
    for b, s, t, h, kv, d, causal in (
            (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 4, 64, True),
            (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 32, 80, True),
            (BATCH, PROMPT_LEN, PROMPT_LEN, 16, 16, 128, True),
            (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 8, 128, True),
            (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 4, 128, True),
            (BATCH, PROMPT_LEN, PROMPT_LEN, 48, 4, 128, True),
            (BATCH, PHI_SEQ, PHI_SEQ, 32, 32, 96, True),
            (BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, False),
            (BATCH, WHISPER_PROMPT, WHISPER_FRAMES, 8, 8, 64, False),
            # whisper-base's decoder: self-attention at the served prompt
            # and at the training length, cross-attention at the latter.
            (BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 8, 8, 64, True),
            (BATCH, WHISPER_CONTEXT, WHISPER_CONTEXT, 8, 8, 64, True),
            (BATCH, WHISPER_CONTEXT, WHISPER_FRAMES, 8, 8, 64, False)):
        q, k, v = rnd(b, s, h, d, dtype=dt), rnd(b, t, kv, d, dtype=dt), rnd(b, t, kv, d, dtype=dt)
        pairs = s * (s + 1) // 2 if causal else s * t  # (query, key) pairs per head
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        timings.append(timing(
            [b, s, t, h, kv, d, causal] if not causal or s != t else [b, s, h, kv, d],
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: fa.flash_attention_plain(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=True),
            flops=4 * b * h * d * pairs, nbytes=nbytes(q, k, v, q), peak=PEAK_BF16_FLOPS))
        # The yardstick's backend, by the kernels it launched.
        timings[-1]["library_kernels"] = kernel_names(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True))
        log(json.dumps({"flash_attention_timing": timings[-1]}))
    results["flash_attention"] = dict(checks=checks, timings=timings)

    # K3: the decode caches (T = prompt + new tokens) of the serve shapes
    # (deepseek-moe-16b's at D 128, G 1), ragged ones with a zero length,
    # lengths 0, 1, 64, 65 and T (64 is exactly one split), a window whose
    # edge falls inside a split, a softcap, D 96 and 128, and G = 64 (one KV
    # head for 64 query heads).
    # (b, t, h, kv, d, lengths, window, softcap)
    checks = []
    t_serve = PROMPT_LEN + NEW_TOKENS
    mid = t_serve - NEW_TOKENS // 2
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, kv, d, lens, win, cap in (
                (BATCH, t_serve, 32, 4, 64, [mid] * BATCH, 0, 0.0),
                (3, 100, 32, 4, 64, [0, 37, 99], 0, 0.0),
                (BATCH, t_serve, 32, 32, 80, [mid] * BATCH, 0, 0.0),
                (3, 100, 32, 32, 80, [0, 37, 99], 0, 0.0),
                (5, 130, 32, 4, 64, [0, 1, 64, 65, 130], 0, 0.0),
                (BATCH, t_serve, 32, 4, 64, [mid, 300, 65, t_serve], 100, 0.0),
                (3, 100, 32, 32, 80, [0, 37, 99], 16, 30.0),
                (2, 130, 8, 2, 96, [130, 65], 0, 0.0), (2, 130, 8, 2, 128, [64, 1], 0, 0.0),
                (2, 130, 64, 1, 64, [130, 65], 0, 0.0),
                (BATCH, t_serve, 16, 16, 128, [mid] * BATCH, 0, 0.0),
                (BATCH, t_serve, 32, 8, 128, [mid] * BATCH, 0, 0.0),
                (BATCH, t_serve, 32, 4, 128, [mid] * BATCH, 0, 0.0),
                (BATCH, t_serve, 48, 4, 128, [mid, 300, 65, t_serve], 0, 0.0),
                # whisper-base's cross cache (every frame valid, a ragged
                # last split) and self cache (prompt + new tokens);
                # phi-3-vision's cache of 1088 slots at lengths past it, as
                # the reference's clamped write leaves them (its kernel
                # and plain version attend all T).
                (BATCH, WHISPER_FRAMES, 8, 8, 64, [WHISPER_FRAMES] * BATCH, 0, 0.0),
                (BATCH, WHISPER_T, 8, 8, 64, [WHISPER_T - 1, 100, 65, WHISPER_T], 0, 0.0),
                (BATCH, PHI_SEQ, 32, 32, 96, [PHI_SEQ + 1, PHI_SEQ + 12, PHI_SEQ + 1,
                                              PHI_SEQ], 0, 0.0)):
            q, k, v = rnd(b, 1, h, d, dtype=dtype), rnd(b, t, kv, d, dtype=dtype), \
                rnd(b, t, kv, d, dtype=dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            kw = dict(window=win, softcap=cap)
            out = ops.flash_decode(q, k, v, lengths, **kw)
            checks.append(compare("flash_decode", [b, t, h, kv, d, lens, win, cap], out,
                                  da.decode_attention_plain(q, k, v, lengths, **kw)))
            require(all(float(out[i].abs().max()) == 0 for i, n in enumerate(lens) if n == 0),
                    "flash_decode: a zero length must give zeros")
    timings = []
    # The mid-generation cache length of each served shape; whisper-base's
    # cross cache is read whole, phi-3-vision's at a length past its T.
    for b, t, h, kv, d, length in (
            (BATCH, t_serve, 32, 4, 64, mid), (BATCH, t_serve, 32, 32, 80, mid),
            (BATCH, t_serve, 16, 16, 128, mid), (BATCH, t_serve, 32, 8, 128, mid),
            (BATCH, t_serve, 32, 4, 128, mid), (BATCH, t_serve, 48, 4, 128, mid),
            (BATCH, WHISPER_FRAMES, 8, 8, 64, WHISPER_FRAMES),
            (BATCH, WHISPER_T, 8, 8, 64, WHISPER_T - WHISPER_NEW // 2),
            (BATCH, PHI_SEQ, 32, 32, 96, PHI_SEQ + NEW_TOKENS // 2)):
        q, k, v = rnd(b, 1, h, d, dtype=dt), rnd(b, t, kv, d, dtype=dt), rnd(b, t, kv, d, dtype=dt)
        lengths = torch.full((b,), length, dtype=torch.int32, device="cuda")
        n = min(length, t)
        read = 2 * b * n * kv * d * k.element_size()  # the K and V rows below the length
        qt, kt, vt = q.transpose(1, 2), k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
        timings.append(timing(
            [b, t, h, kv, d, length], lambda: ops.flash_decode(q, k, v, lengths),
            lambda: da.decode_attention_plain(q, k, v, lengths),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
            flops=4 * b * h * d * n, nbytes=read + 2 * nbytes(q) + nbytes(lengths),
            peak=PEAK_BF16_FLOPS))
        timings[-1]["host_us"] = host_us(lambda: ops.flash_decode(q, k, v, lengths))
    results["flash_decode"] = dict(checks=checks, timings=timings)

    # K4: the prefill shapes of zamba2-2.7b (H 80, N 64) and mamba2-130m
    # (H 24, N 128), one wave of B 4 x 512 tokens in 2 chunks of 256, with
    # xdt and cum as the model's (B,NC,Q,H,.) views and B/C slices of one
    # projection; ragged chunks (Q 77 at N 64 and 128, Q 5); and cum falling
    # by up to 40 a step, so that exp of the unmasked upper triangle would be
    # inf. Every case runs both paths (the dtype of B/C picks one); the bf16
    # path, whose plain version mirrors its hi + lo terms, is also held to
    # the exact f32 form (the plain version on the same B/C upcast).
    def ssd_inputs(b, nc, h, q, p, n, dtype, span=1.0, x_offset=0):
        xdt = (rnd(b, nc, q, h, p + x_offset, dtype=torch.float32) * 0.1)[..., x_offset:]
        cum = -torch.cumsum(torch.rand(b, nc, q, h, generator=gen, device="cuda") * span, dim=2)
        proj = rnd(b, nc, q, 2 * n + 8, dtype=torch.float32) * 0.3
        return (xdt.permute(0, 1, 3, 2, 4), cum.permute(0, 1, 3, 2),
                proj[..., 8:8 + n].to(dtype), proj[..., 8 + n:].to(dtype))

    checks = []
    zamba, mamba = (BATCH, 2, 80, 256, 64, 64), (BATCH, 2, 24, 256, 64, 128)

    def check_ssd(shape, dtype, span=1.0, x_offset=0):
        args = ssd_inputs(*shape, dtype, span, x_offset)
        if span > 1:
            c = args[1][0, 0, 0]
            require(bool(torch.isinf(torch.exp(c[:, None] - c[None, :])).any()),
                    "the overflow case overflows without the mask")
        got = ops.ssd_chunk_dual(*args)
        wants = [("", ssd.ssd_intra_chunk_plain(*args))]
        if dtype == torch.bfloat16:
            wants.append((" vs exact f32", ssd.ssd_intra_chunk_plain(
                args[0], args[1], args[2].float(), args[3].float())))
        for label, want in wants:
            for part, g, w in zip(("y", "states"), got, want):
                require(g.shape == w.shape, f"ssd_chunk_dual {shape} {part} shape {tuple(g.shape)}")
                checks.append(compare("ssd_chunk_dual", [*shape, str(dtype), span, part + label],
                                      g, w, tol=SSD_TOL))

    for shape, span in ((zamba, 1.0), (mamba, 1.0), ((2, 3, 8, 77, 64, 64), 1.0),
                        ((2, 3, 8, 77, 64, 128), 1.0), ((2, 1, 8, 5, 64, 64), 1.0),
                        ((1, 1, 8, 256, 64, 64), 40.0)):
        for dtype in (torch.float32, torch.bfloat16):
            check_ssd(shape, dtype, span)
    # The wrapper at P and N the kernel does not take itself (it pads P to
    # the next width, cuts P in slices of 128 and N in slices of 256): the
    # smallest such input, xdt (1, 1, 1, 8, 16), then P 96 and 160, N 320.
    for shape in ((1, 1, 1, 8, 16, 64), (2, 1, 4, 77, 96, 64), (1, 2, 2, 64, 160, 64),
                  (1, 1, 2, 64, 64, 320)):
        for dtype in (torch.float32, torch.bfloat16):
            check_ssd(shape, dtype)
    # Inputs the tensor-core path's TMA cannot read where they lie (the
    # wrapper copies them into rows it can): B/C of N 44 and xdt one float
    # off alignment (a view of a 65-wide buffer).
    for dtype in (torch.float32, torch.bfloat16):
        check_ssd((2, 1, 4, 77, 64, 44), dtype, x_offset=1)
    # Both paths at both serve shapes, bf16 (the served one) first. The
    # operations are counted once, the scores once per chunk (the kernel
    # does more: split terms, scores per head), at the peak of each path's
    # units.
    timings = []
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_FLOPS), (torch.float32, PEAK_F32_FLOPS)):
        for b, nc, h, q, p, n in (zamba, mamba):
            args = ssd_inputs(b, nc, h, q, p, n, dtype)
            y, states = ssd.ssd_intra_chunk_plain(*args)
            pairs = q * (q + 1) // 2  # (i, j) pairs with j <= i per chunk
            timings.append(timing(
                [b, nc, h, q, p, n, str(dtype).removeprefix("torch.")],
                lambda: ops.ssd_chunk_dual(*args), lambda: ssd.ssd_intra_chunk_plain(*args), None,
                flops=b * nc * (h * (2 * pairs * p + 2 * q * n * p) + 2 * pairs * n),
                nbytes=nbytes(*args, y, states), peak=peak))
    results["ssd_chunk_dual"] = dict(checks=checks, timings=timings)

    for name, r in results.items():
        log(json.dumps({"kernel": name, **r}))
    return results


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


def logits_close(name, got, want, dtype, tol=None):
    if tol is None:
        tol = LOGIT_TOL[dtype]
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    log(json.dumps({"check": name, "dtype": str(dtype).removeprefix("torch."),
                    "max_abs_err": err, "atol": tol}))
    require(finite and err <= tol, f"{name}: max abs err {err} > {tol}")
    # Where prefill's top logit leads by more than twice the tolerance, the
    # greedy token must agree.
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
    require(bool((got.argmax(-1) == want.argmax(-1))[sure].all()),
            f"{name}: greedy tokens differ where the margin exceeds the tolerance")


def expected_launches(per_prefill, per_step=None):
    """Launches of one prefill and of one decode step, from a phase's
    per-prefill counts (and per-step ones, where they do not follow)."""
    prefill = dict(per_prefill, flash_decode=0)
    step = per_step or {"fused_rmsnorm": per_prefill["fused_rmsnorm"], "flash_attention": 0,
                        "flash_decode": per_prefill["flash_attention"], "ssd_chunk_dual": 0}
    return prefill, step


def serve_frontend(cfg, batch):
    """A seeded frontend for an audio or vlm model: (batch, frontend_len,
    d_model), N(0, 0.02) in bf16 on the card; None for the others."""
    if cfg.frontend == "none":
        return None
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return (torch.randn(batch, cfg.frontend_len, cfg.d_model, generator=gen, device="cuda")
            * 0.02).to(torch.bfloat16)


def serve(port, device_name, phase):
    """One serve phase (an entry of PHASES): its requests of PROMPT_LEN (or
    its ``prompt_len``) random tokens at batch BATCH on its model at full
    width and depth, with its seeded frontend. Returns the summary and the
    kernel launches of that run."""
    cfg_mod, models, serving, ops = port["configs"], port["models"], port["serving"], port["ops"]
    arch, requests, new_tokens = phase["arch"], phase["requests"], phase["new_tokens"]
    prompt_len = phase.get("prompt_len", PROMPT_LEN)
    cfg = cfg_mod.get_config(arch)
    require((cfg.n_layers, cfg.d_model, cfg.frontend_len)
            == (phase["layers"], phase["d_model"], phase.get("frontend", 0)),
            f"{arch} at full width and depth")
    frontend = serve_frontend(cfg, BATCH)
    model = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    engine = serving.ServeEngine(cfg, model, batch_size=BATCH, device="cuda")
    require(engine.run.attention_impl == "flash", "the engine defaults to the kernels")
    tok_gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len), generator=tok_gen).tolist()

    # Warm-up: cuBLAS, allocator.
    engine.generate(prompts[:1], max_new_tokens=2,
                    frontend=None if frontend is None else frontend[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=new_tokens, frontend=frontend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    require([r.request_id for r in results] == list(range(requests)), "one result per request")
    require(all(len(r.tokens) == new_tokens and all(0 <= x < cfg.vocab for x in r.tokens)
                for r in results), f"{new_tokens} in-vocabulary tokens per request")
    waves, steps = requests // BATCH, new_tokens - 1
    per_prefill, per_step = expected_launches(phase["per_prefill"], phase.get("per_step"))
    expect = {k: waves * (per_prefill[k] + steps * per_step[k]) for k in per_prefill}
    log(json.dumps({"model": arch, "launches": launches, "expected": expect,
                    "per_prefill": per_prefill, "per_decode_step": per_step}))
    require(all(launches[k] > 0 for k, v in expect.items() if v),
            "every kernel of the path ran on the serve run")
    require(launches == expect, "kernel launches match the path's structure")

    # Per-phase times of one wave, on the same prompts.
    run = engine.run
    tokens = torch.tensor(prompts[:BATCH], device="cuda")
    max_len = prompt_len + new_tokens
    kw = dict(max_len=max_len, frontend=frontend)
    with torch.inference_mode():
        _, prefill_ms = time_ms(lambda: models.prefill(model, cfg, run, tokens, **kw),
                                reps=5, warmup=1)
        logits, cache = models.prefill(model, cfg, run, tokens, **kw)
        cur = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            logits, cache = models.decode_step(model, cfg, run, cache, cur)
            cur = logits[:, -1].argmax(-1)[:, None]
        end.record()
        torch.cuda.synchronize()
        decode_ms = start.elapsed_time(end) / steps

    prefill_busy, prefill_top = device_time(
        lambda: models.prefill(model, cfg, run, tokens, **kw), 1)
    with torch.inference_mode():
        decode_busy, decode_top = device_time(
            lambda: models.decode_step(model, cfg, run, cache, cur), 8)

    summary = {"model": arch, "family": cfg.family, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "params": n_params, "requests": requests,
               "prompt_len": prompt_len, "frontend_len": cfg.frontend_len, "batch": BATCH,
               "new_tokens": new_tokens,
               "wall_s": wall, "tok_per_s": requests * new_tokens / wall,
               "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
               "decode_tok_per_s": BATCH / decode_ms * 1e3,
               "prefill_device_ms": prefill_busy, "decode_device_ms_per_step": decode_busy,
               "decode_device_idle_share":
                   None if decode_busy is None else 1 - decode_busy / decode_ms,
               "prefill_top_kernels_ms": prefill_top, "decode_top_kernels_ms_per_step": decode_top,
               "max_memory_allocated": peak, "device": device_name}
    log(json.dumps({"serve": summary}))

    if "paths_layers" in phase:
        del engine, results, cache, model
        torch.cuda.empty_cache()
        summary["paths"] = cut_paths(port, cfg, tokens, phase["paths_layers"])
        return summary, launches

    # Logits of three runs per path: prefill on the prompt less its last
    # token (511 tokens: the SSD pads its last chunk), one decode step on
    # that token (the cache sized to hold it: a vlm's counts its patches),
    # and prefill on the whole prompt. Paths: the kernels in bf16 and in
    # f32, and the plain path (eager layers, no kernel) in bf16 and in f32,
    # on one set of weights and frontend (the f32 model is the bf16 one
    # upcast, so f32 holds it exactly). TF32 is off.
    del engine, results, cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain_run = cfg_mod.RunConfig(attention_impl="chunked", attention_chunk=64)
    model32 = copy.deepcopy(model).float()
    step_len = prompt_len + (cfg.frontend_len if cfg.family == "vlm" else 0)

    def three(m, r):
        fe = None if frontend is None else frontend.to(m.embed.dtype)
        with torch.inference_mode():
            pre, c = models.prefill(m, cfg, r, tokens[:, :-1], max_len=step_len, frontend=fe)
            dec, _ = models.decode_step(m, cfg, r, c, tokens[:, -1:])
            full, _ = models.prefill(m, cfg, r, tokens, frontend=fe)
        return pre[:, 0], dec[:, 0], full[:, -1]

    # Teacher-forced decode on the kernel path: the step's logits equal the
    # prefill logits of the same prefix.
    k32 = three(model32, run)
    p32 = three(model32, plain_run) if phase["against_plain"] else None
    del model32
    logits_close(f"{arch}: decode_matches_prefill", k32[1], k32[2], torch.float32)
    if phase["against_plain"]:
        k16, p16 = three(model, run), three(model, plain_run)
        gap = float((p16[1] - p16[2]).abs().max())
        log(json.dumps({"check": f"{arch}: plain_decode_matches_prefill",
                        "dtype": "bfloat16", "max_abs_err": gap}))
        logits_close(f"{arch}: decode_matches_prefill", k16[1], k16[2], torch.bfloat16,
                     phase["bf16_decode_tol"])
        # Kernel path against the plain path on the same tokens.
        for i, what in enumerate(("prefill", "decode")):
            logits_close(f"{arch}: {what}_kernels_vs_plain", k32[i], p32[i], torch.float32)
            # In bf16 the plain path rounds attention probabilities to bf16
            # (as the reference does) where the kernels carry them as two
            # bf16 terms (prefill) or in f32 (decode), so the two differ by
            # more than either differs from f32. Hold the kernel path to the
            # plain path's own bf16 error against the f32 plain path.
            err_k = float((k16[i] - p32[i]).abs().max())
            err_p = float((p16[i] - p32[i]).abs().max())
            log(json.dumps({"check": f"{arch}: {what}_bf16_error_vs_f32", "kernels": err_k,
                            "plain": err_p, "limit": 2 * err_p}))
            require(err_k <= 2 * err_p, f"{arch} {what}: bf16 kernel path error {err_k} "
                                        f"exceeds twice the plain path's {err_p}")
    del model
    torch.cuda.empty_cache()
    return summary, launches


def cut_paths(port, full, tokens, layers):
    """A model of ``full``'s width cut to ``layers`` layers, seed-0 weights in
    f32 with TF32 off: prefill on the prompts less their last token and one
    decode step on it, on the kernel path (with its exact launches) and on
    the chunked path, whose logits must agree; but for moe (whose decode
    step has its batch's capacity), the decode step's logits also equal the
    whole prompt's prefill on the kernel path."""
    cfg_mod, models, ops = port["configs"], port["models"], port["ops"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(full, n_layers=layers, dtype="float32")
    model = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    out = {}
    for impl in ("flash", "chunked"):
        run = cfg_mod.RunConfig(attention_impl=impl, attention_chunk=64)
        ops.reset_launches()
        with torch.inference_mode():
            pre, cache = models.prefill(model, cfg, run, tokens[:, :-1], max_len=PROMPT_LEN)
            dec, _ = models.decode_step(model, cfg, run, cache, tokens[:, -1:])
        torch.cuda.synchronize()
        out[impl] = (pre[:, 0], dec[:, 0], dict(ops.LAUNCHES))
    norms = 2 * layers + 1 + (2 * layers if cfg.qk_norm else 0)
    per_prefill, per_step = expected_launches(
        {"fused_rmsnorm": norms, "flash_attention": layers, "ssd_chunk_dual": 0})
    expect = {k: per_prefill[k] + per_step[k] for k in per_prefill}
    require(out["flash"][2] == expect and not any(out["chunked"][2].values()),
            f"{full.name} path launches {out['flash'][2]}, expected {expect}")
    for i, what in enumerate(("prefill", "decode")):
        logits_close(f"{full.name} at {layers} layers: {what}_kernels_vs_chunked",
                     out["flash"][i], out["chunked"][i], torch.float32)
    if cfg.family != "moe":
        with torch.inference_mode():
            whole, _ = models.prefill(model, cfg, cfg_mod.RunConfig(attention_impl="flash"),
                                      tokens)
        logits_close(f"{full.name} at {layers} layers: decode_matches_prefill",
                     out["flash"][1], whole[:, -1], torch.float32)
    del model, out
    torch.cuda.empty_cache()
    return {"layers": layers, "launches": expect}


# ---------------------------------------------------------------------------
# Phase 5: the analyzer (asm -> report) on the card and on the host
# ---------------------------------------------------------------------------

ANALYZER_ARCHS = ("tx2", "csx", "zen", "zen2", "n1")
ANALYZER_PREDICTORS = (None, ("tp", "cp", "lcd"), ("tp",))
# Pins of the Gauss-Seidel kernels at unroll 4 in cy/it, copied from the
# paper's Table I (src/repro/core/validation/gauss_seidel.py: TP, LCD, CP;
# TP is read rounded to two places, the others to a relative 1e-6, as
# tests/test_table1.py reads them) and from the simulator's pins
# (tests/test_sim.py: to 1e-9).
TABLE1_PINS = {"tx2": (2.46, 18.00, 25.00), "csx": (2.19, 14.00, 18.00),
               "zen": (2.00, 11.50, 15.00)}
SIM_PINS = {"tx2": 18.00, "csx": 14.00, "zen": 11.50, "zen2": 10.50, "n1": 7.50}
# tests/test_sim.py::_random_kernel's instruction mix and per-arch seeds.
RANDOM_OPS = {
    "aarch64": ["fadd d{a}, d{b}, d{c}", "fmul d{a}, d{b}, d{c}",
                "fdiv d{a}, d{b}, d{c}", "add x{a}, x{b}, 8",
                "ldr d{a}, [x{b}, 8]", "str d{a}, [x{b}], 8",
                "cmp x{a}, x{b}"],
    "x86": ["vaddsd %xmm{a}, %xmm{b}, %xmm{c}",
            "vmulsd %xmm{a}, %xmm{b}, %xmm{c}",
            "movsd 8(%rax,%rbx,8), %xmm{a}",
            "movsd %xmm{a}, 8(%rax,%rbx,8)",
            "addq $8, %rax", "cmpq %rbx, %rax"],
}
RANDOM_ARCH_SEED = {"tx2": 100, "n1": 200, "csx": 300, "zen": 400, "zen2": 500}
SYNTHETIC_N = 512  # benchmarks/run.py::analyzer_scaling's largest kernel
ANALYZER_REPS = 5


def marked(lines):
    return "# OSACA-BEGIN\n" + "\n".join(lines) + "\n# OSACA-END"


def random_kernel_text(isa, seed, arch):
    """tests/test_sim.py::_random_kernel's text for one (arch, seed)."""
    rng = random.Random(seed * 31 + RANDOM_ARCH_SEED[arch])
    ops = RANDOM_OPS[isa]
    return marked([rng.choice(ops).format(a=rng.randint(0, 7), b=rng.randint(0, 7),
                                          c=rng.randint(0, 7))
                   for _ in range(rng.randint(1, 14))])


def synthetic_text(isa, n):
    """benchmarks/run.py's mixed FP / load / store / pointer-bump kernels
    (``_synthetic_kernel`` for AArch64, ``_synthetic_kernel_x86``)."""
    lines, regs = [], 8
    for i in range(n):
        if isa == "aarch64":
            if i % 7 == 3:
                lines.append(f"ldr d{i % regs}, [x1, {8 * (i % 16)}]")
            elif i % 11 == 5:
                lines.append(f"str d{(i + 1) % regs}, [x2], 8")
            elif i % 5 == 2:
                lines.append(f"add x{3 + i % 4}, x{3 + i % 4}, 8")
            else:
                lines.append(f"fadd d{i % regs}, d{(i + 1) % regs}, d{(i + 2) % regs}")
        elif i % 7 == 3:
            lines.append(f"movsd {8 * (i % 16)}(%rsi,%rbx,8), %xmm{i % regs}")
        elif i % 11 == 5:
            lines.append(f"movsd %xmm{(i + 1) % regs}, {8 * (i % 16)}(%rax)")
        elif i % 5 == 2:
            lines.append("addq $8, %rdx")
        else:
            lines.append(f"vaddsd %xmm{i % regs}, %xmm{(i + 1) % regs}, "
                         f"%xmm{(i + 2) % regs}")
    return marked(lines)


def analyzer_cases(registry):
    """The Gauss-Seidel kernel of each arch x unroll x predictors x
    diagnose, eight randomized kernels per arch, and one 512-instruction
    kernel per ISA. ``timed`` marks the cases whose times are reported."""
    cases = []
    for arch in ANALYZER_ARCHS:
        for unroll in (1, 2, 4):
            for predictors in ANALYZER_PREDICTORS:
                for diagnose in (False, True):
                    cases.append(dict(
                        arch=arch, name="gauss-seidel", text=registry.get_arch(arch).sample_asm,
                        unroll=unroll, predictors=predictors, diagnose=diagnose,
                        pinned=unroll == 4 and predictors is None,
                        timed=unroll == 4 and predictors is None and not diagnose))
    for arch in ANALYZER_ARCHS:
        isa = registry.get_arch(arch).isa
        for seed in range(8):
            cases.append(dict(arch=arch, name=f"rand-{seed}",
                              text=random_kernel_text(isa, seed, arch), unroll=1,
                              predictors=None, diagnose=False, pinned=False, timed=False))
    for arch, isa, name in (("tx2", "aarch64", f"synthetic-{SYNTHETIC_N}"),
                            ("csx", "x86", f"synthetic-x86-{SYNTHETIC_N}")):
        cases.append(dict(arch=arch, name=name, text=synthetic_text(isa, SYNTHETIC_N),
                          unroll=1, predictors=None, diagnose=False, pinned=False,
                          timed=True))
    return cases


def passes(port):
    """The tensor passes run since the last reset, by counter and device
    type: the wave engine's CP and LCD chunk passes and the per-kernel
    engine's LCD sweeps."""
    return {"waves": dict(port["batch"].WAVE_PASSES), "sweeps": dict(port["sweep"].SWEEPS)}


def reset_passes(port):
    port["batch"].reset_wave_passes()
    port["sweep"].reset_sweeps()


def on_card_as_on_host(on_card, on_host):
    """Every pass of the card's run ran on the card, as many as the host's
    run ran on the host."""
    return all(on_card[c]["cpu"] == 0 and on_card[c]["cuda"] == on_host[c]["cpu"]
               and on_host[c]["cuda"] == 0 for c in on_card)


def traced(port, fn, what):
    """``fn()`` on the card under torch.profiler: its result, its device
    events, the kernels among them and the passes it ran. A run that ran a
    pass on the card but whose trace shows no kernel is traced again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        reset_passes(port)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        ran = passes(port)
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
        if kernels or not (ran["waves"]["cuda"] or ran["sweeps"]["cuda"]):
            return out, events, kernels, ran
    raise AssertionError(f"{what}: ran passes on the card, but no CUDA kernel in three traces")


def analyzer(port):
    """Phase 5: every case of :func:`analyzer_cases` through
    ``repro_torch.api.analyze`` on the card and on the host, each from a
    cleared cache; each call is a wave of one (``analyze_kernels`` sends its
    misses to ``analyze_wave``). The two reports must be equal. The wave's
    CP and LCD passes are what runs on the device: the card's run must run
    as many as the host's, every one with its tensors on the card, and its
    torch.profiler trace must hold CUDA kernels wherever a pass ran (the
    per-kernel engine's LCD sweeps, counted apart, run only for the
    reference's fallback cases). Every Gauss-Seidel case runs one CP pass if
    it asks for CP and one LCD pass if it asks for LCD. The other stages run
    on the host on either side, so a case without a pass (predictors ``tp``)
    does no work on the card; such cases are counted as ``host_only``. The
    Gauss-Seidel kernels at unroll 4 must meet their pins. Prints one
    ``{"analyzer": [...]}`` line with the timed cases' wall times (median of
    ANALYZER_REPS, cache cleared) on both sides and the card's device
    activity per analysis."""
    api = port["api"]
    clear = port["analysis"].clear_analysis_cache
    normalize = port["analysis"].normalize_predictors

    def run(case, device):
        clear()
        opts = api.AnalyzeOptions(unroll=case["unroll"], predictors=case["predictors"],
                                  diagnose=case["diagnose"])
        t0 = time.perf_counter()
        report = api.analyze(case["text"], arch=case["arch"], name=case["name"],
                             options=opts, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return report, (time.perf_counter() - t0) * 1e3

    def label(case):
        return (f"{case['arch']} {case['name']} unroll {case['unroll']} "
                f"predictors {case['predictors']} diagnose {case['diagnose']}")

    t_phase = time.perf_counter()
    cases = analyzer_cases(port["registry"])
    run(cases[0], "cuda")  # first use: CUDA context and lazy module loads
    rows, with_kernels, host_only, host_only_events = [], 0, 0, 0
    for case in cases:
        (gpu, _), events, kernels, on_card = traced(port, lambda: run(case, "cuda"),
                                                    f"analyzer {label(case)}")
        reset_passes(port)
        cpu, _ = run(case, "cpu")
        on_host = passes(port)
        require(gpu.to_dict() == cpu.to_dict(),
                f"analyzer {label(case)}: the cuda report differs from the cpu report")
        require(on_card_as_on_host(on_card, on_host),
                f"analyzer {label(case)}: passes {on_card} on the card, {on_host} on the host")
        if on_card["waves"]["cuda"] or on_card["sweeps"]["cuda"]:
            with_kernels += 1
        else:
            host_only += 1
            host_only_events += len(events)
        if case["name"] == "gauss-seidel":
            preds = normalize(case["predictors"])
            want = {"cpu": 0, "cuda": ("cp" in preds) + ("lcd" in preds)}
            require(on_card["waves"] == want,
                    f"analyzer {label(case)}: wave passes {on_card['waves']}, want {want}")
        if case["pinned"]:
            arch = case["arch"]
            if arch in TABLE1_PINS:
                tp, lcd, cp = TABLE1_PINS[arch]
                require(round(gpu.tp_per_it, 2) == tp
                        and math.isclose(gpu.lcd_per_it, lcd, rel_tol=1e-6)
                        and math.isclose(gpu.cp_per_it, cp, rel_tol=1e-6),
                        f"analyzer {arch}: Table I TP/LCD/CP {gpu.tp_per_it}/"
                        f"{gpu.lcd_per_it}/{gpu.cp_per_it}, pinned {tp}/{lcd}/{cp}")
            require(abs(gpu.sim_per_it - SIM_PINS[arch]) <= 1e-9,
                    f"analyzer {arch}: sim {gpu.sim_per_it} cy/it, pinned {SIM_PINS[arch]}")
        if case["timed"]:
            with PassClock(port["batch"]) as on_card_clock:
                gpu_ms = statistics.median(run(case, "cuda")[1] for _ in range(ANALYZER_REPS))
            with PassClock(port["batch"]) as on_host_clock:
                cpu_ms = statistics.median(run(case, "cpu")[1] for _ in range(ANALYZER_REPS))
            device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
            rows.append({"arch": case["arch"], "kernel": case["name"],
                         "instructions": len(gpu.rows), "unroll": case["unroll"],
                         "cuda_ms": gpu_ms, "cpu_ms": cpu_ms,
                         "cuda_pass_ms": on_card_clock.ms / ANALYZER_REPS,
                         "cpu_pass_ms": on_host_clock.ms / ANALYZER_REPS,
                         "kernel_launches": len(kernels),
                         "copies": len(events) - len(kernels),
                         "device_ms": device_ms, "device_busy_share": device_ms / gpu_ms})
    log(json.dumps({"analyzer": rows}))
    log(json.dumps({"analyzer_checks": {"cases": len(cases), "equal": len(cases),
                                        "with_kernels": with_kernels,
                                        "host_only": host_only,
                                        "host_only_device_events": host_only_events,
                                        "seconds": time.perf_counter() - t_phase}}))


# ---------------------------------------------------------------------------
# Phase 6: waves through analyze_kernels on the card and on the host
# ---------------------------------------------------------------------------

WAVE_REPS = 3  # timed runs per side and wave (median); L64 once


def wave_cases(registry):
    """(label, arch, [(name, text)]): benchmarks/run.py's batched_analysis
    waves (synthetic AArch64 kernels of 3..18 instructions, cycling), 256
    randomized kernels per machine, 64 kernels of 449..512 instructions per
    ISA, and a 1-instruction kernel beside a 512-instruction one."""
    cases = [(f"W{count}", "tx2", [(f"synthetic-{3 + i % 16}",
                                    synthetic_text("aarch64", 3 + i % 16))
                                   for i in range(count)])
             for count in (8, 64, 256)]
    for arch in ANALYZER_ARCHS:
        isa = registry.get_arch(arch).isa
        cases.append(("R256", arch, [(f"rand-{seed}", random_kernel_text(isa, seed, arch))
                                     for seed in range(256)]))
    for arch, isa in (("tx2", "aarch64"), ("csx", "x86")):
        cases.append(("L64", arch, [(f"synthetic-{n}", synthetic_text(isa, n))
                                    for n in range(449, 513)]))
    cases.append(("ragged", "tx2", [(f"synthetic-{n}", synthetic_text("aarch64", n))
                                    for n in (1, SYNTHETIC_N)]))
    return cases


class PassClock:
    """Host-clock ms spent inside the wave engine's level-synchronous passes
    while the ``with`` block runs. Each pass ends in its copy of ``dist`` and
    ``parent`` to the host, so on the card the span includes the device's
    work; the rest of a wave's wall time is its host stages."""

    def __init__(self, batch):
        self.batch, self.ms = batch, 0.0

    def __enter__(self):
        inner = self.inner = self.batch._wavefront

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3

        self.batch._wavefront = timed
        return self

    def __exit__(self, *exc):
        self.batch._wavefront = self.inner


def timed_ms(fn, device, reps):
    """Median wall ms of ``reps`` calls of ``fn`` (synchronized on the
    card), and the last call's result."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def waves(port):
    """Phase 6: each wave of :func:`wave_cases` through
    ``analyze_kernels(use_cache=False)`` on the card and on the host, and
    through the port's per-kernel ``analyze_kernel`` loop on the host; the
    three must give equal ``to_dict()`` per slot, and every pass of the
    card's wave must run on the card, as many as the host's. Prints one JSON
    line per wave."""
    analysis, batch, registry = port["analysis"], port["batch"], port["registry"]
    model_for = port["api"].model_for
    rows = []
    for label, arch, named in wave_cases(registry):
        spec = registry.get_arch(arch)
        model = model_for(spec)
        kernels = [spec.parser(text, name=name) for name, text in named]
        reps = 1 if label == "L64" else WAVE_REPS

        def wave(device):
            return analysis.analyze_kernels(kernels, model, use_cache=False, device=device)

        def loop(device):
            return [analysis.analyze_kernel(k, model, device=device) for k in kernels]

        def dicts(analyses):
            return [a.to_report().to_dict() for a in analyses]

        gpu, events, launched, on_card = traced(port, lambda: wave("cuda"), f"wave {label} {arch}")
        reset_passes(port)
        cpu = wave("cpu")
        on_host = passes(port)
        require(on_card_as_on_host(on_card, on_host) and on_card["waves"]["cuda"] >= 2,
                f"wave {label} {arch}: passes {on_card} on the card, {on_host} on the host")
        with PassClock(batch) as on_card_clock:
            cuda_ms, _ = timed_ms(lambda: wave("cuda"), "cuda", reps)
        with PassClock(batch) as on_host_clock:
            cpu_ms, _ = timed_ms(lambda: wave("cpu"), "cpu", reps)
        cpu_loop_ms, solo = timed_ms(lambda: loop("cpu"), "cpu", 1)
        got = dicts(gpu)
        require(got == dicts(cpu), f"wave {label} {arch}: the cuda wave differs from the cpu wave")
        require(got == dicts(solo), f"wave {label} {arch}: the wave differs from the per-kernel loop")
        graphs = {}
        for k, (_, text) in zip(kernels, named):
            costs = model.resolve_kernel(k)
            if costs and text not in graphs:
                graphs[text] = batch._compile_graph(costs)
        row = {"wave": label, "arch": arch, "kernels": len(kernels), "distinct": len(graphs),
               "chunks": on_card["waves"]["cuda"] - 1,
               "cp_levels": max(max(g.cp_lvl) + 1 for g in graphs.values()),
               "lcd_levels": max(max(g.lvl) + 1 for g in graphs.values()),
               "launches": len(launched), "copies": len(events) - len(launched),
               "device_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3,
               "cuda_ms": cuda_ms, "cpu_ms": cpu_ms,
               "cuda_pass_ms": on_card_clock.ms / reps, "cpu_pass_ms": on_host_clock.ms / reps,
               "cpu_loop_ms": cpu_loop_ms}
        if label in ("W8", "W64"):
            row["cuda_loop_ms"], card_solo = timed_ms(lambda: loop("cuda"), "cuda", 1)
            require(dicts(card_solo) == got, f"wave {label}: the card's per-kernel loop differs")
        log(json.dumps({"wave_run": row}))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 7: AnalysisService on the card and on the host
# ---------------------------------------------------------------------------

CHAOS_RATE = 0.05
DEADLINE_S = 0.02  # far below a 512-instruction analysis on either side


def service_traces(registry, serving):
    """benchmarks/run.py's analysis_service trace, and 256 distinct
    randomized kernels over tx2, csx and zen: (label, requests, batch)."""
    req = serving.AnalysisRequest
    tx2, csx, zen = (registry.get_arch(a) for a in ("tx2", "csx", "zen"))
    pool = [req(asm=tx2.sample_asm, arch="tx2", unroll=4, name="gs-tx2"),
            req(asm=csx.sample_asm, arch="csx", unroll=4, name="gs-csx"),
            req(asm=zen.sample_asm, arch="zen", unroll=4, name="gs-zen"),
            req(asm=tx2.sample_asm, arch="tx2", unroll=1, name="gs-tx2-1x")]
    rng = random.Random(0)
    hot = [pool[rng.randrange(len(pool))] for _ in range(256)]
    archs = ("tx2", "csx", "zen")
    distinct = [req(asm=random_kernel_text(registry.get_arch(archs[i % 3]).isa, i, archs[i % 3]),
                    arch=archs[i % 3], name=f"rand-{i}") for i in range(256)]
    return [("hot-loop", hot, 16), ("distinct", distinct, 64)], pool


def service(port):
    """Phase 7: the traces of :func:`service_traces`, a seeded chaos trace
    and a real-clock deadline through ``AnalysisService`` on the card and
    on the host."""
    serving, faults, res = port["serving_analysis"], port["faults"], port["resilience"]
    clear = port["analysis"].clear_analysis_cache
    traces, pool = service_traces(port["registry"], serving)
    rows = []

    def serve(device, requests, size, **kw):
        clear()
        svc = serving.AnalysisService(device=device, **kw)
        t0 = time.perf_counter()
        out = []
        for start in range(0, len(requests), size):
            out += svc.submit_batch(requests[start:start + size])
        if device == "cuda":
            torch.cuda.synchronize()
        return svc, out, time.perf_counter() - t0

    for label, requests, size in traces:
        reset_passes(port)
        gpu_svc, gpu, gpu_s = serve("cuda", requests, size)
        on_card = passes(port)
        reset_passes(port)
        cpu_svc, cpu, cpu_s = serve("cpu", requests, size)
        on_host = passes(port)
        require(all(r.ok for r in gpu), f"service {label}: every request answered")
        require([r.to_dict() for r in gpu] == [r.to_dict() for r in cpu]
                and gpu_svc.stats == cpu_svc.stats,
                f"service {label}: the card's envelopes or stats differ from the host's")
        require(on_card_as_on_host(on_card, on_host) and on_card["waves"]["cuda"] > 0,
                f"service {label}: passes {on_card} on the card, {on_host} on the host")
        rows.append({"trace": label, "requests": len(requests), "batch": size,
                     "stats": gpu_svc.stats, "passes_on_card": on_card["waves"]["cuda"],
                     "cuda_req_per_s": len(requests) / gpu_s,
                     "cpu_req_per_s": len(requests) / cpu_s})
        log(json.dumps({"service_run": rows[-1]}))

    # A seeded chaos trace on a virtual clock: the resilient path runs each
    # job through the degradation ladder's per-kernel engine.
    chaos_requests = pool + traces[1][1][:20]
    chaos_requests = [chaos_requests[(7 * i + i // 5) % len(chaos_requests)] for i in range(64)]

    def chaos(device):
        clock = faults.VirtualClock()
        injector = faults.FaultInjector(seed=0, rates={f"stage:{s}": CHAOS_RATE for s in
                                                       ("dag", "cp", "lcd", "sim")})
        cfg = res.ResilienceConfig(request_timeout_s=10.0, max_queue_depth=8,
                                   min_rung="parse_only", clock=clock, sleep=clock.sleep)
        svc, out, _ = serve(device, chaos_requests, 16, resilience=cfg, faults=injector)
        return {"envelopes": [r.to_dict() for r in out], "counters": svc.counters,
                "stats": svc.stats, "sleeps": clock.sleeps, "calls": injector.calls,
                "fired": injector.fired}

    reset_passes(port)
    gpu = chaos("cuda")
    on_card = passes(port)
    reset_passes(port)
    cpu = chaos("cpu")
    on_host = passes(port)
    require(gpu == cpu, "service chaos: the card's envelopes or counters differ from the host's")
    require(on_card_as_on_host(on_card, on_host) and on_card["sweeps"]["cuda"] > 0,
            f"service chaos: passes {on_card} on the card, {on_host} on the host")
    codes = sorted({e["error_code"] for e in gpu["envelopes"]})
    rows.append({"trace": "chaos", "requests": len(chaos_requests), "codes": codes,
                 "counters": gpu["counters"], "fired": gpu["fired"],
                 "sweeps_on_card": on_card["sweeps"]["cuda"]})
    log(json.dumps({"service_run": rows[-1]}))

    # Last: a real-clock deadline that the worker thread trips while the
    # 512-instruction kernel is analyzed on the card. The abandoned worker
    # runs on to its next stage boundary, so it is joined before anything
    # reads a counter or a trace again.
    req = serving.AnalysisRequest(asm=synthetic_text("aarch64", SYNTHETIC_N), arch="tx2",
                                  name=f"synthetic-{SYNTHETIC_N}")
    clear()
    svc = serving.AnalysisService(device="cuda",
                                  resilience=res.ResilienceConfig(request_timeout_s=DEADLINE_S))
    t0 = time.perf_counter()
    late = svc.submit(req)
    answer_ms = (time.perf_counter() - t0) * 1e3
    workers = [t for t in threading.enumerate() if t.name == "analysis-deadline-worker"]
    for worker in workers:
        worker.join(timeout=300)
    require(not any(w.is_alive() for w in workers), "service deadline: the worker finished")
    torch.cuda.synchronize()
    require(late.error_code in ("DEGRADED", "STAGE_TIMEOUT"),
            f"service deadline: envelope {late.error_code!r}, want DEGRADED or STAGE_TIMEOUT")
    fresh = [serve(device, [req], 1)[1][0].to_dict() for device in ("cuda", "cpu")]
    require(fresh[0] == fresh[1] and fresh[0]["ok"] and not fresh[0]["degraded"],
            "service deadline: a fresh request on the card differs from the host's")
    rows.append({"trace": "deadline", "timeout_s": DEADLINE_S, "error_code": late.error_code,
                 "degradation": late.report.degradation if late.report else None,
                 "attempts": late.attempts, "answer_ms": answer_ms, "workers_joined": len(workers)})
    log(json.dumps({"service_run": rows[-1]}))
    return rows


# ---------------------------------------------------------------------------
# Phase 8: calibration on the card and on the host
# ---------------------------------------------------------------------------


def calibration(port):
    calibrate, clear = port["calibration"].calibrate, port["analysis"].clear_analysis_cache
    rows = []
    for arch in ("tx2", "csx", "zen"):
        results = {}
        for device in ("cuda", "cpu"):
            clear()
            results[device] = calibrate(arch, device=device)
        require(dataclasses.asdict(results["cuda"]) == dataclasses.asdict(results["cpu"]),
                f"calibrate {arch}: the card's result differs from the host's")
        out = results["cuda"].to_dict()
        rows.append({"arch": arch, "kernels": out["n_kernels"],
                     "coverage": out["bracket_coverage"], "drift": out["drift_count"],
                     "mape": {p: e["mape"] for p, e in out["errors"].items()},
                     "bias": {p: e["bias"] for p, e in out["errors"].items()}})
    log(json.dumps({"calibration": rows}))
    return rows


# ---------------------------------------------------------------------------
# Phase 9: accelerator graphs (HLO text and torch.export programs)
# ---------------------------------------------------------------------------

# tests/test_api.py's WHILE_HLO and tests/test_hlo.py's fixtures (SIMPLE_HLO
# and its known_trip_count variant), copied.
WHILE_HLO = """
HloModule api_test, num_partitions=1

%body (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %p = (s32[], f32[8,128]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  %x = f32[8,128]{1,0} get-tuple-element(%p), index=1
  %y = f32[8,128]{1,0} multiply(%x, %x)
  ROOT %t = (s32[], f32[8,128]) tuple(%i2, %y)
}

%cond (p: (s32[], f32[8,128])) -> pred[] {
  %p = (s32[], f32[8,128]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(8)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

ENTRY %main (a: f32[8,128]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  %zero = s32[] constant(0)
  %init = (s32[], f32[8,128]) tuple(%zero, %a)
  %w = (s32[], f32[8,128]) while(%init), condition=%cond, body=%body
  ROOT %out = f32[8,128]{1,0} get-tuple-element(%w), index=1
}
"""
SIMPLE_HLO = """
HloModule test_module, num_partitions=4

%add_red (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %r = f32[] add(%a, %b)
}

%body (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %p = (s32[], f32[8,128]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  %x = f32[8,128]{1,0} get-tuple-element(%p), index=1
  %y = f32[8,128]{1,0} multiply(%x, %x)
  %z = f32[8,128]{1,0} all-reduce(%y), channel_id=1, replica_groups={{0,1,2,3}}, to_apply=%add_red
  ROOT %t = (s32[], f32[8,128]) tuple(%i2, %z)
}

%cond (p: (s32[], f32[8,128])) -> pred[] {
  %p = (s32[], f32[8,128]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(10)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

ENTRY %main (arg: f32[8,128], w: f32[128,256]) -> f32[8,256] {
  %arg = f32[8,128]{1,0} parameter(0)
  %w = f32[128,256]{1,0} parameter(1)
  %zero = s32[] constant(0)
  %init = (s32[], f32[8,128]) tuple(%zero, %arg)
  %loop = (s32[], f32[8,128]) while(%init), condition=%cond, body=%body
  %out = f32[8,128]{1,0} get-tuple-element(%loop), index=1
  ROOT %dot = f32[8,256]{1,0} dot(%out, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""
HLO_TEXTS = (
    ("while_api", WHILE_HLO, 8),
    ("simple", SIMPLE_HLO, 10),
    ("known_trips", SIMPLE_HLO.replace(
        "while(%init), condition=%cond, body=%body",
        'while(%init), condition=%cond, body=%body, '
        'backend_config={"known_trip_count":{"n":"7"}}'), 7),
)
GRAPH_ARCH = "tinyllama-1.1b"
LOOP_TRIPS, LOOP_WIDTH = 16, 4096


def dot_flops(module, cost):
    """The analyzer's dot FLOPs of one run: each dot's FLOPs times the
    executions of its computation."""
    counts = cost.execution_counts()
    return sum(counts.get(comp.name, 0.0) * cost.op_flops(op, comp)
               for comp in module.computations.values()
               for op in comp.ops if op.opcode == "dot")


def on_both(port, source, what):
    """``api.analyze(source, arch="h100")`` on the card (traced) and on the
    host: the two reports must be equal, and every LCD sweep of the card's
    run must run on the card with CUDA kernels in its trace. Returns the
    card's report, its sweeps and the wall ms on both sides."""
    api = port["api"]
    gpu, _, kernels, on_card = traced(
        port, lambda: api.analyze(source, arch="h100", device="cuda"), what)
    cuda_ms, _ = timed_ms(lambda: api.analyze(source, arch="h100", device="cuda"), "cuda", 1)
    reset_passes(port)
    cpu_ms, cpu = timed_ms(lambda: api.analyze(source, arch="h100", device="cpu"), "cpu", 1)
    on_host = passes(port)
    require(gpu.to_dict() == cpu.to_dict(), f"{what}: the cuda report differs from the cpu report")
    require(on_card_as_on_host(on_card, on_host),
            f"{what}: passes {on_card} on the card, {on_host} on the host")
    return gpu, on_card["sweeps"]["cuda"], len(kernels), cuda_ms, cpu_ms


class Forward(torch.nn.Module):
    """A model's forward, tokens to logits, as one module to export."""

    def __init__(self, models, model, cfg, run):
        super().__init__()
        self.forward_hidden, self.lm_logits = models.forward_hidden, models.transformer.lm_logits
        self.model, self.cfg, self.run = model, cfg, run

    def forward(self, tokens):
        x, _ = self.forward_hidden(self.model, self.cfg, self.run, tokens)
        return self.lm_logits(self.model, self.cfg, x)


class TanhChain(torch.nn.Module):
    """LOOP_TRIPS trips of x = tanh(x @ w) as a ``while_loop``."""

    def forward(self, x, w):
        from torch._higher_order_ops.while_loop import while_loop

        return while_loop(lambda i, x: i < LOOP_TRIPS,
                          lambda i, x: (i + 1, torch.tanh(x @ w)),
                          (torch.zeros((), dtype=torch.int64, device=x.device), x))[1]


def accelerator_graphs(port):
    """Phase 9: (a) the HLO texts of HLO_TEXTS through ``api.analyze(text,
    arch="h100")`` on the card and on the host; (b) the tinyllama-1.1b
    forward at full width and depth (bf16, B BATCH x S PROMPT_LEN, chunked
    attention, the serve phase's random weights from seed 0) exported with
    ``torch.export`` on the card and analyzed on both sides: nothing left
    unmapped, the dot FLOPs equal to ``FlopCounterMode``'s count of a run,
    and the measured device time of the exported forward at or above the
    roofline bound; (c) a ``while_loop`` of LOOP_TRIPS trips of tanh(x @ W)
    at LOOP_WIDTH^2 bf16: trip count LOOP_TRIPS, the LCD carried by x."""
    from torch.utils.flop_counter import FlopCounterMode

    hlo, export, costs = port["hlo"], port["hlo_export"], port["hlo_costs"]
    cfg_mod, models = port["configs"], port["models"]
    rows = []
    for label, text, trips in HLO_TEXTS:
        report, sweeps, launched, cuda_ms, cpu_ms = on_both(port, text, f"hlo {label}")
        module = hlo.parse_hlo(text)
        cost = costs.HLOCostModel(module, hlo.H100_SXM)
        (loop,) = [op for op in module.entry.ops if op.opcode == "while"]
        require(cost.while_trip_count(loop) == trips and sweeps == 1 and launched > 0
                and report.lcd_block > 0 and report.lcd_chains[0].length > 0,
                f"hlo {label}: trips {cost.while_trip_count(loop)} (want {trips}), "
                f"{sweeps} sweeps and {launched} kernels on the card")
        rows.append({"graph": label, "trips": trips, "sweeps_on_card": sweeps,
                     "kernel_launches": launched, "lcd_s": report.lcd_block,
                     "cp_s": report.cp_block, "bound_s": report.tp_block,
                     "cuda_ms": cuda_ms, "cpu_ms": cpu_ms})
        log(json.dumps({"graph_run": rows[-1]}))

    # (b) the tinyllama forward, exported on the card.
    cfg = cfg_mod.get_config(GRAPH_ARCH)
    model = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    run = cfg_mod.RunConfig(attention_impl="chunked")
    tok_gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT_LEN), generator=tok_gen).cuda()
    fwd = Forward(models, model, cfg, run)
    t0 = time.perf_counter()
    ep = export.core_aten(torch.export.export(fwd, (tokens,)))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    module = hlo.lower_exported(ep)
    lower_s = time.perf_counter() - t0
    require(module.unmapped == (), f"{GRAPH_ARCH}: unmapped ATen ops {module.unmapped}")
    t0 = time.perf_counter()
    cp = hlo.hlo_critical_path(module)
    cp_s = time.perf_counter() - t0
    report, sweeps, _, cuda_ms, cpu_ms = on_both(port, ep, f"export {GRAPH_ARCH}")
    require(report.cp_block == cp.seconds and sweeps == 0,
            f"export {GRAPH_ARCH}: CP {report.cp_block} against {cp.seconds}, {sweeps} sweeps")
    cost = costs.HLOCostModel(module, hlo.H100_SXM)
    analyzer_dots = dot_flops(module, cost)
    by_opcode = {}  # the bytes term's split: each op's operands and result
    for op in module.entry.ops:
        by_opcode[op.opcode] = by_opcode.get(op.opcode, 0.0) + cost.op_bytes(op, module.entry)
    program = ep.module()
    with torch.inference_mode():
        with FlopCounterMode(display=False) as counter:
            logits = program(tokens)
        want = fwd(tokens)
    counted = counter.get_total_flops()
    roof = hlo.roofline_from_exported(ep, name=GRAPH_ARCH)
    require(analyzer_dots == counted == roof.ca_raw_flops,
            f"export {GRAPH_ARCH}: analyzer dot FLOPs {analyzer_dots}, FlopCounterMode "
            f"{counted}, roofline_from_exported {roof.ca_raw_flops}")
    require(logits.shape == (BATCH, PROMPT_LEN, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()), f"export {GRAPH_ARCH}: logits")
    logits_close(f"export {GRAPH_ARCH}: exported_vs_eager", logits, want, torch.bfloat16)
    with torch.inference_mode():
        measured_ms, span_ms = time_ms(lambda: program(tokens), reps=5, warmup=1)
    bound_ms = report.tp_block * 1e3
    row = {"graph": f"{GRAPH_ARCH} forward", "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": BATCH, "seq": PROMPT_LEN, "fx_nodes": len(ep.graph.nodes),
           "hlo_ops": len(module.entry.ops), "export_s": export_s, "lower_s": lower_s,
           "cp_sweep_s": cp_s, "cuda_ms": cuda_ms, "cpu_ms": cpu_ms,
           "terms_ms": {k: v * 1e3 for k, v in report.port_pressure.items()},
           "bound_ms": bound_ms, "bound_by": report.bottleneck_port,
           "cp_ms": report.cp_block * 1e3, "dot_flops": analyzer_dots,
           "bytes": sum(by_opcode.values()),
           "bytes_by_opcode": dict(sorted(by_opcode.items(), key=lambda kv: -kv[1])[:8]),
           "flops": report.port_pressure["TC"] * hlo.H100_SXM.peak_flops,
           "measured_ms": measured_ms, "span_ms": span_ms,
           "measured_over_bound": measured_ms / bound_ms,
           "roofline_from_exported": roof.row(), "clocks": clocks()}
    log(json.dumps({"graph_run": row}))
    require(measured_ms >= bound_ms,
            f"export {GRAPH_ARCH}: measured {measured_ms} ms beats the bound {bound_ms} ms")
    rows.append(row)
    del program, model, fwd, ep, logits, want
    torch.cuda.empty_cache()

    # (c) a carried chain: tanh(x @ W), LOOP_TRIPS trips.
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(LOOP_WIDTH, LOOP_WIDTH, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(LOOP_WIDTH, LOOP_WIDTH, generator=gen, device="cuda")
         / LOOP_WIDTH ** 0.5).to(torch.bfloat16)
    ep = export.core_aten(torch.export.export(TanhChain(), (x, w)))
    module = hlo.lower_exported(ep)
    (loop,) = [op for op in module.entry.ops if op.opcode == "while"]
    trips = costs.HLOCostModel(module, hlo.H100_SXM).while_trip_count(loop)
    report, sweeps, launched, cuda_ms, cpu_ms = on_both(port, ep, "export while_loop")
    longest = max(report.lcd_chains, key=lambda c: c.length)
    require(trips == LOOP_TRIPS and longest.carried_by == 1 and sweeps == 1 and launched > 0,
            f"export while_loop: trips {trips}, LCD carried by state[{longest.carried_by}], "
            f"{sweeps} sweeps and {launched} kernels on the card")
    program = ep.module()
    with torch.inference_mode():
        y = program(x, w)
        want = TanhChain()(x, w)
        measured_ms, span_ms = time_ms(lambda: program(x, w), reps=5, warmup=1)
    compare("export while_loop", [LOOP_WIDTH, LOOP_WIDTH], y, want)
    row = {"graph": f"while_loop tanh(x @ W) x{LOOP_TRIPS}", "width": LOOP_WIDTH,
           "trips": trips, "lcd_ms": report.lcd_block * 1e3, "lcd_members": list(longest.members),
           "cp_ms": report.cp_block * 1e3, "bound_ms": report.tp_block * 1e3,
           "measured_ms": measured_ms, "span_ms": span_ms,
           "measured_over_lcd": measured_ms / (report.lcd_block * 1e3),
           "cuda_ms": cuda_ms, "cpu_ms": cpu_ms, "clocks": clocks()}
    log(json.dumps({"graph_run": row}))
    require(measured_ms >= report.lcd_block * 1e3,
            f"export while_loop: measured {measured_ms} ms beats the LCD {report.lcd_block * 1e3} ms")
    rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 10: ibench on the card
# ---------------------------------------------------------------------------

# ``python -m repro.core.bench.ibench --dry-run``'s output, copied.
DRY_RUN_TABLE = """\
op        lat µs/op  1/tput µs/op   ILP
---------------------------------------
exp           2.250         0.750  3.00
tanh          1.580         0.527  3.00
rsqrt         2.060         0.687  3.00
add           4.390         1.463  3.00
mul           3.940         0.985  4.00
"""


def ibench(port):
    """Phase 10: ``populate_entry`` (serial-chain latency and stacked
    parallel-chain throughput) on the card for each of ``DEFAULT_OPS`` with
    the default clock and sync; every time finite and positive. The dry run
    must print the reference's table."""
    import contextlib
    import io

    ib = port["ibench"]
    rows = []
    for name in ib.DEFAULT_OPS:
        result, entry = ib.populate_entry(name, ib._op_factory(name), device="cuda")
        times = (result.latency_us, result.inverse_throughput_us)
        require(all(math.isfinite(t) and t > 0 for t in times) and entry.latency == times[0],
                f"ibench {name}: times {times}")
        rows.append({"op": name, "latency_us": result.latency_us,
                     "inverse_throughput_us": result.inverse_throughput_us,
                     "ilp_speedup": result.ilp_speedup, "chain_length": result.chain_length,
                     "n_parallel": result.n_parallel, "shape": [128, 128]})
    log(json.dumps({"ibench": rows}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ib.main(["--dry-run"])
    require(out.getvalue() == DRY_RUN_TABLE, f"ibench --dry-run printed {out.getvalue()!r}")
    return rows


# ---------------------------------------------------------------------------
# Phase 11: training
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_STEPS = "tinyllama-1.1b", 8
# (b) and (e): each trained family at full width, cut to a depth for the f32
# gradient check: zamba2-2.7b to 2 groups of 6 Mamba layers and a shared
# block each, deepseek-moe-16b to its dense layer and 3 MoE layers;
# whisper-base whole (6 encoder and 6 decoder layers).
CHECK_LAYERS = {"tinyllama-1.1b": 4, "mamba2-130m": 4, "zamba2-2.7b": 12,
                "deepseek-moe-16b": 4, "whisper-base": 6, "phi-3-vision-4.2b": 4}
# The pipeline's sequence of a train step (PROMPT_LEN unless named): a vlm's
# counts its patches (DataPipeline takes them off the tokens), an audio
# model's 1500 frames come beside it.
TRAIN_SEQ = {"whisper-base": WHISPER_CONTEXT, "phi-3-vision-4.2b": PHI_SEQ}
# (c) and (f): train_loop on (c)'s schedule, at full width and depth but for
# deepseek-moe-16b, cut to its dense layer and 3 MoE layers (2.3 B
# parameters, 27 GB with gradients and moments) for a few steps whose loss
# is recorded, not checked; checkpoints of tinyllama-1.1b and mamba2-130m.
# ``falls`` names the losses that must fall: the run's (last step below the
# first) and the held-out batch's. mamba2-130m's held-out loss is recorded,
# not checked: on this schedule its step loss fell for 6 of 6 seeds on the
# H100, but its seed-0 held-out loss went from 10.970123 to 10.970534
# (``train_schedules`` prints the spread over seeds; PERF.md §6).
# phi-3-vision-4.2b (4 x 1088 positions, 576 of them patches) gates on
# the step loss (on the H100 it fell for 3 of 3 seeds, and so did the
# held-out loss). whisper-base (4 x 448 tokens beside 1500 frames) does not
# learn on this schedule: its step loss fell for 2 of 6 seeds over 8 steps
# at lr 1e-3 (3 of 6 at 3e-4) and for 1 of 6 over 24 steps, inside a
# batch-to-batch spread of 0.03 (``train_schedules``; PERF.md §6), because
# the reference adds unit-scale sinusoids to N(0, 0.02) token and frame
# embeddings, so the first steps all but cannot see the tokens. Its run's
# losses are recorded, and its gate ("batch") is a batch's loss falling
# under REPEAT_STEPS steps on that batch: descent through the kernels'
# gradients on the card.
REPEAT_STEPS = 3
TRAIN_RUNS = (dict(arch="tinyllama-1.1b", checkpoint=True, falls=("run", "held_out")),
              dict(arch="mamba2-130m", checkpoint=True, falls=("run",)),
              dict(arch="zamba2-2.7b", falls=("run", "held_out")),
              dict(arch="deepseek-moe-16b", layers=4, steps=4, falls=()),
              dict(arch="whisper-base", falls=("batch",)),
              dict(arch="phi-3-vision-4.2b", falls=("run",)))
# (d): the Function of K4 at the SSD's training shapes (B, NC, H, Q, P, N).
SSD_TRAIN_SHAPES = {"zamba2-2.7b": (BATCH, 2, 80, 256, 64, 64),
                    "mamba2-130m": (BATCH, 2, 24, 256, 64, 128)}
# (c)'s schedule: a 2-step warmup to 1e-3, then a cosine to 0 at the last
# step (``total_steps`` = the steps run, as ``repro.launch.train`` sets it).
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
# Gradients of the Functions against autograd through the plain formulas,
# as the largest difference over the largest reference element: in f32 both
# sides differ only in summation order (about 1e-6 on the CPU), held to
# 1e-4; in bf16 autograd through the plain formulas rounds the attention
# probabilities and their gradient to bf16 (steps of 2^-8) where the
# Functions keep f32, held to 2e-2.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (b): the kernel path's gradients against the chunked path's, each tensor
# to 1e-4 of its largest element, in f32 with TF32 off. The paths differ in
# the attention's summation order (the kernel's tiles against 64-key
# chunks, a hand-written backward against autograd through the online
# softmax) and in the norm's backward formula; on the CPU at the tiny
# width the two agree to about 1e-6 of the largest element.
PATH_GRAD_TOL = 1e-4


def compare_grads(name, shape, got, want, tol):
    """Gradients held as the largest difference over the largest element of
    ``want``; every element finite."""
    rows = []
    for part, g, w in zip(("x", "w") if len(got) == 2 else ("q", "k", "v"), got, want):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        row = {"shape": shape, "dtype": str(w.dtype).removeprefix("torch."), "grad": part,
               "max_abs_err": err, "max_abs_ref": scale, "rel": err / max(scale, 1e-30),
               "tol": tol}
        require(bool(torch.isfinite(g.float()).all()) and err <= tol * scale,
                f"{name} backward {row} disagrees with autograd through the plain formula")
        rows.append(row)
    return rows


def train_functions(port):
    """Phase 11(a): the Functions of K1 and K2 on the card, forward (the
    kernel, against the plain version at the kernels' tolerances) and
    backward (against autograd through the plain formula), f32 and bf16;
    each backward timed at the slice's shape."""
    ops, rms, fa, layers, F = port["ops"], port["rms"], port["fa"], port["layers"], \
        torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    checks, grads = [], []
    # K1 at the slice's rows and width, and a width off the 16-byte vectors.
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((BATCH * PROMPT_LEN, 2048), (7, 2050)):
            x = rnd(rows, d, dtype=dtype).requires_grad_()
            w = (1 + rnd(d, dtype=torch.float32, scale=0.1)).to(dtype).requires_grad_()
            g = rnd(rows, d, dtype=dtype)
            out = ops.fused_rmsnorm(x, w)
            require(type(out.grad_fn).__name__ == "FusedRMSNormBackward",
                    "fused_rmsnorm goes through its Function when an input requires grad")
            checks.append(compare("FusedRMSNorm", [rows, d], out.detach(),
                                  rms.rmsnorm_rows_plain(x.detach(), w.detach())))
            got = torch.autograd.grad(out, (x, w), g)
            x2, w2 = x.detach().requires_grad_(), w.detach().requires_grad_()
            want = torch.autograd.grad(rms.rmsnorm_rows_plain(x2, w2), (x2, w2), g)
            grads += compare_grads("FusedRMSNorm", [rows, d], got, want, GRAD_TOL[dtype])
    # K2 at the slice's shape, at D 80, with a window, a softcap, a ragged S
    # and a query offset; without the causal mask at whisper-base's training
    # shapes (the encoder over 1500 frames, the cross-attention of 448
    # tokens against them) and a ragged S != T; phi-3-vision's (576 patches
    # + 512 tokens, D 96). (b, s, t, h, kv, d, window, q_offset, softcap[,
    # causal])
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, t, h, kv, d, win, qoff, cap, *causal in (
                (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 4, 64, 0, 0, 0.0),
                (BATCH, PROMPT_LEN, PROMPT_LEN, 32, 32, 80, 0, 0, 0.0),
                (2, 300, 300, 8, 2, 64, 64, 0, 0.0), (2, 100, 100, 32, 4, 64, 0, 0, 30.0),
                (3, 77, 77, 32, 4, 64, 0, 0, 0.0), (2, 40, 130, 8, 8, 80, 33, 90, 30.0),
                (BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, 0, 0, 0.0, False),
                (BATCH, WHISPER_CONTEXT, WHISPER_FRAMES, 8, 8, 64, 0, 0, 0.0, False),
                (2, 37, 130, 8, 2, 96, 0, 0, 0.0, False),
                (BATCH, PHI_SEQ, PHI_SEQ, 32, 32, 96, 0, 0, 0.0)):
            q = rnd(b, s, h, d, dtype=dtype).requires_grad_()
            k = rnd(b, t, kv, d, dtype=dtype).requires_grad_()
            v = rnd(b, t, kv, d, dtype=dtype).requires_grad_()
            g = rnd(b, s, h, d, dtype=dtype)
            kw = dict(causal=causal == [], window=win, q_offset=qoff, softcap=cap)
            shape = [b, s, t, h, kv, d, win, qoff, cap, kw["causal"]]
            out = ops.flash_attention(q, k, v, **kw)
            require(type(out.grad_fn).__name__ == "FlashAttentionBackward",
                    "flash_attention goes through its Function when an input requires grad")
            checks.append(compare("FlashAttention", shape, out.detach(),
                                  fa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                                           **kw)))
            got = torch.autograd.grad(out, (q, k, v), g)
            leaves = [a.detach().requires_grad_() for a in (q, k, v)]
            want = torch.autograd.grad(layers.naive_attention(*leaves, **kw), leaves, g)
            grads += compare_grads("FlashAttention", shape, got, want, GRAD_TOL[dtype])
            del q, k, v, g, out, got, leaves, want

    # The backward passes at the slice's shapes in bf16: the Function's, the
    # autograd backward through the plain formula, and the library's.
    timings = {}
    x = rnd(BATCH * PROMPT_LEN, 2048, dtype=torch.bfloat16).requires_grad_()
    w = torch.ones(2048, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    g = rnd(BATCH * PROMPT_LEN, 2048, dtype=torch.bfloat16)
    outs = (ops.fused_rmsnorm(x, w), rms.rmsnorm_rows_plain(x, w),
            F.rms_norm(x, (2048,), w, 1e-5))
    t = [time_ms(lambda o=o: torch.autograd.grad(o, (x, w), g, retain_graph=True))
         for o in outs]
    timings["FusedRMSNorm.backward"] = {
        "shape": [BATCH * PROMPT_LEN, 2048], "ms": t[0][0], "plain_ms": t[1][0],
        "library_ms": t[2][0], "bound_by": "bytes",
        "bound_ms": nbytes(x, w, g, x, w) / PEAK_BYTES * 1e3}
    b, s, h, kv, d = BATCH, PROMPT_LEN, 32, 4, 64
    q = rnd(b, s, h, d, dtype=torch.bfloat16).requires_grad_()
    k = rnd(b, s, kv, d, dtype=torch.bfloat16).requires_grad_()
    v = rnd(b, s, kv, d, dtype=torch.bfloat16).requires_grad_()
    g = rnd(b, s, h, d, dtype=torch.bfloat16)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    outs = (ops.flash_attention(q, k, v), layers.naive_attention(q, k, v),
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True).transpose(1, 2))
    t = [time_ms(lambda o=o: torch.autograd.grad(o, (q, k, v), g, retain_graph=True), reps=10)
         for o in outs]
    pairs = s * (s + 1) // 2
    flops = 10 * b * h * d * pairs  # the scores again, dV, dP, dQ, dK
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes(q, k, v, q, q, q, k, v) / PEAK_BYTES * 1e3  # q, k, v, O, dO; dq, dk, dv
    timings["FlashAttention.backward"] = {
        "shape": [b, s, h, kv, d], "ms": t[0][0], "plain_ms": t[1][0], "library_ms": t[2][0],
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    del outs, x, w, q, k, v, g, qt, kt, vt
    torch.cuda.empty_cache()
    # whisper-base's encoder and cross-attention, and phi-3-vision's
    # attention, at their training shapes: every (query, key) pair without
    # the mask.
    for label, (b, s, t, h, kv, d, causal) in (
            ("whisper encoder", (BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, False)),
            ("whisper cross", (BATCH, WHISPER_CONTEXT, WHISPER_FRAMES, 8, 8, 64, False)),
            ("phi-3-vision", (BATCH, PHI_SEQ, PHI_SEQ, 32, 32, 96, True))):
        q = rnd(b, s, h, d, dtype=torch.bfloat16).requires_grad_()
        k = rnd(b, t, kv, d, dtype=torch.bfloat16).requires_grad_()
        v = rnd(b, t, kv, d, dtype=torch.bfloat16).requires_grad_()
        g = rnd(b, s, h, d, dtype=torch.bfloat16)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        outs = (ops.flash_attention(q, k, v, causal=causal),
                layers.naive_attention(q, k, v, causal=causal),
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True).transpose(1, 2))
        t_ms = [time_ms(lambda o=o: torch.autograd.grad(o, (q, k, v), g, retain_graph=True),
                        reps=5) for o in outs]
        pairs = s * (s + 1) // 2 if causal else s * t
        t_ops = 10 * b * h * d * pairs / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes(q, k, v, q, q, q, k, v) / PEAK_BYTES * 1e3
        timings[f"FlashAttention.backward {label}"] = {
            "shape": [b, s, t, h, kv, d, causal], "ms": t_ms[0][0], "plain_ms": t_ms[1][0],
            "library_ms": t_ms[2][0], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "clocks": clocks()}
        del outs, q, k, v, g, qt, kt, vt
        torch.cuda.empty_cache()
    log(json.dumps({"train_functions": {"checks": checks, "grads": grads,
                                        "backward_timings": timings}}))
    return timings


def ssd_backward(port):
    """Phase 11(d): the Function of K4 on the card, at the training shapes
    of zamba2-2.7b and mamba2-130m (one wave of B 4 x 512 tokens in 2
    chunks of 256), with f32 and bf16 B/C, xdt and cum as the model's
    permuted views and B/C slices of one projection: its forward (the
    kernel) against the plain version, its backward against autograd
    through the exact f32 form (the plain version on B and C upcast), each
    backward timed beside autograd's and its bound."""
    ops, ssd = port["ops"], port["ssd"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def leaves_and_args(b, nc, h, q, p, n, dtype):
        xdt = torch.randn(b, nc, q, h, p, generator=gen, device="cuda") * 0.1
        cum = -torch.cumsum(torch.rand(b, nc, q, h, generator=gen, device="cuda"), dim=2)
        proj = (torch.randn(b, nc, q, 2 * n, generator=gen, device="cuda") * 0.3).to(dtype)
        leaves = [t.requires_grad_() for t in (xdt, cum, proj)]
        return leaves, (xdt.permute(0, 1, 3, 2, 4), cum.permute(0, 1, 3, 2), proj[..., :n],
                        proj[..., n:])

    checks, grads, timings = [], [], []
    for arch, shape in SSD_TRAIN_SHAPES.items():
        b, nc, h, q, p, n = shape
        for dtype in (torch.bfloat16, torch.float32):
            label = [arch, *shape, str(dtype).removeprefix("torch.")]
            leaves, args = leaves_and_args(*shape, dtype)
            y, states = ops.ssd_chunk_dual(*args)
            require(type(y.grad_fn).__name__ == "SSDChunkDualBackward",
                    "ssd_chunk_dual goes through its Function when an input requires grad")
            with torch.no_grad():
                want = ssd.ssd_intra_chunk_plain(*args)
            for part, g, w in zip(("y", "states"), (y, states), want):
                checks.append(compare("SSDChunkDual", label + [part], g.detach(), w,
                                      tol=SSD_TOL))
            dy, dstates = torch.randn_like(y), torch.randn_like(states)
            got = torch.autograd.grad((y, states), leaves, (dy, dstates), retain_graph=True)
            plain_leaves = [t.detach().requires_grad_() for t in leaves]
            x2, c2, p2 = plain_leaves
            y2, s2 = ssd.ssd_intra_chunk_plain(x2.permute(0, 1, 3, 2, 4), c2.permute(0, 1, 3, 2),
                                               p2[..., :n].float(), p2[..., n:].float())
            want = torch.autograd.grad((y2, s2), plain_leaves, (dy, dstates), retain_graph=True)
            for part, g, w in zip(("xdt", "cum", "B|C"), got, want):
                tol = GRAD_TOL[dtype if part == "B|C" else torch.float32]
                err, scale = float((g.float() - w.float()).abs().max()), float(w.abs().max())
                row = {"shape": label, "grad": part, "max_abs_err": err, "max_abs_ref": scale,
                       "rel": err / max(scale, 1e-30), "tol": tol}
                require(bool(torch.isfinite(g).all()) and err <= tol * scale,
                        f"SSDChunkDual backward {row} disagrees with autograd through the "
                        f"exact f32 form")
                grads.append(row)
            pairs = q * (q + 1) // 2
            # Per head dM = dy xdt^T and M^T dy over the causal pairs, B dS and
            # (w xdt) dS^T; per chunk the scores, dC and dB from them.
            flops = b * nc * (h * (4 * pairs * p + 4 * q * n * p) + 6 * pairs * n)
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            # xdt, cum, B, C, dy and dS read; dxdt, dcum, dB and dC written.
            t_bytes = (2 * nbytes(*args) + nbytes(dy, dstates)) / PEAK_BYTES * 1e3
            fn = [time_ms(lambda out=out, ins=ins: torch.autograd.grad(
                out, ins, (dy, dstates), retain_graph=True), reps=10)
                for out, ins in (((y, states), leaves), ((y2, s2), plain_leaves))]
            timings.append({"shape": label, "ms": fn[0][0], "plain_ms": fn[1][0],
                            "library_ms": None, "bound_ms": max(t_ops, t_bytes),
                            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                            "clocks": clocks()})
            del leaves, args, y, states, want, got, plain_leaves, y2, s2, dy, dstates
            torch.cuda.empty_cache()
    log(json.dumps({"ssd_backward": {"checks": checks, "grads": grads, "timings": timings}}))
    return timings


def step_launches(cfg, passes):
    """K1, K2 and K4 launches of one train step's forward passes over the
    layers (1 without remat; 2 under it, where each layer's or hybrid
    group's forward runs again in backward), plus the final norm's K1 (and
    an audio model's enc_final_norm): K1 at both norms of every layer (a
    Mamba layer's norm1 and gated norm) and of every shared-block
    invocation and at 3 of an audio decoder layer, K2 at every attention
    layer or invocation and twice in an audio decoder layer (self and
    cross), K4 at every Mamba layer."""
    L = cfg.n_layers
    groups = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    attention = {"ssm": 0, "hybrid": groups}.get(cfg.family, L)
    mamba = L if cfg.family in ("ssm", "hybrid") else 0
    norms, outside = 2 * L + 2 * groups, 1
    if cfg.family == "audio":
        E = cfg.n_encoder_layers
        norms, attention, outside = 2 * E + 3 * L, E + 2 * L, 2
    return {"fused_rmsnorm": passes * norms + outside,
            "flash_attention": passes * attention, "flash_decode": 0,
            "ssd_chunk_dual": passes * mamba}


def train_batch(data, cfg, step, seq=None):
    """The pipeline's batch of ``step`` on the card: tokens of ``seq``
    (TRAIN_SEQ's, less a vlm's patches) and an audio or vlm model's
    frontend."""
    seq = seq or TRAIN_SEQ.get(cfg.name, PROMPT_LEN)
    if cfg.frontend == "vision_stub":
        seq -= cfg.frontend_len
    return {k: torch.from_numpy(v).cuda()
            for k, v in data.make_batch(cfg, BATCH, seq, SEED, step).items()}


def path_gradients(port, arch):
    """Phase 11(b) and (e): one step's loss and gradients of ``arch`` at full
    width, cut to CHECK_LAYERS[arch] layers, in f32 with TF32 off, from one
    seed-0 model, on the kernel path and on the chunked path: the kernel
    path's exact launches, every parameter with a gradient (for moe, every
    expert of every layer, and an aux loss above 0)."""
    cfg_mod, models, ops, step_mod, data = port["configs"], port["models"], port["ops"], \
        port["train_step"], port["data"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = cfg_mod.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=CHECK_LAYERS[arch], dtype="float32")
    log(json.dumps({"train_check": f"{arch} at full width (d {cfg.d_model}), depth cut "
                                   f"from {full.n_layers} to {cfg.n_layers} layers, f32"}))
    model = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = train_batch(data, full, 0)
    results = {}
    for impl in ("flash", "chunked"):
        run = cfg_mod.RunConfig(attention_impl=impl, attention_chunk=64, remat="none",
                                zero=False)
        ops.reset_launches()
        total, metrics, grads = step_mod._grads(model, cfg, run, batch)
        torch.cuda.synchronize()
        results[impl] = (float(total), float(metrics["aux"]), dict(ops.LAUNCHES), grads)
    (loss_k, aux_k, launches, grads_k), (loss_c, aux_c, launches_c, grads_c) = \
        results["flash"], results["chunked"]
    expect = step_launches(cfg, 1)
    require(launches == expect and sum(launches_c.values()) == 0,
            f"{arch}: the kernel path launches {launches}, expected {expect}")
    rel = abs(loss_k - loss_c) / abs(loss_c)
    require(math.isfinite(loss_k) and rel <= 1e-5, f"{arch}: losses {loss_k} vs {loss_c}")
    if cfg.family == "moe":
        require(aux_k > 0 and abs(aux_k - aux_c) <= 1e-5 * aux_c,
                f"{arch}: aux losses {aux_k} vs {aux_c}")
    worst, experts = {}, 0
    for name, gk in grads_k.items():
        gc = grads_c[name]
        scale = float(gc.abs().max())
        err = float((gk - gc).abs().max())
        require(bool(torch.isfinite(gk).all()) and float(gk.abs().max()) > 0,
                f"{arch}: {name} has no gradient on the kernel path")
        if name.endswith(("moe_wi", "moe_wo")):  # (E, ...): every expert learns
            require(bool((gk.flatten(1).abs().amax(dim=1) > 0).all()),
                    f"{arch}: an expert of {name} has no gradient")
            experts += gk.shape[0]
        require(err <= PATH_GRAD_TOL * scale, f"{arch}: {name}: kernel path gradient off by "
                                              f"{err} against the chunked path's {scale}")
        worst[name] = err / scale
    top = dict(sorted(worst.items(), key=lambda kv: -kv[1])[:6])
    summary = {"model": arch, "layers": cfg.n_layers, "loss_flash": loss_k,
               "loss_chunked": loss_c, "loss_rel": rel, "aux": [aux_k, aux_c],
               "params_with_grad": len(grads_k), "experts_with_grad": experts,
               "launches": launches, "grad_rel_worst": top, "tol": PATH_GRAD_TOL}
    log(json.dumps({"train_paths": summary}))
    del model, results, grads_k, grads_c
    torch.cuda.empty_cache()
    return summary


def step_bound(cfg, model, b, s):
    """The least time of one train step on b x s tokens, counted from the
    config: the matmul FLOPs (6 per weight and position it sees: the
    embedding lookup aside, a tied embedding counted once as the head; for
    moe the active weights, top-k and shared experts; for hybrid the shared
    block once per invocation; a vlm's layers also see its F patches, its
    head only the s tokens; an audio model's encoder and cross K/V weights
    see its F frames), plus attention forward and backward (causal pairs,
    every pair of the audio encoder and cross-attention), at the bf16
    tensor-core peak, then AdamW's bytes (22 per parameter: bf16 p and g
    read, f32 m and v read, p, m and v written) at the memory rate; the
    update needs every gradient, so the two add. The SSD's intra-chunk
    products are left out (a lower bound)."""
    def count(params):
        return sum(p.numel() for p in params)

    def causal(n):
        return n * (n + 1) // 2

    n_params = count(model.parameters())
    d, f = cfg.d_model, cfg.frontend_len
    if cfg.family == "moe":
        weights = cfg.active_param_count() - cfg.vocab * d
    else:
        weights = n_params - (0 if cfg.tie_embeddings else cfg.padded_vocab * d)
    groups = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    if groups:
        shared = [*model.shared_attn.parameters(), *model.shared_mlp.parameters()]
        weights += (groups - 1) * sum(p.numel() for p in shared)
    attention_layers = {"ssm": 0, "hybrid": groups}.get(cfg.family, cfg.n_layers)
    matmul = 6 * weights * b * s
    pairs = attention_layers * causal(s)
    if cfg.family == "vlm":
        matmul += 6 * (weights - cfg.padded_vocab * d) * b * f
        pairs = attention_layers * causal(f + s)
    elif cfg.family == "audio":
        framed = count(model.enc_layers.parameters()) + count(
            p for lp in model.layers for p in (lp.cross.cross_wk, lp.cross.cross_wv))
        matmul += 6 * framed * b * (f - s)
        pairs = cfg.n_encoder_layers * f * f + cfg.n_layers * (causal(s) + s * f)
    attn = 12 * b * cfg.n_heads * pairs * cfg.d_head
    flops = matmul + attn
    nbytes_opt = 22 * n_params
    return {"flops": flops, "flops_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "adamw_bytes": nbytes_opt, "adamw_ms": nbytes_opt / PEAK_BYTES * 1e3,
            "bound_ms": flops / PEAK_BF16_FLOPS * 1e3 + nbytes_opt / PEAK_BYTES * 1e3}


def train_run(port, spec):
    """Phase 11(c) and (f): ``train_loop`` of one entry of TRAIN_RUNS in bf16
    at full width (and depth, unless the entry cuts it), then the step's
    times and, where the entry asks, a checkpoint round trip. Returns the
    summary and the kernel launches of the train_loop run."""
    cfg_mod, ops, train_state, step_mod, loop_mod, data, ckpt = (
        port["configs"], port["ops"], port["train_state"], port["train_step"],
        port["train_loop"], port["data"], port["ckpt"])
    arch, steps = spec["arch"], spec.get("steps", TRAIN_STEPS)
    full = cfg_mod.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec.get("layers", full.n_layers))
    seq = TRAIN_SEQ.get(arch, PROMPT_LEN)
    require(cfg.dtype == "bfloat16", f"{arch} in bf16")
    run = cfg_mod.RunConfig(attention_impl="flash", attention_chunk=64, remat="full",
                            zero=False, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                            total_steps=steps)
    # A batch the run never sees (the pipeline's step 1000), for the loss of
    # the seed-0 initial weights (those train_loop starts from) and of the
    # trained ones: free of the batch-to-batch spread of the step losses.
    models, data_mod = port["models"], port["data"]
    held_out = train_batch(data_mod, cfg, 1000, seq)
    with torch.no_grad():
        initial = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     device="cuda")
        held_before = float(step_mod._loss_fn(initial, cfg, run, held_out)[1]["loss"])
    del initial
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, logged = loop_mod.train_loop(cfg, run, steps=steps, global_batch=BATCH,
                                        seq_len=seq, seed=SEED, log_every=1, device="cuda")
    loop_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # Under remat each layer's (hybrid: each group's) forward runs again in
    # backward; the final norm is outside them.
    per_step = step_launches(cfg, 2)
    expect = {k: steps * v for k, v in per_step.items()}
    log(json.dumps({"model": arch, "train_launches": launches, "expected": expect,
                    "per_step": per_step}))
    require(launches == expect, f"{arch}: kernel launches of train_loop match the path's "
                                f"structure")
    losses = [m["loss"] for m in logged]
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"{arch}: a finite loss every step: {losses}")
    held_after = float(step_mod.eval_step(state, held_out, cfg, run)["loss"])
    if "run" in spec["falls"]:
        require(losses[-1] < losses[0], f"{arch}: the loss falls over {steps} steps: {losses}")
    if "held_out" in spec["falls"]:
        require(held_after < held_before,
                f"{arch}: the held-out loss falls: {held_before} -> {held_after}")

    # Times of further steps on the trained state: the whole step (CUDA
    # events), its forward and backward apart, and one step's device busy
    # time (profiler). These steps and the checkpoint's run on the schedule
    # of a longer run, so that their rate is not 0.
    step_fn = step_mod.make_train_step(cfg, dataclasses.replace(run, total_steps=100))
    params = list(state.params.parameters())

    def batch_at(step):
        return train_batch(data, cfg, step, seq)

    step_ms, fwd_ms, bwd_ms, aux = [], [], [], []
    for i in range(3):
        batch = batch_at(steps + i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        total, _ = step_mod._loss_fn(state.params, cfg, run, batch)
        ev[1].record()
        torch.autograd.grad(total, params)
        ev[2].record()
        torch.cuda.synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
        del total
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        aux.append(float(metrics["aux"]))
    if cfg.family == "moe":
        require(all(a > 0 for a in aux), f"{arch}: the aux loss of every step is above 0: {aux}")
    batch = batch_at(steps + 3)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batch)

    busy, top = device_time(one_step, 1, inference=False)
    state = holder["state"]
    peak = torch.cuda.max_memory_allocated()
    repeated = None
    if "batch" in spec["falls"]:
        probe = batch_at(2000)
        repeated = [float(step_mod.eval_step(state, probe, cfg, run)["loss"])]
        for _ in range(REPEAT_STEPS):
            state, _ = step_fn(state, probe)
            repeated.append(float(step_mod.eval_step(state, probe, cfg, run)["loss"]))
        require(repeated[-1] < repeated[0],
                f"{arch}: a batch's loss falls under {REPEAT_STEPS} steps on it: {repeated}")
    n_params = sum(p.numel() for p in params)
    tokens = BATCH * seq  # as train_loop counts them: a vlm's patches among them
    step = statistics.median(step_ms)
    summary = {"model": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
               "params": n_params, "dtype": cfg.dtype, "batch": BATCH, "seq_len": seq,
               "frontend_len": cfg.frontend_len,
               "remat": run.remat, "losses": losses, "held_out_loss": [held_before, held_after],
               "repeated_batch_loss": repeated,
               "train_loop_s": loop_s, "step_ms": step_ms, "aux": aux,
               "tokens_per_s": tokens / step * 1e3, "forward_ms": fwd_ms,
               "backward_ms": bwd_ms, "step_device_busy_ms": busy,
               "step_device_idle_share": None if busy is None else 1 - busy / step,
               "step_top_kernels_ms": top, "max_memory_allocated": peak,
               "bound": step_bound(cfg, state.params, BATCH, batch["tokens"].shape[1])}
    log(json.dumps({"train": summary}))
    if spec.get("checkpoint"):
        summary["checkpoint"] = checkpoint_round_trip(port, cfg, state, step_fn, batch_at)
    del state, params
    torch.cuda.empty_cache()
    return summary, launches


def checkpoint_round_trip(port, cfg, state, step_fn, batch_at):
    """A checkpoint of the state, restored into a fresh one (another seed):
    bit for bit; then one more step from each on the same batch. The
    embedding's gradient sums by atomics in no fixed order, so the two
    steps agree to bf16 rounding, not bitwise: the loss to 1e-3, and each
    parameter within one bf16 step of its value or 2 lr (an update that
    rounds the other way)."""
    train_state, ckpt = port["train_state"], port["ckpt"]
    directory = checkpoint_dir(cfg.name)
    shutil.rmtree(directory, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        writer = ckpt.AsyncCheckpointer(directory, keep=1)
        writer.save(int(state.step), train_state.state_tree(state, cfg))
        writer.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh = train_state.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(SEED + 1), device="cuda")
        tree, saved_step = ckpt.restore_checkpoint(ckpt.latest_checkpoint(directory),
                                                   train_state.state_tree(fresh, cfg))
        fresh = train_state.load_state_tree(fresh, tree, cfg)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in
                         ckpt.latest_checkpoint(directory).iterdir())
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    require(saved_step == int(state.step) == int(fresh.step)
            and int(fresh.opt.count) == int(state.opt.count), "the restored step and count")
    kept = dict(state.params.named_parameters())
    for name, p in fresh.params.named_parameters():
        require(torch.equal(p, kept[name]) and torch.equal(fresh.opt.mu[name], state.opt.mu[name])
                and torch.equal(fresh.opt.nu[name], state.opt.nu[name]),
                f"{name}: the restored state equals the saved one")
    batch = batch_at(int(state.step))
    state, m_kept = step_fn(state, batch)
    fresh, m_restored = step_fn(fresh, batch)
    lr = float(m_kept["lr"])
    loss_rel = abs(float(m_kept["loss"]) - float(m_restored["loss"])) / float(m_kept["loss"])
    require(loss_rel <= 1e-3, f"loss after restore {float(m_restored['loss'])} vs "
                              f"{float(m_kept['loss'])}")
    worst, off = 0.0, 0
    kept = dict(state.params.named_parameters())
    for name, p in fresh.params.named_parameters():
        diff = (p.detach().float() - kept[name].detach().float()).abs()
        limit = torch.clamp(kept[name].detach().float().abs() * 2 ** -7, min=2 * lr)
        require(bool((diff <= limit).all()), f"{name}: the step from the restored state "
                                             f"moved it {float(diff.max())} from the kept one")
        worst = max(worst, float(diff.max()))
        off += int((diff > 0).sum())
    restore = {"model": cfg.name, "step": saved_step, "save_s": save_s,
               "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
               "loss_kept": float(m_kept["loss"]), "loss_restored": float(m_restored["loss"]),
               "loss_rel": loss_rel, "params_max_abs_diff": worst,
               "params_elements_differing": off}
    log(json.dumps({"train_checkpoint": restore}))
    del fresh, kept
    return restore


def checkpoint_dir(arch):
    return os.path.join(ROOT, "build", "train_ckpt", arch)


def training(port):
    """Phase 11: (a), (d), (b) and (e), (c) and (f). Returns the backward
    timings of (a) and (d), the summaries and the kernel launches of the
    train_loop runs, and each part's seconds."""
    seconds = {}
    t0 = time.perf_counter()
    timings = train_functions(port)
    seconds["training (a) functions"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssd_timings = ssd_backward(port)  # zamba2's shape with bf16 B/C first
    timings["SSDChunkDual.backward"] = {**ssd_timings[0], "timings": ssd_timings}
    seconds["training (d) ssd backward"] = time.perf_counter() - t0
    for arch in CHECK_LAYERS:
        t0 = time.perf_counter()
        path_gradients(port, arch)
        seconds[f"training (b, e) paths {arch}"] = time.perf_counter() - t0
    summaries, launches = [], {}
    for spec in TRAIN_RUNS:
        t0 = time.perf_counter()
        summary, run_launches = train_run(port, spec)
        seconds[f"training (c, f) {spec['arch']}"] = time.perf_counter() - t0
        summaries.append(summary)
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
    return timings, summaries, launches, seconds


def train_schedules(port, arch=TRAIN_ARCH, lrs=(3e-4, TRAIN_LR), seeds=(0, 1, 2, 3, 4, 5),
                    steps=TRAIN_STEPS):
    """Not a phase of ``main``: the spread that (c)'s and (f)'s loss checks
    sit in, for ``arch`` at full width and depth. Prints the seed-0 initial
    weights' loss on the ``steps`` batches the run trains on and on the
    held-out batch, and the first and last step losses of its
    ``train_loop`` (same schedule over ``steps`` steps) at each learning
    rate and seed, with the held-out loss after it. Alone: ``python3 -c
    "import sys; sys.path[:0] = ['.']; import chip_smoke as cs; p =
    cs.port_modules(); p['build'].build(); cs.train_schedules(p)"``
    (``arch="zamba2-2.7b"`` for another model)."""
    cfg_mod, models, step_mod, loop_mod, data = (port["configs"], port["models"],
                                                 port["train_step"], port["train_loop"],
                                                 port["data"])
    cfg = cfg_mod.get_config(arch)
    seq = TRAIN_SEQ.get(arch, PROMPT_LEN)
    run = cfg_mod.RunConfig(attention_impl="flash", attention_chunk=64, remat="full",
                            zero=False, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                            total_steps=steps)
    with torch.no_grad():
        initial = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     device="cuda")
        losses = [float(step_mod._loss_fn(initial, cfg, run, train_batch(data, cfg, i, seq))[1][
            "loss"]) for i in range(steps)]
        held_out = train_batch(data, cfg, 1000, seq)
        held_before = float(step_mod._loss_fn(initial, cfg, run, held_out)[1]["loss"])
    del initial
    log(json.dumps({"model": arch, "initial_weights_batch_losses": losses,
                    "held_out_before": held_before}))
    rows = []
    for lr in lrs:
        for seed in seeds:
            state, logged = loop_mod.train_loop(
                cfg, dataclasses.replace(run, learning_rate=lr), steps=steps,
                global_batch=BATCH, seq_len=seq, seed=seed, log_every=steps, device="cuda")
            first, last = logged[0]["loss"], logged[-1]["loss"]
            held = float(step_mod.eval_step(state, held_out, cfg, run)["loss"])
            rows.append({"model": arch, "lr": lr, "seed": seed, "steps": steps, "first": first,
                         "last": last, "falls": last < first, "held_out_after": held})
            log(json.dumps({"train_schedule": rows[-1]}))
            del state
            torch.cuda.empty_cache()
    return losses, rows


# ---------------------------------------------------------------------------
# Phase 12: the sharding layer
# ---------------------------------------------------------------------------

SHARD_ARCH = "tinyllama-1.1b"


def mesh_step(port):
    """Phase 12(a): a one-rank NCCL group and a 1 x 1 mesh; a checkpoint of
    the model after one step (saved here, with ``save_checkpoint``)
    restored onto it by ``apply_resize``, every leaf bit for bit; one train
    step's loss and gradients with the state distributed by
    ``state_shardings`` under the mesh context (``seq_shard``, ``zero`` and
    ``fsdp`` on) against the same step without a mesh; the exact launches
    of both; the mesh step's ms and device idle share. Returns the summary
    and the mesh step's launches."""
    dist = torch.distributed
    cfg_mod, ops, train_state, step_mod, data, ckpt = (
        port["configs"], port["ops"], port["train_state"], port["train_step"], port["data"],
        port["ckpt"])
    elastic, sharding = port["elastic"], port["sharding"]
    cfg = cfg_mod.get_config(SHARD_ARCH)
    run = cfg_mod.RunConfig(attention_impl="flash", attention_chunk=64, remat="full",
                            zero=True, fsdp=True, seq_shard=True, learning_rate=TRAIN_LR,
                            warmup_steps=TRAIN_WARMUP, total_steps=100)
    directory = checkpoint_dir(SHARD_ARCH)
    shutil.rmtree(directory, ignore_errors=True)
    saved_state = train_state.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 2), device="cuda")
    saved_state, _ = step_mod.make_train_step(cfg, run)(saved_state, train_batch(data, cfg, 0))
    ckpt.save_checkpoint(directory, int(saved_state.step),
                         train_state.state_tree(saved_state, cfg))
    del saved_state
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        plan = elastic.plan_resize(1, 1, BATCH, TRAIN_LR, device="cuda")
        mesh = plan.mesh_ctx.mesh
        require(type(mesh).__name__ == "DeviceMesh" and mesh.device_type == "cuda"
                and sharding.mesh_shape(mesh) == {"data": 1, "model": 1},
                f"a 1 x 1 DeviceMesh on the card: {mesh!r}")
        t0 = time.perf_counter()
        state, step = elastic.apply_resize(plan, cfg, run, directory, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        tree = train_state.state_tree(state, cfg)
        saved, saved_step = ckpt.restore_checkpoint(ckpt.latest_checkpoint(directory), tree)
        flat, want = ckpt.ckpt._flatten(tree), ckpt.ckpt._flatten(saved)
        require(step == saved_step == int(state.step) and flat.keys() == want.keys(),
                "apply_resize: the checkpoint's step and leaves")
        for key, t in flat.items():
            require(torch.equal(t, want[key]),
                    f"apply_resize: {key} differs from the checkpoint")
        leaves = len(flat)
        del tree, saved, flat, want

        plain = copy.deepcopy(state)
        on_mesh = train_state.distribute_state(state, train_state.state_shardings(
            state, plan.mesh_ctx, run))
        require(sharding.is_distributed(on_mesh.params.embed)
                and sharding.is_distributed(on_mesh.opt.mu["embed"]),
                "the state's tensors are DTensors on the mesh")
        batch = train_batch(data, cfg, step)
        ops.reset_launches()
        loss0, _, grads0 = step_mod._grads(plain.params, cfg, run, batch)
        torch.cuda.synchronize()
        launches0 = dict(ops.LAUNCHES)
        sharding.set_mesh_context(plan.mesh_ctx)
        try:
            ops.reset_launches()
            loss1, _, grads1 = step_mod._grads(on_mesh.params, cfg, run, batch)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            expect = step_launches(cfg, 2)
            require(launches == launches0 == expect,
                    f"mesh step launches {launches}, without a mesh {launches0}, "
                    f"expected {expect}")
            loss1 = float(loss1.full_tensor())
            rel = abs(loss1 - float(loss0)) / abs(float(loss0))
            require(math.isfinite(loss1) and rel <= 1e-5,
                    f"mesh step loss {loss1} against {float(loss0)}")
            worst = 0.0
            for name, g0 in grads0.items():
                g1 = grads1[name].full_tensor()
                scale = float(g0.float().abs().max())
                err = float((g1.float() - g0.float()).abs().max())
                require(bool(torch.isfinite(g1.float()).all()) and err <= PATH_GRAD_TOL * scale,
                        f"mesh step: {name} gradient off by {err} against {scale}")
                worst = max(worst, err / max(scale, 1e-30))
            del grads0, grads1
            step_fn = step_mod.make_train_step(cfg, run)
            step_ms = []
            holder = {"state": on_mesh}
            for i in range(3):
                b = train_batch(data, cfg, step + 1 + i)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                holder["state"], metrics = step_fn(holder["state"], b)
                end.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
            b = train_batch(data, cfg, step + 4)

            def one_step():
                holder["state"], _ = step_fn(holder["state"], b)

            busy, top = device_time(one_step, 1, inference=False)
        finally:
            sharding.set_mesh_context(None)
        plain_ms = []
        for i in range(3):
            b = train_batch(data, cfg, step + 1 + i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain, _ = step_fn(plain, b)
            end.record()
            torch.cuda.synchronize()
            plain_ms.append(start.elapsed_time(end))
        median = statistics.median(step_ms)
        summary = {"model": SHARD_ARCH, "mesh": sharding.mesh_shape(mesh), "step": step,
                   "restore_s": restore_s, "leaves": leaves, "run": {
                       "seq_shard": run.seq_shard, "zero": run.zero, "fsdp": run.fsdp,
                       "remat": run.remat},
                   "loss_mesh": loss1, "loss_plain": float(loss0), "loss_rel": rel,
                   "grad_rel_worst": worst, "tol": PATH_GRAD_TOL, "launches": launches,
                   "step_ms": step_ms, "plain_step_ms": plain_ms,
                   "tokens_per_s": BATCH * PROMPT_LEN / median * 1e3,
                   "step_device_busy_ms": busy,
                   "step_device_idle_share": None if busy is None else 1 - busy / median,
                   "step_top_kernels_ms": top}
        log(json.dumps({"mesh_step": summary}))
        del state, plain, on_mesh, holder
        torch.cuda.empty_cache()
        return summary, launches
    finally:
        dist.destroy_process_group()
        shutil.rmtree(os.path.dirname(directory), ignore_errors=True)


# (c): the tolerances of tests/test_torch_distributed.py's four-rank test:
# loss and metrics to 1e-6 of themselves, gradients and moments to 1e-5 of
# each tensor's largest element, parameters after AdamW to 2 learning rates.
GLOO_MESHES = ("2x2", "1x4")
GLOO_TOL = {"loss": 1e-6, "metric": 1e-6, "grad": 1e-5, "mu": 1e-5, "nu": 1e-5,
            "param": 2.0, "step": 0.0}


def gloo_meshes(port):
    """Phase 12(c): ``tests/torch_mesh_worker.py`` on each of GLOO_MESHES
    (four processes each, both meshes at once, every architecture), each
    worker in a session of its own so that a timeout stops all its
    processes. Returns a row per (mesh, architecture)."""
    archs = sorted(port["configs"].list_archs())
    out_dir = os.path.join(ROOT, "build", "gloo_meshes")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {mesh: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"), *mesh.split("x"),
         os.path.join(out_dir, f"{mesh}.json"), *archs], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True) for mesh in GLOO_MESHES}
    logs = {}
    try:
        for mesh, proc in procs.items():
            logs[mesh] = proc.communicate(timeout=600)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    rows = []
    for mesh, proc in procs.items():
        require(proc.returncode == 0, f"gloo mesh {mesh}: exit {proc.returncode}\n"
                                      f"{logs[mesh][-3000:]}")
        with open(os.path.join(out_dir, f"{mesh}.json")) as f:
            results = json.load(f)
        for arch in archs:
            r = results[arch]
            require("error" not in r, f"gloo mesh {mesh}, {arch}:\n{r.get('error', '')[-3000:]}")
            worst = {}
            for key, v in r["errors"].items():
                kind = key.split()[0]
                worst[kind] = max(worst.get(kind, 0.0), v)
            for kind, v in worst.items():
                require(v <= GLOO_TOL[kind], f"gloo mesh {mesh}, {arch}: {kind} off by {v}, "
                                             f"above {GLOO_TOL[kind]}")
            require(r["placements"]["residual"] == ["(Shard(dim=0), Shard(dim=1))"],
                    f"gloo mesh {mesh}, {arch}: the residual stream held "
                    f"{r['placements']['residual']}")
            row = {"mesh": mesh, "model": arch, "worst": worst, "tol": GLOO_TOL,
                   "placements": r["placements"]}
            rows.append(row)
            log(json.dumps({"gloo_mesh": row}))
    shutil.rmtree(out_dir, ignore_errors=True)
    return rows


def capacity_plan(port):
    """Phase 12(b), arithmetic only: per architecture, the bytes of its whole
    state (bf16 parameters, f32 moments) and of its weights, and each
    device's share of ``state_shardings`` with ZeRO and FSDP on the 16 x 16
    and 2 x 16 x 16 meshes (planning meshes: no device is touched)."""
    cfg_mod, train_state, sharding, mesh_mod = (port["configs"], port["train_state"],
                                                port["sharding"], port["mesh"])
    meshes = {"16x16": (("data", 16), ("model", 16)),
              "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}
    run = cfg_mod.RunConfig(zero=True, fsdp=True)
    rows = []
    for arch in sorted(cfg_mod.list_archs()):
        state = train_state.abstract_train_state(cfg_mod.get_config(arch))
        params = dict(state.params.named_parameters())
        weights = sum(p.numel() * p.element_size() for p in params.values())
        whole = weights + 2 * sum(m.numel() * 4 for m in state.opt.mu.values()) + 8
        row = {"model": arch, "params": sum(p.numel() for p in params.values()),
               "weights_bytes": weights, "state_bytes": whole, "per_device_bytes": {}}
        for label, axes in meshes.items():
            mesh = mesh_mod.AbstractMesh(axes)
            ctx = sharding.MeshContext(mesh, data_axes=tuple(a for a, _ in axes[:-1]))
            sh = train_state.state_shardings(state, ctx, run)
            zero = [0] * len(axes)

            def local(t, spec):
                shape, _ = sharding.local_shape_and_offset(tuple(t.shape), mesh, spec, zero)
                return math.prod(shape)

            per_device = 8 + sum(local(p, sh.params[k].spec) * p.element_size()
                                 for k, p in params.items())
            per_device += sum(4 * (local(m, sh.opt.mu[k].spec) + local(m, sh.opt.nu[k].spec))
                              for k, m in state.opt.mu.items())
            row["per_device_bytes"][label] = per_device
        rows.append(row)
        log(json.dumps({"capacity": row}))
        del state, params
    return rows


# Phase 13(a): the dry run's cells, four processes at a time, the longest
# first; yi-9b's long_500k is a documented skip.
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
                ("tinyllama-1.1b", "decode_32k"), ("mamba2-130m", "long_500k"),
                ("yi-9b", "long_500k"))
DRYRUN_JOBS = 4
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")


def dry_run_start():
    """Starts phase 13(a), the dry-run CLI over DRYRUN_CELLS, in a session
    of its own; ``dry_run_finish`` reads it."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda",
           "--jobs", str(DRYRUN_JOBS), "--out", DRYRUN_OUT]
    for arch, shape in DRYRUN_CELLS:
        cmd += ["--cell", f"{arch}:{shape}"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, cwd=ROOT)


def dry_run_finish(port, proc):
    """Phase 13(a): waits for the dry run, holds its count of cells, its
    skip and its rows (nothing unmapped, positive compute and memory terms,
    a memory estimate), prints a line per row and ``roofline_table``'s
    table and candidates over them. Returns the rows."""
    try:
        out = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    lines = out.splitlines()
    for line in lines:
        if line.startswith(("OK ", "SKIP ", "FAIL ")) or "cells OK" in line:
            log(f"  dryrun: {line}")
    n = len(DRYRUN_CELLS)
    require(proc.returncode == 0 and f"{n}/{n} cells OK" in out,
            f"dry run: exit {proc.returncode}\n{out[-4000:]}")
    require(any(line.startswith("SKIP  yi-9b x long_500k") for line in lines),
            "dry run: yi-9b x long_500k must be a documented skip")
    rows = port["roofline_table"].load_rows(DRYRUN_OUT)
    ran = sorted((r["arch"], r["shape"]) for r in rows)
    require(ran == sorted(c for c in DRYRUN_CELLS if c[0] != "yi-9b"),
            f"dry run: rows for {ran}")
    keys = ("compute_s", "memory_s", "collective_s", "dominant", "bound_s", "useful_ratio",
            "arg_bytes", "out_bytes", "alias_bytes", "temp_bytes", "memory_per_device",
            "mem_per_device_adjusted", "collectives", "lower_s", "compile_s", "chips")
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        require(r["unmapped"] == [], f"dry run {r['arch']} x {r['shape']}: unmapped "
                                     f"{r['unmapped']}")
        require(r["chips"] == 256 and r["compute_s"] > 0 and r["memory_s"] > 0
                and r["temp_bytes"] > 0 and r["arg_bytes"] > 0,
                f"dry run {r['arch']} x {r['shape']}: {r}")
        log(json.dumps({"dryrun": {"arch": r["arch"], "shape": r["shape"],
                                   "mesh": r["mesh"], **{k: r[k] for k in keys}}}))
    table = port["roofline_table"]
    for line in table.fmt_table(rows, "16x16").splitlines():
        log(f"  {line}")
    for k, v in table.candidates(rows).items():
        log(f"  - {k}: {v}")
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    return rows


def traced_step(port):
    """Phase 13(b): on a one-rank NCCL group and a 1 x 1 mesh, the dry run's
    trace of phase 11's tinyllama-1.1b step (bf16, BATCH x PROMPT_LEN) under
    its own run config, its row and roofline; then the same step run on the
    card with a real state placed by ``state_shardings``: the traced
    arguments' bytes equal to the live state's and batch's, the median of
    three timed steps at least the traced bound, and the allocator's peak
    beside the traced arg + temp + out bytes. Returns the summary."""
    dist = torch.distributed
    cfg_mod, dryrun, train_state, step_mod, data, mesh_mod, sharding = (
        port["configs"], port["dryrun"], port["train_state"], port["train_step"],
        port["data"], port["mesh"], port["sharding"])
    cfg = cfg_mod.get_config(TRAIN_ARCH)
    shape = cfg_mod.base.ShapeConfig("phase11", PROMPT_LEN, BATCH, "train")
    run = dryrun.default_run_config(cfg, shape)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        ctx = mesh_mod.make_elastic_mesh_context(1, device="cuda")
        t0 = time.perf_counter()
        gm, inputs = dryrun.trace_cell(cfg, shape, run, ctx, "cuda")
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        row, report, _ = dryrun.cell_row(gm, inputs, f"{TRAIN_ARCH}/phase11",
                                         port["specs"].model_flops_estimate(cfg, shape))
        lower_s = time.perf_counter() - t0
        del gm, inputs
        require(row["unmapped"] == [], f"traced step: unmapped {row['unmapped']}")
        log(report.render())

        state = train_state.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        state = train_state.distribute_state(state, train_state.state_shardings(
            state, ctx, run))
        batches = [{k: v.to(torch.int32) for k, v in train_batch(data, cfg, i).items()}
                   for i in range(4)]
        local = [*state.params.parameters(), *state.opt.mu.values(), *state.opt.nu.values(),
                 state.opt.count, state.step, *batches[0].values()]
        live = sum((t.to_local() if sharding.is_distributed(t) else t).numel()
                   * t.element_size() for t in local)
        require(live == row["arg_bytes"],
                f"traced step: arguments {row['arg_bytes']} B, live state and batch {live} B")
        step_fn = step_mod.make_train_step(cfg, run)
        sharding.set_mesh_context(ctx)
        try:
            holder = {"state": state}
            holder["state"], metrics = step_fn(holder["state"], batches[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step_ms = []
            for b in batches[1:]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                holder["state"], metrics = step_fn(holder["state"], b)
                end.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated()
        finally:
            sharding.set_mesh_context(None)
        loss = float(metrics["loss"].full_tensor())
        require(math.isfinite(loss), f"traced step: loss {loss}")
        median = statistics.median(step_ms)
        bound_ms = row["bound_s"] * 1e3
        require(median >= bound_ms,
                f"traced step: measured {median} ms beats the traced bound {bound_ms} ms")
        summary = {"model": TRAIN_ARCH, "batch": [BATCH, PROMPT_LEN], "run": {
                       "attention_impl": run.attention_impl, "remat": run.remat,
                       "zero": run.zero, "fsdp": run.fsdp, "seq_shard": run.seq_shard},
                   "trace_s": trace_s, "lower_s": lower_s, "loss": loss,
                   "step_ms": step_ms, "bound_ms": bound_ms,
                   "measured_over_bound": median / bound_ms,
                   "dominant": row["dominant"], "compute_s": row["compute_s"],
                   "memory_s": row["memory_s"], "collective_s": row["collective_s"],
                   "arg_bytes": row["arg_bytes"], "live_arg_bytes": live,
                   "out_bytes": row["out_bytes"], "alias_bytes": row["alias_bytes"],
                   "temp_bytes": row["temp_bytes"], "traced_bytes": row["memory_per_device"],
                   "allocator_peak_bytes": peak, "allocator_base_bytes": base,
                   "peak_over_traced": peak / row["memory_per_device"]}
        log(json.dumps({"traced_step": summary}))
        del state, holder, batches, metrics
        torch.cuda.empty_cache()
        return summary
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------


def port_modules():
    """The port's modules this script drives, imported from ``src/``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    return {
        "build": importlib.import_module("repro_torch.kernels._build"),
        "ops": importlib.import_module("repro_torch.kernels.ops"),
        "rms": importlib.import_module("repro_torch.kernels.rmsnorm"),
        "fa": importlib.import_module("repro_torch.kernels.flash_attention"),
        "da": importlib.import_module("repro_torch.kernels.decode_attention"),
        "ssd": importlib.import_module("repro_torch.kernels.ssd_scan"),
        "configs": importlib.import_module("repro_torch.configs"),
        "models": importlib.import_module("repro_torch.models"),
        "serving": importlib.import_module("repro_torch.serving"),
        "api": importlib.import_module("repro_torch.api"),
        "analysis": importlib.import_module("repro_torch.core.analysis"),
        "sweep": importlib.import_module("repro_torch.core.analysis.sweep"),
        "batch": importlib.import_module("repro_torch.core.analysis.batch"),
        "registry": importlib.import_module("repro_torch.core.registry"),
        "serving_analysis": importlib.import_module("repro_torch.serving.analysis"),
        "faults": importlib.import_module("repro_torch.serving.faults"),
        "resilience": importlib.import_module("repro_torch.serving.resilience"),
        "calibration": importlib.import_module("repro_torch.core.calibration"),
        "hlo": importlib.import_module("repro_torch.core.hlo"),
        "hlo_export": importlib.import_module("repro_torch.core.hlo.export"),
        "hlo_costs": importlib.import_module("repro_torch.core.hlo.costs"),
        "ibench": importlib.import_module("repro_torch.core.bench.ibench"),
        "layers": importlib.import_module("repro_torch.models.layers"),
        "train": importlib.import_module("repro_torch.train"),
        "train_step": importlib.import_module("repro_torch.train.step"),
        "train_state": importlib.import_module("repro_torch.train.state"),
        "train_loop": importlib.import_module("repro_torch.launch.train"),
        "data": importlib.import_module("repro_torch.data"),
        "ckpt": importlib.import_module("repro_torch.checkpoint"),
        "sharding": importlib.import_module("repro_torch.distributed.sharding"),
        "mesh": importlib.import_module("repro_torch.launch.mesh"),
        "elastic": importlib.import_module("repro_torch.launch.elastic"),
        "specs": importlib.import_module("repro_torch.launch.specs"),
        "dryrun": importlib.import_module("repro_torch.launch.dryrun"),
        "roofline_table": importlib.import_module("repro_torch.launch.roofline_table"),
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    port = port_modules()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": name, "count": torch.cuda.device_count()}))

    seconds = {}
    t0 = time.perf_counter()
    build_logs = port["build"].build()
    seconds["build"] = time.perf_counter() - t0
    log(json.dumps({"build_s": seconds["build"], "built": sorted(build_logs)}))
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                log(f"  {src}: {entry_label(line)}")
            elif "registers" in line or "spill" in line:
                log(f"  {src}:   {line.strip()}")

    t0 = time.perf_counter()
    kernels = check_kernels(port)
    seconds["kernels"] = time.perf_counter() - t0
    launches = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        _, run_launches = serve(port, name, phase)
        seconds[f"serve {phase['arch']}"] = time.perf_counter() - t0
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
    for label, fn in (("analyzer", analyzer), ("waves", waves), ("service", service),
                      ("calibration", calibration), ("accelerator graphs", accelerator_graphs),
                      ("ibench", ibench)):
        t0 = time.perf_counter()
        fn(port)
        seconds[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    backward_timings, _, train_launches, train_seconds = training(port)
    seconds["training"] = time.perf_counter() - t0
    seconds.update(train_seconds)
    for k, v in train_launches.items():
        launches[k] += v
    t0 = time.perf_counter()
    _, mesh_launches = mesh_step(port)
    seconds["sharding (a) mesh step"] = time.perf_counter() - t0
    for k, v in mesh_launches.items():
        launches[k] += v
    t0 = time.perf_counter()
    capacity_plan(port)
    seconds["sharding (b) capacity plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo_meshes(port)
    seconds["sharding (c) gloo meshes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry_run = dry_run_start()
    try:
        traced_step(port)
    except BaseException:
        os.killpg(dry_run.pid, 9)
        raise
    seconds["dry run (b) traced step"] = time.perf_counter() - t0
    dry_run_finish(port, dry_run)
    seconds["dry run (a) cells"] = time.perf_counter() - t0
    log(json.dumps({"phase_seconds": seconds}))

    sources = {
        "fused_rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:19"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:79"),
        "flash_decode": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:63"),
        "ssd_chunk_dual": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:57"),
    }
    rows = []
    for kname, (src, replaces) in sources.items():
        k = kernels[kname]
        t = k["timings"][0]
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us",
                "clocks")
        backward = {"fused_rmsnorm": "FusedRMSNorm.backward",
                    "flash_attention": "FlashAttention.backward",
                    "ssd_chunk_dual": "SSDChunkDual.backward"}.get(kname)
        rows.append({"name": kname, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                     "launches": launches[kname],
                     "max_abs_err": max(c["max_abs_err"] for c in k["checks"]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "shape": t["shape"],
                     "timings": [{key: r[key] for key in keys + ("library_kernels",) if key in r}
                                 for r in k["timings"]],
                     "backward": backward and {"function": backward,
                                               **backward_timings[backward]}})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
