"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Randomly initializes a model of any family (e.g. ``--arch tinyllama-1.1b``,
``--arch deepseek-moe-16b``, ``--arch mamba2-130m``, ``--arch
zamba2-2.7b``, ``--arch whisper-base``, ``--arch phi-3-vision-4.2b``;
weights from a ``torch.Generator`` with seed 0; the tiny variant unless
``--no-tiny``) and serves a batch of synthetic requests through the
continuous-batching engine, on the CUDA device unless ``--device cpu`` is
given. An audio or vlm model gets the reference's stub frontend, ones of
shape (batch, frontend_len, d_model) in bf16. Prints the tokens per second
and the device it ran on.

``--mode analyze`` serves *kernel-analysis* traffic instead, through the
versioned ``AnalysisService`` request/response API, as
``repro.launch.serve --mode analyze`` does, with the analyses' tensor passes
on ``--device``.  ``--arch`` then names a machine from the architecture
registry (``tx2``/``csx``/``zen``/… or any alias, not an LLM config id), and
``--kernel-file`` analyzes a specific assembly file instead of the built-in
hot-loop pool.  Output is JSON lines — one ``AnalysisResponse.to_dict()`` per
request (malformed requests come back as per-request error envelopes) plus a
final summary object — so other tools can consume the analyses directly.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs, tiny_variant


def _predictors(args) -> tuple:
    if not args.predictors:
        return ()
    return tuple(p.strip() for p in args.predictors.split(",") if p.strip())


def _analysis_pool(args):
    from repro_torch.core.registry import get_arch
    from repro_torch.serving.analysis import AnalysisRequest

    preds = _predictors(args)
    diag = bool(getattr(args, "diagnose", False))
    if args.kernel_file:
        with open(args.kernel_file) as f:
            asm = f.read()
        arch = get_arch(args.arch or "tx2").id
        return [AnalysisRequest(asm=asm, arch=arch, unroll=args.unroll,
                                name=args.kernel_file, predictors=preds,
                                diagnose=diag)]
    if args.arch:
        spec = get_arch(args.arch)
        if spec.sample_asm is None:
            raise SystemExit(f"arch '{spec.id}' has no built-in sample kernel; "
                             f"pass --kernel-file")
        return [
            AnalysisRequest(asm=spec.sample_asm, arch=spec.id, unroll=u,
                            name=f"{spec.id}-gauss-seidel/{u}x",
                            predictors=preds, diagnose=diag)
            for u in (1, args.unroll)
        ]
    # Default synthetic traffic: a stream of requests drawn from a few hot
    # kernels, the common shape of analysis-in-a-tuning-loop workloads.
    # The 4x requests use the corpus kernel name so --measurements can join
    # recorded ground truth (corpora record the sample kernel at 4x unroll).
    tx2, csx = get_arch("tx2"), get_arch("csx")
    return [
        AnalysisRequest(asm=tx2.sample_asm, arch="tx2", unroll=args.unroll,
                        name="gauss-seidel", predictors=preds, diagnose=diag),
        AnalysisRequest(asm=csx.sample_asm, arch="csx", unroll=args.unroll,
                        name="gauss-seidel", predictors=preds, diagnose=diag),
        AnalysisRequest(asm=tx2.sample_asm, arch="tx2", unroll=1,
                        name="gs-tx2-1x", predictors=preds, diagnose=diag),
    ]


def _analysis_service(args):
    """Build the service; resilience turns on when any knob is set."""
    from repro_torch.serving.analysis import AnalysisService
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.resilience import ResilienceConfig

    resilience = None
    if args.deadline_ms > 0 or args.queue_depth > 0 or args.fault_rate > 0:
        resilience = ResilienceConfig(
            request_timeout_s=args.deadline_ms / 1e3,
            max_queue_depth=args.queue_depth,
            min_rung=args.min_rung)
    faults = None
    if args.fault_rate > 0:
        # Spread the configured rate over the expensive stage boundaries.
        faults = FaultInjector(seed=args.fault_seed, rates={
            "stage:dag": args.fault_rate,
            "stage:cp": args.fault_rate,
            "stage:lcd": args.fault_rate,
            "stage:sim": args.fault_rate,
        })
    return AnalysisService(resilience=resilience, faults=faults,
                           measurements_dir=args.measurements or None,
                           device=args.device)


def _serve_analysis(args) -> None:
    try:
        pool = _analysis_pool(args)
    except (ValueError, OSError) as exc:  # unknown arch / bad --kernel-file
        sys.exit(str(exc))
    rng = np.random.default_rng(0)
    requests = [pool[i] for i in rng.integers(0, len(pool), size=args.requests)]

    service = _analysis_service(args)
    t0 = time.time()
    responses = []
    for start in range(0, len(requests), args.batch_size):
        responses.extend(
            service.submit_batch(requests[start:start + args.batch_size]))
    dt = time.time() - t0

    for resp in responses:
        print(json.dumps(resp.to_dict()))
    print(json.dumps({
        "event": "summary",
        "requests": len(responses),
        "errors": sum(1 for r in responses if not r.ok),
        "degraded": sum(1 for r in responses if r.degraded),
        "shed": service.counters["shed"],
        "retries": service.counters["retries"],
        "seconds": dt,
        "req_per_s": len(responses) / max(dt, 1e-9),
        "cache_hits": service.stats["hits"],
        "cache_misses": service.stats["misses"],
        "device": service.device.type,
    }))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="generate", choices=("generate", "analyze"))
    # Validated per mode: an LLM config id when generating, an architecture-
    # registry id/alias when analyzing.
    ap.add_argument("--arch", default=None)
    ap.add_argument("--kernel-file", default=None,
                    help="assembly file to analyze (--mode analyze)")
    ap.add_argument("--unroll", type=int, default=4)
    # Resilience knobs (--mode analyze): any of these switches the service
    # onto the resilient path (deadlines, backpressure, degradation ladder).
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request analysis deadline (0 = none)")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="admission bound; excess load is shed with "
                         "OVERLOADED + retry_after (0 = unbounded)")
    ap.add_argument("--min-rung", default="parse_only",
                    choices=("full", "bracket", "tp_only", "parse_only"),
                    help="cheapest degradation rung allowed")
    ap.add_argument("--predictors", default="",
                    help="comma-separated predictor subset "
                         "(tp,cp,lcd,sim; empty = all)")
    ap.add_argument("--diagnose", action="store_true",
                    help="attach structured bottleneck findings "
                         "(schema-v5 report 'findings') to each analysis")
    ap.add_argument("--measurements", default="",
                    help="directory of recorded measurement corpora "
                         "(<arch>.json); matching kernels get schema-v5 "
                         "measured_block ground truth joined in, and "
                         "--diagnose then reports PREDICTION_DRIFT")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="deterministic injected fault rate per stage site")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.mode == "analyze":
        _serve_analysis(args)
        return

    arch = args.arch or "tinyllama-1.1b"
    if arch not in list_archs():
        sys.exit(f"unknown model config '{arch}'; known: "
                 f"{', '.join(list_archs())}")
    device = resolve_device(args.device)

    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch)
    if args.tiny:
        cfg = tiny_variant(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    engine = ServeEngine(cfg, params, batch_size=args.batch_size, device=device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len).tolist()
               for _ in range(args.requests)]

    frontend = None
    if cfg.frontend != "none":
        frontend = torch.ones((args.batch_size, cfg.frontend_len, cfg.d_model),
                              dtype=torch.bfloat16, device=device)

    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=args.max_new_tokens,
                              frontend=frontend)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.tokens) for r in results)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{len(results)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {name}")
    for r in results[:4]:
        print(f"  req {r.request_id}: {r.tokens[:12]}")


if __name__ == "__main__":
    main()
