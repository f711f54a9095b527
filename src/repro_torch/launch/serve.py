"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Randomly initializes a model of the dense, ssm or hybrid family (e.g.
``--arch tinyllama-1.1b``, ``--arch mamba2-130m``, ``--arch zamba2-2.7b``;
weights from a ``torch.Generator`` with seed 0; the tiny variant unless
``--no-tiny``) and serves a batch of synthetic requests through the
continuous-batching engine, on the CUDA device unless ``--device cpu`` is
given. Prints the tokens per second and the device it ran on.

Only ``--mode generate`` is ported; kernel-analysis serving
(``--mode analyze`` in ``repro.launch.serve``) waits for its own slice.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs, tiny_variant


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="generate", choices=("generate",))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    args = ap.parse_args(argv)

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

    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=args.max_new_tokens)
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
