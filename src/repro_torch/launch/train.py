"""Training driver: ``python -m repro_torch.launch.train --arch <id>``.

Wires the substrate together as ``repro.launch.train`` does: config
registry, train state, deterministic data pipeline, train step, async
checkpointing and heartbeat/straggler monitoring. One device and no mesh
(sharding is ROADMAP item 9). It runs on the CUDA device unless ``--device
cpu`` is given, through the kernel-backed ops (``attention_impl="flash"``:
K1 at every norm, K2 at every attention layer, K4 at every Mamba layer); it
trains the tiny variant unless ``--no-tiny``. Every family trains (e.g.
``--arch tinyllama-1.1b``, ``--arch deepseek-moe-16b``, ``--arch
mamba2-130m``, ``--arch zamba2-2.7b``, ``--arch whisper-base``, ``--arch
phi-3-vision-4.2b``; an audio or vlm model on the pipeline's seeded frame or
patch embeddings, a vlm's ``--seq-len`` counting its patches).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import Device, resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_checkpoint, restore_checkpoint
from repro_torch.configs import RunConfig, get_config, list_archs, tiny_variant
from repro_torch.data import DataPipeline
from repro_torch.launch.ft import HeartbeatRegistry, StragglerDetector
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.state import load_state_tree, state_tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg, run: RunConfig, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir=None, seed: int = 0, checkpoint_every: int = 0,
               log_every: int = 10, restore: bool = True, device: Device = None):
    """Train ``steps`` steps from seed ``seed`` (or from the latest
    checkpoint in ``ckpt_dir``); returns (state, [{"step", "loss",
    "tokens_per_s"} per logged step])."""
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, run)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    start_step = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and restore:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            tree, start_step = restore_checkpoint(path, state_tree(state, cfg))
            state = load_state_tree(state, tree, cfg)
            print(f"restored checkpoint @ step {start_step}")

    pipeline = DataPipeline(cfg, global_batch, seq_len, seed=seed, start_step=start_step,
                            device=dev)
    hb = HeartbeatRegistry(timeout_s=120.0)
    stragglers = StragglerDetector()
    host = "host0"
    try:
        metrics_out = []
        t_wall = time.time()
        for step in range(start_step, start_step + steps):
            batch = next(pipeline)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            _sync(dev)
            dt = time.time() - t0
            hb.beat(host)
            stragglers.record(host, dt)
            if (step + 1) % log_every == 0 or step == start_step:
                loss = float(metrics["loss"])
                toks = global_batch * seq_len / dt
                print(f"step {step + 1:5d}  loss {loss:8.4f}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  "
                      f"{toks:,.0f} tok/s  {dt * 1e3:.0f} ms/step")
                metrics_out.append({"step": step + 1, "loss": loss, "tokens_per_s": toks})
            if ckpt and checkpoint_every and (step + 1) % checkpoint_every == 0:
                ckpt.save(step + 1, state_tree(state, cfg))
        if ckpt:
            ckpt.save(start_step + steps, state_tree(state, cfg))
            ckpt.wait()
    finally:
        pipeline.close()
    wall = time.time() - t_wall
    print(f"done: {steps} steps in {wall:.1f}s "
          f"({steps * global_batch * seq_len / wall:,.0f} tok/s sustained) on {dev}")
    return state, metrics_out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny_variant(cfg)
    run = RunConfig(attention_impl="flash", attention_chunk=64, remat="full", zero=False,
                    warmup_steps=20, total_steps=args.steps)
    train_loop(cfg, run, steps=args.steps, global_batch=args.global_batch,
               seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
               checkpoint_every=args.checkpoint_every, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
