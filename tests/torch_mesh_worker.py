"""A train step of a tiny model on a gloo mesh of several CPU processes,
against the same step without a mesh; run by
``tests/test_torch_distributed.py``. With ``--serve``, the serve path and
the loss's sharded argmax instead; run by ``tests/test_torch_dryrun.py``.

    python tests/torch_mesh_worker.py [--serve] DATA MODEL OUT.json ARCH [ARCH ...]

starts DATA x MODEL processes, one rank each, on a gloo group over a file
store beside OUT.json. For each architecture, every rank builds the same
tiny f32 state from seed 0, takes ``_grads`` and one ``train_step`` without a mesh, then the same on
a ``("data", "model")`` mesh with ``seq_shard``, ``zero`` and ``fsdp`` on and
the state distributed by ``state_shardings``. Rank 0 writes, per
architecture and quantity,
the largest difference over the largest magnitude of the plain result
(loss, metrics, every gradient, and the moments after AdamW; for the
parameters after AdamW, the largest difference in learning rates), the
placements the residual stream held after each sequence-parallel
constraint, and those of each kernel wrapper's first input; or the
architecture's traceback, the other architectures running on. Each
process destroys its group on the way out."""

import dataclasses
import json
import os
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(got, want) -> float:
    got, want = _full(got).double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def _step(arch, world, data, model) -> dict:
    from repro_torch.configs import RunConfig, get_config, tiny_variant
    from repro_torch.distributed import set_mesh_context
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_elastic_mesh_context
    from repro_torch.models import transformer
    from repro_torch.train.state import distribute_state, init_train_state, state_shardings
    from repro_torch.train.step import _grads, train_step

    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    run = RunConfig(attention_impl="flash", remat="full", zero=True, fsdp=True,
                    seq_shard=True, warmup_steps=1)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2 * data, 64), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.frontend_len:
        batch["frontend"] = torch.randn(2 * data, cfg.frontend_len, cfg.d_model,
                                        generator=g)
    plain = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss0, _, grads0 = _grads(plain.params, cfg, run, batch)
    plain, metrics0 = train_step(plain, batch, cfg, run)

    ctx = make_elastic_mesh_context(world, model, device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = distribute_state(state, state_shardings(state, ctx, run))
    seen = {"residual": set(), "fused_rmsnorm": set(), "flash_attention": set(),
            "ssd_chunk_dual": set()}
    originals = {"residual": (transformer, "_seq_constrain"),
                 **{k: (ops, k) for k in seen if k != "residual"}}

    def recording(what, fn):
        def call(x, *args, **kwargs):
            if what != "residual" and hasattr(x, "placements"):
                seen[what].add(str(tuple(x.placements)))  # a kernel's input on the mesh
            out = fn(x, *args, **kwargs)
            if what == "residual":
                seen[what].add(str(tuple(out.placements)))
            return out
        call.__wrapped__ = fn
        return call

    for what, (module, name) in originals.items():
        setattr(module, name, recording(what, getattr(module, name)))
    set_mesh_context(ctx)
    try:
        loss1, _, grads1 = _grads(state.params, cfg, run, batch)
        state, metrics1 = train_step(state, batch, cfg, run)
    finally:
        set_mesh_context(None)
        for what, (module, name) in originals.items():
            setattr(module, name, getattr(module, name).__wrapped__)
    err = {"loss": _rel(loss1, loss0)}
    err.update({f"metric {k}": _rel(metrics1[k], v) for k, v in metrics0.items()})
    err.update({f"grad {k}": _rel(grads1[k], v) for k, v in grads0.items()})
    for (k, p), q in zip(plain.params.named_parameters(), state.params.parameters()):
        # In learning rates: AdamW's step on an element whose gradient
        # is near 0 follows the gradient's rounding.
        err[f"param {k}"] = float((_full(q.detach()) - p.detach()).abs().max()
                                  / run.learning_rate)
    for k in plain.opt.mu:
        err[f"mu {k}"] = _rel(state.opt.mu[k], plain.opt.mu[k])
        err[f"nu {k}"] = _rel(state.opt.nu[k], plain.opt.nu[k])
    err["step"] = float(int(_full(state.step)) != 1)
    return {"errors": err, "placements": {k: sorted(v) for k, v in seen.items()},
            "mesh": {"data": ctx.data_size, "model": ctx.model_size}}


def _argmax_ties(world, data, model) -> dict:
    """``_ce`` of (N, V) logits sharded over the batch and the vocabulary
    against the same logits whole: the summed loss and the correct-token
    count, with every row's maximum tied between two columns of different
    vocabulary shards (rows 0 mod 3), two columns of one shard (rows 1 mod
    3) or not tied."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_elastic_mesh_context
    from repro_torch.train.loss import _ce

    ctx = make_elastic_mesh_context(world, model, device="cpu")
    n, v = 8 * data, 16
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(n, v, generator=g)
    width = v // model
    for r in range(n):
        top = float(logits[r].max()) + 1.0
        cols = ((r % model, width + (r + 1) % model) if r % 3 == 0 else
                (width - 2, width - 1) if r % 3 == 1 else (r % v,))
        for c in cols:
            logits[r, c] = top
    labels = torch.argmax(logits, dim=-1)
    labels[::4] = (labels[::4] + 3) % v  # some rows wrong
    mesh = ctx.mesh
    dl = distribute_tensor(logits, mesh, [Shard(0), Shard(1)])
    dy = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
    loss0, acc0 = _ce(logits, labels)
    loss1, acc1 = _ce(dl, dy)
    return {"acc": [int(acc0), int(_full(acc1))],
            "loss": _rel(loss1, loss0),
            "first": [int(i) for i in torch.argmax(logits, dim=-1)],
            "placements": str(tuple(dl.placements))}


def _serve(arch, world, data, model) -> dict:
    """``prefill`` of a (2 * DATA, 32) prompt into a cache of 40 positions
    and 3 ``decode_step``s, tiny f32, ``chunked``: without a mesh, then on
    the mesh with the parameters placed by ``param_sharding_rules``; the
    largest difference of each step's logits and of every cache tensor
    over the largest magnitude of the plain one, and the caches'
    placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import RunConfig, get_config, tiny_variant
    from repro_torch.distributed import set_mesh_context
    from repro_torch.distributed.sharding import distribute, param_sharding_rules
    from repro_torch.launch.mesh import make_elastic_mesh_context
    from repro_torch.models.transformer import decode_step, init_params, prefill
    from repro_torch.train.step import eval_step
    from repro_torch.train.state import TrainState

    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    run = RunConfig(attention_impl="chunked", attention_chunk=16, remat="none")
    g = torch.Generator().manual_seed(1)
    b = 2 * data
    tokens = torch.randint(0, cfg.vocab, (b, 32), generator=g)
    steps = [torch.randint(0, cfg.vocab, (b, 1), generator=g) for _ in range(3)]
    frontend = (torch.randn(b, cfg.frontend_len, cfg.d_model, generator=g)
                if cfg.frontend_len else None)

    def serve(model):
        logits, cache = prefill(model, cfg, run, tokens, max_len=40, frontend=frontend)
        out = [logits]
        for t in steps:
            logits, cache = decode_step(model, cfg, run, cache, t)
            out.append(logits)
        return out, cache

    plain = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits0, cache0 = serve(plain)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if frontend is not None:
        batch["frontend"] = frontend
    metrics0 = eval_step(TrainState(plain, None, None), batch, cfg, run)
    ctx = make_elastic_mesh_context(world, model, device="cpu")
    placed = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rules = param_sharding_rules(placed, ctx)
    for name, p in list(placed.named_parameters()):
        owner, _, attr = name.rpartition(".")
        module = placed.get_submodule(owner) if owner else placed
        setattr(module, attr, torch.nn.Parameter(distribute(p.detach(), rules[name]),
                                                 requires_grad=False))
    set_mesh_context(ctx)
    try:
        logits1, cache1 = serve(placed)
        metrics1 = eval_step(TrainState(placed, None, None), batch, cfg, run)
    finally:
        set_mesh_context(None)
    err = {f"logits {i}": _rel(a, w) for i, (a, w) in enumerate(zip(logits1, logits0))}
    err.update({f"cache {k}": _rel(v, cache0[k]) for k, v in cache1.items() if k != "pos"})
    return {"errors": err, "pos": [cache0["pos"], cache1["pos"]],
            "accuracy": [float(metrics0["accuracy"]), float(_full(metrics1["accuracy"]))],
            "placements": {k: str(tuple(v.placements)) for k, v in cache1.items()
                           if isinstance(v, DTensor)}}


def _rank(rank, world, data, model, out, archs, mode="train"):
    torch.set_num_threads(1)  # the ranks share the host's cores
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{out}.store", rank=rank,
                            world_size=world)
    try:
        results = {}
        if mode == "serve":
            try:
                results["argmax"] = _argmax_ties(world, data, model)
            except Exception:  # noqa: BLE001
                results["argmax"] = {"error": traceback.format_exc()}
        for arch in archs:  # each architecture's failure recorded, the rest run
            try:
                results[arch] = (_serve if mode == "serve" else _step)(arch, world, data,
                                                                      model)
            except Exception:  # noqa: BLE001
                results[arch] = {"error": traceback.format_exc()}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def main(argv):
    mode = "serve" if argv[0] == "--serve" else "train"
    argv = argv[1:] if mode == "serve" else argv
    data, model, out, archs = int(argv[0]), int(argv[1]), argv[2], argv[3:]
    world = data * model
    if os.path.exists(f"{out}.store"):
        os.remove(f"{out}.store")
    mp.start_processes(_rank, args=(world, data, model, out, archs, mode), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1:])
