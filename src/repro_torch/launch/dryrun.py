"""Multi-pod dry run: trace every (architecture × input shape × mesh) cell
for one rank of a fake process group and record memory / cost / roofline
artifacts; the counterpart of ``repro.launch.dryrun``.

Where the reference lowers and compiles each cell for 256 or 512
placeholder devices, a cell here runs on a ``fake`` process group of 256
(16 × 16) or 512 (2 × 16 × 16) ranks, which moves no data: the state and
the inputs are fake tensors (``FakeTensorMode``) placed by the sharding
layer's rules (``train/state.py::state_shardings``,
``launch/specs.py::{batch,cache}_shardings``), so nothing is allocated, and
``make_fx`` traces the step on rank 0's local shards into a per-rank
graph of core ATen ops and functional collectives
(:func:`trace_on_mesh`).  That graph goes through the export front end and
the roofline (``core/hlo/roofline.py::roofline_from_traced``), and a
schedule-order memory estimate (:func:`memory_analysis`) stands in for
XLA's ``memory_analysis()``.  The rows keep the reference's keys, so
``repro_torch.launch.roofline_table`` reads rows of either package.

The run configs are the reference's (``chunked`` attention in chunks of
512), so no CUDA kernel is traced, as the reference traces no Pallas
kernel.  A cell's tensors carry ``device``'s type (the card's, ``cuda``,
unless the caller names another; the tests pass ``cpu``), which a fake
tensor needs no card for; the mesh's ``DeviceMesh`` is of that type too.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 4] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --cell mamba2-130m:long_500k
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import fx
from torch.utils import _pytree as pytree

from repro_torch import Device, resolve_device
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import MeshContext, set_mesh_context
from repro_torch.distributed.sharding import distribute, empty_sharded, is_distributed
from repro_torch.launch.mesh import live_world_size, make_mesh_context
from repro_torch.launch.specs import (batch_shardings, cache_shardings, input_specs,
                                      model_flops_estimate)
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.optim import OptState
from repro_torch.train.state import (TrainState, distribute_state, init_train_state,
                                     state_shardings)
from repro_torch.train.step import train_step

MESH_RANKS = {False: 256, True: 512}
# Nodes whose value lives in their first input's storage: a view, a
# collective's wait, or an in-place write into a slice that
# functionalization made a scatter (XLA's dynamic-update-slice, done in
# place in a buffer that is dead after it).
_VIEWS = {"view", "_unsafe_view", "permute", "expand", "unsqueeze", "squeeze", "slice",
          "select", "alias", "t", "transpose", "split", "split_with_sizes", "unbind",
          "as_strided", "wait_tensor", "detach", "lift_fresh", "slice_scatter",
          "select_scatter"}
# Kept whole in the trace (core ATen ops that the default table decomposes):
# a write into one layer of a cache stays a write of that layer, where its
# decomposition rewrites the whole cache through a ``where``.
_KEEP = ("select_scatter",)


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Documented skips (DESIGN.md §5): '' means the cell runs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention architecture at 500k context: O(S^2) attention "
                "and a 500k dense KV cache are out of scope by design "
                "(sub-quadratic archs run this cell)")
    return ""


def default_run_config(cfg: ModelConfig, shape: ShapeConfig,
                       overrides=None) -> RunConfig:
    kw = dict(
        attention_impl="chunked",
        attention_chunk=512,
        remat="full" if shape.kind == "train" else "none",
        seq_shard=shape.kind == "train",
        zero=shape.kind == "train",
        fsdp=shape.kind == "train",
        loss_chunk=0,
    )
    kw.update(overrides or {})
    return RunConfig(**kw)


# ---------------------------------------------------------------------------
# The per-rank tracer
# ---------------------------------------------------------------------------


def _packet(node: fx.Node) -> Optional[str]:
    packet = getattr(node.target, "overloadpacket", None)
    return getattr(packet, "__name__", None)


def _like(out, ref):
    """``out`` in ``ref``'s placements (a DTensor output held to its
    input's sharding, as the reference's ``out_shardings``)."""
    if is_distributed(out) and tuple(out.placements) != tuple(ref.placements):
        return out.redistribute(ref.device_mesh, ref.placements)
    return out


def _replicated(out):
    """A DTensor output with its pending sums reduced (the reference's
    ``None`` out-sharding of a metric); any other value as it is."""
    if is_distributed(out) and any(p.is_partial() for p in out.placements):
        from torch.distributed.tensor import Replicate

        return out.redistribute(out.device_mesh, [Replicate()] * out.device_mesh.ndim)
    return out


def trace_on_mesh(body: Callable[[Any], Any], tree: Any,
                  donated: Tuple[str, ...] = ()) -> Tuple[fx.GraphModule, List[torch.Tensor]]:
    """One rank's graph of ``body(tree)``.

    ``tree`` is a dict of (nested dicts of) fake tensors and DTensors of
    fake local shards.  The trace takes each leaf's local tensor as a
    placeholder, rebuilds the DTensor around it (``DTensor.from_local``
    under the leaf's mesh, placements and global shape), runs ``body`` and
    returns the local tensors of its output tree's leaves.  It is
    functionalized (in-place updates become ``slice_scatter`` and the like;
    an update of an input becomes an output, as a donated buffer is),
    decomposed to core ATen, with DTensor's redistributions as
    ``_c10d_functional`` collectives, and rid of the nodes no output
    needs.  The leaves of ``tree`` under the keys ``donated`` are donated:
    ``gm.meta["alias"]`` lists (input index, output index) for each of them
    that comes back as an output of its size, under the same key path.

    Returns (graph, its fake inputs)."""
    from torch._decomp import core_aten_decompositions
    from torch._subclasses.functional_tensor import FunctionalTensor, FunctionalTensorMode
    from torch.distributed.tensor import DTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, spec = pytree.tree_flatten_with_path(tree)
    paths = [pytree.keystr(p) for p, _ in leaves]
    leaves = [v for _, v in leaves]
    layouts = [(v.device_mesh, tuple(v.placements), v.shape, v.stride())
               if is_distributed(v) else None for v in leaves]
    inputs = [v.to_local() if is_distributed(v) else v for v in leaves]
    out_paths: List[str] = []

    def rank(*local):
        with FunctionalTensorMode():
            rebuilt = [FunctionalTensor.to_functional(x) for x in local]
            rebuilt = [x if lay is None else
                       DTensor.from_local(x, lay[0], lay[1], run_check=False, shape=lay[2],
                                          stride=lay[3])
                       for x, lay in zip(rebuilt, layouts)]
            outs = pytree.tree_flatten_with_path(body(pytree.tree_unflatten(rebuilt, spec)))[0]
            out_paths[:] = [pytree.keystr(p) for p, _ in outs]
            outs = [v.to_local() if is_distributed(v) else v for _, v in outs]
        return [_from_functional(v) for v in outs]

    table = {op: fn for op, fn in core_aten_decompositions().items()
             if getattr(op, "overloadpacket", None) not in
             [getattr(torch.ops.aten, k) for k in _KEEP]}
    gm = make_fx(rank, tracing_mode="fake", decomposition_table=table)(*inputs)
    # DTensor (torch 2.11) runs some ops on tensors of the global shape to
    # infer its outputs' metadata, and a trace records them; nothing reads
    # them.
    gm.graph.eliminate_dead_code()
    gm.recompile()
    by_path = {p: i for i, p in enumerate(out_paths)}
    outputs = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    alias = []
    for i, (path, x) in enumerate(zip(paths, inputs)):
        j = by_path.get(path)
        if j is None or not path.startswith(tuple(f"[{k!r}]" for k in donated)):
            continue
        val = outputs[j].meta.get("val")
        if isinstance(val, torch.Tensor) and val.shape == x.shape and val.dtype == x.dtype:
            alias.append((i, j))
    gm.meta["alias"] = alias
    return gm, inputs


def _from_functional(t):
    """The value a functional tensor holds now (its pending updates
    applied), as the traced tensor; an update of an input is not written
    back, so the updated value is an output in a buffer of its own, as a
    donated input's is."""
    from torch._subclasses.functional_tensor import FunctionalTensor

    if not isinstance(t, FunctionalTensor):
        return t
    torch._sync(t)
    return torch._from_functional_tensor(t.elem)


def _bytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(_bytes(v) for v in val)
    return 0


def memory_analysis(gm: fx.GraphModule) -> Dict[str, int]:
    """The reference's ``memory_analysis()`` keys for one rank's graph:

    * ``arg_bytes``: the local bytes of every input;
    * ``out_bytes``: those of every output;
    * ``alias_bytes``: those of the donated inputs that come back as
      outputs (``gm.meta["alias"]``: the train state, the decode cache);
    * ``temp_bytes``: the peak bytes of live intermediates, the nodes run
      in the graph's order, each value freed after its last use, a view
      (or a collective's wait) counted once with the value it aliases,
      inputs and outputs left out (they are ``arg`` and ``out``).

    This is a schedule-order estimate of eager execution, not XLA's buffer
    assignment, which reorders, fuses and reuses buffers."""
    nodes = list(gm.graph.nodes)
    output = nodes[-1]
    outs = pytree.tree_leaves(output.args[0])
    outs = [o for o in outs if isinstance(o, fx.Node)]
    args = [n for n in nodes if n.op == "placeholder"]
    root: Dict[fx.Node, fx.Node] = {}
    for n in nodes:
        base = n
        if n.op == "call_function" and (_packet(n) in _VIEWS or
                                        n.target.__name__ == "getitem"):
            src = next((a for a in n.args if isinstance(a, fx.Node)), None)
            base = root.get(src, n) if src is not None else n
        root[n] = base
    kept = {root[n] for n in args + outs}
    last: Dict[fx.Node, int] = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            last[root[a]] = i
    live = peak = 0
    frees: Dict[int, List[fx.Node]] = {}
    for r, i in last.items():
        frees.setdefault(i, []).append(r)
    for i, n in enumerate(nodes):
        if n.op == "call_function" and root[n] is n and n not in kept:
            live += _bytes(n.meta.get("val"))
            peak = max(peak, live)
        for r in frees.get(i, ()):
            if r.op == "call_function" and r not in kept:
                live -= _bytes(r.meta.get("val"))
    alias = gm.meta.get("alias", ())
    return {
        "arg_bytes": sum(_bytes(n.meta.get("val")) for n in args),
        "out_bytes": sum(_bytes(o.meta.get("val")) for o in outs),
        "alias_bytes": sum(_bytes(args[i].meta.get("val")) for i, _ in alias),
        "temp_bytes": peak,
    }


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _fake(spec: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A tensor of a meta spec's shape and dtype on ``device`` (fake under
    the caller's ``FakeTensorMode``)."""
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def _param_tree(model) -> Dict[str, torch.Tensor]:
    return {k: p for k, p in model.named_parameters()}


def _set_params(model, params: Dict[str, torch.Tensor], grad: bool) -> None:
    for name, t in params.items():
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, attr, torch.nn.Parameter(t, requires_grad=grad))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, ctx: MeshContext,
               device: Device = None) -> Tuple[fx.GraphModule, List[torch.Tensor]]:
    """One rank's graph of a cell's step on the mesh of ``ctx`` (a
    ``DeviceMesh`` over a started group, fake or not), and its fake inputs:

    * train: ``train_step`` on the state placed by ``state_shardings`` and
      the batch by ``batch_shardings``; the state donated;
    * prefill: ``prefill`` of the tokens (and a frontend), parameters as
      ``state_shardings`` places them;
    * decode: ``decode_step`` on ``input_specs``' cache placed by
      ``cache_shardings``, at ``pos = T - 1``; the cache donated.

    Nothing is allocated: the state and inputs are fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device)
    specs = input_specs(cfg, shape)
    fake_mode = FakeTensorMode()
    set_mesh_context(ctx)
    try:
        with fake_mode:
            state = init_train_state(cfg, device=dev)
            shardings = state_shardings(state, ctx, run)
            if shape.kind == "train":
                state = distribute_state(state, shardings)
            else:
                _set_params(state.params, {
                    k: distribute(p.detach(), shardings.params[k])
                    for k, p in _param_tree(state.params).items()}, grad=False)
            bshard = batch_shardings(specs, ctx)
            batch = {k: distribute(_fake(v, dev), bshard[k])
                     for k, v in specs.items() if k != "cache"}
            tree: Dict[str, Any] = {"params": _param_tree(state.params), "batch": batch}
            if shape.kind == "train":
                tree.update(mu=state.opt.mu, nu=state.opt.nu, count=state.opt.count,
                            step=state.step)
            if shape.kind == "decode":
                cshard = cache_shardings(specs["cache"], ctx)
                tree["cache"] = {k: empty_sharded(v.shape, v.dtype, cshard[k])
                                 for k, v in specs["cache"].items() if k != "pos"}
        model = state.params

        if shape.kind == "train":
            def body(t):
                _set_params(model, t["params"], grad=True)
                st = TrainState(model, OptState(dict(t["mu"]), dict(t["nu"]), t["count"]),
                                t["step"])
                new, metrics = train_step(st, t["batch"], cfg, run)
                return {"params": {k: _like(p.detach(), t["params"][k])
                                   for k, p in _param_tree(new.params).items()},
                        "mu": {k: _like(v, t["mu"][k]) for k, v in new.opt.mu.items()},
                        "nu": {k: _like(v, t["nu"][k]) for k, v in new.opt.nu.items()},
                        "count": _like(new.opt.count, t["count"]),
                        "step": _like(new.step, t["step"]),
                        "metrics": {k: _replicated(v) for k, v in metrics.items()}}
            donated = ("params", "mu", "nu", "count", "step")
        elif shape.kind == "prefill":
            def body(t):
                _set_params(model, t["params"], grad=False)
                with torch.no_grad():
                    logits, cache = prefill(model, cfg, run, t["batch"]["tokens"],
                                            frontend=t["batch"].get("frontend"))
                cache.pop("pos")
                return {"logits": _replicated(logits), "cache": cache}
            donated = ()
        else:
            def body(t):
                _set_params(model, t["params"], grad=False)
                cache = dict(t["cache"], pos=shape.seq_len - 1)
                with torch.no_grad():
                    logits, cache = decode_step(model, cfg, run, cache, t["batch"]["tokens"])
                cache.pop("pos")
                return {"logits": _replicated(logits),
                        "cache": {k: _like(v, t["cache"][k]) for k, v in cache.items()}}
            donated = ("cache",)
        return trace_on_mesh(body, tree, donated)
    finally:
        set_mesh_context(None)


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               run_overrides=None, device: Device = None):
    """Trace one cell; returns (graph, fake inputs, meta), or (None, None,
    meta with "skipped") for a documented skip.  Starts nothing: the
    default group must be a (fake) group of the mesh's 256 or 512 ranks."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = cell_skip_reason(cfg, shape)
    if reason:
        return None, None, {"arch": arch, "shape": shape_name, "skipped": reason}
    ranks = MESH_RANKS[multi_pod]
    if live_world_size() != ranks:
        raise RuntimeError(f"a {'2x16x16' if multi_pod else '16x16'} cell needs a "
                           f"process group of {ranks} ranks; the default group has "
                           f"{live_world_size()}")
    ctx = make_mesh_context(multi_pod=multi_pod, device=device)
    run = default_run_config(cfg, shape, run_overrides)
    gm, inputs = trace_cell(cfg, shape, run, ctx, device)
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "model_flops": model_flops_estimate(cfg, shape),
    }
    return gm, inputs, meta


def cell_row(gm: fx.GraphModule, inputs, name: str,
             model_flops: Optional[float] = None) -> Tuple[Dict[str, Any], Any, str]:
    """(row, report, HLO text) of a traced cell: ``report.row()``, its
    memory analysis, the ATen ops the lowering left ``unmapped``, and
    ``cpu_convert_artifact_bytes``, which is 0 here: XLA's CPU backend
    converts bf16 dot operands to f32 and hoists the conversions, and the
    reference subtracts those buffers; a traced graph has no such pass, so
    it has none to subtract. Its f32 converts of large bf16 buffers
    (``hotspots.cpu_bf16_artifact_bytes`` of the lowered graph, in the row
    as ``f32_convert_bytes``) are the program's own upcasts, which the card
    runs too (a decode step's f32 attention over a bf16 cache)."""
    from repro_torch.core.hlo.export import graph_text
    from repro_torch.core.hlo.hotspots import cpu_bf16_artifact_bytes
    from repro_torch.core.hlo.parser import parse_hlo
    from repro_torch.core.hlo.roofline import roofline_from_traced

    mem = memory_analysis(gm)
    text, unmapped = graph_text(gm, name.replace("/", "_"))
    module = parse_hlo(text)
    module.unmapped = unmapped
    report = roofline_from_traced(
        gm, inputs, name=name, model_flops=model_flops, module=module,
        memory_per_device=mem["arg_bytes"] + mem["out_bytes"] + mem["temp_bytes"])
    row = report.row()
    row["cpu_convert_artifact_bytes"] = 0
    row["f32_convert_bytes"] = cpu_bf16_artifact_bytes(module)
    row["unmapped"] = list(unmapped)
    row.update(mem)
    return row, report, text


@contextlib.contextmanager
def fake_group(ranks: int):
    """A ``fake`` default process group of ``ranks`` ranks, this process
    rank 0 (it moves no data and needs no peers), destroyed on the way
    out."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 (registers "fake")

    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir=None, run_overrides=None, save_hlo: bool = False,
             name_suffix: str = "", device: Device = None):
    """Trace, lower and cost one cell on the default (fake) group; print
    its line and report and write its row (and, with ``save_hlo``, its
    HLO text) under ``out_dir``. ``lower_s`` is the trace, ``compile_s``
    the lowering and the cost model."""
    t0 = time.time()
    gm, inputs, meta = lower_cell(arch, shape_name, multi_pod, run_overrides, device)
    if gm is None:
        print(f"SKIP  {arch} x {shape_name}: {meta['skipped']}")
        return meta
    t_lower = time.time() - t0
    t0 = time.time()
    row, report, text = cell_row(gm, inputs, f"{arch}/{shape_name}{name_suffix}",
                                 meta["model_flops"])
    t_compile = time.time() - t0
    row.update(meta)
    row.update({"lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1)})
    mem = row["arg_bytes"] + row["temp_bytes"]
    mem_adj = max(mem - row["cpu_convert_artifact_bytes"], row["arg_bytes"])
    row["mem_per_device_adjusted"] = mem_adj
    row["collectives"] = {op: {"count": report.collective.counts[op], "bytes": b}
                          for op, b in report.collective.bytes_by_op.items()}
    print(f"OK    {arch} x {shape_name} [{row['mesh']}] "
          f"mem/dev={mem / 2**30:.2f}GiB "
          f"(adj {mem_adj / 2**30:.2f}GiB) "
          f"dominant={row['dominant']} bound={row['bound_s'] * 1e3:.2f}ms "
          f"(trace {t_lower:.0f}s lower {t_compile:.0f}s)")
    print(report.render())

    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{arch}__{shape_name}__{row['mesh'].replace('x', '-')}{name_suffix}"
        (out_dir / f"{stem}.json").write_text(json.dumps(row, indent=2, default=str))
        if save_hlo:
            (out_dir / f"{stem}.hlo.txt").write_text(text)
    return row


def _run_here(cells, args) -> List[tuple]:
    """Each cell in this process, in a fake group of its mesh's ranks."""
    failures = []
    for arch, shape, mp in cells:
        try:
            with fake_group(MESH_RANKS[mp]):
                run_cell(arch, shape, mp, out_dir=args.out, save_hlo=args.save_hlo,
                         device=args.device)
        except Exception as e:  # noqa: BLE001
            failures.append((arch, shape, mp, repr(e)))
            print(f"FAIL  {arch} x {shape} multi_pod={mp}: {e}")
            traceback.print_exc()
    return failures


def _run_jobs(cells, args) -> List[tuple]:
    """Each cell in a subprocess of its own (a process group is global to
    its process), ``args.jobs`` at a time; each one's output printed when
    it ends."""
    def one(cell):
        arch, shape, mp = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(args.out), "--device", str(args.device)]
        cmd += ["--multi-pod"] * mp + ["--save-hlo"] * args.save_hlo
        proc = subprocess.run(cmd, capture_output=True, text=True, env=dict(os.environ))
        return cell, proc

    failures = []
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for (arch, shape, mp), proc in pool.map(one, cells):
            sys.stdout.write(proc.stdout)
            if proc.returncode != 0:
                sys.stdout.write(proc.stderr[-4000:])
                failures.append((arch, shape, mp, f"exit {proc.returncode}"))
                print(f"FAIL  {arch} x {shape} multi_pod={mp}: exit {proc.returncode}")
            sys.stdout.flush()
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' and the mesh's device type (default cuda)")
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE",
                    help="a cell to run (repeatable), in place of --arch/--shape/--all")
    ap.add_argument("--jobs", type=int, default=0,
                    help="run each cell in a subprocess, this many at a time "
                         "(default: every cell in this process, one after another)")
    args = ap.parse_args(argv)
    args.device = str(resolve_device(args.device))

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    pairs = [tuple(c.split(":")) for c in args.cell] or [(a, s) for a in archs for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(arch, shape, mp) for arch, shape in pairs for mp in meshes]

    failures = (_run_jobs if args.jobs > 0 else _run_here)(cells, args)
    print(f"\n{len(cells) - len(failures)}/{len(cells)} cells OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
