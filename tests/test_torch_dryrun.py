"""The port's dry run (``repro_torch.launch.dryrun``), its roofline table
and the repairs it needed: the loss's accuracy on vocabulary-sharded logits,
and the serve path (``prefill``, ``decode_step``) on a mesh.

The dry run traces a cell's step for one rank of a fake process group
(``make_fx`` under ``FakeTensorMode``), so it is checked here on small
meshes and tiny configs: the reference's own 16-device smoke case on the
port, a tensor-parallel MLP whose collective volume is counted by hand,
the memory estimate on a graph small enough to count by hand, and a
full-size cell's row read by both packages' roofline tables.  The pure
functions equal the reference's for every cell.  Values are checked where
data moves: on a one-rank gloo group (bit for bit) and on meshes of four
gloo processes (``tests/torch_mesh_worker.py --serve``).  Every process
group a test starts is destroyed on its way out."""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import SHAPES, RunConfig, get_config, list_archs, tiny_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hlo import H100_SXM, lower_graph
from repro_torch.core.hlo.roofline import collective_stats
from repro_torch.distributed import MeshContext, set_mesh_context
from repro_torch.distributed.sharding import distribute, param_sharding_rules, placements
from repro_torch.launch import dryrun, roofline_table, specs
from repro_torch.launch.mesh import _device_mesh, make_elastic_mesh_context
from repro_torch.models.transformer import decode_step, init_params, prefill
from repro_torch.train.loss import _ce

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402 (sets XLA_FLAGS on import)
import repro.launch.roofline_table as ref_table  # noqa: E402
import repro.launch.specs as ref_specs  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402

# The reference's dry run forces 512 host devices at import; give the
# process its flags back before jax starts a backend.
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCHS = sorted(list_archs())
CELLS = [(a, s) for a in ARCHS for s in sorted(SHAPES)]
ROOT = Path(__file__).resolve().parent


@contextlib.contextmanager
def gloo_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_ctx(data, model):
    return MeshContext(mesh=_device_mesh("cpu", (data, model), ("data", "model")))


# -- the pure functions, against the reference, on every cell ----------------------


def test_cells_cover_every_architecture_and_shape():
    assert len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_rules_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port, ref = SHAPES[shape], REF_SHAPES[shape]
    assert dryrun.cell_skip_reason(cfg, port) == ref_dryrun.cell_skip_reason(jcfg, ref)
    mine = dataclasses.asdict(dryrun.default_run_config(cfg, port, {"attention_chunk": 64}))
    theirs = dataclasses.asdict(ref_dryrun.default_run_config(jcfg, ref,
                                                              {"attention_chunk": 64}))
    assert {k: mine[k] for k in theirs} == theirs
    assert specs.model_flops_estimate(cfg, port) == ref_specs.model_flops_estimate(jcfg, ref)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(specs.input_specs(cfg, port)) == shapes(ref_specs.input_specs(jcfg, ref))


# -- F1: the accuracy on vocabulary-sharded logits -----------------------------------


def tied_logits(n=8, v=16, shard=4):
    """(logits, labels): every row's maximum tied between two columns of
    different shards of ``shard`` columns (rows 0 mod 3), of one shard
    (rows 1 mod 3) or not tied; every fourth label wrong."""
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(n, v, generator=g)
    width = v // shard
    for r in range(n):
        cols = ((r % shard, width + (r + 1) % shard) if r % 3 == 0 else
                (width - 2, width - 1) if r % 3 == 1 else (r % v,))
        logits[r, list(cols)] = float(logits[r].max()) + 1.0
    labels = torch.argmax(logits, dim=-1)
    labels[::4] = (labels[::4] + 3) % v
    return logits, labels


def test_tied_logits_keep_the_first_index():
    logits, labels = tied_logits()
    assert int(torch.argmax(logits[0])) == 0 and int(torch.argmax(logits[3])) == 3
    assert int(torch.argmax(logits[1])) == 2  # first of the tie in one shard


def test_sharded_accuracy_on_a_one_rank_mesh():
    logits, labels = tied_logits()
    loss0, acc0 = _ce(logits, labels)
    with gloo_group():
        ctx = make_elastic_mesh_context(1, device="cpu")
        dl = distribute_tensor(logits, ctx.mesh, [Shard(0), Shard(1)])
        dy = distribute_tensor(labels, ctx.mesh, [Shard(0), Replicate()])
        loss1, acc1 = _ce(dl, dy)
        assert torch.equal(full(acc1), acc0) and int(acc0) == 6
        assert torch.equal(full(loss1), loss0)


def test_sharded_accuracy_traces_under_fake_tensors():
    """On a 4 x 4 fake group the accuracy of (N, V) logits sharded over
    both axes traces: two all-reduces of the local (N,), a max and a min
    over the model axis, and nothing read on the host."""
    from torch.fx.experimental.proxy_tensor import make_fx

    with dryrun.fake_group(16):
        mesh = mesh_ctx(4, 4).mesh

        def acc(local_logits, local_labels):
            dl = DTensor.from_local(local_logits, mesh, [Shard(0), Shard(1)], run_check=False)
            dy = DTensor.from_local(local_labels, mesh, [Shard(0), Replicate()],
                                    run_check=False)
            return _ce(dl, dy)[1].to_local()

        gm = make_fx(acc, tracing_mode="fake")(torch.randn(16, 32),
                                               torch.zeros(16, dtype=torch.long))
        reduces = [n for n in gm.graph.nodes if "all_reduce" in str(n.target)]
        assert [n.args[1] for n in reduces] == ["max", "min"]
        assert all(tuple(n.meta["val"].shape) == (16,) for n in reduces)
        assert not any("_local_scalar_dense" in str(n.target) for n in gm.graph.nodes)


# -- F2/F3: the serve path on a mesh ---------------------------------------------------


def serve(model, cfg, run, tokens, steps, frontend=None):
    logits, cache = prefill(model, cfg, run, tokens, max_len=40, frontend=frontend)
    out = [logits]
    for t in steps:
        logits, cache = decode_step(model, cfg, run, cache, t)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_serve_path_on_a_one_rank_mesh_equals_the_plain_path(arch):
    """``prefill`` and three ``decode_step``s, tiny f32, ``chunked``: on a
    one-rank gloo mesh (parameters placed by ``param_sharding_rules``, the
    cache by ``cache_shardings``) every logit and cache element equals the
    plain path's, bit for bit."""
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    run = RunConfig(attention_impl="chunked", attention_chunk=16, remat="none")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    steps = [torch.randint(0, cfg.vocab, (2, 1), generator=g) for _ in range(3)]
    logits0, cache0 = serve(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                            cfg, run, tokens, steps)
    with gloo_group():
        ctx = make_elastic_mesh_context(1, device="cpu")
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        rules = param_sharding_rules(model, ctx)
        dryrun._set_params(model, {k: distribute(p.detach(), rules[k])
                                   for k, p in model.named_parameters()}, grad=False)
        set_mesh_context(ctx)
        try:
            logits1, cache1 = serve(model, cfg, run, tokens, steps)
        finally:
            set_mesh_context(None)
        want = specs.cache_shardings(cache0, ctx)
        assert cache1["pos"] == cache0["pos"] == 35
        for k, v in cache1.items():
            if k != "pos":
                assert isinstance(v, DTensor), k
                assert tuple(v.placements) == placements(want[k].mesh, want[k].spec,
                                                         v.shape), k
                assert torch.equal(full(v), cache0[k]), k
        for a, b in zip(logits1, logits0):
            assert torch.equal(full(a), b)


# Both meshes' runs (tests/torch_mesh_worker.py --serve), started together.
FOUR_RANKS = {"2x2": ("tinyllama-1.1b", "zamba2-2.7b"), "1x4": ("tinyllama-1.1b", "zamba2-2.7b")}
# tests/test_torch_distributed.py's tolerance for a tensor on four gloo
# ranks: the row-parallel products add partial sums in another order.
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def four_rank_serving(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    out = tmp_path_factory.mktemp("four_rank_serving")
    procs = {mesh: subprocess.Popen(
        [sys.executable, str(ROOT / "torch_mesh_worker.py"), "--serve", *mesh.split("x"),
         str(out / f"{mesh}.json"), *archs], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for mesh, archs in FOUR_RANKS.items()}
    logs = {}
    for mesh, proc in procs.items():
        try:
            logs[mesh] = proc.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
    results = {}
    for mesh, proc in procs.items():
        assert proc.returncode == 0, logs[mesh][-6000:]
        results[mesh] = json.loads((out / f"{mesh}.json").read_text())
    return results


@pytest.mark.parametrize("mesh,arch", [(m, a) for m, archs in FOUR_RANKS.items()
                                       for a in archs])
def test_serve_path_on_four_gloo_ranks(four_rank_serving, mesh, arch):
    """The cache's K/V sharded over the sequence on the model axis (each
    rank writing its own shard), the SSM states over heads and channels:
    every step's logits and every cache tensor within 1e-5 of the plain
    path's largest element, ``pos`` and the forward's accuracy equal."""
    r = four_rank_serving[mesh][arch]
    assert "error" not in r, r.get("error")
    assert r["pos"] == [35, 35]
    assert r["accuracy"][0] == r["accuracy"][1]
    assert r["placements"]["k"] == "(Shard(dim=1), Shard(dim=2))"
    for k, v in r["errors"].items():
        assert v <= GRAD_TOL, (k, v)


@pytest.mark.parametrize("mesh", sorted(FOUR_RANKS))
def test_sharded_accuracy_on_four_gloo_ranks(four_rank_serving, mesh):
    """Ties between vocabulary shards go to the first index, as
    ``jnp.argmax``'s: the correct-token count equals the whole logits'."""
    r = four_rank_serving[mesh]["argmax"]
    assert "error" not in r, r.get("error")
    assert r["acc"][0] == r["acc"][1]
    assert r["loss"] <= 1e-6
    assert r["placements"] == "(Shard(dim=0), Shard(dim=1))"


# -- the tracer ---------------------------------------------------------------------


def test_memory_analysis_counts_by_hand():
    """x (4, 8) f32 -> a = x * 2 (128 B), b = a.view(32) (a view: no
    bytes), c = b + 1 (128 B), out = c.sum(): at c both a and c are live,
    256 B; arguments 128 B, the output 4 B."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x):
        a = x * 2
        return (a.view(32) + 1).sum()

    gm = make_fx(f, tracing_mode="fake")(torch.randn(4, 8))
    mem = dryrun.memory_analysis(gm)
    assert mem == {"arg_bytes": 128, "out_bytes": 4, "alias_bytes": 0, "temp_bytes": 256}


def test_donated_inputs_alias_their_outputs():
    """An input updated in place comes back as an output of its own (the
    functionalized graph writes nothing back), aliased to it."""
    def body(t):
        t["state"]["w"].mul_(0.5)
        return {"state": {"w": t["state"]["w"]}, "y": t["x"] @ t["state"]["w"]}

    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = {"state": {"w": torch.empty(8, 8)}, "x": torch.empty(2, 8)}
    gm, _ = dryrun.trace_on_mesh(body, tree, donated=("state",))
    assert gm.meta["alias"] == [(0, 0)]
    assert not any(str(n.target).endswith("copy_.default") for n in gm.graph.nodes)
    mem = dryrun.memory_analysis(gm)
    assert mem["alias_bytes"] == 256 and mem["arg_bytes"] == 256 + 64


def test_tensor_parallel_mlp_makes_one_all_reduce():
    """A ColwiseParallel / RowwiseParallel MLP on a 1 x 4 fake mesh: one
    ``all-reduce`` per rank, of the output's local bytes (B, S, d) f32."""
    from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                                   parallelize_module)
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s, d, ff = 2, 8, 64, 256
    with dryrun.fake_group(4):
        mesh = mesh_ctx(1, 4).mesh
        with FakeTensorMode():
            mlp = torch.nn.Sequential(torch.nn.Linear(d, ff, bias=False), torch.nn.ReLU(),
                                      torch.nn.Linear(ff, d, bias=False))
            mlp = parallelize_module(mlp, mesh["model"], {"0": ColwiseParallel(),
                                                          "2": RowwiseParallel()})
            tree = {"params": dict(mlp.named_parameters()), "x": torch.empty(b, s, d)}

        def body(t):
            dryrun._set_params(mlp, t["params"], grad=False)
            return {"y": mlp(t["x"])}

        gm, _ = dryrun.trace_on_mesh(body, tree)
        module = lower_graph(gm)
    assert module.unmapped == () and module.num_partitions == 4
    stats = collective_stats(module, H100_SXM)
    assert stats.counts == {"all-reduce": 1}
    assert stats.total_bytes == b * s * d * 4


SMOKE = ShapeConfig("smoke", seq_len=128, global_batch=8, kind="train")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b", "mamba2-130m"])
def test_reference_smoke_on_the_port(arch):
    """``tests/test_distributed.py``'s 16-device smoke case on the port: a
    tiny train step (seq 128, batch 8, ``chunked`` in chunks of 64, remat
    "full", ZeRO, FSDP, sequence sharding) on a 4 x 4 fake mesh traces,
    lowers with nothing unmapped and costs on 16 partitions."""
    cfg = tiny_variant(get_config(arch))
    run = RunConfig(attention_impl="chunked", attention_chunk=64, remat="full", zero=True,
                    fsdp=True, seq_shard=True)
    with dryrun.fake_group(16):
        gm, inputs = dryrun.trace_cell(cfg, SMOKE, run, mesh_ctx(4, 4), "cpu")
        row, report, _ = dryrun.cell_row(gm, inputs, f"{arch}/smoke")
    assert row["temp_bytes"] > 0
    assert report.num_partitions == row["chips"] == 16
    assert report.terms["TC"] > 0 and report.terms["HBM"] > 0
    assert row["unmapped"] == []
    assert set(report.collective.counts) <= {"all-gather", "all-reduce", "reduce-scatter",
                                             "all-to-all"}
    assert report.terms["NVLink"] > 0
    # The state comes back in its own buffers: parameters, moments, count
    # and step are donated.
    assert 0 < row["alias_bytes"] <= row["arg_bytes"]


def test_lower_cell_needs_the_mesh_ranks():
    with dryrun.fake_group(16):
        with pytest.raises(RuntimeError, match="256 ranks"):
            dryrun.lower_cell("mamba2-130m", "long_500k", device="cpu")


def ref_row_keys():
    from repro.core.hlo.roofline import roofline_report

    text = ("HloModule m\n\nENTRY %main (p: f32[4]) -> f32[4] {\n"
            "  %p = f32[4] parameter(0)\n  ROOT %a = f32[4] add(%p, %p)\n}\n")
    return set(roofline_report(text).row()) | {
        "cpu_convert_artifact_bytes", "arch", "shape", "mesh", "kind", "model_flops",
        "lower_s", "compile_s", "arg_bytes", "temp_bytes", "out_bytes", "alias_bytes",
        "mem_per_device_adjusted"}


def test_rows_read_by_both_roofline_tables(tmp_path, capsys):
    """A full-size cell on a 256-rank fake group writes a row with the
    reference's keys; a skipped cell writes none; both packages' tables
    read the rows alike, the port's naming NVLink where the reference
    names ICI."""
    with dryrun.fake_group(256):
        row = dryrun.run_cell("mamba2-130m", "long_500k", out_dir=tmp_path, device="cpu")
        skipped = dryrun.run_cell("yi-9b", "long_500k", out_dir=tmp_path, device="cpu")
    assert "skipped" in skipped
    assert ref_row_keys() <= set(row)
    assert row["unmapped"] == [] and row["chips"] == 256 and row["mesh"] == "16x16"
    assert row["cpu_convert_artifact_bytes"] == 0
    assert row["mem_per_device_adjusted"] == row["arg_bytes"] + row["temp_bytes"]
    assert row["memory_per_device"] == row["arg_bytes"] + row["out_bytes"] + row["temp_bytes"]
    rows = roofline_table.load_rows(tmp_path)
    assert len(rows) == 1 and rows == ref_table.load_rows(tmp_path)
    for mesh in ("16x16", "2x16x16"):
        assert roofline_table.fmt_table(rows, mesh) == ref_table.fmt_table(rows, mesh)
    mine, theirs = roofline_table.candidates(rows), ref_table.candidates(rows)
    assert mine["worst_roofline_fraction"] == theirs["worst_roofline_fraction"]
    assert mine["most_collective_bound"] == theirs["most_collective_bound"].replace(
        "(ICI ", "(NVLink ")
    out = capsys.readouterr().out
    assert "OK    mamba2-130m x long_500k [16x16]" in out and "SKIP  yi-9b x long_500k" in out


def test_cli_runs_a_cell_and_the_table(tmp_path):
    """``python -m repro_torch.launch.dryrun --jobs 1`` runs the cell in a
    subprocess of its own and counts it; ``roofline_table`` prints the
    row."""
    env = dict(os.environ, PYTHONPATH=str(ROOT.parent / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--jobs", "1",
         "--arch", "mamba2-130m", "--shape", "long_500k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK    mamba2-130m x long_500k [16x16]" in proc.stdout
    assert "1/1 cells OK" in proc.stdout
    table = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline_table",
                            "--dir", str(tmp_path)], capture_output=True, text=True,
                           timeout=120, env=env)
    assert table.returncode == 0 and "| mamba2-130m | long_500k |" in table.stdout


def test_cli_raises_without_a_card():
    """The dry run's tensors are the card's unless ``--device`` names
    another type; without a card it stops before tracing anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k"])
