"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports ``jax`` or ``repro``, and with no CUDA device the entry points raise
instead of running on the CPU. Each check runs in a fresh interpreter."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from test_api import WHILE_HLO

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py"))


def _python(code, cwd=ROOT, **env):
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=cwd, env=full_env)


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_module_list_covers_the_slice():
    for name in ("repro_torch.kernels.ops", "repro_torch.kernels.ssd_scan",
                 "repro_torch.models.transformer", "repro_torch.models.mamba2",
                 "repro_torch.serving.engine", "repro_torch.launch.serve",
                 "repro_torch.api", "repro_torch.core.registry",
                 "repro_torch.core.isa.parser_x86", "repro_torch.core.isa.parser_aarch64",
                 "repro_torch.core.machine.model", "repro_torch.core.machine.tx2",
                 "repro_torch.core.validation.gauss_seidel",
                 "repro_torch.core.calibration.corpus",
                 "repro_torch.core.analysis.sweep", "repro_torch.core.analysis.dag",
                 "repro_torch.core.analysis.scheduler", "repro_torch.core.analysis.lcd",
                 "repro_torch.core.analysis.critical_path",
                 "repro_torch.core.analysis.throughput",
                 "repro_torch.core.analysis.diagnostics",
                 "repro_torch.core.analysis.report", "repro_torch.core.analysis.render",
                 "repro_torch.core.analysis.analyze", "repro_torch.core.sim.engine",
                 "repro_torch.core.analysis.batch", "repro_torch.core.machine.lint",
                 "repro_torch.core.calibration.calibrate", "repro_torch.core.bench",
                 "repro_torch.core.bench.runner", "repro_torch.serving.resilience",
                 "repro_torch.serving.faults", "repro_torch.serving.analysis",
                 "repro_torch.core.hlo", "repro_torch.core.hlo.parser",
                 "repro_torch.core.hlo.machine", "repro_torch.core.hlo.costs",
                 "repro_torch.core.hlo.critical_path", "repro_torch.core.hlo.lcd",
                 "repro_torch.core.hlo.hotspots", "repro_torch.core.hlo.roofline",
                 "repro_torch.core.hlo.export", "repro_torch.core.bench.ibench",
                 "repro_torch.train", "repro_torch.train.loss", "repro_torch.train.state",
                 "repro_torch.train.step", "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.ckpt", "repro_torch.models.convert",
                 "repro_torch.launch.ft", "repro_torch.launch.train",
                 "repro_torch.models.moe", "repro_torch.models.layers",
                 "repro_torch.distributed", "repro_torch.distributed.sharding",
                 "repro_torch.launch.mesh", "repro_torch.launch.elastic",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                 "repro_torch.launch.roofline_table"):
        assert name in MODULES


def test_every_reference_module_has_its_port_file():
    ref = ROOT / "src" / "repro"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (ROOT / "src" / "repro_torch" / p.relative_to(ref)).exists())
    assert missing == []


def test_port_imports_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, '.')\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print('BAD', bad)\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout


def test_accelerator_graph_modules_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.core.hlo, repro_torch.core.hlo.hotspots\n"
            "import repro_torch.core.bench.ibench\n"
            "from repro_torch.core.hlo import H100_SXM\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print('BAD', bad, H100_SXM.name)\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD [] h100_sxm" in proc.stdout


def test_entry_points_raise_without_a_card():
    _needs_no_card()
    code = ("from repro_torch.configs import get_config, tiny_variant\n"
            "from repro_torch.models import Transformer, init_cache\n"
            "from repro_torch.serving import ServeEngine\n"
            "cfg = tiny_variant(get_config('tinyllama-1.1b'))\n"
            "model = Transformer(cfg, device='cpu')\n"
            "for fn in (lambda: ServeEngine(cfg, model), lambda: Transformer(cfg),\n"
            "           lambda: init_cache(cfg, 1, 8)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as exc:\n"
            "        assert 'no CUDA device' in str(exc), exc\n"
            "    else:\n"
            "        raise SystemExit('ran on the CPU without being asked')\n"
            "print('RAISED')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RAISED" in proc.stdout


def test_analyze_raises_without_a_card():
    # Every exported analyzer function that takes ``device`` runs on the
    # card unless told otherwise: called without one, each raises.
    _needs_no_card()
    code = ("import inspect\n"
            "import torch\n"
            f"HLO = {WHILE_HLO!r}\n"
            "import repro_torch.api as api\n"
            "import repro_torch.core.analysis as analysis\n"
            "import repro_torch.core.analysis.sweep as sweep\n"
            "import repro_torch.core.bench.ibench as ibench\n"
            "import repro_torch.core.hlo as hlo\n"
            "import repro_torch.core.sim as sim\n"
            "from repro_torch.core.analysis.report import AnalysisReport\n"
            "from repro_torch.core.analysis.dag import build_dag\n"
            "from repro_torch.core.registry import get_arch\n"
            "spec = get_arch('tx2')\n"
            "model, kernel = spec.model_factory(), spec.parser(spec.sample_asm)\n"
            "dag = build_dag(kernel, model, copies=2, dual_writeback=True)\n"
            "ptr, idx = dag.pred_csr()\n"
            "calls = {\n"
            "    'analyze': lambda: api.analyze(spec.sample_asm, arch='tx2'),\n"
            "    'analyze_raw': lambda: api.analyze_raw(spec.sample_asm, arch='tx2'),\n"
            "    'analyze_kernel': lambda: analysis.analyze_kernel(kernel, model),\n"
            "    'analyze_kernel_bracket': lambda: analysis.analyze_kernel_bracket(kernel, model),\n"
            "    'analyze_kernel_rung': lambda: analysis.analyze_kernel_rung(\n"
            "        kernel, model, rung='tp_only'),\n"
            "    'analyze_kernel_ladder': lambda: analysis.analyze_kernel_ladder(kernel, model),\n"
            "    'analyze_kernels': lambda: analysis.analyze_kernels([kernel], model),\n"
            "    'analyze_wave': lambda: analysis.analyze_wave([kernel], model),\n"
            "    'lcd_from_dag': lambda: analysis.lcd_from_dag(dag, len(kernel)),\n"
            "    'loop_carried_dependencies': lambda: analysis.loop_carried_dependencies(\n"
            "        kernel, model),\n"
            "    'batched_longest_paths': lambda: sweep.batched_longest_paths(\n"
            "        ptr, idx, dag.latency_vector(), [[0]]),\n"
            "    'hlo_loop_carried': lambda: hlo.hlo_loop_carried(HLO),\n"
            "    'measure_latency': lambda: ibench.measure_latency(torch.exp),\n"
            "    'measure_throughput': lambda: ibench.measure_throughput(torch.exp),\n"
            "    'populate_entry': lambda: ibench.populate_entry('exp', torch.exp),\n"
            "}\n"
            "exported = {n for mod in (api, analysis, sim, sweep, hlo, ibench)\n"
            "            for n in getattr(mod, '__all__', dir(mod))\n"
            "            if callable(getattr(mod, n, None)) and not n.startswith('_')\n"
            "            and not inspect.isclass(getattr(mod, n))\n"
            "            and getattr(mod, n).__module__.startswith('repro_torch.')\n"
            "            and 'device' in inspect.signature(getattr(mod, n)).parameters}\n"
            "assert exported == set(calls), sorted(exported ^ set(calls))\n"
            "for name, fn in calls.items():\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as exc:\n"
            "        assert 'no CUDA device' in str(exc), (name, exc)\n"
            "    else:\n"
            "        raise SystemExit(f'{name} ran on the CPU without being asked')\n"
            "for fn in (lambda: api.analyze(HLO), lambda: AnalysisReport.from_hlo(HLO)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as exc:\n"
            "        assert 'no CUDA device' in str(exc), exc\n"
            "    else:\n"
            "        raise SystemExit('an HLO analysis ran on the CPU without being asked')\n"
            "print(api.analyze(spec.sample_asm, arch='tx2', device='cpu').tp_per_it)\n"
            "print('RAISED')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    assert "RAISED" in proc.stdout


def test_serve_cli_raises_without_a_card():
    _needs_no_card()
    proc = _python("from repro_torch.launch.serve import main; "
                   "main(['--requests', '1', '--max-new-tokens', '1'])")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "tok/s" not in proc.stdout


def test_train_cli_raises_without_a_card():
    _needs_no_card()
    proc = _python("from repro_torch.launch.train import main; main(['--steps', '1'])")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "loss" not in proc.stdout


def test_train_entry_points_raise_without_a_card():
    _needs_no_card()
    code = ("from repro_torch.configs import RunConfig, get_config, tiny_variant\n"
            "from repro_torch.data import DataPipeline\n"
            "from repro_torch.launch.train import train_loop\n"
            "from repro_torch.train import init_train_state\n"
            "cfg = tiny_variant(get_config('tinyllama-1.1b'))\n"
            "for fn in (lambda: init_train_state(cfg), lambda: DataPipeline(cfg, 1, 8),\n"
            "           lambda: train_loop(cfg, RunConfig(), steps=1, global_batch=1,\n"
            "                              seq_len=8)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as exc:\n"
            "        assert 'no CUDA device' in str(exc), exc\n"
            "    else:\n"
            "        raise SystemExit('ran on the CPU without being asked')\n"
            "print('RAISED')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RAISED" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    _needs_no_card()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_mesh_entry_points_raise_without_a_card():
    """On a started (one-rank gloo) group, a mesh, a resize plan and a
    restore onto it are built on the card unless the CPU is named; a
    planning mesh beyond the group needs no device."""
    _needs_no_card()
    code = ("import tempfile\n"
            "import torch, torch.distributed as dist\n"
            "from repro_torch.configs import RunConfig, get_config, tiny_variant\n"
            "from repro_torch.checkpoint import save_checkpoint\n"
            "from repro_torch.launch.elastic import apply_resize, plan_resize\n"
            "from repro_torch.launch.mesh import AbstractMesh, make_elastic_mesh_context\n"
            "from repro_torch.train.state import init_train_state, state_tree\n"
            "dist.init_process_group('gloo', store=dist.HashStore(), rank=0, world_size=1)\n"
            "try:\n"
            "    cfg = tiny_variant(get_config('tinyllama-1.1b'))\n"
            "    d = tempfile.mkdtemp()\n"
            "    save_checkpoint(d, 1, state_tree(init_train_state(cfg, device='cpu'), cfg))\n"
            "    plan = plan_resize(1, 1, 8, 1e-3, device='cpu')\n"
            "    calls = [lambda: make_elastic_mesh_context(1),\n"
            "             lambda: plan_resize(1, 1, 8, 1e-3),\n"
            "             lambda: apply_resize(plan, cfg, RunConfig(), d)]\n"
            "    for fn in calls:\n"
            "        try:\n"
            "            fn()\n"
            "        except RuntimeError as exc:\n"
            "            assert 'no CUDA device' in str(exc), exc\n"
            "        else:\n"
            "            raise SystemExit('ran on the CPU without being asked')\n"
            "    assert isinstance(make_elastic_mesh_context(8).mesh, AbstractMesh)\n"
            "    state, step = apply_resize(plan, cfg, RunConfig(), d, device='cpu')\n"
            "    assert step == 1 and state.params.embed.device.type == 'cpu'\n"
            "finally:\n"
            "    dist.destroy_process_group()\n"
            "print('RAISED')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    assert "RAISED" in proc.stdout
