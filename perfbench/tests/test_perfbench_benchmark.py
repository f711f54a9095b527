"""BENCHMARK.json: the contract's shapes and characters, every cell's files
found by name, a new cell added by files and entries alone, and what the
harness imports."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = 24  # what later PRs may grow to, at this run length
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
            else:
                assert line(m["layer"]) and m["moves"] in e2e
                for w in m["workloads"]:  # each listed cell reports what it moves
                    assert w in e2e[m["moves"]].get("workloads", [w])
    every = [m["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for m in BENCH[k]]
    assert len(every) == len(set(every))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    spec = harness.CellSpec(workload)
    assert spec.config["name"] == spec.workload["config"]
    assert spec.driver().Cell is not None
    e2e = [m["name"] for m in spec.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.metrics("per_layer")
    assert layers
    for m in layers:
        assert callable(spec.reader(m["name"]).read)
    for number in spec.limits.values():
        assert number["limit"] is not None


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A later cell adds a configuration, a mix, a metric and a limits file,
    and entries in BENCHMARK.json; nothing that is there changes."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    pb = tmp_path / "perfbench"
    config = json.loads((pb / "configs" / "deepseek-moe-16b.json").read_text())
    config["name"] = "deepseek-moe-16b-copy"
    (pb / "configs" / "deepseek-moe-16b-copy.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "docs-short-answer.json").read_text())
    mix["prompt_median"] = 256
    (pb / "traffic" / "chat-short.json").write_text(json.dumps(mix))
    (pb / "limits" / "moe-serve-chat.json").write_text(
        (pb / "limits" / "moe-serve-docs.json").read_text())
    (pb / "metrics" / "calls.serve.py").write_text("def read(trace):\n    return len(trace.calls)\n")
    bench["configs"].append(dict(bench["configs"][0], name="deepseek-moe-16b-copy",
                                 file="perfbench/configs/deepseek-moe-16b-copy.json"))
    bench["workloads"].append({"name": "moe-serve-chat", "config": "deepseek-moe-16b-copy",
                               "traffic": "chat-short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls.serve", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "serve_tok_s", "workloads": ["moe-serve-chat"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "moe-serve-docs" in m["workloads"]:
            m["workloads"].append("moe-serve-chat")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.CellSpec("moe-serve-chat", root=tmp_path)
    assert spec.mix["prompt_median"] == 256 and spec.config["name"] == "deepseek-moe-16b-copy"
    assert "calls.serve" in [m["name"] for m in spec.metrics("per_layer")]
    assert spec.reader("calls.serve").read(type("T", (), {"calls": [1, 2]})()) == 2
    assert all(p.read_bytes() == b for p, b in before.items())


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "perfbench").rglob("*.py")))
def test_imports(path):
    """No module of the benchmark imports jax or the JAX package (whole
    top-level names: the port's name begins with the JAX package's), and
    the reference imports nothing of the program."""
    names = set(imported(ROOT / path))
    assert not names & FORBIDDEN
    if path.startswith("perfbench/reference/"):
        assert "repro_torch" not in names


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, runpy; sys.argv = ['run.py', '--help']\n"
            "try:\n    runpy.run_path('perfbench/run.py', run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "import perfbench.harness as h, perfbench.drivers.serve_waves, "
            "perfbench.calibrate, repro_torch.serving.engine\n"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "src:."})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "moe-serve-docs",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
