"""``repro_torch.core.machine.lint`` against ``repro.core.machine.lint``: the
findings (severity, arch, code, subject, message) must be equal on the
shipped machine models, on the registry, and on each purposely corrupted
table of tests/test_lint.py; the CLI's exit codes are the reference's, and
``python -m repro_torch.core.machine.lint --strict`` passes."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

import repro.core.machine as ref_machine
import repro.core.machine.lint as ref_lint
import repro.core.machine.model as ref_model
import repro.core.machine.window as ref_window
import repro.core.registry as ref_registry
import repro_torch.core.machine as port_machine
import repro_torch.core.machine.lint as port_lint
import repro_torch.core.machine.model as port_model
import repro_torch.core.machine.window as port_window
import repro_torch.core.registry as port_registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
FACTORIES = ("thunderx2", "cascade_lake", "zen", "zen2", "neoverse_n1")
PORT = (port_machine, port_model, port_window, port_lint, port_registry)
REF = (ref_machine, ref_model, ref_window, ref_lint, ref_registry)


def issues(found):
    return [(i.severity, i.arch, i.code, i.subject, i.message) for i in found]


def with_entry(model, key, entry):
    db = dict(model.db)
    db[key] = entry
    return dataclasses.replace(model, db=db)


# Each corruption of tests/test_lint.py, built in either package:
# (machine, model module, window module) -> the model to lint.
CORRUPTIONS = {
    "negative_latency_undeclared_port": lambda m, mm, w: with_entry(
        m.thunderx2(), "badinst", mm.DBEntry(latency=-3.0, pressure={"P9": 0.5})),
    "nan_latency": lambda m, mm, w: with_entry(
        m.thunderx2(), "naninst", mm.DBEntry(latency=float("nan"), pressure={})),
    "implausible_latency": lambda m, mm, w: with_entry(
        m.thunderx2(), "slowinst", mm.DBEntry(latency=4000.0, pressure={"P0": 1.0})),
    "negative_pressure_empty_uop_ports": lambda m, mm, w: with_entry(
        m.thunderx2(), "badp",
        mm.DBEntry(latency=1.0, pressure={"P0": -0.5}, uops=((1.0, ()),))),
    "uop_pressure_mismatch": lambda m, mm, w: with_entry(
        m.thunderx2(), "liar", mm.DBEntry(latency=1.0, pressure={"P0": 1.0},
                                          uops=((1.0, ("P0", "P1")),))),
    "uop_pressure_honest": lambda m, mm, w: with_entry(
        m.thunderx2(), "liar", mm.uops_entry(1.0, [(1.0, ("P0", "P1"))])),
    "throughput_inconsistent": lambda m, mm, w: with_entry(
        m.thunderx2(), "tooGood", dataclasses.replace(
            mm.uops_entry(4.0, [(2.0, ("P0",))]), throughput=0.5)),
    "throughput_consistent": lambda m, mm, w: with_entry(
        m.thunderx2(), "tooGood", dataclasses.replace(
            mm.uops_entry(4.0, [(2.0, ("P0",))]), throughput=2.0)),
    "duplicate_port": lambda m, mm, w: dataclasses.replace(
        m.thunderx2(), ports=m.thunderx2().ports + ("P0",)),
    "missing_entry": lambda m, mm, w: dataclasses.replace(
        m.thunderx2(), load_entry=None),
    "window_bounds": lambda m, mm, w: dataclasses.replace(
        m.thunderx2(), window=w.WindowParams(issue_width=8, rob_size=4,
                                             sched_size=60, lsq_size=36,
                                             retire_width=4)),
    "no_window": lambda m, mm, w: dataclasses.replace(m.thunderx2(), window=None),
    "fusion_no_pressure": lambda m, mm, w: dataclasses.replace(
        m.cascade_lake(), fused_branch_pressure={}),
    "bad_frequency": lambda m, mm, w: dataclasses.replace(
        m.thunderx2(), frequency_ghz=0.0),
}


@pytest.mark.parametrize("factory", FACTORIES)
def test_shipped_models_equal_reference(factory):
    port = issues(port_lint.lint_model(getattr(port_machine, factory)()))
    assert port == issues(ref_lint.lint_model(getattr(ref_machine, factory)()))
    assert port == []


def test_shipped_registry_and_lint_all_equal_reference():
    assert issues(port_lint.lint_registry()) == issues(ref_lint.lint_registry()) == []
    assert issues(port_lint.lint_all()) == issues(ref_lint.lint_all()) == []


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corrupted_models_equal_reference(name):
    build = CORRUPTIONS[name]
    port = issues(port_lint.lint_model(build(*PORT[:3])))
    ref = issues(ref_lint.lint_model(build(*REF[:3])))
    assert port == ref
    assert bool(port) == (name not in ("uop_pressure_honest",
                                       "throughput_consistent"))


def registry_tables(pkg, name):
    """The injected alias/registry tables of tests/test_lint.py's registry
    cases, from ``pkg``'s own live snapshot where they need one."""
    if name == "alias_cycle":
        return {"a": "B", "b": "A"}, {}
    if name == "dangling_alias":
        return {"a": "ghost"}, {}
    names, registry = pkg.registry_snapshot()
    if name == "self_resolution":
        names["tx2"] = "csx"
    elif name == "no_parser":
        registry["tx2"] = dataclasses.replace(registry["tx2"], parser=None)
    return names, registry


@pytest.mark.parametrize("name", ["alias_cycle", "dangling_alias",
                                  "self_resolution", "no_parser"])
def test_corrupted_registries_equal_reference(name):
    port = issues(port_lint.lint_registry(*registry_tables(port_registry, name)))
    ref = issues(ref_lint.lint_registry(*registry_tables(ref_registry, name)))
    assert port == ref and port
    assert port_lint.lint_registry() == []  # live tables unharmed


@pytest.mark.parametrize("argv", [["--strict"], ["tx2", "--strict"], [],
                                  ["csx", "zen"]])
def test_cli_equal_reference(argv, capsys):
    assert port_lint.main(argv) == ref_lint.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:]  # the same summary line, twice


@pytest.mark.parametrize("severity,argv,rc", [
    ("error", [], 1), ("warning", [], 0), ("warning", ["--strict"], 1)])
def test_cli_exit_codes_on_findings(monkeypatch, capsys, severity, argv, rc):
    rcs = []
    for lint in (port_lint, ref_lint):
        issue = lint.LintIssue(severity, "tx2", "NEGATIVE_LATENCY", "badinst",
                               "latency -3.0 is not a non-negative number")
        monkeypatch.setattr(lint, "lint_all", lambda arch_ids=None: [issue])
        rcs.append(lint.main(argv))
    assert rcs == [rc, rc]
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and "NEGATIVE_LATENCY" in out[0]


def test_module_cli_strict_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.machine.lint", "--strict"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert "5 machine DB(s) + registry checked — 0 error(s), 0 warning(s)" \
        in proc.stdout
