"""One run of one cell: set-up, the measured window, the traced calls, the
output check, and the result line.

The cell's configuration, traffic mix, per-layer readers and limits are all
found by the names in ``BENCHMARK.json``. A run refuses to start without as
many CUDA devices as the cell asks for, and refuses to print a result if
``jax``, ``jaxlib``, ``flax`` or the JAX package (``repro``) was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNEL_BUILD = ROOT / "build" / "repro_torch"


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class CellSpec:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.bench = load_json(root / "BENCHMARK.json")
        byname = {w["name"]: w for w in self.bench["workloads"]}
        if name not in byname:
            raise KeyError(f"no workload {name!r}; have {sorted(byname)}")
        self.workload = byname[name]
        entry = {c["name"]: c for c in self.bench["configs"]}[self.workload["config"]]
        self.config = load_json(root / entry["file"])
        self.mix = load_json(root / "perfbench" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "perfbench" / "limits" / f"{name}.json")
        self.root = root

    def metrics(self, kind: str) -> List[dict]:
        """The cell's end-to-end or per-layer metrics."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.workload["name"] in m["workloads"]]

    def driver(self):
        return importlib.import_module(f"perfbench.drivers.{self.mix['driver']}")

    def reader(self, metric: str):
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card(index: int = 0) -> Dict[str, str]:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    fields = "name,power.limit,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
                              "-i", str(index)], capture_output=True, text=True, timeout=60)
        return dict(zip(fields.split(","), (v.strip() for v in out.stdout.split(","))))
    except (OSError, subprocess.SubprocessError) as err:
        return {"error": str(err)}


def built() -> set:
    return set(KERNEL_BUILD.glob("*.so")) if KERNEL_BUILD.exists() else set()


def window(cell, seconds: float, trace: bool):
    """The measured window: calls until ``seconds`` have passed (and at least
    the cell's ``min_calls``, which its output check samples), then a
    synchronize. With ``trace`` the calls after the first (as many as the
    cell's ``traced_calls``) run under the profiler recording the device
    alone, for the per-layer metrics, and the call after them under the
    profiler recording the host too, for the idle gaps by host operation.
    Returns (records, window seconds, trace or None)."""
    import torch

    from perfbench.yardstick import trace as tracing

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    records, captured = [], None
    start = time.perf_counter()
    while True:
        i = len(records)
        if trace and captured is None and i == 1:
            from repro_torch.kernels import ops

            def calls(n):
                return lambda: [cell.call(len(records) + j) for j in range(n)]

            captured = tracing.capture(calls(cell.traced_calls), ops.LAUNCHES, cell)
            records += captured.calls
            hosted = tracing.capture(calls(1), ops.LAUNCHES, cell, host=True)
            records += hosted.calls
            captured.gaps = hosted.idle_gaps()
        else:
            records.append(cell.call(i))
        if time.perf_counter() - start >= seconds and len(records) >= cell.min_calls:
            break
    sync()
    return records, time.perf_counter() - start, captured


def run(spec: CellSpec, cell, seconds: float, trace: bool, t_process: float,
        device_info: Optional[dict] = None) -> dict:
    """Set-up, window, output check; returns the result line's object."""
    import torch

    before = built()
    if cell.device.type == "cuda":  # the kernels, in parallel, where not yet built
        from repro_torch.kernels import _build

        _build.build()
    cell.setup()
    compiled = built() != before
    t_first = time.time()
    setup_s = t_first - t_process
    records, window_s, captured = window(cell, seconds, trace)
    attempted, failed = cell.counts(records)
    log(window={"calls": len(records), "seconds": window_s, "setup_s": setup_s,
                "setup_compiled": compiled, "traced_calls": len(captured.calls) if captured else 0,
                "call_s": [round(r["t1"] - r["t0"], 4) for r in records]})
    on_card = torch.cuda.is_available() and cell.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
    metrics, units = {}, {}
    if trace:
        for m in spec.metrics("per_layer"):
            value = spec.reader(m["name"]).read(captured)
            if value is not None:
                metrics[m["name"]] = value
                units[m["name"]] = m["unit"]
    else:
        e2e = cell.end_to_end(records, window_s)
        e2e["setup_s"] = setup_s
        e2e["peak_mem_gib"] = peak / 2 ** 30
        for m in spec.metrics("end_to_end"):
            metrics[m["name"]] = e2e[m["name"]]
            units[m["name"]] = m["unit"]
    cell.release()
    t_check = time.time()
    checks = cell.check(records, spec.limits)
    log(check={"seconds": time.time() - t_check})
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
              "device": dict(device_info or {}, memory_peak_bytes=peak)}
    if captured is not None:
        result["device"].update(busy_s=captured.busy_s, window_s=captured.window_s)
        result["breakdown"] = {"device_ops": captured.device_ops(),
                               "idle_gaps": captured.gaps}
    result["checks"] = checks
    return result


def process_start() -> float:
    """The wall-clock time this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = t_process or process_start()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = CellSpec(args.workload)
    import torch

    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    log(card=card(0), torch=torch.__version__, cuda=torch.version.cuda,
        workload=args.workload, seed=args.seed, seconds=args.seconds, trace=args.trace)
    cell = spec.driver().Cell(spec.config, spec.mix, args.seed, device)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    result = run(spec, cell, args.seconds, bool(args.trace), t_process, info)
    log(card_after=card(0))
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}, which the benchmark may not import", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
