"""The port's resilient serving path against the reference's: each seeded
chaos scenario of tests/test_resilience.py runs through both packages'
``AnalysisService`` under virtual clocks, and the envelopes
(``AnalysisResponse.to_dict()``), the service counters, the cache stats, the
simulated backoff waits and the injector's call counts must be equal. Also:
the primitives' deterministic schedules, ``api.analyze(..., timeout_s=...)``,
``ServeEngine.analyze_asm``, and ``python -m repro_torch.launch.serve --mode
analyze``."""

import json
import os
import pathlib
import subprocess
import sys
import threading
import types

import pytest
import torch

import repro.api as ref_api
import repro.core.analysis as ref_analysis
import repro.serving.analysis as ref_serving
import repro.serving.faults as ref_faults
import repro.serving.resilience as ref_res
import repro_torch.api as port_api
import repro_torch.core.analysis as port_analysis
import repro_torch.serving.analysis as port_serving
import repro_torch.serving.faults as port_faults
import repro_torch.serving.resilience as port_res
from repro_torch.core.validation import GS_CLX_ASM, GS_TX2_ASM
from test_torch_analysis import random_kernel_text

ROOT = pathlib.Path(__file__).resolve().parents[1]


def package(serving, faults, res, **service_kw):
    return types.SimpleNamespace(
        Service=lambda **kw: serving.AnalysisService(**service_kw, **kw),
        Request=serving.AnalysisRequest, Response=serving.AnalysisResponse,
        Faults=faults.FaultInjector, Clock=faults.VirtualClock,
        Config=res.ResilienceConfig, res=res)


PORT = package(port_serving, port_faults, port_res, device="cpu")
REF = package(ref_serving, ref_faults, ref_res)


def config(pkg, clock, **kw):
    kw.setdefault("request_timeout_s", 10.0)
    return pkg.Config(clock=clock, sleep=clock.sleep, **kw)


def observe(service, responses, clock, faults=None):
    return {"envelopes": [r.to_dict() for r in responses],
            "counters": dict(service.counters), "stats": dict(service.stats),
            "sleeps": list(clock.sleeps),
            "calls": faults.calls if faults else None,
            "fired": faults.fired if faults else None}


def gs(pkg, name="gs", **kw):
    return pkg.Request(asm=GS_TX2_ASM, arch="tx2", name=name, **kw)


# Each scenario drives one service through a seeded chaos run and returns
# what it observed; tests/test_resilience.py names the same runs.
def full_rung_matches_plain_path(pkg):
    clock = pkg.Clock()
    plain, resilient = pkg.Service(), pkg.Service(resilience=config(pkg, clock))
    req = gs(pkg, unroll=4)
    return observe(resilient, [plain.submit(req), resilient.submit(req)], clock)


def degrades_to_tp_only_on_persistent_cp_fault(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, rates={"stage:cp": 1.0})
    service = pkg.Service(resilience=config(pkg, clock), faults=faults)
    return observe(service, [service.submit(gs(pkg, unroll=4))], clock, faults)


def degrades_to_parse_only_on_deadline_blowout(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, rates={"timeout:dag": 1.0}, clock=clock,
                        advance_s=3600.0)
    service = pkg.Service(resilience=config(pkg, clock), faults=faults)
    return observe(service, [service.submit(gs(pkg, unroll=4))], clock, faults)


def min_rung_full_errors_instead_of_degrading(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, rates={"stage:tp": 1.0})
    service = pkg.Service(resilience=config(pkg, clock, min_rung="full"),
                          faults=faults)
    return observe(service, [service.submit(gs(pkg))], clock, faults)


def stage_budget_triggers_degradation(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, scripts={"timeout:dag": set(range(1, 7))},
                        clock=clock, advance_s=0.2)
    service = pkg.Service(resilience=config(pkg, clock, stage_timeout_s=0.1,
                                            request_timeout_s=100.0),
                          faults=faults)
    return observe(service, [service.submit(gs(pkg))], clock, faults)


def sheds_load_beyond_queue_depth(pkg):
    clock = pkg.Clock()
    service = pkg.Service(resilience=config(pkg, clock, max_queue_depth=2,
                                            retry_after_s=0.25))
    reqs = [gs(pkg, name=f"r{i}") for i in range(5)]
    return observe(service, service.submit_batch(reqs)
                   + service.submit_batch(reqs[:2]), clock)


def breaker_opens_then_recovers(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, scripts={"stage:tp": set(range(1, 7))})
    service = pkg.Service(resilience=config(pkg, clock, min_rung="full",
                                            breaker_failure_threshold=2,
                                            breaker_reset_s=30.0),
                          faults=faults)
    responses = [service.submit(gs(pkg, name=n)) for n in ("j1", "j2", "j3")]
    clock.advance(30.0)
    responses += [service.submit(gs(pkg, name=n)) for n in ("j4", "j5")]
    out = observe(service, responses, clock, faults)
    out["breaker"] = service.breaker_for("tx2").state
    return out


def degraded_answer_counts_as_breaker_failure(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, rates={"stage:cp": 1.0})
    service = pkg.Service(resilience=config(pkg, clock,
                                            breaker_failure_threshold=2),
                          faults=faults)
    responses = [service.submit(gs(pkg, name=f"d{i}")) for i in range(3)]
    return observe(service, responses, clock, faults)


def client_errors_do_not_trip_breaker(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, scripts={"parse": {1}}, transient=False)
    service = pkg.Service(resilience=config(pkg, clock,
                                            breaker_failure_threshold=1),
                          faults=faults)
    responses = [service.submit(gs(pkg, name="bad")),
                 service.submit(pkg.Request(asm="x", arch="not-a-machine"))]
    out = observe(service, responses, clock, faults)
    out["breaker"] = service.breaker_for("tx2").state
    return out


def degraded_results_are_never_cached(pkg):
    clock = pkg.Clock()
    service = pkg.Service(resilience=config(pkg, clock),
                          faults=pkg.Faults(seed=0, rates={"stage:cp": 1.0}))
    req = gs(pkg, unroll=4)
    responses = [service.submit(req)]
    service.faults = None  # the outage ends
    responses += [service.submit(req), service.submit(req)]
    return observe(service, responses, clock)


def transient_errors_are_not_negative_cached(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, scripts={"parse": {1}})
    service = pkg.Service(resilience=config(pkg, clock), faults=faults)
    return observe(service, [service.submit(gs(pkg)), service.submit(gs(pkg))],
                   clock, faults)


def permanent_errors_are_negative_cached(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, scripts={"parse": {1}}, transient=False)
    service = pkg.Service(resilience=config(pkg, clock), faults=faults)
    req = gs(pkg, name="bad")
    return observe(service, [service.submit(req), service.submit(req)], clock,
                   faults)


def cache_eviction_fault_forces_reanalysis(pkg):
    clock = pkg.Clock()
    faults = pkg.Faults(seed=0, scripts={"cache": {2}})
    service = pkg.Service(resilience=config(pkg, clock), faults=faults)
    return observe(service, [service.submit(gs(pkg)) for _ in range(3)], clock,
                   faults)


def seeded_chaos_trace(pkg):
    """``serve --mode analyze --fault-rate 0.05 --queue-depth 8`` on a
    virtual clock: 64 requests over a pool of 24 kernels on three machines,
    batches of 16, faults at every expensive stage boundary."""
    clock = pkg.Clock()
    rate = 0.05
    faults = pkg.Faults(seed=3, rates={f"stage:{s}": rate for s in
                                       ("dag", "cp", "lcd", "sim")})
    service = pkg.Service(resilience=config(pkg, clock, max_queue_depth=8,
                                            min_rung="parse_only"),
                          faults=faults)
    pool = [pkg.Request(asm=GS_TX2_ASM, arch="tx2", unroll=4, name="gs-tx2"),
            pkg.Request(asm=GS_CLX_ASM, arch="csx", unroll=4, name="gs-csx"),
            pkg.Request(asm=GS_TX2_ASM, arch="tx2", unroll=1, name="gs-tx2-1x")]
    pool += [pkg.Request(asm=random_kernel_text(arch, seed), arch=arch,
                         name=f"{arch}-rand-{seed}")
             for arch in ("tx2", "csx", "zen") for seed in range(7)]
    reqs = [pool[(7 * i + i // 5) % len(pool)] for i in range(64)]
    responses = []
    for start in range(0, len(reqs), 16):
        responses += service.submit_batch(reqs[start:start + 16])
    return observe(service, responses, clock, faults)


SCENARIOS = [full_rung_matches_plain_path,
             degrades_to_tp_only_on_persistent_cp_fault,
             degrades_to_parse_only_on_deadline_blowout,
             min_rung_full_errors_instead_of_degrading,
             stage_budget_triggers_degradation, sheds_load_beyond_queue_depth,
             breaker_opens_then_recovers,
             degraded_answer_counts_as_breaker_failure,
             client_errors_do_not_trip_breaker,
             degraded_results_are_never_cached,
             transient_errors_are_not_negative_cached,
             permanent_errors_are_negative_cached,
             cache_eviction_fault_forces_reanalysis, seeded_chaos_trace]


# The one envelope text that differs (ROADMAP §C): an unknown arch's error
# lists the registry's known ids, and the port's registry has no HLO target
# yet (item 10), so the reference's list names one more.
REF_ONLY_ARCH = "tpu-v5e (tpu/v5e/tpu_v5e), "


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_chaos_scenario_equals_reference(scenario):
    port_analysis.clear_analysis_cache()
    ref_analysis.clear_analysis_cache()
    port, ref = scenario(PORT), scenario(REF)
    for envelope in ref["envelopes"]:
        if envelope["error_code"] == "UNKNOWN_ARCH":
            assert REF_ONLY_ARCH in envelope["error"]
            envelope["error"] = envelope["error"].replace(REF_ONLY_ARCH, "")
    assert port == ref
    assert port["envelopes"]


def test_chaos_trace_reaches_every_outcome():
    out = seeded_chaos_trace(PORT)
    codes = {e["error_code"] for e in out["envelopes"]}
    assert {"", "OVERLOADED", "DEGRADED"} <= codes
    assert out["counters"]["shed"] == 32 and out["counters"]["retries"] > 0
    assert out["fired"]


# -- the primitives replay the reference's schedules ---------------------------


def test_backoff_and_injector_schedules_equal_reference():
    runs = []
    for res, faults in ((port_res, port_faults), (ref_res, ref_faults)):
        policy = res.RetryPolicy(base_delay_s=0.01, max_delay_s=0.05)
        rng = res.ResilienceConfig(seed=7).jitter_rng()
        inj = faults.FaultInjector(seed=42, rates={"stage:cp": 0.3},
                                   scripts={"parse": {2, 5}})
        runs.append(([policy.backoff(i, rng) for i in range(8)],
                     [inj.should_fire(s) for s in ("stage:cp", "parse") * 20],
                     inj.calls, inj.fired))
    assert runs[0] == runs[1]


def test_error_texts_equal_reference():
    for exc_p, exc_r in (
            (port_res.StageTimeout("cp", 0.25), ref_res.StageTimeout("cp", 0.25)),
            (port_faults.InjectedFault("timeout:dag", 3),
             ref_faults.InjectedFault("timeout:dag", 3)),
            (port_res.AdmissionController(8).overload_error(),
             ref_res.AdmissionController(8).overload_error())):
        assert (str(exc_p), exc_p.code, exc_p.retryable) == \
            (str(exc_r), exc_r.code, exc_r.retryable)
    for exc in (ValueError("unknown arch 'm1'"), KeyError("fmla"),
                RuntimeError("boom")):
        assert port_res.classify_exception(exc) == ref_res.classify_exception(exc)


def test_run_with_deadline_abandons_a_blocked_worker():
    release = threading.Event()
    try:
        with pytest.raises(port_res.StageTimeout) as ei:
            port_res.run_with_deadline(release.wait, 0.05)
        assert ei.value.stage == "worker"
    finally:
        release.set()
    assert port_res.run_with_deadline(lambda: 42, 5.0) == 42


# -- the facade's deadlines ----------------------------------------------------


def both_reports(**opts):
    port_analysis.clear_analysis_cache()
    ref_analysis.clear_analysis_cache()
    port = port_api.analyze(GS_TX2_ASM, arch="tx2", device="cpu",
                            options=port_api.AnalyzeOptions(**opts))
    ref = ref_api.analyze(GS_TX2_ASM, arch="tx2",
                          options=ref_api.AnalyzeOptions(**opts))
    return port, ref


def test_api_analyze_degrades_on_expired_deadline():
    port, ref = both_reports(timeout_s=0.0, degrade=True)
    assert port.degraded and port.degradation == "parse_only" and port.rows
    assert port.to_dict() == ref.to_dict()


def test_api_analyze_raises_without_degrade():
    with pytest.raises(port_res.StageTimeout, match="deadline expired at "
                                                    "stage 'resolve'"):
        port_api.analyze(GS_TX2_ASM, arch="tx2", device="cpu",
                         options=port_api.AnalyzeOptions(timeout_s=0.0))


@pytest.mark.parametrize("degrade", [False, True])
def test_api_analyze_under_generous_deadline_is_bit_identical(degrade):
    port, ref = both_reports(unroll=4, timeout_s=60.0, degrade=degrade)
    plain, _ = both_reports(unroll=4)
    assert not port.degraded
    assert port.to_dict() == ref.to_dict() == plain.to_dict()


# -- the engine's co-resident service and the CLI ------------------------------


def test_serve_engine_analyze_asm():
    from repro_torch.configs import get_config, tiny_variant
    from repro_torch.models import Transformer
    from repro_torch.serving import ServeEngine

    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    engine = ServeEngine(cfg, Transformer(cfg, device="cpu"), device="cpu")
    assert engine.analysis.device.type == "cpu"
    assert engine.analysis is engine.analysis  # built once
    reqs = [port_serving.AnalysisRequest(asm=GS_TX2_ASM, arch="tx2", unroll=4,
                                         name="gs"),
            port_serving.AnalysisRequest(asm=GS_CLX_ASM, arch="clx", name="c")]
    got = engine.analyze_asm(reqs)
    ref = ref_serving.AnalysisService().analyze_batch(
        [ref_serving.AnalysisRequest(**r.to_dict()) for r in reqs])
    assert [a.to_report().to_dict() for a in got] == \
        [a.to_report().to_dict() for a in ref]


def serve_cli(module, *args):
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", module, "--mode", "analyze",
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]


@pytest.mark.parametrize("args", [
    ("--requests", "5", "--arch", "zen2"),
    ("--requests", "24", "--batch-size", "8", "--deadline-ms", "60000",
     "--queue-depth", "6", "--fault-rate", "0.05", "--fault-seed", "1",
     "--predictors", "tp,cp,lcd", "--diagnose")],
    ids=["plain", "resilient"])
def test_serve_analyze_emits_the_reference_envelopes(args):
    port = serve_cli("repro_torch.launch.serve", "--device", "cpu", *args)
    ref = serve_cli("repro.launch.serve", *args)
    assert len(port) == len(ref) == int(args[1]) + 1  # responses + summary
    assert port[:-1] == ref[:-1]
    summary, ref_summary = port[-1], ref[-1]
    assert summary.pop("device") == "cpu"
    for timed in ("seconds", "req_per_s"):
        summary.pop(timed), ref_summary.pop(timed)
    assert summary == ref_summary


def test_service_and_cli_run_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for make in (port_serving.AnalysisService,
                 lambda: port_serving.AnalysisService(resilience=port_res.ResilienceConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "analyze",
         "--requests", "1"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert '"event": "summary"' not in proc.stdout
