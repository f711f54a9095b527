"""``repro_torch.core.calibration.calibrate`` and the measurement runner
against the reference: per-kernel predictions, MAPE, bias, max APE,
coverage and drift count must be equal, field for field (no tolerance), for
the recorded corpora of tx2, csx and zen and for a hand-made corpus; the
service joins measured corpora as the reference's does; the runner's
executor and corpus-fallback cases of tests/test_calibration.py give the
reference's answers."""

import dataclasses

import pytest
import torch

import repro.core.bench as ref_bench
import repro.core.calibration as ref_cal
import repro.serving.analysis as ref_serving
import repro_torch.core.bench as port_bench
import repro_torch.core.calibration as port_cal
import repro_torch.serving.analysis as port_serving
from repro_torch.core.analysis import clear_analysis_cache

SMALL_ASM = "fadd d0, d0, d1\nfmul d2, d0, d3"


def plain(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("arch", ["tx2", "csx", "zen"])
def test_calibrate_equals_reference(arch):
    clear_analysis_cache()
    port = port_cal.calibrate(arch, device="cpu")
    ref = ref_cal.calibrate(arch)
    assert plain(port) == plain(ref)
    assert port.to_dict() == ref.to_dict()
    assert port.n_kernels >= 4 and port.drift_count >= 1


def corpus(pkg):
    mk = pkg.MeasuredKernel
    return pkg.MeasurementCorpus(arch="tx2", entries=(
        mk(name="gs", unroll=4, measured_cy_per_it=18.5, builtin="sample"),
        mk(name="small", unroll=1, measured_cy_per_it=3.0, asm=SMALL_ASM),
        mk(name="drifted", unroll=2, measured_cy_per_it=500.0, asm=SMALL_ASM),
    ))


def test_calibrate_corpus_equals_reference():
    port = port_cal.calibrate_corpus(corpus(port_cal), device="cpu")
    ref = ref_cal.calibrate_corpus(corpus(ref_cal))
    assert plain(port) == plain(ref)
    assert port.drift_count >= 1


def test_calibrate_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cal.calibrate("tx2")


def test_service_measurement_join_equals_reference():
    """tests/test_calibration.py's service join: a matching name carries
    the measurement and its drift finding, the cached object stays clean."""
    envelopes = []
    for serving, cal, kw in ((port_serving, port_cal, {"device": "cpu"}),
                             (ref_serving, ref_cal, {})):
        hot = cal.MeasurementCorpus(arch="tx2", entries=(cal.MeasuredKernel(
            name="hot", unroll=1, measured_cy_per_it=500.0,
            source="bench-rig"),))
        service = serving.AnalysisService(measurements={"tx2": hot}, **kw)
        bare = serving.AnalysisService(**kw)
        reqs = [serving.AnalysisRequest(asm=SMALL_ASM, arch="tx2", name=n,
                                        diagnose=True)
                for n in ("hot", "cold")]
        envelopes.append([r.to_dict() for r in service.submit_batch(reqs)]
                         + [bare.submit(reqs[0]).to_dict()]
                         + [service.stats, bare.stats])
    assert envelopes[0] == envelopes[1]
    assert envelopes[0][0]["report"]["measured_block"] == 500.0
    assert envelopes[0][1]["report"]["measured_block"] is None


def test_runner_executor_equals_reference():
    calls = []

    def executor(asm, unroll):
        calls.append((asm, unroll))
        return 1e-9  # one nanosecond per iteration

    got = []
    for bench in (port_bench, ref_bench):
        runner = bench.KernelMeasurementRunner("tx2", executor=executor)
        assert runner.can_execute
        got.append(plain(runner.measure("hot", asm=SMALL_ASM, unroll=2)))
        with pytest.raises(ValueError, match="no asm"):
            runner.measure("hot")
        with pytest.raises(ValueError, match="non-positive"):
            bench.KernelMeasurementRunner(
                "tx2", executor=lambda a, u: 0.0).measure("hot", asm=SMALL_ASM)
    assert got[0] == got[1]
    assert got[0]["measured_cy_per_it"] == pytest.approx(2.2)  # at 2.2 GHz
    assert calls == [(SMALL_ASM, 2)] * 2


def test_runner_falls_back_to_recorded_corpus(tmp_path):
    port_cal.MeasurementCorpus(arch="tx2", entries=(port_cal.MeasuredKernel(
        name="gs", unroll=4, measured_cy_per_it=18.5),)).save(tmp_path / "tx2.json")
    answers = []
    for bench in (port_bench, ref_bench):
        runner = bench.KernelMeasurementRunner("tx2", corpus_dir=tmp_path)
        assert not runner.can_execute
        empty = bench.KernelMeasurementRunner("n1", corpus_dir=tmp_path)
        answers.append([plain(runner.measure("gs", unroll=4)),
                        runner.measure("gs", unroll=2),  # no wildcard recorded
                        sorted(runner.measure_all(["gs", "nope"], unroll=4)),
                        empty.measure("gs", unroll=4)])
    assert answers[0] == answers[1]
    assert answers[0][0]["measured_cy_per_it"] == 18.5
    assert answers[0][1:] == [None, ["gs"], None]


def test_bench_exports_only_the_runner():
    assert port_bench.__all__ == ["KernelMeasurementRunner"]
