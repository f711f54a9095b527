"""``repro_torch.api.analyze`` against ``repro.api.analyze``: the schema-v5
``to_dict()`` must be equal, float64 for float64, over the five machine
models × unroll × predictor subsets × diagnose, on the randomized kernels of
tests/test_sim.py, with measured corpora and on the degradation ladder; the
paper's Table I and the simulator's pins hold on the port; HLO sources and
``torch.export`` programs route to the h100 target as the reference's route
to tpu-v5e."""

import json
import warnings

import pytest
import torch

import repro.api as ref_api
import repro.core.analysis as ref_analysis
import repro.core.analysis.analyze as ref_analyze
import repro_torch.api as port_api
import repro_torch.core.analysis as port_analysis
import repro_torch.core.analysis.analyze as port_analyze
import repro_torch.core.analysis.batch as port_batch
import repro_torch.core.analysis.sweep as port_sweep
from repro_torch.core.registry import get_arch
from repro_torch.core.validation import TABLE1
from test_api import WHILE_HLO
from test_torch_analysis import random_kernel_text

ASM_ARCHS = ("tx2", "csx", "zen", "zen2", "n1")
PREDICTOR_SETS = (None, ("tp", "cp", "lcd"), ("tp",), ("tp", "lcd"),
                  ("tp", "cp"), ("sim",))
# Simulator pins at unroll 4 (tests/test_sim.py, BENCH_analysis.json).
SIM_PINS = {"tx2": (18.0, "ports"), "n1": (7.5, "dependencies"),
            "csx": (14.0, "dependencies"), "zen": (11.5, "dependencies"),
            "zen2": (10.5, "dependencies")}


def both(text, arch, name="gauss-seidel", **opts):
    """Reference and port reports of one analysis, each from a cold cache."""
    ref_analysis.clear_analysis_cache()
    port_analysis.clear_analysis_cache()
    ref = ref_api.analyze(text, arch=arch, name=name,
                          options=ref_api.AnalyzeOptions(**opts))
    port = port_api.analyze(text, arch=arch, name=name, device="cpu",
                            options=port_api.AnalyzeOptions(**opts))
    return ref, port


@pytest.mark.parametrize("diagnose", [False, True])
@pytest.mark.parametrize("predictors", PREDICTOR_SETS,
                         ids=lambda p: ",".join(p) if p else "default")
@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_to_dict_equal_reference_on_gauss_seidel(arch, unroll, predictors, diagnose):
    ref, port = both(get_arch(arch).sample_asm, arch, unroll=unroll,
                     predictors=predictors, diagnose=diagnose)
    assert port.to_dict() == ref.to_dict()
    json.dumps(port.to_dict())  # plain data: no tensor left in the report


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_to_dict_equal_reference_on_randomized_kernels(arch, seed):
    ref, port = both(random_kernel_text(arch, seed), arch, name="rand",
                     diagnose=True)
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_measurements_auto_joins_the_recorded_corpus(arch):
    ref, port = both(get_arch(arch).sample_asm, arch, unroll=4, diagnose=True,
                     measurements="auto")
    assert port.to_dict() == ref.to_dict()
    if arch in ("tx2", "csx", "zen"):
        assert port.measured_block is not None
        assert port.measured_per_it == TABLE1[arch].measured_cy_per_it
    else:
        assert port.measured_block is None


def test_synthetic_corpus_entries_join():
    for arch in ("tx2", "csx", "zen"):
        corpus = port_api.AnalyzeOptions(measurements="auto").resolved(arch).measurements
        for entry in corpus.entries:
            if entry.asm:
                ref, port = both(entry.asm, arch, name=entry.name, unroll=entry.unroll,
                                 diagnose=True, measurements="auto")
                assert port.measured_source == entry.source
                assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_degrade_walks_the_ported_ladder(arch):
    ref, port = both(get_arch(arch).sample_asm, arch, unroll=2, degrade=True,
                     diagnose=True)
    assert port.to_dict() == ref.to_dict()
    assert port.degradation == "full"


@pytest.mark.parametrize("failing_stage,rung", [
    ("sim", "bracket"), ("lcd", "tp_only"), ("dag", "tp_only"),
    ("tp", "parse_only"), ("resolve", "parse_only")])
def test_ladder_rungs_equal_reference(failing_stage, rung):
    def checkpoint(stage):
        if stage == failing_stage:
            raise RuntimeError(f"injected at {stage}")

    for arch in ("tx2", "zen"):
        spec, ref_spec = get_arch(arch), ref_api.get_arch(arch)
        ref = ref_analyze.analyze_kernel_ladder(
            ref_spec.parser(ref_spec.sample_asm, name="gs"), ref_api.model_for(arch),
            4, checkpoint=checkpoint, diagnose=True)
        port = port_analyze.analyze_kernel_ladder(
            spec.parser(spec.sample_asm, name="gs"), port_api.model_for(arch), 4,
            checkpoint=checkpoint, diagnose=True, device="cpu")
        assert port.degradation == rung
        assert port.to_report().to_dict() == ref.to_report().to_dict()


def test_table1_pins():
    for arch in ("tx2", "csx", "zen"):
        port_analysis.clear_analysis_cache()
        report = port_api.analyze(get_arch(arch).sample_asm, arch=arch,
                                  name="gauss-seidel", device="cpu",
                                  options=port_api.AnalyzeOptions(unroll=4))
        row = TABLE1[arch]
        assert round(report.tp_per_it, 2) == row.tp
        assert report.lcd_per_it == pytest.approx(row.lcd)
        assert report.cp_per_it == pytest.approx(row.cp)


@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_simulator_pins(arch):
    port_analysis.clear_analysis_cache()
    analysis = port_api.analyze_raw(get_arch(arch).sample_asm, arch=arch, name="gs",
                                    device="cpu",
                                    options=port_api.AnalyzeOptions(unroll=4))
    sim_per_it, limiter = SIM_PINS[arch]
    assert analysis.sim_per_it == pytest.approx(sim_per_it, abs=1e-9)
    assert analysis.sim.limiter == limiter
    assert analysis.sim.copies == 4 and analysis.sim.converged


@pytest.mark.parametrize("fmt", ["text", "json", "markdown"])
@pytest.mark.parametrize("arch", ["tx2", "csx"])
def test_renderers_equal_reference(arch, fmt):
    ref, port = both(get_arch(arch).sample_asm, arch, unroll=4, diagnose=True,
                     measurements="auto")
    assert port.render(fmt) == ref.render(fmt)


def test_legacy_kwargs_coerce_to_the_same_analysis():
    text = get_arch("tx2").sample_asm
    port_analysis.clear_analysis_cache()
    with pytest.warns(DeprecationWarning):
        legacy = port_api.analyze(text, arch="tx2", unroll=4, diagnose=True,
                                  device="cpu")
    modern = port_api.analyze(text, arch="tx2", device="cpu",
                              options=port_api.AnalyzeOptions(unroll=4, diagnose=True))
    assert legacy.to_dict() == modern.to_dict()
    with pytest.warns(DeprecationWarning):
        positional = port_api.analyze(text, "thunderx2", 4, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_api.analyze(text, "thunderx2", 4)
    assert positional.to_dict() == ref.to_dict()


def test_sources_paths_and_kernels(tmp_path):
    text = get_arch("csx").sample_asm
    path = tmp_path / "gs.s"
    path.write_text(text)
    port_analysis.clear_analysis_cache()
    from_path = port_api.analyze(str(path), arch="clx", device="cpu")
    assert from_path.kernel_name == "gs.s" and from_path.arch == "csx"
    kernel = get_arch("csx").parser(text, name="mine")
    from_kernel = port_api.analyze(kernel, arch="csx", device="cpu")
    assert from_kernel.kernel_name == "mine"
    ref = ref_api.analyze(str(path), arch="clx")
    assert from_path.to_dict() == ref.to_dict()


def test_timeout_raises_not_implemented():
    # ``timeout_s`` is ported now (the serving tier's deadlines): under a
    # generous deadline it no longer raises, and the report is the
    # reference's. tests/test_torch_resilience.py covers expired deadlines.
    text = get_arch("tx2").sample_asm
    for opts in (dict(unroll=4, timeout_s=60.0),
                 dict(unroll=4, timeout_s=60.0, degrade=True)):
        ref, port = both(text, "tx2", **opts)
        assert not port.degraded
        assert port.to_dict() == ref.to_dict()
        raw = port_api.analyze_raw(text, arch="tx2", name="gauss-seidel",
                                   device="cpu",
                                   options=port_api.AnalyzeOptions(**opts))
        assert raw.to_report().to_dict() == ref.to_dict()


def test_hlo_sources_route_to_h100(tmp_path):
    """HLO text, an .hlo path, a parsed module and an ExportedProgram are
    analyzed on the h100 target, auto-routed there under an asm arch, as
    repro.api routes them to tpu-v5e."""
    from test_torch_hlo import TorchFori
    from repro_torch.core.hlo import lower_exported, parse_hlo

    on_h100 = port_api.analyze(WHILE_HLO, arch="h100", device="cpu")
    assert (on_h100.kind, on_h100.arch, on_h100.ports) == ("hlo", "h100", ("TC", "HBM", "NVLink"))
    assert on_h100.lcd_block > 0 and on_h100.cp_block >= on_h100.lcd_block - 1e-12
    for arch in ("tx2", "hopper", "sm90", "H100-SXM"):
        for source in (WHILE_HLO, parse_hlo(WHILE_HLO)):
            assert port_api.analyze(source, arch=arch, device="cpu").to_dict() == \
                on_h100.to_dict()
    path = tmp_path / "module.hlo"
    path.write_text(WHILE_HLO)
    from_path = port_api.analyze(str(path), device="cpu")
    assert from_path.kernel_name == "module.hlo"
    assert from_path.prediction_bracket() == on_h100.prediction_bracket()
    ep = torch.export.export(TorchFori(), (torch.ones(8, 64), torch.ones(64, 64)))
    report = port_api.analyze(ep, arch="tx2", device="cpu", name="fori")
    assert (report.kind, report.arch, report.kernel_name) == ("hlo", "h100", "fori")
    assert report.to_dict() == port_api.analyze(lower_exported(ep), arch="h100",
                                                device="cpu", name="fori").to_dict()
    with pytest.raises(ValueError, match="unknown arch 'tpu-v5e'"):
        port_api.analyze(WHILE_HLO, arch="tpu-v5e", device="cpu")


def test_hlo_branch_rejects_as_the_reference_does():
    from repro.core.isa import parse_aarch64

    for opts in (dict(predictors=("tp",)), dict(diagnose=True),
                 dict(measurements="auto")):
        with pytest.raises(ValueError) as ref:
            ref_api.analyze(WHILE_HLO, arch="tpu-v5e", options=ref_api.AnalyzeOptions(**opts))
        with pytest.raises(ValueError) as port:
            port_api.analyze(WHILE_HLO, arch="h100", device="cpu",
                             options=port_api.AnalyzeOptions(**opts))
        assert str(port.value) == str(ref.value)
    for source in ("fadd d0, d0, d1", parse_aarch64("fadd d0, d0, d1")):
        with pytest.raises(ValueError, match="arch 'h100' expects an HLO module"):
            port_api.analyze(source, arch="hopper", device="cpu")
    with pytest.raises(ValueError, match="not a valid HLO module"):
        port_api.analyze("HloModule truncated\n", arch="tx2", device="cpu")
    with pytest.raises(ValueError) as ref:
        ref_api.analyze_raw(WHILE_HLO, arch="tpu-v5e")
    with pytest.raises(ValueError) as port:
        port_api.analyze_raw(WHILE_HLO, arch="h100", device="cpu")
    assert str(port.value) == str(ref.value).replace("tpu-v5e", "h100")


def test_hlo_report_json_roundtrip():
    report = port_api.analyze(WHILE_HLO, arch="hopper", device="cpu")
    payload = json.dumps(report.to_dict(), sort_keys=True)
    restored = port_api.AnalysisReport.from_dict(json.loads(payload))
    assert json.dumps(restored.to_dict(), sort_keys=True) == payload
    assert restored.render("text") == report.render("text")


def test_cache_separates_devices_and_serves_views():
    text = get_arch("zen").sample_asm
    kernel = get_arch("zen").parser(text, name="a")
    model = port_api.model_for("zen")
    keys = {port_analyze._cache_key(kernel, model, 4, device_type=d)
            for d in ("cpu", "cuda")}
    assert len(keys) == 2
    port_analysis.clear_analysis_cache()
    port_sweep.reset_sweeps()
    port_batch.reset_wave_passes()
    renamed = get_arch("zen").parser(text, name="b")
    opts = port_api.AnalyzeOptions(unroll=4)
    first, dup = port_analysis.analyze_kernels([kernel, renamed], model, opts,
                                               device="cpu")
    (hit,) = port_analysis.analyze_kernels([kernel], model, opts, device="cpu")
    # Analyzed once, as one wave: its CP pass and one LCD chunk pass.
    assert port_batch.WAVE_PASSES == {"cpu": 2, "cuda": 0}
    assert port_sweep.SWEEPS == {"cpu": 0, "cuda": 0}
    assert port_analyze._cache.stats == {"hits": 2, "misses": 1}
    assert (first.kernel.name, dup.kernel.name, hit.kernel.name) == ("a", "b", "a")
    assert dup.lcd is first.lcd and hit is first
