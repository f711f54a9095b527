"""``repro_torch.core.analysis.batch.analyze_wave`` against the reference's
``repro.core.analysis.batch.analyze_wave`` and against the port's own
per-kernel ``analyze_kernel`` loop: ``AnalysisReport.to_dict()`` must be equal
(exact floats, exact ordering, no tolerance) over the grid of
tests/test_batch.py (five machines x unroll x predictor subsets x diagnose,
ragged waves of 1 beside 512 instructions, duplicate texts, empty and
singleton waves, the empty-kernel fallback, padding that never leaks, the
cache settings and the LRU's stats), on the CPU. The level-synchronous pass
is also held to a scalar per-node sweep on random graphs with ties, zero
weights and unreachable columns, and chunked waves to unchunked ones."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import repro.core.analysis.batch as ref_batch
import repro.core.registry as ref_registry
import repro_torch.core.analysis.analyze as port_analyze
import repro_torch.core.analysis.batch as port_batch
from repro.core.machine.model import DBEntry as RefDBEntry
from repro_torch.core.analysis import analyze_kernel, analyze_kernels
from repro_torch.core.analysis.sweep import UNREACHABLE
from repro_torch.core.machine.model import DBEntry as PortDBEntry
from repro_torch.core.registry import get_arch

ARCHS = ("tx2", "n1", "csx", "zen", "zen2")
PREDICTOR_SETS = (("tp",), ("tp", "cp"), ("tp", "lcd"), ("tp", "cp", "lcd"),
                  None)
AARCH64_OPS = ["fadd d{a}, d{b}, d{c}", "fmul d{a}, d{b}, d{c}",
               "fdiv d{a}, d{b}, d{c}", "add x{a}, x{b}, 8",
               "ldr d{a}, [x{b}, 8]", "str d{a}, [x{b}], 8",
               "cmp x{a}, x{b}"]
X86_OPS = ["vaddsd %xmm{a}, %xmm{b}, %xmm{c}",
           "vmulsd %xmm{a}, %xmm{b}, %xmm{c}",
           "movsd 8(%rax,%rbx,8), %xmm{a}",
           "movsd %xmm{a}, 8(%rax,%rbx,8)",
           "addq $8, %rax", "cmpq %rbx, %rax"]
SEEDS = {arch: 101 * (i + 1) for i, arch in enumerate(ARCHS)}


def random_text(rng, isa, n):
    ops = AARCH64_OPS if isa == "aarch64" else X86_OPS
    return "\n".join(
        rng.choice(ops).format(a=rng.randint(0, 7), b=rng.randint(0, 7),
                               c=rng.randint(0, 7))
        for _ in range(n))


def random_texts(arch, seed, count, lo=1, hi=12):
    rng = random.Random(seed)
    isa = get_arch(arch).isa
    return [random_text(rng, isa, rng.randint(lo, hi)) for _ in range(count)]


class Side:
    """One package's model and parser for an arch (the port's or the
    reference's)."""

    def __init__(self, spec, model=None):
        self.spec = spec
        self.model = model if model is not None else spec.model_factory()

    def kernels(self, texts, names=None):
        names = names or [f"k{i}" for i in range(len(texts))]
        return [self.spec.parser(t, name=n) for t, n in zip(texts, names)]


def sides(arch):
    return Side(get_arch(arch)), Side(ref_registry.get_arch(arch))


def dicts(analyses):
    return [a.to_report().to_dict() for a in analyses]


def check_wave(arch, texts, names=None, port=None, ref=None, **kw):
    """Port wave == reference wave == port per-kernel loop; returns the
    port's dicts."""
    if port is None:
        port, ref = sides(arch)
    pk, rk = port.kernels(texts, names), ref.kernels(texts, names)
    got = dicts(port_batch.analyze_wave(pk, port.model, device="cpu", **kw))
    assert got == dicts(ref_batch.analyze_wave(rk, ref.model, **kw))
    loop = [analyze_kernel(k, port.model, device="cpu", **kw) for k in pk]
    assert got == dicts(loop)
    return got


# -- the differential grid of tests/test_batch.py ------------------------------


@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_wave_equal_across_unrolls(arch, unroll):
    texts = random_texts(arch, SEEDS[arch] + unroll, 6)
    check_wave(arch, texts + [get_arch(arch).sample_asm], unroll=unroll)


@pytest.mark.parametrize("preds", PREDICTOR_SETS,
                         ids=lambda p: ",".join(p) if p else "default")
@pytest.mark.parametrize("arch", ARCHS)
def test_wave_equal_across_predictor_subsets(arch, preds):
    check_wave(arch, random_texts(arch, SEEDS[arch] + 7, 5), predictors=preds)


@pytest.mark.parametrize("diagnose", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_wave_equal_with_diagnostics(arch, diagnose):
    got = check_wave(arch, random_texts(arch, SEEDS[arch] + 11, 5),
                     diagnose=diagnose)
    if diagnose:
        assert all(d["findings"] is not None for d in got)


@pytest.mark.parametrize("arch", ["tx2", "csx"])
def test_ragged_wave_1_instr_next_to_512_instr(arch):
    rng = random.Random(77)
    isa = get_arch(arch).isa
    texts = [random_text(rng, isa, n) for n in (1, 512, 3, 512)]
    check_wave(arch, texts, predictors=("tp", "cp", "lcd"))


@pytest.mark.parametrize("arch", ARCHS)
def test_duplicate_kernel_texts_in_one_wave(arch):
    text, other = random_texts(arch, SEEDS[arch] + 13, 2, lo=4, hi=8)
    names = ["dup-a", "solo", "dup-b", "dup-c"]
    got = check_wave(arch, [text, other, text, text], names=names)
    assert [d["kernel_name"] for d in got] == names


def test_wave_empty_and_singleton():
    port, _ = sides("tx2")
    assert port_batch.analyze_wave([], port.model, device="cpu") == []
    check_wave("tx2", ["fadd d0, d1, d2"])


def test_wave_with_empty_kernel_falls_back_on_the_same_device(monkeypatch):
    seen = []
    real = port_analyze.analyze_kernel

    def spy(*args, **kwargs):
        seen.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_analyze, "analyze_kernel", spy)
    texts = random_texts("tx2", 5, 2, lo=4, hi=6)
    port, ref = sides("tx2")
    assert len(port.kernels([""])[0].instructions) == 0
    pk = port.kernels([texts[0], "", texts[1]])
    rk = ref.kernels([texts[0], "", texts[1]])
    got = dicts(port_batch.analyze_wave(pk, port.model, device="cpu"))
    assert got == dicts(ref_batch.analyze_wave(rk, ref.model))
    assert seen == [torch.device("cpu")]  # the empty kernel, on the wave's device


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_rows_never_leak_into_members(arch):
    """Every member of a ragged wave reports what it reports alone."""
    port, _ = sides(arch)
    texts = random_texts(arch, SEEDS[arch] + 17, 8, hi=24)
    wave = check_wave(arch, texts)
    for i, (text, in_wave) in enumerate(zip(texts, wave)):
        solo = port_batch.analyze_wave(port.kernels([text], [f"k{i}"]),
                                       port.model, device="cpu")
        assert dicts(solo)[0] == in_wave


# -- analyze_kernels sends its misses through the wave --------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_kernels_cache_settings_agree(arch):
    port, _ = sides(arch)
    texts = random_texts(arch, SEEDS[arch] + 19, 6)
    kernels = port.kernels(texts + [texts[0]],
                           [f"k{i}" for i in range(6)] + ["dup"])
    port_analyze.clear_analysis_cache()
    cold = analyze_kernels(kernels, port.model, use_cache=False, device="cpu")
    warm = analyze_kernels(kernels, port.model, use_cache=True, device="cpu")
    again = analyze_kernels(kernels, port.model, use_cache=True, device="cpu")
    assert dicts(cold) == dicts(warm) == dicts(again)
    assert dicts(cold) == dicts(
        [analyze_kernel(k, port.model, device="cpu") for k in kernels])


def test_analyze_kernels_lru_stats_semantics():
    port, _ = sides("tx2")
    texts = random_texts("tx2", 11, 3, lo=5, hi=5)
    wave = port.kernels([texts[0], texts[1], texts[0], texts[2], texts[0]],
                        ["a", "b", "a-dup", "c", "a-dup2"])
    port_analyze.clear_analysis_cache()
    stats = port_analyze._cache.stats
    analyze_kernels(wave, port.model, device="cpu")
    assert (stats["misses"], stats["hits"]) == (3, 2)  # in-wave duplicates
    analyze_kernels(wave, port.model, device="cpu")
    assert (stats["misses"], stats["hits"]) == (3, 7)  # 5 more, all served


def test_analyze_kernels_misses_are_one_wave(monkeypatch):
    port, _ = sides("csx")
    waves = []
    real = port_batch.analyze_wave

    def spy(kernels, model, **kwargs):
        waves.append((len(kernels), kwargs["device"]))
        return real(kernels, model, **kwargs)

    monkeypatch.setattr(port_batch, "analyze_wave", spy)
    texts = random_texts("csx", 23, 4)
    port_analyze.clear_analysis_cache()
    analyze_kernels(port.kernels(texts[:2]), port.model, device="cpu")
    analyze_kernels(port.kernels(texts), port.model, device="cpu")
    analyze_kernels(port.kernels(texts), port.model, device="cpu",
                    use_cache=False)
    cpu = torch.device("cpu")
    assert waves == [(2, cpu), (2, cpu), (4, cpu)]


def test_analyze_kernels_cache_hit_returns_named_view():
    port, _ = sides("tx2")
    text = "fadd d0, d1, d2\nfmul d3, d0, d4"
    port_analyze.clear_analysis_cache()
    (first,) = analyze_kernels(port.kernels([text], ["first"]), port.model,
                               device="cpu")
    (second,) = analyze_kernels(port.kernels([text], ["second"]), port.model,
                                device="cpu")
    assert (first.kernel.name, second.kernel.name) == ("first", "second")
    assert second.tp is first.tp


# -- ties, zero weights, UNREACHABLE against the padding -----------------------


def with_latency(arch, latency, mnemonics=None):
    """Both packages' models of ``arch`` with the latency of every DB entry
    (or of those of ``mnemonics``) set to ``latency``."""
    out = []
    for side, entry_cls in zip(sides(arch), (PortDBEntry, RefDBEntry)):
        model = side.model
        db = {k: (dataclasses.replace(e, latency=latency)
                  if mnemonics is None or k.split(":")[0] in mnemonics else e)
              for k, e in model.db.items()}
        assert db != model.db
        assert all(isinstance(e, entry_cls) for e in db.values())
        loads = (dataclasses.replace(model.load_entry, latency=latency)
                 if mnemonics is None else model.load_entry)
        out.append(Side(side.spec, dataclasses.replace(
            model, name=f"{model.name}-lat{latency}", db=db,
            load_entry=loads, _lookup_cache={}, fallbacks={})))
    return out


@pytest.mark.parametrize("latency", [1.0, 0.0])
@pytest.mark.parametrize("arch", ["tx2", "csx"])
def test_all_equal_and_zero_latencies(arch, latency):
    # Every path of equal length: each max is decided by the first
    # predecessor alone, and with zero weights every reached value is 0.
    port, ref = with_latency(arch, latency)
    texts = random_texts(arch, 29, 6, lo=4, hi=16) + [get_arch(arch).sample_asm]
    check_wave(arch, texts, port=port, ref=ref, diagnose=True)


def test_zero_latency_nodes_beside_weighted_ones():
    port, ref = with_latency("tx2", 0.0, mnemonics={"fmul", "add"})
    texts = random_texts("tx2", 31, 6, lo=6, hi=16) + [get_arch("tx2").sample_asm]
    check_wave("tx2", texts, port=port, ref=ref)


def scalar_sweep(totals, lat, preds, starts, s_max, fill):
    """The per-node recurrence the wave replicates, one node at a time:
    first maximal predecessor, then a start wins unless a path reaches its
    node with as much or more."""
    v_max = max(totals)
    dist = np.full((len(totals), v_max + 1, s_max), fill)
    dist[:, v_max, :] = port_batch._PAD_VALUE
    parent = np.full((len(totals), v_max, s_max), -1, dtype=np.int64)
    for r, n in enumerate(totals):
        for s in range(s_max):
            for v in range(n):
                best, arg = None, -1
                for u in preds[r][v]:
                    if best is None or dist[r, u, s] > best:
                        best, arg = dist[r, u, s], u
                if best is not None:
                    dist[r, v, s] = best + lat[r][v]
                    parent[r, v, s] = arg
                w = starts.get((r, v, s))
                if w is not None and dist[r, v, s] < w:
                    dist[r, v, s] = w
                    parent[r, v, s] = -1
    return dist, parent


@pytest.mark.parametrize("seed", range(12))
def test_wavefront_equals_scalar_sweep(seed):
    # Random forward DAGs of ragged sizes with in-degrees up to 4 (so short
    # lists are padded), integer and zero weights (ties everywhere, and a
    # start reached by a path exactly as long as its own weight), and starts
    # on a few (row, node, column) triples: most columns leave most nodes
    # UNREACHABLE, which must beat the padding node's _PAD_VALUE.
    rng = random.Random(seed)
    totals = [rng.randint(1, 12) for _ in range(rng.randint(1, 4))]
    s_max = rng.randint(1, 4)
    lat, preds, lvl = [], [], []
    for n in totals:
        lat.append([float(rng.choice([0, 0, 1, 2, 4])) for _ in range(n)])
        preds.append([rng.sample(range(v), rng.randint(0, min(v, 4)))
                      for v in range(n)])
        levels = []
        for v in range(n):
            levels.append(max((levels[u] for u in preds[-1][v]), default=-1) + 1)
        lvl.append(levels)
    starts = {}
    for r, n in enumerate(totals):
        for s in range(s_max):
            for v in rng.sample(range(n), rng.randint(0, min(n, 4))):
                starts[(r, v, s)] = lat[r][v]
    keys = sorted(starts)
    start_arrays = (np.array([k[0] for k in keys], dtype=np.int64),
                    np.array([k[1] for k in keys], dtype=np.int64),
                    np.array([k[2] for k in keys], dtype=np.int64),
                    np.array([starts[k] for k in keys], dtype=np.float64),
                    np.array([lvl[k[0]][k[1]] for k in keys], dtype=np.int64))
    for fill in (UNREACHABLE, port_batch._PAD_VALUE):
        got = port_batch._wavefront(
            len(totals), max(totals), s_max, fill, totals,
            np.array([w for row in lat for w in row], dtype=np.float64),
            np.array([len(p) for row in preds for p in row], dtype=np.int64),
            np.array([x for row in lvl for x in row], dtype=np.int64),
            np.array([u for row in preds for p in row for u in p],
                     dtype=np.int64),
            start_arrays, torch.device("cpu"))
        want = scalar_sweep(totals, lat, preds, starts, s_max, fill)
        for g, w in zip(got, want):
            # Padding node slots past a row's own nodes are never written.
            assert g.dtype == w.dtype and np.array_equal(g, w)


# -- chunks and the pass counter -----------------------------------------------


@pytest.mark.parametrize("arch", ["tx2", "zen"])
def test_chunked_wave_equals_unchunked(arch, monkeypatch):
    port, _ = sides(arch)
    texts = random_texts(arch, 37, 12, lo=6, hi=40)
    kernels = port.kernels(texts)
    port_batch.reset_wave_passes()
    whole = dicts(port_batch.analyze_wave(kernels, port.model, device="cpu"))
    whole_passes = port_batch.WAVE_PASSES["cpu"]
    monkeypatch.setattr(port_batch, "_CHUNK_BYTES", 16 * 1024)
    port_batch.reset_wave_passes()
    chunked = dicts(port_batch.analyze_wave(kernels, port.model, device="cpu"))
    assert port_batch.WAVE_PASSES["cpu"] > whole_passes + 3  # many chunks
    assert chunked == whole
    check_wave(arch, texts)  # and the reference's unchunked wave


def test_wave_passes_count_cp_and_lcd_chunks_on_cpu():
    port, _ = sides("tx2")
    kernels = port.kernels(random_texts("tx2", 41, 5, lo=4, hi=10)
                           + [get_arch("tx2").sample_asm])
    for preds, passes in ((("tp",), 0), (("tp", "cp"), 1), (("tp", "lcd"), 1),
                          (None, 2)):
        port_batch.reset_wave_passes()
        port_batch.analyze_wave(kernels, port.model, predictors=preds,
                                device="cpu")
        assert port_batch.WAVE_PASSES == {"cpu": passes, "cuda": 0}
