"""The port's front end, machine models, registry and measured corpora
against the JAX package's: parsed kernels, every machine DB and the corpora
must be equal field for field (dataclass ``==`` semantics across the two
packages' classes)."""

import ast
import dataclasses
import pathlib

import pytest

import repro.core.calibration.corpus as ref_corpus
import repro.core.isa as ref_isa
import repro.core.isa.parser_aarch64 as ref_pa
import repro.core.isa.parser_x86 as ref_px
import repro.core.registry as ref_registry
import repro.core.validation as ref_validation
import repro_torch.core.calibration.corpus as port_corpus
import repro_torch.core.isa as port_isa
import repro_torch.core.isa.parser_aarch64 as port_pa
import repro_torch.core.isa.parser_x86 as port_px
import repro_torch.core.registry as port_registry
import repro_torch.core.validation as port_validation

TESTS = pathlib.Path(__file__).resolve().parent
ASM_ARCHS = ("tx2", "csx", "zen", "zen2", "n1")


def plain(obj):
    """What dataclass ``==`` compares, as plain data: a dataclass becomes its
    class name and its ``compare=True`` fields, recursively."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj) if f.compare)
    if isinstance(obj, (list, tuple)):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, dict):
        return tuple((k, plain(v)) for k, v in obj.items())
    if isinstance(obj, (set, frozenset)):
        return frozenset(plain(x) for x in obj)
    return obj


# Each parser entry point of the reference's parser tests, by the name those
# tests call it under: (isa, whether it parses one line, wraps in markers).
_PARSE_CALLS = {
    "parse_line_aarch64": ("aarch64", True, False),
    "parse_line_x86": ("x86", True, False),
    "parse_aarch64": ("aarch64", False, False),
    "parse_x86": ("x86", False, False),
    "a64_kernel": ("aarch64", False, True),
    "x86_kernel": ("x86", False, True),
}


def _parser_inputs():
    """Every literal assembly input of tests/test_parsers.py and
    tests/test_extensions.py, read from their syntax trees: string arguments
    of the parse calls, and ``asm = "..."`` variables passed to them."""
    cases = []
    for fname in ("test_parsers.py", "test_extensions.py"):
        tree = ast.parse((TESTS / fname).read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            names = {}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    names[node.targets[0].id] = node.value.value
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id in _PARSE_CALLS and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    text = arg.value
                elif isinstance(arg, ast.Name) and arg.id in names:
                    text = names[arg.id]
                else:
                    continue
                cases.append((f"{fname}:{node.lineno}", node.func.id, text))
    return cases


PARSER_CASES = _parser_inputs()


def test_parser_inputs_were_found():
    assert len(PARSER_CASES) >= 40
    assert {call for _, call, _ in PARSER_CASES} == set(_PARSE_CALLS)


@pytest.mark.parametrize("where,call,text", PARSER_CASES,
                         ids=[c[0] for c in PARSER_CASES])
def test_parsed_forms_equal_reference(where, call, text):
    isa, one_line, wrap = _PARSE_CALLS[call]
    if wrap:
        text = f"# OSACA-BEGIN\n{text}\n# OSACA-END"
    if one_line:
        ref = (ref_pa.parse_line_aarch64 if isa == "aarch64" else ref_px.parse_line_x86)(text)
        port = (port_pa.parse_line_aarch64 if isa == "aarch64" else port_px.parse_line_x86)(text)
    else:
        ref = (ref_isa.parse_aarch64 if isa == "aarch64" else ref_isa.parse_x86)(text)
        port = (port_isa.parse_aarch64 if isa == "aarch64" else port_isa.parse_x86)(text)
    assert type(port).__module__.startswith("repro_torch.")
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("asm", ["GS_TX2_ASM", "GS_CLX_ASM", "GS_ZEN_ASM"])
def test_gauss_seidel_kernels_parse_equal(asm):
    text = getattr(port_validation, asm)
    assert text == getattr(ref_validation, asm)
    parse = "parse_aarch64" if asm == "GS_TX2_ASM" else "parse_x86"
    ref = getattr(ref_isa, parse)(text, name="gauss-seidel")
    port = getattr(port_isa, parse)(text, name="gauss-seidel")
    assert len(port) > 0 and plain(port) == plain(ref)


def test_table1_equal():
    assert plain(port_validation.TABLE1) == plain(ref_validation.TABLE1)
    for arch in ("tx2", "csx", "zen"):
        assert plain(port_validation.table1_row(arch)) == \
            plain(ref_validation.table1_row(arch))


@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_machine_model_equal_entry_by_entry(arch):
    ref = ref_registry.get_arch(arch).model_factory()
    port = port_registry.get_arch(arch).model_factory()
    assert port.ports == ref.ports
    assert plain(port.window) == plain(ref.window)
    assert port.db.keys() == ref.db.keys()
    for key in ref.db:
        assert plain(port.db[key]) == plain(ref.db[key]), key
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_resolved_costs_equal_on_gauss_seidel(arch):
    ref_spec = ref_registry.get_arch(arch)
    port_spec = port_registry.get_arch(arch)
    ref_kernel = ref_spec.parser(ref_spec.sample_asm, name="gs")
    port_kernel = port_spec.parser(port_spec.sample_asm, name="gs")
    ref_costs = ref_spec.model_factory().resolve_kernel(ref_kernel)
    port_costs = port_spec.model_factory().resolve_kernel(port_kernel)
    assert plain(port_costs) == plain(ref_costs)
    assert [c.total_pressure for c in port_costs] == \
        [c.total_pressure for c in ref_costs]


def test_registry_ids_and_aliases():
    assert port_registry.asm_arch_ids() == ref_registry.asm_arch_ids()
    assert port_registry.list_arch_ids() == ref_registry.asm_arch_ids()
    for arch in ref_registry.asm_arch_ids():
        ref = ref_registry.get_arch(arch)
        port = port_registry.get_arch(arch)
        assert (port.id, port.isa, port.frequency_ghz, port.aliases,
                port.description, port.sample_asm) == \
            (ref.id, ref.isa, ref.frequency_ghz, ref.aliases,
             ref.description, ref.sample_asm)
        for alias in ref.aliases + (ref.id.upper(), ref.id + " "):
            assert port_registry.get_arch(alias).id == ref.id
    for hlo_name in ("tpu-v5e", "tpu", "v5e"):
        ref_registry.get_arch(hlo_name)  # the reference's HLO target ...
        with pytest.raises(ValueError, match="unknown arch"):
            port_registry.get_arch(hlo_name)  # ... is not the port's


def test_corpora_equal():
    ref_avail = ref_corpus.available_corpora()
    port_avail = port_corpus.available_corpora()
    assert sorted(port_avail) == sorted(ref_avail) == ["csx", "tx2", "zen"]
    assert {a: str(p) for a, p in port_avail.items()} == \
        {a: str(p) for a, p in ref_avail.items()}
    for arch in ASM_ARCHS:
        ref = ref_corpus.resolve_measurements("auto", arch)
        port = port_corpus.resolve_measurements("auto", arch)
        assert plain(port) == plain(ref)
        if ref is not None:
            assert port.digest == ref.digest and len(port) == len(ref)
            for entry in ref.entries:
                assert plain(port.lookup(entry.name, entry.unroll)) == \
                    plain(ref.lookup(entry.name, entry.unroll))
