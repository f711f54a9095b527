"""The port's graph passes on float64 tensors (on the CPU here) against the
JAX package's NumPy passes: the batched longest-path sweep, the
water-filling scheduler, LCD, CP and the simulator, all compared exactly."""

import json
import os
import platform
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.analysis.dag as ref_dag
import repro.core.analysis.lcd as ref_lcd
import repro.core.analysis.scheduler as ref_sched
import repro.core.analysis.sweep as ref_sweep
import repro.core.registry as ref_registry
import repro.core.sim.engine as ref_engine
import repro_torch.core.analysis.dag as port_dag
import repro_torch.core.analysis.lcd as port_lcd
import repro_torch.core.analysis.reference as port_reference
import repro_torch.core.analysis.scheduler as port_sched
import repro_torch.core.analysis.sweep as port_sweep
import repro_torch.core.registry as port_registry
import repro_torch.core.sim.engine as port_engine
import test_sim
from repro.core.analysis.critical_path import critical_path_from_dag as ref_cp_from_dag
from repro_torch.core.analysis.critical_path import \
    critical_path_from_dag as port_cp_from_dag
from test_torch_isa import plain

ASM_ARCHS = ("tx2", "csx", "zen", "zen2", "n1")
CPU = torch.device("cpu")


def random_kernel_text(arch, seed):
    """The text of tests/test_sim.py's randomized kernel for (arch, seed)."""
    rng = random.Random(seed * 31 + test_sim.ARCH_SEED[arch])
    kernel = test_sim._random_kernel(rng, port_registry.get_arch(arch).isa)
    return "# OSACA-BEGIN\n" + "\n".join(f.raw for f in kernel) + "\n# OSACA-END"


def both(arch, text):
    """(reference model, kernel), (port model, kernel) for one asm text."""
    ref_spec, port_spec = ref_registry.get_arch(arch), port_registry.get_arch(arch)
    return ((ref_spec.model_factory(), ref_spec.parser(text, name="k")),
            (port_spec.model_factory(), port_spec.parser(text, name="k")))


KERNELS = ([(arch, "gs", port_registry.get_arch(arch).sample_asm) for arch in ASM_ARCHS]
           + [(arch, f"rand{seed}", random_kernel_text(arch, seed))
              for arch in ASM_ARCHS for seed in range(8)])
KERNEL_IDS = [f"{arch}-{name}" for arch, name, _ in KERNELS]


# -- the batched sweep ---------------------------------------------------------


def random_dag(rng, n, max_indeg, weight_choices):
    preds = []
    for v in range(n):
        k = rng.randint(0, min(v, max_indeg))
        preds.append(rng.sample(range(v), k))
    weights = [rng.choice(weight_choices) for _ in range(n)]
    return preds, weights


SWEEP_CASES = [
    # (seed, nodes, max in-degree, weights, rows, starts per row)
    (0, 30, 3, (0.0, 1.0, 2.0), 6, 1),        # integer weights: many ties
    (1, 60, 5, (1.0,), 12, 1),                # all equal: ties everywhere
    (2, 50, 4, (0.5, 1.5, 3.0, 4.0), 8, 3),   # multi-start rows
    (3, 80, 6, (1 / 3, 0.1, 2.0, 7.0), 20, 2),
    (4, 40, 2, (0.0,), 5, 4),                 # zero weights, sentinel ties
    (5, 1, 0, (2.0,), 3, 1),
    (6, 25, 4, (1.0, 2.0), 25, 1),            # a row per node
]


@pytest.mark.parametrize("seed,n,indeg,wc,n_rows,starts", SWEEP_CASES)
def test_batched_longest_paths_equal_reference(seed, n, indeg, wc, n_rows, starts):
    rng = random.Random(seed)
    preds, weights = random_dag(rng, n, indeg, wc)
    rows = [[rng.randrange(n) for _ in range(rng.randint(1, starts))]
            for _ in range(n_rows)]
    if n_rows > 1:
        rows[1] = rows[0] + rows[0]  # a start listed twice
    ref_ptr, ref_idx = ref_sweep.pred_csr_from_lists(preds)
    D_ref, P_ref = ref_sweep.batched_longest_paths(
        ref_ptr, ref_idx, np.array(weights, dtype=np.float64), rows)
    ptr, idx = port_sweep.pred_csr_from_lists(preds)
    port_sweep.reset_sweeps()
    D, P = port_sweep.batched_longest_paths(ptr, idx, weights, rows, device="cpu")
    assert port_sweep.SWEEPS == {"cpu": 1, "cuda": 0}
    assert D.device == P.device == CPU
    assert D.dtype == torch.float64 and P.dtype == torch.int64
    assert D.shape == (n_rows, n) and P.shape == (n_rows, n)
    # Every entry, the unreachable ones' sentinel sums and parents too.
    assert np.array_equal(D.numpy(), D_ref)
    assert np.array_equal(P.numpy(), P_ref)


def test_sweep_ties_pick_the_first_predecessor():
    # Node 3 has three predecessors at equal distance: the first listed wins,
    # as the scalar DP's strict ">" scan has it. Node 4 is a start reached at
    # exactly its own weight through node 3's path: path-through wins.
    preds = [[], [], [], [2, 0, 1], [3]]
    weights = [1.0, 1.0, 1.0, 1.0, 3.0]
    rows = [[0, 1, 2, 4]]
    ptr, idx = port_sweep.pred_csr_from_lists(preds)
    D, P = port_sweep.batched_longest_paths(ptr, idx, weights, rows, device=CPU)
    assert P[0, 3].item() == 2 and D[0, 3].item() == 2.0
    assert D[0, 4].item() == 5.0 and P[0, 4].item() == 3
    D_ref, P_ref = ref_sweep.batched_longest_paths(
        *ref_sweep.pred_csr_from_lists(preds), np.array(weights), rows)
    assert np.array_equal(D.numpy(), D_ref) and np.array_equal(P.numpy(), P_ref)


def test_dag_exports_live_on_the_dag_device():
    # The DAG's CSR and latency exports stay on the host, equal to the
    # reference's; the sweep that reads them puts D and P on the device it
    # is given, and only there.
    (rm, rk), (model, kernel) = both("tx2", port_registry.get_arch("tx2").sample_asm)
    dag = port_dag.build_dag(kernel, model, copies=2, dual_writeback=True)
    ref = ref_dag.build_dag(rk, rm, copies=2, dual_writeback=True)
    ptr, idx = dag.pred_csr()
    lat = dag.latency_vector()
    ref_ptr, ref_idx = ref.pred_csr()
    assert all(isinstance(a, np.ndarray) for a in (ptr, idx, lat))
    assert ptr.dtype == idx.dtype == np.int64 and lat.dtype == np.float64
    assert np.array_equal(ptr, ref_ptr) and np.array_equal(idx, ref_idx)
    assert np.array_equal(lat, ref.latency_vector())
    assert ptr[-1] == idx.size == sum(len(p) for p in dag.preds)
    D, P = port_sweep.batched_longest_paths(ptr, idx, lat, [[0]], device="cpu")
    assert D.device == P.device == CPU


# -- the water-filling scheduler ---------------------------------------------------


# Non-dyadic demands: subset sums of these round differently under different
# summation orders, which is where a device reduction could part from the
# reference's NumPy product.
NON_DYADIC = (1 / 3, 0.1, 0.7, 2 / 3, 1 / 7, 0.2, 1.1, 0.3)


def random_classes(rng, n_ports, n_classes, values):
    ports = [f"P{i}" for i in range(n_ports)]
    classes = {}
    for _ in range(n_classes):
        eligible = frozenset(rng.sample(ports, rng.randint(1, n_ports)))
        classes[eligible] = classes.get(eligible, 0.0) + rng.choice(values) * rng.randint(1, 5)
    return ports, classes


def test_non_dyadic_cases_are_order_sensitive():
    # Some subset demand of the cases below rounds differently when its
    # classes are summed in reverse: the cases can tell summation orders apart.
    sensitive = 0
    for seed in range(40):
        rng = random.Random(seed)
        _, classes = random_classes(rng, rng.randint(3, 9), rng.randint(4, 24), NON_DYADIC)
        values = list(classes.values())
        fwd = rev = 0.0
        for x, y in zip(values, reversed(values)):
            fwd += x
            rev += y
        sensitive += fwd != rev
    assert sensitive > 0


_CORETYPE_PROBE = """
import json, sys
import repro.core.analysis.scheduler as ref
import repro_torch.core.analysis.scheduler as port
out = []
for ports, items in json.load(sys.stdin):
    classes = {frozenset(e): c for e, c in items}
    r, p = ref.min_max_load(classes, ports), port.min_max_load(classes, ports)
    out.append([[x.hex() for x in [r.bound, *r.port_load.values()]],
                (p.bound, p.port_load, p.levels) == (r.bound, r.port_load, r.levels)])
json.dump(out, sys.stdout)
"""


def _blas_is_dynamic_openblas():
    blas = np.show_config(mode="dicts")["Build Dependencies"].get("blas", {})
    return (platform.machine() in ("x86_64", "AMD64")
            and "DYNAMIC_ARCH" in blas.get("openblas configuration", ""))


@pytest.mark.skipif(not _blas_is_dynamic_openblas(),
                    reason="needs NumPy on an x86 OpenBLAS built with DYNAMIC_ARCH")
def test_blas_kernel_sets_the_demand_bits():
    # The reference's water levels depend on which OpenBLAS kernel computes
    # `demands @ contained`: under the Haswell and the Sandybridge kernels
    # some of the non-dyadic cases below come out with other bits.  So no
    # one fixed summation order reproduces the reference on every host; the
    # port runs NumPy's product, and matches the reference under each kernel.
    cases = []
    for seed in range(40):
        rng = random.Random(seed)
        ports, classes = random_classes(rng, rng.randint(3, 9), rng.randint(4, 24),
                                        NON_DYADIC)
        cases.append([ports, [[sorted(e), c] for e, c in classes.items()]])
    src = str(Path(__file__).resolve().parents[1] / "src")
    runs = {}
    for coretype in ("Haswell", "Sandybridge"):
        env = dict(os.environ, OPENBLAS_CORETYPE=coretype, OPENBLAS_NUM_THREADS="1",
                   PYTHONPATH=src)
        done = subprocess.run([sys.executable, "-c", _CORETYPE_PROBE], env=env,
                              input=json.dumps(cases), capture_output=True, text=True,
                              check=True, timeout=120)
        runs[coretype] = json.loads(done.stdout)
        assert all(same for _, same in runs[coretype]), coretype
    differ = [i for i, (a, b) in enumerate(zip(runs["Haswell"], runs["Sandybridge"]))
              if a[0] != b[0]]
    assert differ, "both OpenBLAS kernels gave the same bits on every case"


@pytest.mark.parametrize("seed", range(40))
def test_min_max_load_equal_reference_non_dyadic(seed):
    rng = random.Random(seed)
    ports, classes = random_classes(rng, rng.randint(3, 9), rng.randint(4, 24), NON_DYADIC)
    ref = ref_sched.min_max_load(classes, ports)
    port = port_sched.min_max_load(classes, ports)
    assert plain(port) == plain(ref)  # bound, every port load, levels: bit for bit


@pytest.mark.parametrize("seed", range(10))
def test_min_max_load_matches_lp(seed):
    rng = random.Random(1000 + seed)
    ports, classes = random_classes(rng, rng.randint(2, 6), rng.randint(1, 7), NON_DYADIC)
    schedule = port_sched.min_max_load(classes, ports)
    assert schedule.bound == pytest.approx(ref_sched.linprog_min_max(classes), abs=1e-6)
    assert schedule.bound == pytest.approx(port_sched.brute_force_min_max(classes),
                                           abs=1e-9)


def test_min_max_load_beyond_dense_enumeration():
    # More contended ports than the dense subset enumeration takes: the
    # union-closure candidates go through the same tensor pass.
    ports = [f"P{i}" for i in range(20)]
    classes = {frozenset(ports[:19]): 7 / 3, frozenset(ports[:2]): 2.2,
               frozenset(ports[2:5]): 4.1, frozenset(ports[5:6]): 0.7,
               frozenset(ports[19:]): 0.3}
    ref = ref_sched.min_max_load(classes, ports)
    port = port_sched.min_max_load(classes, ports)
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("arch,name,text", KERNELS, ids=KERNEL_IDS)
def test_balance_from_costs_equal_reference(arch, name, text):
    (rm, rk), (pm, pk) = both(arch, text)
    ref = ref_sched.balance_from_costs(rm.resolve_kernel(rk), rm.ports)
    port = port_sched.balance_from_costs(pm.resolve_kernel(pk), pm.ports)
    assert plain(port) == plain(ref)


# -- LCD, CP and the simulator on the shared 2-copy DAG ------------------------------


def dags(arch, text):
    (rm, rk), (pm, pk) = both(arch, text)
    ref = ref_dag.build_dag(rk, rm, copies=2, dual_writeback=True)
    port = port_dag.build_dag(pk, pm, copies=2, dual_writeback=True)
    return (rm, rk, ref), (pm, pk, port)


@pytest.mark.parametrize("arch,name,text", KERNELS, ids=KERNEL_IDS)
def test_lcd_and_cp_equal_reference(arch, name, text):
    (rm, rk, rdag), (pm, pk, pdag) = dags(arch, text)
    assert plain(pdag.nodes) == plain(rdag.nodes)
    assert pdag.preds == rdag.preds and pdag.cp_preds == rdag.cp_preds
    port_sweep.reset_sweeps()
    port = port_lcd.lcd_from_dag(pdag, len(pk), device="cpu")
    ref = ref_lcd.lcd_from_dag(rdag, len(rk))
    assert plain(port) == plain(ref)
    assert port_sweep.SWEEPS["cpu"] <= 1 and port_sweep.SWEEPS["cuda"] == 0
    assert plain(port_cp_from_dag(pdag)) == plain(ref_cp_from_dag(rdag))


@pytest.mark.parametrize("arch", ASM_ARCHS)
def test_lcd_equals_the_per_source_engine(arch):
    # The port's batched sweep against its own copy of the seed's
    # per-source DP (repro.core.analysis.reference).
    (_, _), (model, kernel) = both(arch, port_registry.get_arch(arch).sample_asm)
    batched = port_lcd.loop_carried_dependencies(kernel, model, device="cpu")
    slow = port_reference.reference_loop_carried_dependencies(kernel, model)
    assert batched.longest == slow.longest
    assert {c.instr_indices for c in batched.chains} == \
        {c.instr_indices for c in slow.chains}


@pytest.mark.parametrize("arch,name,text", KERNELS, ids=KERNEL_IDS)
def test_simulate_template_equal_reference(arch, name, text):
    (rm, rk, rdag), (pm, pk, pdag) = dags(arch, text)
    ref_t = ref_engine.template_from_dag(rdag, rm)
    port_t = port_engine.template_from_dag(pdag, pm)
    for field in ("latency", "intra_ptr", "intra_idx", "cross_ptr", "cross_idx",
                  "is_load", "is_store"):
        array, ref_array = getattr(port_t, field), getattr(ref_t, field)
        assert array.dtype == ref_array.dtype, field
        assert np.array_equal(array, ref_array), field
    assert port_t.uops == ref_t.uops and port_t.ports == ref_t.ports
    ref = ref_engine.simulate_template(ref_t, rm.window)
    port = port_engine.simulate_template(port_t, pm.window)
    assert port == ref  # cy/block, copies, converged, limiter, port busy
