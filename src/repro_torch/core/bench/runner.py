"""Kernel-level benchmark runner: real hardware where available, recorded
measured corpora everywhere else.

The paper measures each kernel's cycles/iteration on the target machine and
compares against the analytic bracket.  Where there is no x86/ARM hardware
to execute on, the runner follows the same two-tier policy the instruction
database uses (:mod:`repro_torch.core.bench.ibench`):

* an injectable ``executor`` — a callable ``(asm, unroll) -> seconds per
  high-level iteration`` — measures live when the caller *can* execute the
  kernel (a real machine, a cycle-accurate simulator, a test stub).  The
  runner converts seconds to cycles via the arch registry's clock frequency;
* otherwise the runner answers from the recorded per-arch corpus under
  ``data/measurements/<arch>.json`` (:mod:`repro_torch.core.calibration.corpus`),
  the role the paper's published measurement tables play.

Either way the answer is a :class:`MeasuredKernel`, ready to join against
analysis output through ``AnalyzeOptions(measurements=...)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.calibration.corpus import (MeasuredKernel, MeasurementCorpus,
                                           load_corpus)
from repro_torch.core.registry import get_arch


@dataclass
class KernelMeasurementRunner:
    """Measure (or recall) a kernel's cycles/iteration for one arch.

    ``executor``: optional ``(asm: str, unroll: int) -> float`` returning
    wall seconds per *high-level iteration* (i.e. already divided by the
    iteration count, not per unrolled block).  When present it wins over the
    recorded corpus.

    ``corpus_dir``: directory holding ``<arch>.json`` corpora; ``None`` uses
    the repo default (or ``$REPRO_MEASUREMENTS_DIR``).
    """

    arch: str
    corpus_dir: Optional[str] = None
    executor: Optional[Callable[[str, int], float]] = None
    _corpus: Optional[MeasurementCorpus] = field(default=None, repr=False)
    _corpus_loaded: bool = field(default=False, repr=False)

    @property
    def spec(self):
        return get_arch(self.arch)

    @property
    def corpus(self) -> Optional[MeasurementCorpus]:
        """The recorded corpus for this arch, or ``None`` if none exists."""
        if not self._corpus_loaded:
            try:
                self._corpus = load_corpus(self.spec.id, self.corpus_dir)
            except FileNotFoundError:
                self._corpus = None
            self._corpus_loaded = True
        return self._corpus

    @property
    def can_execute(self) -> bool:
        return self.executor is not None

    def measure(self, name: str, asm: str = "",
                unroll: int = 1) -> Optional[MeasuredKernel]:
        """Measure ``name`` live, or recall it from the recorded corpus.

        Returns ``None`` when the kernel can be neither executed (no
        ``executor``) nor recalled (no corpus entry) — callers treat that as
        "no ground truth", exactly like a corpus miss during analysis.
        """
        spec = self.spec
        if self.executor is not None:
            if not asm:
                raise ValueError(
                    f"runner for '{spec.id}' has an executor but no asm was "
                    f"given for kernel '{name}'")
            seconds_per_it = self.executor(asm, unroll)
            if seconds_per_it <= 0.0:
                raise ValueError(
                    f"executor returned non-positive time "
                    f"{seconds_per_it!r} for kernel '{name}'")
            cy_per_it = seconds_per_it * spec.frequency_ghz * 1e9
            return MeasuredKernel(
                name=name, unroll=unroll, measured_cy_per_it=cy_per_it,
                source=f"executed@{spec.frequency_ghz:g}GHz", asm=asm)
        corpus = self.corpus
        if corpus is None:
            return None
        return corpus.lookup(name, unroll)

    def measure_all(self, names, unroll: int = 1):
        """Best-effort batch: ``{name: MeasuredKernel}`` for resolvable ones."""
        out = {}
        for name in names:
            entry = self.measure(name, unroll=unroll)
            if entry is not None:
                out[name] = entry
        return out
