"""Measured-performance corpora: recorded kernel cy/it per architecture.

The paper validates its [TP, CP] bracket against *measured* cycles per
iteration on real Cascade Lake / Zen / ThunderX2 machines (Table I).  A
:class:`MeasurementCorpus` is the persisted form of such measurements — one
JSON file per architecture under ``data/measurements/<arch>.json`` — so the
calibration loop (``repro.core.calibration.calibrate``) can score every
predictor against ground truth even on machines where the kernels cannot be
executed (an analyzer host need not run x86/ARM assembly; the corpora play
the role uops.info/Agner-Fog data play for the instruction DBs).

Entries are keyed by ``(kernel name, unroll)``: the measured cy/it of a
Gauss-Seidel sweep at 4x unroll is a different ground-truth point than the
same loop at 1x.  An entry carries its kernel either inline (``asm``) or by
reference to the architecture registry's built-in sample kernel
(``builtin="sample"``), plus a free-form ``source`` provenance string
(``paper-table1``, ``recorded-ibench``, …).

The corpus :attr:`~MeasurementCorpus.digest` is a stable content hash that
participates in analysis cache keys — two analyses joined against different
corpora must not share a cached report (the measured fields and any
``PREDICTION_DRIFT`` findings would differ).

This module is deliberately standalone (stdlib only): it is imported by the
analysis options layer and must not drag in parsers or machine models.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

#: Corpus file schema.  v1: arch, description, entries[] with
#: (name, unroll, measured_cy_per_it, source, asm | builtin).
CORPUS_SCHEMA_VERSION = 1

#: Environment override for the corpus directory (tests, out-of-tree data).
CORPUS_DIR_ENV = "REPRO_MEASUREMENTS_DIR"

#: ``unroll`` wildcard: an entry recorded without a specific unroll factor
#: matches a lookup at any unroll.
ANY_UNROLL = 0


@dataclass(frozen=True)
class MeasuredKernel:
    """One measured ground-truth point: a kernel's steady-state cy/it.

    ``asm`` holds the kernel text inline; ``builtin="sample"`` references
    the architecture registry's built-in sample kernel instead (the paper's
    Gauss-Seidel loops, kept in one place).  Exactly one of the two should
    be set; resolution happens in the calibration joiner, not here.
    """

    name: str
    unroll: int
    measured_cy_per_it: float
    source: str = ""  # provenance: "paper-table1", "recorded-ibench", ...
    asm: str = ""
    builtin: str = ""  # "" | "sample"

    def to_dict(self) -> Dict:
        data: Dict = {
            "name": self.name,
            "unroll": self.unroll,
            "measured_cy_per_it": self.measured_cy_per_it,
            "source": self.source,
        }
        if self.asm:
            data["asm"] = self.asm
        if self.builtin:
            data["builtin"] = self.builtin
        return data

    @classmethod
    def from_dict(cls, data: Dict) -> "MeasuredKernel":
        return cls(
            name=data["name"],
            unroll=int(data.get("unroll", ANY_UNROLL)),
            measured_cy_per_it=float(data["measured_cy_per_it"]),
            source=data.get("source", ""),
            asm=data.get("asm", ""),
            builtin=data.get("builtin", ""),
        )


@dataclass(frozen=True)
class MeasurementCorpus:
    """All recorded measurements for one architecture."""

    arch: str
    entries: Tuple[MeasuredKernel, ...] = ()
    description: str = ""
    schema_version: int = CORPUS_SCHEMA_VERSION

    def __post_init__(self):
        object.__setattr__(self, "entries", tuple(self.entries))

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, name: str, unroll: int) -> Optional[MeasuredKernel]:
        """The entry measured for ``(name, unroll)``.

        An exact unroll match wins; an entry recorded with
        ``unroll == ANY_UNROLL`` matches any requested unroll (per-iteration
        numbers are unroll-normalized by construction).
        """
        wildcard = None
        for entry in self.entries:
            if entry.name != name:
                continue
            if entry.unroll == unroll:
                return entry
            if entry.unroll == ANY_UNROLL and wildcard is None:
                wildcard = entry
        return wildcard

    @property
    def digest(self) -> str:
        """Stable content hash; participates in analysis cache identity."""
        memo = self.__dict__.get("_digest")
        if memo is None:
            canonical = json.dumps(self.to_dict(), sort_keys=True,
                                   separators=(",", ":"))
            memo = hashlib.sha256(canonical.encode()).hexdigest()[:16]
            self.__dict__["_digest"] = memo
        return memo

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict:
        return {
            "schema_version": self.schema_version,
            "arch": self.arch,
            "description": self.description,
            "entries": [entry.to_dict() for entry in self.entries],
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "MeasurementCorpus":
        version = data.get("schema_version", CORPUS_SCHEMA_VERSION)
        if version > CORPUS_SCHEMA_VERSION:
            raise ValueError(
                f"measurement corpus schema v{version} is newer than "
                f"supported v{CORPUS_SCHEMA_VERSION}")
        return cls(
            arch=data["arch"],
            entries=tuple(MeasuredKernel.from_dict(e)
                          for e in data.get("entries", ())),
            description=data.get("description", ""),
            schema_version=version,
        )

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, text: str) -> "MeasurementCorpus":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json(indent=2, sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "MeasurementCorpus":
        return cls.from_json(Path(path).read_text())

    def with_entries(self,
                     entries: Iterable[MeasuredKernel]) -> "MeasurementCorpus":
        return replace(self, entries=tuple(entries))


# -- corpus directory ---------------------------------------------------------


def default_corpus_dir() -> Path:
    """``$REPRO_MEASUREMENTS_DIR`` or the repo's ``data/measurements``."""
    env = os.environ.get(CORPUS_DIR_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[4] / "data" / "measurements"


def corpus_path(arch: str, directory=None) -> Path:
    """The canonical ``<dir>/<arch>.json`` file path for an arch's corpus."""
    base = Path(directory) if directory else default_corpus_dir()
    return base / f"{arch}.json"


def load_corpus(arch: str, directory=None) -> MeasurementCorpus:
    """Load the recorded corpus for ``arch``; FileNotFoundError when the
    architecture has no recorded measurements."""
    path = corpus_path(arch, directory)
    if not path.is_file():
        raise FileNotFoundError(
            f"no measurement corpus for arch '{arch}' at {path}")
    return MeasurementCorpus.load(path)


def available_corpora(directory=None) -> Dict[str, Path]:
    """``{arch: path}`` for every recorded corpus in the directory."""
    base = Path(directory) if directory else default_corpus_dir()
    if not base.is_dir():
        return {}
    return {p.stem: p for p in sorted(base.glob("*.json"))}


def resolve_measurements(measurements, arch: str):
    """One resolution point for the ``measurements`` analysis option.

    Accepts ``None`` (no corpus), a :class:`MeasurementCorpus`, the string
    ``"auto"`` (the recorded corpus for ``arch`` if one exists, else
    ``None``), a corpus *file* path, or a corpus *directory* (the arch's
    ``<arch>.json`` inside it — missing file resolves to ``None``, matching
    ``"auto"``: a directory opt-in means "use what is recorded").
    """
    if measurements is None:
        return None
    if isinstance(measurements, MeasurementCorpus):
        return measurements
    if measurements == "auto":
        try:
            return load_corpus(arch)
        except FileNotFoundError:
            return None
    path = Path(os.fspath(measurements))
    if path.is_dir():
        try:
            return load_corpus(arch, directory=path)
        except FileNotFoundError:
            return None
    return MeasurementCorpus.load(path)
