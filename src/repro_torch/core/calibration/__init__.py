"""Measured-performance corpora (``corpus``): recorded cy/it ground truth per
architecture, read in place from ``data/measurements/<arch>.json``. The
calibration joiner (``calibrate`` in ``repro.core.calibration``) is not
ported yet.
"""

from repro_torch.core.calibration.corpus import (ANY_UNROLL, CORPUS_DIR_ENV,
                                                 CORPUS_SCHEMA_VERSION,
                                                 MeasuredKernel,
                                                 MeasurementCorpus,
                                                 available_corpora,
                                                 corpus_path,
                                                 default_corpus_dir,
                                                 load_corpus,
                                                 resolve_measurements)

__all__ = [
    "ANY_UNROLL",
    "CORPUS_DIR_ENV",
    "CORPUS_SCHEMA_VERSION",
    "MeasuredKernel",
    "MeasurementCorpus",
    "available_corpora",
    "corpus_path",
    "default_corpus_dir",
    "load_corpus",
    "resolve_measurements",
]
