"""Measurement + calibration subsystem (``repro.core.calibration``).

``corpus`` reads measured cy/it ground truth per architecture in place from
``data/measurements/<arch>.json``; ``calibrate`` joins a corpus against the
analysis pipeline (on ``device``) and scores the four predictors
(optimistic/balanced TP, CP, window-limited sim) with MAPE, signed bias, and
bracket coverage.
"""

from repro_torch.core.calibration.calibrate import (BRACKET_REL_TOL,
                                                    CALIBRATED_PREDICTORS,
                                                    CalibrationResult,
                                                    KernelCalibration,
                                                    PredictorError, calibrate,
                                                    calibrate_corpus,
                                                    resolve_entry_asm)
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
    "BRACKET_REL_TOL",
    "CALIBRATED_PREDICTORS",
    "CORPUS_DIR_ENV",
    "CORPUS_SCHEMA_VERSION",
    "CalibrationResult",
    "KernelCalibration",
    "MeasuredKernel",
    "MeasurementCorpus",
    "PredictorError",
    "available_corpora",
    "calibrate",
    "calibrate_corpus",
    "corpus_path",
    "default_corpus_dir",
    "load_corpus",
    "resolve_entry_asm",
    "resolve_measurements",
]
