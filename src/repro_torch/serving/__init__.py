from repro_torch.serving.analysis import (AnalysisRequest, AnalysisResponse,
                                          AnalysisService)
from repro_torch.serving.engine import GenerationResult, ServeEngine
from repro_torch.serving.faults import FaultInjector, InjectedFault, VirtualClock
from repro_torch.serving.resilience import (AdmissionController, CircuitBreaker,
                                            Deadline, ErrorCode,
                                            ResilienceConfig, RetryPolicy,
                                            ServingError, StageTimeout)

__all__ = ["AdmissionController", "AnalysisRequest", "AnalysisResponse",
           "AnalysisService", "CircuitBreaker", "Deadline", "ErrorCode",
           "FaultInjector", "GenerationResult", "InjectedFault",
           "ResilienceConfig", "RetryPolicy", "ServeEngine", "ServingError",
           "StageTimeout", "VirtualClock"]
