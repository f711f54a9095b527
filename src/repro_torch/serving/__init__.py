from repro_torch.serving.engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
