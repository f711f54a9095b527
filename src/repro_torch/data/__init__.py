from repro_torch.data.pipeline import DataPipeline, make_batch

__all__ = ["DataPipeline", "make_batch"]
