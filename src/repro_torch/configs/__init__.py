from repro_torch.configs.base import (
    ModelConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    get_config,
    list_archs,
    tiny_variant,
)

__all__ = [
    "ModelConfig", "RunConfig", "SHAPES", "ShapeConfig",
    "get_config", "list_archs", "tiny_variant",
]
