from repro_torch.distributed.sharding import (
    MeshContext,
    constrain,
    current_mesh,
    param_sharding_rules,
    set_mesh_context,
    spec_for_path,
    zero_extend,
)

__all__ = [
    "MeshContext", "constrain", "current_mesh", "param_sharding_rules",
    "set_mesh_context", "spec_for_path", "zero_extend",
]
