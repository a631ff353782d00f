from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    get_config,
    list_archs,
    register,
    shape_applicable,
)

__all__ = [
    "SHAPES", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "get_config", "list_archs", "register", "shape_applicable",
]
