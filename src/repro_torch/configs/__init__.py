from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    shape_supported,
)
