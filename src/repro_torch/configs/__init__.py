from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, MLAConfig, SSMConfig, ShapeConfig, RunConfig,
    SHAPES, get_config, list_archs, smoke_config, cell_supported,
    ARCH_REGISTRY,
)
