"""Architecture configurations (the port's copy of ``repro/configs``)."""
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape, LayerDesc, all_archs, get_arch

__all__ = ["INPUT_SHAPES", "ArchConfig", "InputShape", "LayerDesc", "all_archs", "get_arch"]
