"""Architecture configurations (the port's copy of ``repro/configs``)."""
from repro_torch.configs.base import ArchConfig, LayerDesc, get_arch

__all__ = ["ArchConfig", "LayerDesc", "get_arch"]
