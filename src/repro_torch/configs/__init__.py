"""Architecture configurations (the port's copy of ``repro/configs``)."""
from repro_torch.configs.base import ArchConfig, get_arch

__all__ = ["ArchConfig", "get_arch"]
