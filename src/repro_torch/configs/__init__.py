from .registry import ARCH_NAMES, get_config, smoke_config

__all__ = ["ARCH_NAMES", "get_config", "smoke_config"]
