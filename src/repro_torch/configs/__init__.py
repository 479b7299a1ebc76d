from .registry import get_config, list_archs, reduce_config, register

__all__ = ["get_config", "list_archs", "reduce_config", "register"]
