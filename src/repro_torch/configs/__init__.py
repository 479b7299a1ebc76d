from .registry import get_config, list_archs, reduce_config, register
from .shapes import SHAPES, cell_is_applicable, input_specs

__all__ = ["get_config", "list_archs", "reduce_config", "register",
           "SHAPES", "cell_is_applicable", "input_specs"]
