"""Architecture configs the port runs: the dense GQA/MHA, hybrid and MoE
models whose serving path is on the card. Use ``get_arch(name)`` /
``reduced(name)`` / ``cells()``."""

from .base import (SHAPES, ArchConfig, ShapeConfig, active_param_count, cells, get_arch,
                   list_archs, param_count, reduced, register)

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "reduced", "register",
           "list_archs", "cells", "param_count", "active_param_count"]
