"""The LM substrate's model: layers, attention (prefill through the flash
kernel), the RG-LRU block, the MoE layer, the block-pattern transformer
(dense, hybrid and MoE) and the public ``build_model``."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
