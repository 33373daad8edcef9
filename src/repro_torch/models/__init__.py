"""The LM substrate's dense-attention model: layers, attention (prefill through
the flash kernel), the transformer and the public ``build_model``."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
