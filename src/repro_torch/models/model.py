"""Public model API: ``build_model(cfg)`` -> init / prefill / decode_step /
init_decode_cache.

The layer the serving launcher and the tests consume, as the reference's
``src/repro/models/model.py``; the assembly lives in ``transformer.py``.

Weights are stored in ``param_dtype`` (float32 masters by default; bf16 for
a model whose masters do not fit the card, as deepseek-moe-16b) and the
forward passes compute in ``dtype`` (bf16 by default). The reference casts
each matrix to ``dtype`` at every use; here ``init`` makes the cast copy
once, when the weights are built (``Transformer.compute``; none when they
are stored in ``dtype``), which gives the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device, seeded_generator
from . import transformer

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable          # (seed) -> Transformer
    loss_fn: Callable       # training: not ported yet
    prefill: Callable       # (params, tokens) -> (logits (B, V), caches)
    decode_step: Callable   # (params, token (B,), cache, pos) -> (logits, cache)
    init_decode_cache: Callable  # (batch, max_len, quantized=False) -> cache


def build_model(cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.float32,
                device: str | torch.device = "cuda") -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the CPU is asked
    for). Raises ``NotImplementedError`` for configs the port does not run."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)

    def init(seed: int = 0) -> transformer.Transformer:
        """Random weights from a generator on the device seeded from ``seed``,
        with the compute copy made here, once."""
        params = transformer.init_params(cfg, seeded_generator(dev, seed),
                                         dtype=param_dtype, device=dev)
        params.compute(dtype)
        return params

    def loss_fn(params, batch):
        raise NotImplementedError(
            "loss_fn belongs to the training slice (loss_fn, chunked_cross_entropy, "
            "optim/, launch/train.py; ROADMAP queue 1, item 16), not ported yet")

    @torch.inference_mode()
    def prefill_fn(params, tokens):
        return transformer.prefill(cfg, params, tokens, dtype=dtype)

    @torch.inference_mode()
    def decode_fn(params, token, cache, pos):
        return transformer.decode_step(cfg, params, token, cache, pos, dtype=dtype)

    def init_cache(batch, max_len, quantized=False):
        return transformer.init_decode_cache(cfg, batch, max_len, dtype=dtype,
                                             quantized=quantized, device=dev)

    return Model(cfg=cfg, device=dev, init=init, loss_fn=loss_fn, prefill=prefill_fn,
                 decode_step=decode_fn, init_decode_cache=init_cache)
