"""Attention: the prefill path through the flash kernel (global causal, or a
sliding window for ``local`` blocks), the decode path over a KV cache; GQA
throughout.

Mirrors the reference's ``src/repro/models/attention.py``. There the chunked
path is a pure-JAX twin of the Pallas flash kernel; here
``chunked_causal_attention`` dispatches through ``kernels.ops.flash_attention``:
a CUDA tensor launches the hand-written kernel (its ``window`` mode for
``local`` blocks), a CPU tensor takes its plain version, which walks the same
KV chunks as the reference. Decode attention has no kernel in the reference
and stays plain PyTorch: over the first ``cache_len`` slots of a global
layer's cache, or over the valid slots of a ``local`` layer's rolling buffer
of ``window`` slots, where position ``p`` sits at slot ``p % window``
(``transformer.grow_cache`` rolls the prefill's keys into that order; RoPE
carries the absolute positions, so the slots' order does not matter).

Shapes: q (B, Hq, Sq, Dh); k, v (B, Hkv, Skv, Dh); GQA expands Hkv -> Hq
(Hq % Hkv == 0).
"""

from __future__ import annotations

import torch

from ..kernels import ops

__all__ = ["chunked_causal_attention", "decode_attention"]

_NEG_INF = -1e30


def _expand_gqa(k: torch.Tensor, v: torch.Tensor, hq: int):
    """Repeat each kv head ``hq / Hkv`` times, as ``jnp.repeat`` on axis 1."""
    hkv = k.shape[1]
    if hkv == hq:
        return k, v
    rep = hq // hkv
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             chunk_size: int = 1024, window: int = 0,
                             q_offset: int = 0) -> torch.Tensor:
    """Causal attention (``window > 0``: sliding window) of the queries at
    positions ``q_offset + i``: the flash kernel on the card, the chunked
    plain version on the CPU."""
    return ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset,
                               chunk_size=chunk_size)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     cache_len: int, window: int = 0,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One new token ``q (B, Hq, 1, Dh)`` over the first ``cache_len``
    positions of a ``(B, Hkv, S, Dh)`` cache. With ``k_scale``/``v_scale``
    (``(B, Hkv, S)`` float32) the cache is int8 quantized per (token, head)
    and is dequantized first."""
    hq, dh = q.shape[1], q.shape[-1]
    if k_scale is not None:
        k_cache = k_cache.to(torch.float32) * k_scale[..., None]
        v_cache = v_cache.to(torch.float32) * v_scale[..., None]
    k_cache, v_cache = _expand_gqa(k_cache, v_cache, hq)
    s = k_cache.shape[2]
    scale = 1.0 / (dh ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    mask = pos < cache_len
    if window > 0:
        mask = mask & (pos >= cache_len - window)
    logits = torch.where(mask, logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v_cache.to(torch.float32))
    return out.to(q.dtype)
