"""The block-pattern transformer for dense attention blocks: prefill, decode
with KV caches, and the weights as ``nn.Module``s.

Mirrors the reference's ``src/repro/models/transformer.py`` for configs whose
``block_pattern`` is ``("attn",)`` with a dense gated FFN (qwen3, smollm,
minicpm, chatglm3). The reference stacks full units along a leading axis
and applies them under ``lax.scan``; here the blocks are an
``nn.ModuleList`` and the scan is a loop. MoE, RG-LRU, xLSTM, local
attention, encoder-decoder, M-RoPE and leading dense layers raise
``NotImplementedError`` (ROADMAP queue 1, item 16).

Entry points (same weights):
    ``forward_full``   — pre-head hidden states for a whole sequence
    ``prefill``        — forward_full + per-layer KV caches, last-token logits
    ``decode_step``    — one token through the cached keys and values

Caches keep the reference's tree: ``{"units": [{"k", "v"}]}`` with each leaf
stacked over the layers, ``(n_layers, B, Hkv, S, Dh)``; an int8 cache adds
per-(token, head) float32 scales ``"ks"``, ``"vs"`` ``(n_layers, B, Hkv, S)``.
``decode_step`` writes the new token's entries into the cache in place (the
reference writes a functional ``where(iota == pos)`` copy of the same values)
and returns the same dict.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention, layers

__all__ = ["Transformer", "Block", "Attention", "check_supported", "pattern_layout",
           "init_params", "forward_full", "logits_from_hidden", "prefill",
           "init_decode_cache", "grow_cache", "decode_step"]

_ITEM = "ROADMAP queue 1, item 16"


def pattern_layout(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    """(n_full_units, tail_kinds), as the reference lays out the layers."""
    pat = cfg.block_pattern
    n_scan = cfg.n_layers - cfg.n_dense_layers
    n_units = n_scan // len(pat)
    tail_len = n_scan - n_units * len(pat)
    return n_units, pat[:tail_len]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    missing = []
    if tuple(cfg.block_pattern) != ("attn",):
        missing.append(f"block pattern {cfg.block_pattern}")
    if cfg.is_moe:
        missing.append("MoE blocks")
    if cfg.n_dense_layers > 0:
        missing.append("leading dense layers")
    if cfg.enc_dec:
        missing.append("encoder-decoder")
    if cfg.rope not in ("standard", "half", "none"):
        missing.append(f"rope={cfg.rope!r}")
    if cfg.frontend != "none":
        missing.append(f"frontend={cfg.frontend!r}")
    if cfg.d_ff == 0:
        missing.append("blocks without an FFN")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to PyTorch yet ({_ITEM}); "
            f"the port runs dense ('attn',) blocks")


class Attention(nn.Module):
    """``wq (d, Hq, Dh)``, ``wk``/``wv (d, Hkv, Dh)``, ``wo (Hq, Dh, d)`` and,
    with qk_norm, RMSNorm scales ``q_norm``/``k_norm`` over Dh."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        w = layers._weight
        self.wq = w((d, hq, dh), d ** -0.5, dtype, device, gen)
        self.wk = w((d, hkv, dh), d ** -0.5, dtype, device, gen)
        self.wv = w((d, hkv, dh), d ** -0.5, dtype, device, gen)
        self.wo = w((hq, dh, d), (hq * dh) ** -0.5, dtype, device, gen)
        if cfg.qk_norm:
            self.q_norm = layers.Norm("rmsnorm", dh, device=device)
            self.k_norm = layers.Norm("rmsnorm", dh, device=device)


class Block(nn.Module):
    """One ``attn`` block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.ln1 = layers.Norm(cfg.norm, cfg.d_model, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device, gen=gen)
        self.ln2 = layers.Norm(cfg.norm, cfg.d_model, device=device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype=dtype, device=device, gen=gen)


class Transformer(nn.Module):
    """The weights: ``embed (vocab, d)``, ``blocks``, ``final_norm`` and, for
    untied embeddings, ``lm_head (d, vocab)``.

    The matrices are stored in the parameter dtype (float32 masters); norm
    scales stay float32, as the reference keeps them. ``compute(dtype)``
    returns the copy the forward passes read: the matrices cast to ``dtype``
    once and kept (the reference casts them at every use, which gives the
    same bits), the norms shared with the masters. The masters are read only
    here (no training path), so the copy never goes stale; moving the module
    drops it.
    """

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = layers._weight((cfg.vocab_size, d), 0.02, dtype, device, gen)
        self.blocks = nn.ModuleList(Block(cfg, dtype=dtype, device=device, gen=gen)
                                    for _ in range(cfg.n_layers))
        self.final_norm = layers.Norm(cfg.norm, d, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = layers._weight((d, cfg.vocab_size), d ** -0.5, dtype, device, gen)
        self._compute: dict[torch.dtype, Transformer] = {}

    def compute(self, dtype: torch.dtype) -> "Transformer":
        """These weights with every matrix in ``dtype`` (norms shared)."""
        if all(p.dtype == dtype for n, p in self.named_parameters() if not _is_norm(n)):
            return self
        if dtype not in self._compute:
            copy = Transformer(self.cfg, device="meta")
            state = {name: t if _is_norm(name) else t.to(dtype)
                     for name, t in self.state_dict().items()}
            copy.load_state_dict(state, assign=True)
            self._compute[dtype] = copy
        return self._compute[dtype]

    def _apply(self, fn, recurse=True):
        self._compute = {}
        return super()._apply(fn, recurse)


def _is_norm(name: str) -> bool:
    return name.endswith(("ln1.scale", "ln2.scale", "ln1.bias", "ln2.bias", "_norm.scale",
                          "_norm.bias", "final_norm.scale", "final_norm.bias"))


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Transformer:
    """Random weights drawn from ``gen`` with the reference's scales:
    ``N(0, 0.02^2)`` embeddings, ``N(0, 1/d_in)`` matrices, unit norms."""
    return Transformer(cfg, dtype=dtype, device=device, gen=gen)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ArchConfig, p: Attention, h: torch.Tensor):
    q = torch.einsum("bsd,dhk->bhsk", h, p.wq.to(h.dtype))
    k = torch.einsum("bsd,dhk->bhsk", h, p.wk.to(h.dtype))
    v = torch.einsum("bsd,dhk->bhsk", h, p.wv.to(h.dtype))
    if cfg.qk_norm:
        q = layers.rmsnorm(p.q_norm, q)
        k = layers.rmsnorm(p.k_norm, k)
    return q, k, v


def _apply_rope(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor, pos: torch.Tensor):
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "half":
        return layers.apply_rope_half(q, k, pos)
    return layers.apply_rope(q, k, pos)


def _ffn(cfg: ArchConfig, p: Block, x: torch.Tensor) -> torch.Tensor:
    h2 = layers.norm_apply(p.ln2, x)
    return x + layers.mlp(p.mlp, h2, act=cfg.act)


def _out_proj(p: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhsk,hkd->bsd", attn_out, p.wo.to(attn_out.dtype))


def _attn_full(cfg: ArchConfig, p: Block, x: torch.Tensor, pos: torch.Tensor):
    """Full-sequence attention block: ``(x, {"k", "v"})``."""
    h = layers.norm_apply(p.ln1, x)
    q, k, v = _project_qkv(cfg, p.attn, h)
    q, k = _apply_rope(cfg, q, k, pos)
    attn_out = attention.chunked_causal_attention(q, k, v, chunk_size=1024)
    x = x + _out_proj(p.attn, attn_out)
    return _ffn(cfg, p, x), k, v


def _quantize_kv(t: torch.Tensor):
    """Per-(token, head) int8 quantization: t (B, Hkv, 1, Dh) -> (q, scale)."""
    tf = t.to(torch.float32)
    scale = torch.clamp_min(tf.abs().amax(dim=-1) / 127.0, 1e-8)     # (B, Hkv, 1)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _attn_step(cfg: ArchConfig, p: Block, x: torch.Tensor, cache: dict, layer: int,
               pos: int):
    """Single-token attention block; writes slot ``pos`` of layer ``layer``'s
    cache entries in place."""
    h = layers.norm_apply(p.ln1, x)
    q, k, v = _project_qkv(cfg, p.attn, h)                     # (B, H, 1, Dh)
    pos_t = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k = _apply_rope(cfg, q, k, pos_t)
    k_cache, v_cache = cache["k"][layer], cache["v"][layer]
    write = min(pos, k_cache.shape[2] - 1)
    kq = {}
    if "ks" in cache:
        k_w, k_s = _quantize_kv(k)
        v_w, v_s = _quantize_kv(v)
        k_cache[:, :, write] = k_w[:, :, 0]
        v_cache[:, :, write] = v_w[:, :, 0]
        cache["ks"][layer][:, :, write] = k_s[:, :, 0]
        cache["vs"][layer][:, :, write] = v_s[:, :, 0]
        kq = dict(k_scale=cache["ks"][layer], v_scale=cache["vs"][layer])
    else:
        k_cache[:, :, write] = k[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, write] = v[:, :, 0].to(v_cache.dtype)
    attn_out = attention.decode_attention(q, k_cache, v_cache, cache_len=pos + 1, **kq)
    x = x + _out_proj(p.attn, attn_out)
    return _ffn(cfg, p, x)


# ---------------------------------------------------------------------------
# full forward / prefill / decode
# ---------------------------------------------------------------------------


def _weights(params: Transformer, dtype) -> Transformer:
    check_supported(params.cfg)
    return params.compute(dtype)


def forward_full(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
                 dtype=torch.bfloat16, collect_cache: bool = False):
    """Hidden states (B, S, d) after the final norm, and with
    ``collect_cache`` the prefill caches ``{"units": [{"k", "v"}]}`` (leaves
    ``(n_layers, B, Hkv, S, Dh)`` in ``dtype``), else None."""
    w = _weights(params, dtype)
    b, s = tokens.shape
    x = layers.embed(w.embed, tokens, dtype)
    pos = torch.arange(s, device=tokens.device)
    caches = None
    if collect_cache:
        shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim_)
        caches = {"units": [{"k": torch.empty(shape, dtype=dtype, device=x.device),
                             "v": torch.empty(shape, dtype=dtype, device=x.device)}]}
    for i, blk in enumerate(w.blocks):
        x, k, v = _attn_full(cfg, blk, x, pos)
        if caches is not None:
            caches["units"][0]["k"][i] = k
            caches["units"][0]["v"][i] = v
    return layers.norm_apply(w.final_norm, x), caches


def logits_from_hidden(cfg: ArchConfig, params: Transformer, hidden: torch.Tensor):
    w = params.compute(hidden.dtype)
    if cfg.tie_embeddings:
        return hidden @ w.embed.T
    return hidden @ w.lm_head


def prefill(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
            dtype=torch.bfloat16):
    """``(last-token logits (B, V), caches)``."""
    hidden, caches = forward_full(cfg, params, tokens, dtype, collect_cache=True)
    logits = logits_from_hidden(cfg, params, hidden[:, -1:])
    return logits[:, 0], caches


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      quantized: bool = False, device=None):
    """Zero caches sized for ``max_len`` decode positions; ``quantized``
    stores K/V as int8 with per-(token, head) float32 scales."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if quantized:
        entry = {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                 "ks": zeros(shape[:-1], torch.float32), "vs": zeros(shape[:-1], torch.float32)}
    else:
        entry = {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    return {"units": [entry]}


def grow_cache(cfg: ArchConfig, caches: dict, prefill_len: int, max_len: int,
               dtype=torch.bfloat16) -> dict:
    """Prefill caches as fixed decode buffers of ``max_len``: each attention
    entry zero-padded on the sequence axis (decode masks by ``pos + 1``)."""
    check_supported(cfg)
    out = {"units": []}
    for entry in caches["units"]:
        k, v = entry["k"], entry["v"]
        pad = max_len - k.shape[-2]
        if pad > 0:
            k = nn.functional.pad(k, (0, 0, 0, pad))
            v = nn.functional.pad(v, (0, 0, 0, pad))
        out["units"].append({"k": k.to(dtype), "v": v.to(dtype)})
    return out


def decode_step(cfg: ArchConfig, params: Transformer, token: torch.Tensor, cache: dict,
                pos: int, dtype=torch.bfloat16):
    """One decode step. ``token (B,)`` int; ``pos`` the position it takes
    (the same for all rows). Writes its keys and values into ``cache`` in
    place; returns ``(logits (B, V), cache)``."""
    w = _weights(params, dtype)
    x = layers.embed(w.embed, token[:, None], dtype)
    entry = cache["units"][0]
    for i, blk in enumerate(w.blocks):
        x = _attn_step(cfg, blk, x, entry, i, int(pos))
    x = layers.norm_apply(w.final_norm, x)
    return logits_from_hidden(cfg, params, x)[:, 0], cache
