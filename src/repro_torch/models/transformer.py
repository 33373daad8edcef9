"""The block-pattern transformer: prefill, decode with caches, and the
weights as ``nn.Module``s.

Mirrors the reference's ``src/repro/models/transformer.py`` for patterns
whose kinds are ``attn`` (global causal attention), ``local`` (sliding-window
attention over ``cfg.window`` keys) and ``rglru`` (the RG-LRU recurrent block
of ``rglru.py``), each followed by a gated FFN: dense, or the MoE layer of
``moe.py`` when the config has experts. The dense archs (qwen3, smollm,
minicpm, chatglm3; pattern ``("attn",)``), recurrentgemma-2b (``("rglru",
"rglru", "local")``) and the MoE archs (deepseek-moe-16b, llama4-scout;
``("attn",)``).

Layout: the ``n_dense_layers`` leading blocks (deepseek's first layer) are
``Transformer.head_layers``: ``attn`` blocks with a dense FFN of width
``dense_d_ff``, applied before everything else. ``pattern_layout`` gives
``n_units`` full units of the pattern over the other layers and the tail
kinds. Block ``u * len(pattern) + j`` of ``Transformer.blocks`` is pattern
position ``j`` of unit ``u``; the tail blocks come after the units. The
reference stacks the units along a leading axis and applies them under
``lax.scan``; here the blocks are an ``nn.ModuleList`` and the scan is a
loop. xLSTM, encoder-decoder, M-RoPE and frontends raise
``NotImplementedError`` (ROADMAP queue 1, item 16).

Entry points (same weights):
    ``forward_full``   — pre-head hidden states for a whole sequence
    ``prefill``        — forward_full + per-layer caches, last-token logits
    ``decode_step``    — one token through the cached states

Caches keep the reference's tree: ``{"head_<i>": entry, "units": [one
entry per pattern position, each leaf stacked over the units], "tail_<i>":
entry}``. An
attention entry is ``{"k", "v"}`` ``(B, Hkv, S, Dh)`` (an int8 cache adds
per-(token, head) float32 scales ``"ks"``, ``"vs"`` ``(B, Hkv, S)``); a
``local`` entry holds at most ``window`` positions, as a rolling buffer in
which position ``p`` sits at slot ``p % window``; an ``rglru`` entry is
``{"h" (B, d_rnn) float32, "conv" (B, 3, d_rnn)}``. ``decode_step`` writes
the new token's keys, values and recurrent states into the cache in place
(the reference writes functional copies of the same values) and returns
the same dict.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention, layers, moe, rglru

__all__ = ["Transformer", "Block", "Attention", "check_supported", "pattern_layout",
           "block_kinds", "keeps_float32", "init_params", "forward_full",
           "logits_from_hidden", "prefill", "init_decode_cache", "grow_cache", "decode_step"]

_ITEM = "ROADMAP queue 1, item 16"
_KINDS = ("attn", "local", "rglru")


def pattern_layout(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    """(n_full_units, tail_kinds), as the reference lays out the layers."""
    pat = cfg.block_pattern
    n_scan = cfg.n_layers - cfg.n_dense_layers
    n_units = n_scan // len(pat)
    tail_len = n_scan - n_units * len(pat)
    return n_units, pat[:tail_len]


def block_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of each block of ``Transformer.blocks``: the units' pattern
    positions in order, then the tail."""
    n_units, tail = pattern_layout(cfg)
    return list(cfg.block_pattern) * n_units + list(tail)


def _d_rnn(cfg: ArchConfig) -> int:
    return cfg.d_model       # the reference's lru width (RG-2B: 2560 = d_model)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    missing = []
    other = sorted(set(cfg.block_pattern) - set(_KINDS))
    if other:
        missing.append(f"{', '.join(other)} blocks")
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
            f"the port runs {', '.join(_KINDS)} blocks with a dense or MoE FFN")


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
    """One block of ``kind``: ``ln1``, ``attn`` (``attn``, ``local``) or ``rec``
    (``rglru``), ``ln2``, and ``mlp`` or, in an MoE config, ``moe``;
    ``dense_d_ff`` makes a leading dense layer (an ``mlp`` of that width).
    ``in_unit``: a block of the pattern's units, which the reference runs
    compiled (``_ffn``)."""

    def __init__(self, cfg: ArchConfig, kind: str, *, in_unit: bool = False,
                 dense_d_ff: int = 0, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.kind = kind
        self.in_unit = in_unit
        self.ln1 = layers.Norm(cfg.norm, cfg.d_model, device=device)
        if kind == "rglru":
            self.rec = rglru.RecurrentBlock(cfg.d_model, _d_rnn(cfg), dtype=dtype,
                                            device=device, gen=gen)
        else:
            self.attn = Attention(cfg, dtype=dtype, device=device, gen=gen)
        self.ln2 = layers.Norm(cfg.norm, cfg.d_model, device=device)
        if cfg.is_moe and not dense_d_ff:
            self.moe = moe.MoE(cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                               cfg.n_shared_experts, dtype=dtype, device=device, gen=gen)
        else:
            self.mlp = layers.MLP(cfg.d_model, dense_d_ff or cfg.d_ff, dtype=dtype,
                                  device=device, gen=gen)


class Transformer(nn.Module):
    """The weights: ``embed (vocab, d)``, ``head_layers`` (the leading dense
    layers), ``blocks``, ``final_norm`` and, for untied embeddings,
    ``lm_head (d, vocab)``.

    The matrices are stored in the parameter dtype (float32 masters, or
    bf16 to serve a model whose masters do not fit); the leaves the
    reference reads in float32 (norm scales and biases, the RG-LRU's gates
    and ``lambda``, the MoE router: ``keeps_float32``) stay float32.
    ``compute(dtype)`` returns the copy the forward passes read: the other
    matrices cast to ``dtype`` once and kept (the reference casts them at
    every use, which gives the same bits), the float32 leaves shared with
    the masters. The masters are read only
    here (no training path), so the copy never goes stale; moving the module
    drops it.
    """

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = layers._weight((cfg.vocab_size, d), 0.02, dtype, device, gen)
        self.head_layers = nn.ModuleList(
            Block(cfg, "attn", dense_d_ff=cfg.dense_d_ff or cfg.d_ff, dtype=dtype,
                  device=device, gen=gen) for _ in range(cfg.n_dense_layers))
        n_unit_blocks = pattern_layout(cfg)[0] * len(cfg.block_pattern)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, in_unit=i < n_unit_blocks, dtype=dtype, device=device, gen=gen)
            for i, kind in enumerate(block_kinds(cfg)))
        self.final_norm = layers.Norm(cfg.norm, d, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = layers._weight((d, cfg.vocab_size), d ** -0.5, dtype, device, gen)
        self._compute: dict[torch.dtype, Transformer] = {}

    def compute(self, dtype: torch.dtype) -> "Transformer":
        """These weights with every matrix in ``dtype`` (float32 leaves shared)."""
        if all(p.dtype == dtype for n, p in self.named_parameters() if not keeps_float32(n)):
            return self
        if dtype not in self._compute:
            copy = Transformer(self.cfg, device="meta")
            state = {name: t if keeps_float32(name) else t.to(dtype)
                     for name, t in self.state_dict().items()}
            copy.load_state_dict(state, assign=True)
            self._compute[dtype] = copy
        return self._compute[dtype]

    def _apply(self, fn, recurse=True):
        self._compute = {}
        return super()._apply(fn, recurse)


#: The leaves the reference stores and reads in float32 whatever the compute
#: and parameter dtypes: norm scales and biases, the RG-LRU's gates and
#: ``lambda``, and the MoE router.
_FLOAT32_LEAVES = ("scale", "bias", "w_a", "b_a", "w_i", "b_i", "lambda", "router")


def keeps_float32(name: str) -> bool:
    """Whether the parameter ``name`` stays float32 in every copy."""
    return name.rsplit(".", 1)[-1] in _FLOAT32_LEAVES


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


def _ffn(cfg: ArchConfig, p: Block, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``x + out`` (the mixer's residual), then the FFN and its residual.

    The reference runs a unit's blocks compiled (inside its ``lax.scan``),
    and there XLA adds ``x + out`` in float32 and the ``ln2`` norm reads
    that sum before it is rounded to the compute dtype; the residual keeps
    the rounded sum, as it does op by op. (In bf16 a top-1 MoE with
    capacity drops turns a one-step difference there into other routes.)"""
    s = x + out
    if p.in_unit:
        h2 = layers.norm_apply(p.ln2, x.to(torch.float32) + out.to(torch.float32)).to(x.dtype)
    else:
        h2 = layers.norm_apply(p.ln2, s)
    if hasattr(p, "moe"):       # serving drops the load-balance loss
        return s + moe.moe_apply(p.moe, h2, top_k=cfg.experts_per_token, act=cfg.act,
                                 capacity_factor=cfg.capacity_factor)[0]
    return s + layers.mlp(p.mlp, h2, act=cfg.act)


def _out_proj(p: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhsk,hkd->bsd", attn_out, p.wo.to(attn_out.dtype))


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "local" else 0


def _attn_full(cfg: ArchConfig, p: Block, x: torch.Tensor, pos: torch.Tensor, window: int):
    """Full-sequence attention block (``window > 0``: sliding window):
    ``(x, {"k", "v"})``, the cache keeping the last ``window`` positions."""
    h = layers.norm_apply(p.ln1, x)
    q, k, v = _project_qkv(cfg, p.attn, h)
    q, k = _apply_rope(cfg, q, k, pos)
    attn_out = attention.chunked_causal_attention(q, k, v, chunk_size=1024, window=window)
    if window and window < k.shape[2]:
        k, v = k[:, :, -window:], v[:, :, -window:]
    return _ffn(cfg, p, x, _out_proj(p.attn, attn_out)), {"k": k, "v": v}


def _recurrent_full(cfg: ArchConfig, p: Block, x: torch.Tensor):
    out, state = rglru.rglru_block_apply(p.rec, layers.norm_apply(p.ln1, x))
    return _ffn(cfg, p, x, out), state


def _block_full(cfg: ArchConfig, kind: str, p: Block, x: torch.Tensor, pos: torch.Tensor):
    if kind == "rglru":
        return _recurrent_full(cfg, p, x)
    return _attn_full(cfg, p, x, pos, _window(cfg, kind))


def _quantize_kv(t: torch.Tensor):
    """Per-(token, head) int8 quantization: t (B, Hkv, 1, Dh) -> (q, scale)."""
    tf = t.to(torch.float32)
    scale = torch.clamp_min(tf.abs().amax(dim=-1) / 127.0, 1e-8)     # (B, Hkv, 1)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _attn_step(cfg: ArchConfig, p: Block, x: torch.Tensor, cache: dict, pos: int,
               window: int):
    """Single-token attention block; writes its keys and values into
    ``cache`` (one layer's ``{"k", "v"}``, ``(B, Hkv, S_max, Dh)``) in place:
    at slot ``pos``, or ``pos % window`` in a local layer's rolling buffer,
    which then holds ``min(pos + 1, S_max)`` valid slots (RoPE carries the
    absolute positions, so the order of the slots does not matter)."""
    h = layers.norm_apply(p.ln1, x)
    q, k, v = _project_qkv(cfg, p.attn, h)                     # (B, H, 1, Dh)
    pos_t = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k = _apply_rope(cfg, q, k, pos_t)
    k_cache, v_cache = cache["k"], cache["v"]
    s_max = k_cache.shape[2]
    write = min(pos % window if window else pos, s_max - 1)
    kq = {}
    if "ks" in cache:
        k_w, k_s = _quantize_kv(k)
        v_w, v_s = _quantize_kv(v)
        k_cache[:, :, write] = k_w[:, :, 0]
        v_cache[:, :, write] = v_w[:, :, 0]
        cache["ks"][:, :, write] = k_s[:, :, 0]
        cache["vs"][:, :, write] = v_s[:, :, 0]
        kq = dict(k_scale=cache["ks"], v_scale=cache["vs"])
    else:
        k_cache[:, :, write] = k[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, write] = v[:, :, 0].to(v_cache.dtype)
    valid = min(pos + 1, s_max) if window else pos + 1
    attn_out = attention.decode_attention(q, k_cache, v_cache, cache_len=valid, **kq)
    return _ffn(cfg, p, x, _out_proj(p.attn, attn_out))


def _recurrent_step(cfg: ArchConfig, p: Block, x: torch.Tensor, cache: dict):
    """Single-token RG-LRU block; writes the new ``h`` and ``conv`` into
    ``cache`` in place."""
    out, state = rglru.rglru_block_step(p.rec, layers.norm_apply(p.ln1, x), cache)
    cache["h"].copy_(state["h"])
    cache["conv"].copy_(state["conv"])
    return _ffn(cfg, p, x, out)


def _block_step(cfg: ArchConfig, kind: str, p: Block, x: torch.Tensor, cache: dict,
                pos: int):
    if kind == "rglru":
        return _recurrent_step(cfg, p, x, cache)
    return _attn_step(cfg, p, x, cache, pos, _window(cfg, kind))


def _layer_caches(cfg: ArchConfig, caches: dict):
    """Each block's cache entry, in block order: views into the stacked
    unit entries, then the tail entries."""
    n_units, tail = pattern_layout(cfg)
    for u in range(n_units):
        for entry in caches["units"]:
            yield {name: t[u] for name, t in entry.items()}
    for i in range(len(tail)):
        yield caches[f"tail_{i}"]


# ---------------------------------------------------------------------------
# full forward / prefill / decode
# ---------------------------------------------------------------------------


def _weights(params: Transformer, dtype) -> Transformer:
    check_supported(params.cfg)
    return params.compute(dtype)


def forward_full(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
                 dtype=torch.bfloat16, collect_cache: bool = False):
    """Hidden states (B, S, d) after the final norm, and with
    ``collect_cache`` the prefill caches (the module docstring's tree: a
    ``head`` or ``attn`` entry holds all S positions, a ``local`` one the last
    ``min(S, window)``, an ``rglru`` one the state after position S - 1),
    else None."""
    w = _weights(params, dtype)
    x = layers.embed(w.embed, tokens, dtype)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    n_units, _ = pattern_layout(cfg)
    width = len(cfg.block_pattern)
    caches = {}
    for i, blk in enumerate(w.head_layers):
        x, entry = _attn_full(cfg, blk, x, pos, 0)
        if collect_cache:
            caches[f"head_{i}"] = entry
    if collect_cache and n_units:
        caches["units"] = [None] * width
    for i, blk in enumerate(w.blocks):
        x, entry = _block_full(cfg, blk.kind, blk, x, pos)
        if not collect_cache:
            continue
        u, j = divmod(i, width)
        if u >= n_units:
            caches[f"tail_{i - n_units * width}"] = entry
            continue
        if u == 0:      # the stacked buffers, from the first unit's shapes
            caches["units"][j] = {name: t.new_empty((n_units, *t.shape))
                                  for name, t in entry.items()}
        for name, t in entry.items():
            caches["units"][j][name][u] = t
    return layers.norm_apply(w.final_norm, x), (caches if collect_cache else None)


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
    """Zero caches sized for ``max_len`` decode positions (a ``local`` entry
    for ``min(window, max_len)``); ``quantized`` stores K/V as int8 with
    per-(token, head) float32 scales."""
    check_supported(cfg)
    n_units, tail = pattern_layout(cfg)

    def entry(kind, lead=()):
        if kind == "rglru":
            state = rglru.rglru_init_state(batch, _d_rnn(cfg), dtype, device)
            return {name: t.new_zeros((*lead, *t.shape)) for name, t in state.items()}
        s = min(cfg.window or max_len, max_len) if kind == "local" else max_len
        shape = (*lead, batch, cfg.n_kv_heads, s, cfg.head_dim_)
        zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        if quantized:
            return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                    "ks": zeros(shape[:-1], torch.float32),
                    "vs": zeros(shape[:-1], torch.float32)}
        return {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}

    cache = {f"head_{i}": entry("attn") for i in range(cfg.n_dense_layers)}
    if n_units:
        cache["units"] = [entry(kind, (n_units,)) for kind in cfg.block_pattern]
    for i, kind in enumerate(tail):
        cache[f"tail_{i}"] = entry(kind)
    return cache


def grow_cache(cfg: ArchConfig, caches: dict, prefill_len: int, max_len: int,
               dtype=torch.bfloat16) -> dict:
    """Prefill caches as fixed decode buffers of ``max_len``: an ``attn``
    entry zero-padded on the sequence axis (decode masks by ``pos + 1``); a
    ``local`` entry rolled so that position ``p`` sits at slot ``p % window``
    (the slot decode overwrites is then the oldest), padded to ``min(window,
    max_len)``; recurrent states passed through unchanged."""
    check_supported(cfg)
    window = cfg.window
    _, tail = pattern_layout(cfg)

    def fix(kind, entry):
        if kind == "rglru":
            return entry
        k, v = entry["k"], entry["v"]
        target = max_len
        if kind == "local" and window:
            shift = prefill_len % window if prefill_len >= window else 0
            if shift:
                k, v = torch.roll(k, shift, dims=-2), torch.roll(v, shift, dims=-2)
            target = min(window, max_len)
        pad = target - k.shape[-2]
        if pad > 0:
            k = nn.functional.pad(k, (0, 0, 0, pad))
            v = nn.functional.pad(v, (0, 0, 0, pad))
        return {"k": k.to(dtype), "v": v.to(dtype)}

    out = {}
    for key, val in caches.items():
        if key == "units":
            out["units"] = [fix(kind, e) for kind, e in zip(cfg.block_pattern, val)]
        elif key.startswith("head_"):
            out[key] = fix("attn", val)
        else:
            out[key] = fix(tail[int(key.split("_")[1])], val)
    return out


def decode_step(cfg: ArchConfig, params: Transformer, token: torch.Tensor, cache: dict,
                pos: int, dtype=torch.bfloat16):
    """One decode step. ``token (B,)`` int; ``pos`` the position it takes
    (the same for all rows). Writes its keys, values and recurrent states
    into ``cache`` in place; returns ``(logits (B, V), cache)``."""
    w = _weights(params, dtype)
    x = layers.embed(w.embed, token[:, None], dtype)
    for i, blk in enumerate(w.head_layers):
        x = _attn_step(cfg, blk, x, cache[f"head_{i}"], int(pos), 0)
    for blk, entry in zip(w.blocks, _layer_caches(cfg, cache)):
        x = _block_step(cfg, blk.kind, blk, x, entry, int(pos))
    x = layers.norm_apply(w.final_norm, x)
    return logits_from_hidden(cfg, params, x)[:, 0], cache
