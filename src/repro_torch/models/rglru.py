"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Mirrors the reference's ``src/repro/models/rglru.py``. Block structure (the
"recurrent block" of Griffin):

    x-branch: Dense(d -> d_rnn) -> causal depthwise Conv1D(width 4) -> RG-LRU
    gate    : Dense(d -> d_rnn) -> GeLU (``layers.gelu``, the tanh approximation)
    out     : (x_branch * gate) -> Dense(d_rnn -> d)

RG-LRU recurrence (per channel), in float32 whatever the compute dtype:

    r_t = sigmoid(u_t W_a + b_a),  i_t = sigmoid(u_t W_i + b_i)
    a_t = sigmoid(Lambda)^(8 r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

The prefill solves the linear recurrence with a log-depth scan over the
``(a, b)`` pairs (Hillis-Steele doubling, ceil(log2 S) passes; the
reference's ``jax.lax.associative_scan`` combines the same pairs in another
tree). No closed form with cumulative products: ``a_t`` lies near 0.9-0.999,
and a product over thousands of steps leaves float32's range. Decode is one
step carrying ``(h, conv)``: ``h (B, d_rnn)`` float32 and the last three
pre-conv inputs ``conv (B, 3, d_rnn)`` in the compute dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import layers

__all__ = ["RecurrentBlock", "rglru_init_state", "rglru_block_apply", "rglru_block_step"]

_C = 8.0
_CONV_W = 4


class Gates(nn.Module):
    """The recurrence and input gates ``w_a``, ``w_i (d_rnn, d_rnn)`` and
    ``b_a``, ``b_i (d_rnn,)``: float32 always, as the reference keeps them."""

    def __init__(self, d_rnn: int, *, device=None, gen=None):
        super().__init__()
        std = d_rnn ** -0.5
        self.w_a = layers._weight((d_rnn, d_rnn), std, torch.float32, device, gen)
        self.b_a = nn.Parameter(torch.zeros(d_rnn, device=device), requires_grad=False)
        self.w_i = layers._weight((d_rnn, d_rnn), std, torch.float32, device, gen)
        self.b_i = nn.Parameter(torch.zeros(d_rnn, device=device), requires_grad=False)


class RecurrentBlock(nn.Module):
    """``w_x``, ``w_gate (d, d_rnn)``, ``w_out (d_rnn, d)``, ``conv (4, d_rnn)``
    in the parameter dtype; ``gates`` and ``lambda (d_rnn,)`` in float32.
    ``lambda`` is drawn so that ``sigmoid(lambda)^8`` covers (0.9, 0.999)."""

    def __init__(self, d: int, d_rnn: int, *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.w_x = layers._weight((d, d_rnn), d ** -0.5, dtype, device, gen)
        self.w_gate = layers._weight((d, d_rnn), d ** -0.5, dtype, device, gen)
        self.w_out = layers._weight((d_rnn, d), d_rnn ** -0.5, dtype, device, gen)
        self.conv = layers._weight((_CONV_W, d_rnn), 1.0 / math.sqrt(d), dtype, device, gen)
        self.gates = Gates(d_rnn, device=device, gen=gen)
        u = torch.rand(d_rnn, generator=gen, device=device) * (0.999 - 0.9) + 0.9
        root = u ** (1.0 / _C)
        self.register_parameter("lambda", nn.Parameter(torch.log(root / (1.0 - root)),
                                                       requires_grad=False))


def rglru_init_state(batch: int, d_rnn: int, dtype=torch.float32, device=None) -> dict:
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, d_rnn), dtype=dtype, device=device)}


def _gates(p: RecurrentBlock, u: torch.Tensor):
    """``(a, b)`` of the recurrence ``h_t = a_t h_{t-1} + b_t``, float32."""
    uf = u.to(torch.float32)
    g = p.gates
    r = torch.sigmoid(uf @ g.w_a + g.b_a)
    i = torch.sigmoid(uf @ g.w_i + g.b_i)
    log_a = _C * r * nn.functional.logsigmoid(getattr(p, "lambda"))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def _causal_conv(p: RecurrentBlock, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width 4 over ``u (B, S, d_rnn)``, in float32
    (it feeds only the float32 gates). The taps are added from the oldest,
    starting at 0, as the reference's Python ``sum``, each sum rounded to
    ``u.dtype`` but the last: compiled, the reference drops the rounding of
    a value converted to float32 right after (XLA; it gives the compiled
    reference block's bits, where rounding the last sum too moves a bf16
    block's output by 4e-3 of its scale)."""
    w = p.conv.to(u.dtype)
    up = torch.cat([u.new_zeros((u.shape[0], _CONV_W - 1, u.shape[2])), u], dim=1)
    taps = [up[:, i:i + u.shape[1]] * w[i] for i in range(_CONV_W)]
    return sum(taps[:-1]).to(torch.float32) + taps[-1].to(torch.float32)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along dim 1: after the
    pass of ``shift``, position ``t`` holds the composition of steps
    ``t - 2 shift + 1 .. t``. Overwrites ``a`` and ``b``; returns ``b``."""
    s, shift = a.shape[1], 1
    while shift < s:
        b[:, shift:] = a[:, shift:] * b[:, :-shift] + b[:, shift:]
        if 2 * shift < s:
            a[:, shift:] = a[:, shift:] * a[:, :-shift]
        shift *= 2
    return b


def rglru_block_apply(p: RecurrentBlock, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Full-sequence apply. ``x (B, S, d)``; returns ``(out (B, S, d), state)``
    with the state after the last position. ``h0`` is folded into the first
    step: ``h_1 = a_1 h0 + b_1``."""
    u_in = layers.dense(p.w_x, x)                       # (B, S, d_rnn)
    u = _causal_conv(p, u_in)
    a, b = _gates(p, u)                                 # float32 (B, S, d_rnn)
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    h = _linear_scan(a, b)
    gate = layers.gelu(layers.dense(p.w_gate, x))
    out = layers.dense(p.w_out, h.to(x.dtype) * gate)
    pad = u_in.new_zeros((x.shape[0], _CONV_W - 1, u_in.shape[-1]))
    # copies, so that the state does not keep the (B, S, d_rnn) buffers alive
    state = {"h": h[:, -1].clone(),
             "conv": torch.cat([pad, u_in], dim=1)[:, -(_CONV_W - 1):].clone()}
    return out, state


def rglru_block_step(p: RecurrentBlock, x: torch.Tensor, state: dict):
    """One decode step. ``x (B, 1, d)``; returns ``(out (B, 1, d), new_state)``."""
    u = layers.dense(p.w_x, x)                          # (B, 1, d_rnn)
    window = torch.cat([state["conv"], u], dim=1)       # (B, 4, d_rnn)
    w = p.conv.to(u.dtype)
    u_c = torch.sum(window * w[None], dim=1, keepdim=True)
    a, b = _gates(p, u_c)
    h = a[:, 0] * state["h"] + b[:, 0]                  # (B, d_rnn)
    gate = layers.gelu(layers.dense(p.w_gate, x))
    out = layers.dense(p.w_out, h[:, None].to(x.dtype) * gate)
    return out, {"h": h, "conv": window[:, 1:]}
