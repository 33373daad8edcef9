"""Common model layers: plain functions on tensors, and the small modules that
hold their weights.

Mirrors the reference's ``src/repro/models/layers.py`` operation for
operation, in the same dtype order, so that bf16 results round where the
reference's do:

* ``rmsnorm``/``layernorm`` compute in float32 and cast back to the input's
  dtype; their scale and bias are read in float32;
* ``embed`` gathers rows of a table already in the compute dtype (the
  reference casts the table, then gathers);
* ``_rotate`` casts cos/sin to ``x.dtype`` before it multiplies;
* ``gelu`` is ``jax.nn.gelu``'s tanh formula with its constants in
  ``x.dtype``, op by op (ATen's fused bf16 GELU rounds elsewhere);
* ``silu`` is ``jax.nn.silu`` as XLA expands it, ``x * (1 / (1 + exp(-x)))``
  op by op in ``x.dtype`` (ATen's fused SiLU rounds once, at the end).

Weights are stored in the model's parameter dtype (float32 masters); the
matrices are cast to the compute dtype once, when the compute copy is made
(``transformer.Transformer.compute``), which gives the bits the reference's
cast at each use gives.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Norm", "MLP", "dense", "rmsnorm", "layernorm", "norm_apply", "embed", "gelu",
           "silu", "mlp", "rotary_angles", "apply_rope", "apply_rope_half"]


def _weight(shape, std: float, dtype, device, gen) -> nn.Parameter:
    """A ``N(0, std^2)`` parameter drawn from ``gen`` (inference only: no grad)."""
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device) * std
    return nn.Parameter(w, requires_grad=False)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) weights."""

    def __init__(self, kind: str, d: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        if kind != "rmsnorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                     requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(self, x)


class MLP(nn.Module):
    """Gated MLP weights ``w_in``, ``w_gate`` (d, d_ff) and ``w_out`` (d_ff, d),
    each ``N(0, 1/d_in)`` as the reference's ``dense_init``."""

    def __init__(self, d: int, d_ff: int, *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.w_in = _weight((d, d_ff), d ** -0.5, dtype, device, gen)
        self.w_gate = _weight((d, d_ff), d ** -0.5, dtype, device, gen)
        self.w_out = _weight((d_ff, d), d_ff ** -0.5, dtype, device, gen)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype."""
    return x @ w.to(x.dtype)


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale.to(torch.float32)
    return out.to(dt)


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p.scale.to(torch.float32) + p.bias.to(torch.float32)
    return out.to(dt)


def norm_apply(p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if p.kind == "rmsnorm" else layernorm(p, x)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` cast to ``dtype`` (cast first, as the
    reference does; a no-op for the compute copy's table)."""
    return table.to(dtype)[tokens]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, as ``jax.nn.gelu`` computes it."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32).to(x.dtype)
    k = torch.tensor(0.044715, dtype=torch.float32).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each op
    rounding to ``x.dtype``, as ``jax.nn.silu`` compiles."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def mlp(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = dense(p.w_in, x)
    g = dense(p.w_gate, x)
    g = silu(g) if act == "silu" else gelu(g)
    return dense(p.w_out, h * g)


def rotary_angles(positions: torch.Tensor, dim: int, base: float = 10_000.0) -> torch.Tensor:
    """(..., dim/2) float32 angles for integer ``positions`` of any shape."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device),
                          exps)
    return positions.to(torch.float32)[..., None] * inv


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the (even, odd) pairs of the last dim of ``x`` by ``angles``
    (broadcastable to ``x``'s shape with the last dim halved)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def _head_angles(positions: torch.Tensor, dim: int, base: float) -> torch.Tensor:
    ang = rotary_angles(positions, dim, base)          # (B?, S, dim/2)
    if ang.ndim == 2:                                   # (S, dim/2)
        ang = ang[None]
    return ang[:, None]                                 # (B, 1, S, dim/2)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               base: float = 10_000.0):
    """Standard RoPE over the full head dim. q, k: (B, H, S, Dh); positions:
    (B, S) or (S,)."""
    ang = _head_angles(positions, q.shape[-1], base)
    return _rotate(q, ang), _rotate(k, ang)


def apply_rope_half(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                    base: float = 10_000.0):
    """ChatGLM-style 2D RoPE: rotate the first half of the head dim, pass the
    second half through."""
    half = q.shape[-1] // 2
    ang = _head_angles(positions, half, base)
    q_rot = _rotate(q[..., :half], ang)
    k_rot = _rotate(k[..., :half], ang)
    return (torch.cat([q_rot, q[..., half:]], -1), torch.cat([k_rot, k[..., half:]], -1))
